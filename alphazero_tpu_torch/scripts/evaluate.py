"""Model-against-model evaluation CLI (counterpart of
``alphazero_tpu/scripts/evaluate.py``, the same flags plus ``--device``):
A against B with the colours swapped between the two halves of the games,
and the Elo change; prints one JSON line.

    python -m alphazero_tpu_torch.scripts.evaluate \\
        --model-a models_zoo/flagship_gomoku15 --num-games 32
"""
from __future__ import annotations

import argparse
import json
import os


def load_eval_fn(model_path, env, device="cuda"):
    """The uniform stub (value noise 0.1) without a model, else the bundle's
    BN-folded net in its own dtype (bf16 for the flagship)."""
    if model_path is None:
        from alphazero_tpu_torch.models.stub import make_uniform_eval_fn

        return make_uniform_eval_fn(env.num_actions, value_noise=0.1)
    from alphazero_tpu_torch.models.io import load_model
    from alphazero_tpu_torch.models.resnet import make_inference_eval_fn

    model, _ = load_model(model_path, env.observation_shape, device=device)
    return make_inference_eval_fn(model)


def default_max_moves(game: str, board_size: int) -> int:
    return (board_size ** 2 + 1 if game == "gomoku"
            else 2 * board_size ** 2 if game == "go" else 512)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--game", default="gomoku",
                   choices=["gomoku", "go", "chess"])
    p.add_argument("--board-size", type=int, default=15)
    p.add_argument("--model-a", default=None)
    p.add_argument("--model-b", default=None)
    p.add_argument("--num-games", type=int, default=32)
    p.add_argument("--simulations", type=int, default=200)
    p.add_argument("--max-moves", type=int, default=None)
    p.add_argument("--temperature", type=float, default=0.1)
    p.add_argument("--opening-moves", type=int, default=6,
                   help="mirrored random opening plies (deep searches are "
                   "near-deterministic at low temperature; without opening "
                   "diversity every game is a replica)")
    p.add_argument("--wave", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--elo-file", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    from alphazero_tpu_torch.core import registry
    from alphazero_tpu_torch.elo.tracker import EloTracker
    from alphazero_tpu_torch.eval.arena import ArenaConfig, play_match_host
    from alphazero_tpu_torch.mcts.search import MCTSConfig

    device = torch.device(args.device)
    env = registry.create_game(args.game, args.board_size)
    eval_a = load_eval_fn(args.model_a, env, device)
    eval_b = load_eval_fn(args.model_b, env, device)
    config = ArenaConfig(
        mcts=MCTSConfig(num_simulations=args.simulations, dirichlet_epsilon=0.0,
                        wave_size=min(args.wave, args.simulations)),
        max_moves=args.max_moves or default_max_moves(args.game, env.board_size),
        temperature=args.temperature,
        opening_random_moves=args.opening_moves,
    )
    gen = torch.Generator(device=device).manual_seed(args.seed)
    res = play_match_host(env, eval_a, eval_b, gen, config, args.num_games,
                          device=device)
    wins_a, wins_b, draws = int(res.wins_a), int(res.wins_b), int(res.draws)
    n = wins_a + wins_b + draws
    score = (wins_a + 0.5 * draws) / max(n, 1)

    name_a = args.model_a or "uniform_a"
    name_b = args.model_b or "uniform_b"
    tracker = (EloTracker.load(args.elo_file)
               if args.elo_file and os.path.exists(args.elo_file) else EloTracker())
    tracker.add_series(name_a, name_b, wins_a, wins_b, draws)
    if args.elo_file:
        tracker.save(args.elo_file)

    print(json.dumps({
        "wins_a": wins_a, "wins_b": wins_b, "draws": draws,
        "score_a": round(score, 3),
        "elo_a": round(tracker.get_rating(name_a), 1),
        "elo_b": round(tracker.get_rating(name_b), 1),
    }))


if __name__ == "__main__":
    main()
