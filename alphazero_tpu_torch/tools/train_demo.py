"""A short end-to-end training demo, then an arena against the uniform
random player (counterpart of ``tools/train_demo.py``, which runs at
import; this runs in ``main``).

Gomoku 9x9 by default: a 4x64 SE-ResNet, a constant learning rate, 512
self-play games an iteration at 128 simulations with the production int8
actors; then 64 games of the trained net (the raw BatchNorm net as JAX's
``model.apply`` runs it, ``make_raw_eval_fn``; 64 simulations, W=1,
T=0.1) against the uniform stub with value noise.  The record
(iterations, train wall s, the history, the arena's wins) goes to
``--output``; one summary line is printed.

    python -m alphazero_tpu_torch.tools.train_demo [--device cuda]

Env knobs: DEMO_GAME (gomoku; or go), DEMO_ITERS (8), DEMO_WAVE (1),
DEMO_BOARD (9), DEMO_GAMES (512), DEMO_SIMS (128).
"""
from __future__ import annotations

import argparse
import json
import os
import time

from alphazero_tpu_torch.tools import _common

ARENA_GAMES = 64


def knobs() -> dict:
    env = os.environ.get
    return {"iters": int(env("DEMO_ITERS", "8")), "game": env("DEMO_GAME", "gomoku"),
            "wave": int(env("DEMO_WAVE", "1")), "board": int(env("DEMO_BOARD", "9")),
            "games": int(env("DEMO_GAMES", "512")), "sims": int(env("DEMO_SIMS", "128"))}


def recipe(k: dict, checkpoint_dir: str):
    from alphazero_tpu_torch.mcts.search import MCTSConfig
    from alphazero_tpu_torch.models.resnet import ResNetConfig
    from alphazero_tpu_torch.selfplay.actor import SelfPlayConfig
    from alphazero_tpu_torch.training.learner import LearnerConfig
    from alphazero_tpu_torch.training.pipeline import PipelineConfig

    iters = k["iters"]
    return PipelineConfig(
        game=k["game"],
        board_size=k["board"],
        model=ResNetConfig(num_blocks=4, channels=64),
        selfplay=SelfPlayConfig(
            mcts=MCTSConfig(num_simulations=k["sims"], dirichlet_alpha=0.2,
                            wave_size=k["wave"]),
            max_moves=k["board"] * k["board"] + 1,
            temperature_drop_move=12,
        ),
        learner=LearnerConfig(learning_rate=2e-3, scheduler="constant",
                              total_steps=iters * 64),
        iterations=iters,
        games_per_iteration=k["games"],
        train_steps_per_iteration=64,
        train_batch_size=2048,
        replay_capacity=200_000,
        min_replay_before_training=4096,
        checkpoint_dir=checkpoint_dir,
        checkpoint_every=10**9,
    )


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    _common.add_args(p, "train_demo.json")
    args = p.parse_args(argv)
    k = knobs()
    out = _common.check_output(args.output)

    import torch

    from alphazero_tpu_torch.eval.arena import ArenaConfig, play_match
    from alphazero_tpu_torch.mcts.search import MCTSConfig
    from alphazero_tpu_torch.models.resnet import make_raw_eval_fn
    from alphazero_tpu_torch.models.stub import make_uniform_eval_fn
    from alphazero_tpu_torch.training.pipeline import Pipeline

    dev = torch.device(args.device)
    cfg = recipe(k, _common.beside(out, "demo_ckpt"))
    pipe = Pipeline(cfg, device=dev)
    t0 = time.time()
    # ``Pipeline.run`` with each iteration printed as it ends.
    history = _common.train_iterations(pipe, k["iters"])
    pipe.save_history()
    train_s = time.time() - t0

    env = pipe.env
    eval_trained = make_raw_eval_fn(pipe.state.module)
    eval_random = make_uniform_eval_fn(env.num_actions, value_noise=0.1)
    acfg = ArenaConfig(mcts=MCTSConfig(num_simulations=64, dirichlet_epsilon=0.0),
                       max_moves=cfg.selfplay.max_moves, temperature=0.1)
    res = play_match(env, eval_trained, eval_random, _common.generator(dev, 7),
                     acfg, ARENA_GAMES, device=dev)
    result = {
        "iterations": k["iters"],
        "train_wall_s": round(train_s, 1),
        "history": history,
        "arena_vs_random": {"wins": int(res.wins_a), "losses": int(res.wins_b),
                            "draws": int(res.draws)},
    }
    _common.write_json(out, result)
    print(json.dumps({
        "game": k["game"],
        "final_loss": history[-1].get("loss"),
        "first_loss": next((h.get("loss") for h in history if "loss" in h), None),
        "win_rate_vs_random": int(res.wins_a) / ARENA_GAMES,
        "train_wall_s": round(train_s, 1),
    }))
    return result


if __name__ == "__main__":
    main()
