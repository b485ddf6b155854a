"""The flagship recipe: Gomoku 15x15, the 6-block 64-channel SE-ResNet,
800-simulation self-play (counterpart of ``tools/train_flagship.py``).

Trains for a bounded budget, keeps the weights every ``FLAG_EVAL_EVERY``
iterations and plays each kept net against the iteration-0 net and its
predecessor (``play_match``: one batched search, colours swapped between
the halves, fixed simulations), rated with sequential Elo
(``elo/tracker.py``).  Writes the record (pipeline history, the arena
series, the Elo table) to ``--output``, the final weights as a bundle and
the loss and Elo plots beside it.

    python -m alphazero_tpu_torch.tools.train_flagship [--device cuda]

Env knobs: FLAG_ITERS (16), FLAG_GAMES (256), FLAG_SIMS (800),
FLAG_EVAL_EVERY (4), FLAG_EVAL_GAMES (128), FLAG_EVAL_SIMS (100);
FLAG_MODEL_OUT (default ``flagship_gomoku15`` beside ``--output``).
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import time

from alphazero_tpu_torch.tools import _common


def knobs() -> dict:
    env = os.environ.get
    return {"iters": int(env("FLAG_ITERS", "16")), "games": int(env("FLAG_GAMES", "256")),
            "sims": int(env("FLAG_SIMS", "800")),
            "eval_every": int(env("FLAG_EVAL_EVERY", "4")),
            "eval_games": int(env("FLAG_EVAL_GAMES", "128")),
            "eval_sims": int(env("FLAG_EVAL_SIMS", "100"))}


def recipe(k: dict, checkpoint_dir: str):
    from alphazero_tpu_torch.mcts.search import MCTSConfig
    from alphazero_tpu_torch.models.resnet import ResNetConfig
    from alphazero_tpu_torch.selfplay.actor import SelfPlayConfig
    from alphazero_tpu_torch.training.learner import LearnerConfig
    from alphazero_tpu_torch.training.pipeline import PipelineConfig

    return PipelineConfig(
        game="gomoku", board_size=15,
        model=ResNetConfig(),  # the flagship: 6 blocks, 64 channels, BN
        selfplay=SelfPlayConfig(
            mcts=MCTSConfig(num_simulations=k["sims"], wave_size=16),
            max_moves=225, temperature_drop_move=30,
        ),
        learner=LearnerConfig(total_steps=max(k["iters"] * 64, 256)),
        iterations=k["iters"],
        games_per_iteration=k["games"],
        train_steps_per_iteration=64,
        train_batch_size=1024,
        replay_capacity=200_000,
        min_replay_before_training=4_096,
        checkpoint_dir=checkpoint_dir,
        checkpoint_every=10**9,  # the kept nets stay in memory
    )


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    _common.add_args(p, "train_flagship_gomoku15.json")
    args = p.parse_args(argv)
    k = knobs()
    out = _common.check_output(args.output)
    bundle = _common.check_output(os.environ.get(
        "FLAG_MODEL_OUT", _common.beside(out, "flagship_gomoku15")))

    import torch

    from alphazero_tpu_torch.elo.tracker import EloTracker
    from alphazero_tpu_torch.eval.arena import ArenaConfig, play_match
    from alphazero_tpu_torch.mcts.search import MCTSConfig
    from alphazero_tpu_torch.models.io import save_model
    from alphazero_tpu_torch.models.resnet import make_inference_eval_fn
    from alphazero_tpu_torch.training.pipeline import Pipeline
    from alphazero_tpu_torch.utils.visualization import (
        plot_elo_history, plot_training_history,
    )

    dev = torch.device(args.device)
    cfg = recipe(k, _common.beside(out, "flagship_ckpt"))
    pipe = Pipeline(cfg, device=dev)
    arena_cfg = ArenaConfig(mcts=MCTSConfig(num_simulations=k["eval_sims"],
                                            dirichlet_epsilon=0.0), max_moves=225)

    def snap():
        return make_inference_eval_fn(copy.deepcopy(pipe.state.module))

    snapshots = {0: snap()}
    elo = EloTracker()
    elo.add_player("iter_0")
    series = []

    def rate(it):
        step = it + 1
        if step % k["eval_every"] and step != k["iters"]:
            return
        snapshots[step] = snap()
        name = f"iter_{step}"
        elo.add_player(name)
        opponents = ["iter_0"]
        prev = sorted(s for s in snapshots if 0 < s < step)
        if prev:
            opponents.append(f"iter_{prev[-1]}")
        for opp in dict.fromkeys(opponents):
            opp_step = int(opp.split("_")[1])
            res = play_match(pipe.env, snapshots[step], snapshots[opp_step],
                             _common.generator(dev, 9000 + step * 100 + opp_step),
                             arena_cfg, k["eval_games"], device=dev)
            wa, wb, dr = int(res.wins_a), int(res.wins_b), int(res.draws)
            elo.add_series(name, opp, wa, wb, dr)
            rec = {"player": name, "opponent": opp, "wins": wa, "losses": wb,
                   "draws": dr, "rating": round(elo.get_rating(name), 1),
                   "opp_rating": round(elo.get_rating(opp), 1)}
            series.append(rec)
            print(f"  arena {name} vs {opp}: +{wa} -{wb} ={dr} "
                  f"({rec['rating']} vs {rec['opp_rating']})", flush=True)

    t0 = time.time()
    _common.train_iterations(pipe, k["iters"], rate)
    payload = {
        "config": {
            "iterations": k["iters"], "games_per_iteration": k["games"],
            "simulations": k["sims"], "eval_games": k["eval_games"],
            "eval_sims": k["eval_sims"], "wall_s": round(time.time() - t0, 1),
        },
        "history": pipe.history,
        "arena_series": series,
        "elo": {p: round(elo.get_rating(p), 1) for p, _ in elo.leaderboard()},
    }
    _common.write_json(out, payload)
    save_model(bundle, pipe.state.module, "resnet", pipe.env.num_actions, cfg.model)
    print(f"wrote {out}, {bundle} (+.json)", flush=True)
    stem = os.path.splitext(out)[0]
    try:
        p1 = plot_training_history(pipe.history, _common.check_output(stem + "_loss.png"))
        p2 = plot_elo_history(elo, _common.check_output(stem + "_elo.png"))
        print(f"wrote {p1} and {p2}", flush=True)
    except ImportError as e:  # no matplotlib: the plots are optional, as in JAX
        print(f"plotting skipped: {e}", flush=True)
    return payload


if __name__ == "__main__":
    main()
