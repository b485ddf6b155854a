"""Train a go9 net from scratch and rate it on the uniform-MCTS anchor
ladder (counterpart of ``tools/train_zoo_go9.py``: the same recipe,
ladder, round-robin and anchored Bradley-Terry fit).

The recipe: 9x9 Go with komi, the default 6x64 SE-ResNet, W=16 self-play
with the production int8 actors, a warmup-cosine schedule, 64 steps of
batch 1024 an iteration, a 200,000-position ring.  The net is then rated
(BN-folded bf16, ``G9_EVAL_SIMS`` simulations, W=16) against every
``uniform_mcts_`` anchor, the anchors play their round-robin, and
Bradley-Terry is fitted with uniform_mcts_256 at 1500.

    python -m alphazero_tpu_torch.tools.train_zoo_go9 [--device cuda]
        [--output build/tools/train_zoo_go9.json] [--ladder uniform_mcts_16]

Env knobs: G9_ITERS (16), G9_GAMES (96), G9_SIMS (192), G9_EVAL_SIMS
(128), G9_EVAL_GAMES (48), G9_LR (1e-3), G9_KOMI (7.5); G9_MODEL_OUT (the
bundle; default ``zoo_go9`` beside ``--output``).
"""
from __future__ import annotations

import argparse
import json
import os
import time

from alphazero_tpu_torch.tools import _common

MAX_MOVES = 9 * 9 * 2


def knobs() -> dict:
    env = os.environ.get
    return {"iters": int(env("G9_ITERS", "16")), "games": int(env("G9_GAMES", "96")),
            "sims": int(env("G9_SIMS", "192")),
            "eval_sims": int(env("G9_EVAL_SIMS", "128")),
            "eval_games": int(env("G9_EVAL_GAMES", "48")),
            "lr": float(env("G9_LR", "1e-3")), "komi": float(env("G9_KOMI", "7.5"))}


def recipe(k: dict, checkpoint_dir: str):
    from alphazero_tpu_torch.mcts.search import MCTSConfig
    from alphazero_tpu_torch.selfplay.actor import SelfPlayConfig
    from alphazero_tpu_torch.training.learner import LearnerConfig
    from alphazero_tpu_torch.training.pipeline import PipelineConfig

    iters = k["iters"]
    return PipelineConfig(
        game="go", board_size=9, game_options=(("komi", k["komi"]),),
        selfplay=SelfPlayConfig(
            mcts=MCTSConfig(num_simulations=k["sims"], wave_size=16),
            max_moves=MAX_MOVES, temperature_drop_move=16,
        ),
        learner=LearnerConfig(
            learning_rate=k["lr"], scheduler="warmup_cosine",
            warmup_steps=64, total_steps=max(iters * 64, 256),
        ),
        iterations=iters,
        games_per_iteration=k["games"],
        train_steps_per_iteration=64,
        train_batch_size=1024,
        replay_capacity=200_000,
        min_replay_before_training=2_048,
        checkpoint_dir=checkpoint_dir,
        checkpoint_every=10**9,
    )


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    _common.add_args(p, "train_zoo_go9.json")
    p.add_argument("--ladder", default=None,
                   help="comma-separated anchors to rate against (default: every "
                   "uniform_mcts_ anchor of the pool)")
    args = p.parse_args(argv)
    k = knobs()
    out = _common.check_output(args.output)
    bundle = _common.check_output(os.environ.get(
        "G9_MODEL_OUT", _common.beside(out, "zoo_go9")))

    import torch

    from alphazero_tpu_torch.mcts.search import MCTSConfig
    from alphazero_tpu_torch.models.io import save_model
    from alphazero_tpu_torch.models.resnet import make_inference_eval_fn
    from alphazero_tpu_torch.training.pipeline import Pipeline

    dev = torch.device(args.device)
    cfg = recipe(k, _common.beside(out, "zoo_go9_ckpt"))
    pipe = Pipeline(cfg, device=dev)
    env = pipe.env

    t0 = time.time()
    history = _common.train_iterations(pipe, k["iters"])

    cand = (make_inference_eval_fn(pipe.state.module),
            MCTSConfig(num_simulations=k["eval_sims"], dirichlet_epsilon=0.0,
                       wave_size=16))
    matches = _common.uniform_ladder(
        env, cand, "zoo_go9", "go9", k["eval_games"], MAX_MOVES, 4, dev,
        args.ladder.split(",") if args.ladder else None)
    payload = {
        "config": {
            "iterations": k["iters"], "games_per_iteration": k["games"],
            "simulations": k["sims"], "eval_sims": k["eval_sims"],
            "eval_games": k["eval_games"], "learning_rate": k["lr"],
            "komi": k["komi"], "wall_s": round(time.time() - t0, 1),
        },
        "history": history,
        "matches": matches,
        "bt_ratings": _common.fit_anchored(matches),
    }
    _common.write_json(out, payload)
    print("ratings: " + json.dumps(payload["bt_ratings"]), flush=True)
    save_model(bundle, pipe.state.module, "resnet", env.num_actions, cfg.model)
    print(f"wrote {out}, {bundle} (+.json)", flush=True)
    return payload


if __name__ == "__main__":
    main()
