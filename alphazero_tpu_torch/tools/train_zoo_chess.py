"""Train a chess net and rate it on the uniform-MCTS ladder (counterpart of
``tools/train_zoo_chess.py``, the sibling of ``train_zoo_go9``).

Chess at low skill draws often (the ply cap is a draw), so the record keeps
wins, losses and draws, and the Bradley-Terry fit counts a draw as half a
win.  After the ladder the net also plays at 800 simulations against
uniform_mcts_64 and uniform_mcts_256 (``eval_800``, the extra rows of the
committed ``docs/train_zoo_chess.json``), those of them that ``--ladder``
names.

    python -m alphazero_tpu_torch.tools.train_zoo_chess [--device cuda]

Env knobs: CZ_ITERS (10), CZ_GAMES (96), CZ_SIMS (160), CZ_MAX_MOVES (180;
the committed record ran 48 x 128 x 256 at 220), CZ_EVAL_SIMS (128),
CZ_EVAL_GAMES (32), CZ_LR (1e-3); CZ_MODEL_OUT (the
bundle; default ``zoo_chess`` beside ``--output``).
"""
from __future__ import annotations

import argparse
import json
import os
import time

from alphazero_tpu_torch.tools import _common

EVAL_800 = ("uniform_mcts_64", "uniform_mcts_256")


def knobs() -> dict:
    env = os.environ.get
    return {"iters": int(env("CZ_ITERS", "10")), "games": int(env("CZ_GAMES", "96")),
            "sims": int(env("CZ_SIMS", "160")),
            "max_moves": int(env("CZ_MAX_MOVES", "180")),
            "eval_sims": int(env("CZ_EVAL_SIMS", "128")),
            "eval_games": int(env("CZ_EVAL_GAMES", "32")),
            "lr": float(env("CZ_LR", "1e-3"))}


def recipe(k: dict, checkpoint_dir: str):
    from alphazero_tpu_torch.mcts.search import MCTSConfig
    from alphazero_tpu_torch.selfplay.actor import SelfPlayConfig
    from alphazero_tpu_torch.training.learner import LearnerConfig
    from alphazero_tpu_torch.training.pipeline import PipelineConfig

    iters = k["iters"]
    return PipelineConfig(
        game="chess", board_size=8,
        selfplay=SelfPlayConfig(
            mcts=MCTSConfig(num_simulations=k["sims"], wave_size=16),
            max_moves=k["max_moves"], temperature_drop_move=20,
        ),
        learner=LearnerConfig(
            learning_rate=k["lr"], scheduler="warmup_cosine",
            warmup_steps=64, total_steps=max(iters * 64, 256),
        ),
        iterations=iters,
        games_per_iteration=k["games"],
        train_steps_per_iteration=64,
        train_batch_size=1024,
        replay_capacity=100_000,  # config/chess.json's 500k exceeded the TPU's HBM
        min_replay_before_training=2_048,
        checkpoint_dir=checkpoint_dir,
        checkpoint_every=10**9,
    )


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    _common.add_args(p, "train_zoo_chess.json")
    p.add_argument("--ladder", default=None,
                   help="comma-separated anchors to rate against (default: every "
                   "uniform_mcts_ anchor of the pool)")
    args = p.parse_args(argv)
    k = knobs()
    out = _common.check_output(args.output)
    bundle = _common.check_output(os.environ.get(
        "CZ_MODEL_OUT", _common.beside(out, "zoo_chess")))

    import torch

    from alphazero_tpu_torch.eval import anchors
    from alphazero_tpu_torch.eval.arena import play_match_sides
    from alphazero_tpu_torch.mcts.search import MCTSConfig
    from alphazero_tpu_torch.models.io import save_model
    from alphazero_tpu_torch.models.resnet import make_inference_eval_fn
    from alphazero_tpu_torch.training.pipeline import Pipeline

    dev = torch.device(args.device)
    cfg = recipe(k, _common.beside(out, "zoo_chess_ckpt"))
    pipe = Pipeline(cfg, device=dev)
    env = pipe.env

    t0 = time.time()
    history = _common.train_iterations(pipe, k["iters"])

    eval_fn = make_inference_eval_fn(pipe.state.module)
    cand = (eval_fn, MCTSConfig(num_simulations=k["eval_sims"], dirichlet_epsilon=0.0,
                                wave_size=16))
    ladder = args.ladder.split(",") if args.ladder else None
    matches = _common.uniform_ladder(env, cand, "zoo_chess", "chess", k["eval_games"],
                                     k["max_moves"], 2, dev, ladder)
    payload = {
        "config": {
            "iterations": k["iters"], "games_per_iteration": k["games"],
            "simulations": k["sims"], "max_moves": k["max_moves"],
            "eval_sims": k["eval_sims"], "eval_games": k["eval_games"],
            "learning_rate": k["lr"], "wall_s": round(time.time() - t0, 1),
        },
        "history": history,
        "matches": matches,
        "bt_ratings": _common.fit_anchored(matches),
    }
    strong = (eval_fn, MCTSConfig(num_simulations=800, dirichlet_epsilon=0.0,
                                  wave_size=16))
    rows = []
    for aname in [a for a in EVAL_800 if ladder is None or a in ladder]:
        res = play_match_sides(
            env, strong, anchors.make_anchor(env, aname),
            _common.generator(dev, _common._seed("zoo_chess@800", aname)),
            k["eval_games"], max_moves=k["max_moves"], opening_random_moves=2,
            device=dev)
        rows.append(["zoo_chess@800", aname, int(res.wins_a), int(res.wins_b),
                     int(res.draws)])
        print("  {} vs {}: +{} -{} ={}".format(*rows[-1]), flush=True)
    payload["eval_800"] = rows
    _common.write_json(out, payload)
    print("ratings: " + json.dumps(payload["bt_ratings"]), flush=True)
    save_model(bundle, pipe.state.module, "resnet", env.num_actions, cfg.model)
    print(f"wrote {out}, {bundle} (+.json)", flush=True)
    return payload


if __name__ == "__main__":
    main()
