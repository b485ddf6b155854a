"""Resume the flagship with a fresh warmup-cosine cycle and rate every kept
net on the fixed anchor pool (counterpart of ``tools/train_flagship2.py``).

The JAX round-4 run plateaued because its warmup-cosine schedule had
decayed to ~0 at its last iteration.  This resumes from a bundle
(``FLAG2_START``; ``scratch`` keeps the fresh init) with a fresh optimizer
and a fresh cycle at a lower peak, a deeper replay window and the
production int8 actors, then rates the start and every
``FLAG2_EVAL_EVERY``-th net against each anchor of ``eval/anchors.POOL``
(``play_match_sides``), against its predecessor and against the start
(``play_match_host``), and fits every match jointly with Bradley-Terry
(uniform_mcts_256 = 1500).  The anchors' round-robin is read from
``--anchor-table`` (default the committed ``docs/anchor_table.json``, read
only); where that file does not exist it is played and written beside
``--output``.

    python -m alphazero_tpu_torch.tools.train_flagship2 [--device cuda]

Env knobs: FLAG2_ITERS (24), FLAG2_GAMES (256), FLAG2_SIMS (800),
FLAG2_EVAL_EVERY (4), FLAG2_EVAL_GAMES (128), FLAG2_ANCHOR_GAMES (64),
FLAG2_EVAL_SIMS (200), FLAG2_LR (5e-4), FLAG2_REPLAY (400000),
FLAG2_START (default ``models_zoo/flagship_gomoku15`` of the checkout),
FLAG2_TAG (''), FLAG2_BASE_ITER (16), FLAG2_START_NAME (r4_final),
FLAG2_RECYCLE (0); FLAG2_SNAP_DIR and FLAG2_MODEL_OUT (default beside
``--output``).  ``--output`` defaults to
``build/tools/train_flagship2<FLAG2_TAG>.json``.
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
    return {
        "iters": int(env("FLAG2_ITERS", "24")), "games": int(env("FLAG2_GAMES", "256")),
        "sims": int(env("FLAG2_SIMS", "800")),
        "eval_every": int(env("FLAG2_EVAL_EVERY", "4")),
        "eval_games": int(env("FLAG2_EVAL_GAMES", "128")),
        "anchor_games": int(env("FLAG2_ANCHOR_GAMES", "64")),
        "eval_sims": int(env("FLAG2_EVAL_SIMS", "200")),
        "lr": float(env("FLAG2_LR", "5e-4")),
        "replay_cap": int(env("FLAG2_REPLAY", "400000")),
        "start": env("FLAG2_START", os.path.join(_common.ROOT, "models_zoo",
                                                 "flagship_gomoku15")),
        "tag": env("FLAG2_TAG", ""),
        "base_iter": int(env("FLAG2_BASE_ITER", "16")),
        "start_name": env("FLAG2_START_NAME", "r4_final"),
        "recycle": env("FLAG2_RECYCLE", "0") == "1",
    }


def recipe(k: dict, checkpoint_dir: str):
    from alphazero_tpu_torch.mcts.search import MCTSConfig
    from alphazero_tpu_torch.selfplay.actor import SelfPlayConfig
    from alphazero_tpu_torch.training.learner import LearnerConfig
    from alphazero_tpu_torch.training.pipeline import PipelineConfig

    iters = k["iters"]
    return PipelineConfig(
        game="gomoku", board_size=15,
        selfplay=SelfPlayConfig(
            mcts=MCTSConfig(num_simulations=k["sims"], wave_size=16),
            max_moves=225, temperature_drop_move=30,
            recycle=k["recycle"],
        ),
        learner=LearnerConfig(
            learning_rate=k["lr"], scheduler="warmup_cosine",
            warmup_steps=64, total_steps=max(iters * 64, 256),
        ),
        iterations=iters,
        games_per_iteration=k["games"],
        train_steps_per_iteration=64,
        train_batch_size=1024,
        replay_capacity=k["replay_cap"],
        min_replay_before_training=4_096,
        checkpoint_dir=checkpoint_dir,
        checkpoint_every=10**9,
    )


def anchor_round_robin(env, games: int, device) -> list:
    """Every pair of the anchor pool, 225 plies, 6 mirrored opening plies,
    seeded by the pair's names."""
    from alphazero_tpu_torch.eval import anchors
    from alphazero_tpu_torch.eval.arena import play_match_sides

    table = []
    pool = list(anchors.POOL)
    for i, na in enumerate(pool):
        for nb in pool[i + 1:]:
            res = play_match_sides(env, anchors.make_anchor(env, na),
                                   anchors.make_anchor(env, nb),
                                   _common.generator(device, _common._seed(na, nb)),
                                   games, max_moves=225, opening_random_moves=6,
                                   device=device)
            table.append([na, nb, int(res.wins_a), int(res.wins_b), int(res.draws)])
            print("  anchor {} vs {}: +{} -{} ={}".format(*table[-1]), flush=True)
    return table


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    k = knobs()
    _common.add_args(p, f"train_flagship2{k['tag']}.json")
    p.add_argument("--anchor-table",
                   default=os.path.join(_common.ROOT, "docs", "anchor_table.json"),
                   help="the anchors' cached round-robin (read only)")
    args = p.parse_args(argv)
    out = _common.check_output(args.output)
    snap_dir = _common.check_output(os.environ.get(
        "FLAG2_SNAP_DIR", _common.beside(out, "flagship2_snaps")))
    bundle = _common.check_output(os.environ.get(
        "FLAG2_MODEL_OUT", _common.beside(out, "flagship2_gomoku15")))

    import torch

    from alphazero_tpu_torch.eval import anchors
    from alphazero_tpu_torch.eval.arena import (
        ArenaConfig, play_match_host, play_match_sides,
    )
    from alphazero_tpu_torch.mcts.search import MCTSConfig
    from alphazero_tpu_torch.models.io import load_model, save_model
    from alphazero_tpu_torch.models.resnet import make_inference_eval_fn
    from alphazero_tpu_torch.parallel import mesh as meshlib
    from alphazero_tpu_torch.training.learner import create_train_state
    from alphazero_tpu_torch.training.pipeline import Pipeline
    from alphazero_tpu_torch.utils.visualization import plot_anchored_curve

    dev = torch.device(args.device)
    cfg = recipe(k, _common.beside(out, "flagship2_ckpt"))
    pipe = Pipeline(cfg, device=dev)
    env = pipe.env
    if k["start"] != "scratch":
        # Resume: the bundle's weights, a fresh optimizer and cycle.
        start, _ = load_model(k["start"], env.observation_shape, device=dev)
        module = pipe.state.module
        module.load_state_dict(start.state_dict())
        pipe.state = create_train_state(meshlib.replicate(pipe.mesh, module), cfg.learner)

    cand_cfg = MCTSConfig(num_simulations=k["eval_sims"], dirichlet_epsilon=0.0,
                          wave_size=16)
    arena = ArenaConfig(mcts=cand_cfg, max_moves=225, opening_random_moves=6)
    anchor_sides = {n: anchors.make_anchor(env, n) for n in anchors.POOL}
    matches: list = []

    def record(a, b, res):
        rec = (a, b, int(res.wins_a), int(res.wins_b), int(res.draws))
        matches.append(rec)
        print(f"  match {a} vs {b}: +{rec[2]} -{rec[3]} ={rec[4]}", flush=True)

    if os.path.exists(args.anchor_table):
        with open(args.anchor_table) as f:
            table = [tuple(r) for r in json.load(f)]
        print(f"anchor table loaded ({len(table)} pairings)", flush=True)
    else:
        table = [tuple(r) for r in anchor_round_robin(env, k["anchor_games"], dev)]
        _common.write_json(_common.beside(out, "anchor_table.json"),
                           [list(r) for r in table])
    matches.extend(table)

    def rate_snapshot(name, eval_fn, prev_name=None, prev_eval=None):
        for aname in anchors.POOL:
            res = play_match_sides(env, (eval_fn, cand_cfg), anchor_sides[aname],
                                   _common.generator(dev, _common._seed(name, aname)),
                                   k["anchor_games"], max_moves=225,
                                   opening_random_moves=6, device=dev)
            record(name, aname, res)
        if prev_eval is not None:
            res = play_match_host(env, eval_fn, prev_eval,
                                  _common.generator(dev, _common._seed(name, prev_name)),
                                  arena, k["eval_games"], device=dev)
            record(name, prev_name, res)

    t_start = time.time()
    start_name = k["start_name"]
    evals = {start_name: make_inference_eval_fn(pipe.state.module)}
    print(f"rating the resume start ({start_name}) vs the anchor pool...", flush=True)
    rate_snapshot(start_name, evals[start_name])
    state = {"prev": start_name}

    def after(it):
        step = it + 1
        if step % k["eval_every"] and step != k["iters"]:
            return
        name = f"it_{k['base_iter'] + step}"  # absolute numbering
        kept = copy.deepcopy(pipe.state.module)
        evals[name] = make_inference_eval_fn(kept)
        # Every rated net is written at once, so it can be reproduced.
        save_model(os.path.join(snap_dir, name), kept, "resnet", env.num_actions,
                   cfg.model)
        prev = state["prev"]
        rate_snapshot(name, evals[name], prev, evals[prev])
        if prev != start_name:
            res = play_match_host(env, evals[name], evals[start_name],
                                  _common.generator(dev, _common._seed(name, "start")),
                                  arena, k["eval_games"], device=dev)
            record(name, start_name, res)
        state["prev"] = name
        ratings = _common.fit_anchored(matches)
        print("  BT ratings so far: " + json.dumps(
            dict(sorted(ratings.items(), key=lambda kv: -kv[1]))), flush=True)

    history = _common.train_iterations(pipe, k["iters"], after)
    ratings = _common.fit_anchored(matches)
    lr, steps = k["lr"], max(k["iters"] * 64, 256)
    payload = {
        "config": {
            "resumed_from": k["start"], "iterations": k["iters"],
            "recycle": k["recycle"], "base_iter": k["base_iter"],
            "games_per_iteration": k["games"], "simulations": k["sims"],
            "eval_games": k["eval_games"], "anchor_games": k["anchor_games"],
            "eval_sims": k["eval_sims"], "learning_rate": lr,
            "replay_capacity": k["replay_cap"],
            "wall_s": round(time.time() - t_start, 1),
            "plateau_diagnosis": (
                "r4 built its optimizer with total_steps=1024 warmup-cosine;"
                " LR had decayed to ~0 by iteration 16 — the plateau was the"
                f" schedule. This resume restarts the cycle at peak {lr} over"
                f" {steps} steps."
            ),
        },
        "history": history,
        "matches": [list(m) for m in matches],
        "bt_ratings": ratings,
        "anchor": {"name": anchors.CANONICAL, "rating": anchors.CANONICAL_RATING},
    }
    _common.write_json(out, payload)
    print("final BT ratings: " + json.dumps(ratings, indent=2), flush=True)
    save_model(bundle, pipe.state.module, "resnet", env.num_actions, cfg.model)
    print(f"wrote {out}, {bundle} (+.json)", flush=True)

    pts = sorted((k["base_iter"] if n == start_name else int(n.split("_")[1]), r)
                 for n, r in ratings.items()
                 if n == start_name or n.startswith("it_"))
    try:
        png = plot_anchored_curve(
            pts, {a: ratings[a] for a in anchors.POOL if a in ratings},
            _common.check_output(os.path.splitext(out)[0] + "_elo.png"),
            label="flagship (BT, anchored)",
            xlabel=f"training iteration (absolute; r4 ended at {k['base_iter']})",
            ylabel="Bradley-Terry Elo (uniform_mcts_256 = 1500)",
            title="Flagship gomoku15/800-sim resume — anchored ratings")
        print(f"wrote {png}", flush=True)
    except ImportError as e:  # no matplotlib: the plot is optional, as in JAX
        print(f"plotting skipped: {e}", flush=True)
    return payload


if __name__ == "__main__":
    main()
