"""Rate a model bundle against the fixed anchor pool (counterpart of
``tools/anchor_eval.py``).

Plays the bundle (Gomoku 15x15, its BN-folded net at ``cand_sims``
simulations a move) against every anchor of ``eval/anchors.POOL``, merges
the cached anchor round-robin (``docs/anchor_table.json``, read only) into
the match table and fits the anchored Bradley-Terry scale, which makes the
result comparable across runs.  The record is printed and appended to the
JSON list in ``--output``.

    python -m alphazero_tpu_torch.scripts.anchor_eval \\
        models_zoo/flagship_gomoku15 800 --output anchor_evals.json

Env: AE_GAMES (64 games an anchor), AE_NAME (candidate label, default
``<bundle name>@<sims>``), AE_WAVE (16), AE_OPENING (6 random opening
moves).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import zlib

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TABLE = os.path.join(ROOT, "docs", "anchor_table.json")


def _seed(*names) -> int:
    return zlib.crc32("|".join(names).encode()) & 0x7FFFFFFF


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("bundle", nargs="?",
                   default=os.path.join(ROOT, "models_zoo", "flagship_gomoku15"))
    p.add_argument("cand_sims", nargs="?", type=int, default=800)
    p.add_argument("--output", default="anchor_evals.json",
                   help="JSON list the result is appended to")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)
    bundle, cand_sims = args.bundle, args.cand_sims
    games = int(os.environ.get("AE_GAMES", "64"))
    name = os.environ.get("AE_NAME", os.path.basename(bundle) + f"@{cand_sims}")
    wave = int(os.environ.get("AE_WAVE", "16"))
    opening = int(os.environ.get("AE_OPENING", "6"))

    import torch

    from alphazero_tpu_torch.core import registry
    from alphazero_tpu_torch.elo.bradley_terry import fit_bradley_terry
    from alphazero_tpu_torch.eval import anchors, arena
    from alphazero_tpu_torch.mcts.search import MCTSConfig
    from alphazero_tpu_torch.models.io import load_model
    from alphazero_tpu_torch.models.resnet import make_inference_eval_fn

    dev = torch.device(args.device)
    env = registry.create_game("gomoku", 15)
    model, _ = load_model(bundle, env.observation_shape, device=dev)
    side = (
        make_inference_eval_fn(model),
        MCTSConfig(num_simulations=cand_sims, dirichlet_epsilon=0.0,
                   wave_size=min(wave, cand_sims)),
    )

    matches = []
    if os.path.exists(TABLE):
        with open(TABLE) as f:
            matches.extend(tuple(r) for r in json.load(f))

    t0 = time.time()
    results = []
    for aname in anchors.POOL:
        gen = torch.Generator(device=dev).manual_seed(_seed(name, aname))
        res = arena.play_match_sides(
            env, side, anchors.make_anchor(env, aname), gen, games,
            max_moves=225, opening_random_moves=opening, device=dev)
        rec = (name, aname, int(res.wins_a), int(res.wins_b), int(res.draws))
        matches.append(rec)
        results.append(rec)
        print(f"  {name} vs {aname}: +{rec[2]} -{rec[3]} ={rec[4]}", flush=True)

    ratings = fit_bradley_terry(matches, anchor=anchors.CANONICAL,
                                anchor_rating=anchors.CANONICAL_RATING)
    out = {
        "candidate": name, "bundle": bundle, "sims": cand_sims,
        "games_per_anchor": games, "opening_random_moves": opening,
        "matches": [list(r) for r in results],
        "bt_rating": round(ratings[name], 1),
        "anchor_ratings": {a: round(ratings[a], 1) for a in anchors.POOL
                           if a in ratings},
        "wall_s": round(time.time() - t0, 1),
    }
    print(json.dumps(out))
    hist = []
    if os.path.exists(args.output):
        with open(args.output) as f:
            hist = json.load(f)
    hist.append(out)
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    with open(args.output, "w") as f:
        json.dump(hist, f, indent=2)
    return out


if __name__ == "__main__":
    main()
