"""Merge the flagship's training legs into one joint Bradley-Terry fit
(counterpart of ``tools/merge_flagship_legs.py``; host only).

  * parses the ``  match A vs B: +x -y =z`` lines of a log (a leg that
    ended before it wrote its record),
  * concatenates them with the match tables of the legs' JSON records,
  * drops exact duplicates (each leg re-rates its start with the same
    seeds and merges the same cached anchor round-robin: one observation,
    not several),
  * fits one anchored Bradley-Terry table (uniform_mcts_256 = 1500) and
    writes the record to ``--output`` and the curve beside it.

    python -m alphazero_tpu_torch.tools.merge_flagship_legs LOG JSON [JSON...]
        [--output build/tools/train_flagship3.json]
"""
from __future__ import annotations

import argparse
import json
import os
import re

from alphazero_tpu_torch.tools import _common

MATCH_RE = re.compile(r"^\s*match (\S+) vs (\S+): \+(\d+) -(\d+) =(\d+)\s*$")


def parse_log(path: str) -> list:
    out = []
    with open(path) as f:
        for line in f:
            m = MATCH_RE.match(line)
            if m:
                a, b, wa, wb, dr = m.groups()
                out.append((a, b, int(wa), int(wb), int(dr)))
    return out


def merge(paths) -> tuple:
    """(the record of the joint fit over ``paths`` (``.json`` records, any
    other file a log), the unrounded ratings)."""
    from alphazero_tpu_torch.elo.bradley_terry import fit_bradley_terry
    from alphazero_tpu_torch.eval import anchors

    matches, sources = [], {}
    for p in paths:
        if p.endswith(".json"):
            with open(p) as f:
                rows = [tuple(r) for r in json.load(f)["matches"]]
        else:
            rows = parse_log(p)
        sources[os.path.basename(p)] = len(rows)
        matches.extend(rows)
    unique = list(dict.fromkeys(matches))
    ratings = fit_bradley_terry(unique, anchor=anchors.CANONICAL,
                                anchor_rating=anchors.CANONICAL_RATING)
    return {
        "sources": sources,
        "n_matches_raw": len(matches),
        "n_matches_unique": len(unique),
        "matches": [list(r) for r in unique],
        "bt_ratings": {k: round(v, 1) for k, v in ratings.items()},
        "anchor": {"name": anchors.CANONICAL, "rating": anchors.CANONICAL_RATING},
    }, ratings


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("paths", nargs="+", help="a log and the legs' JSON records")
    p.add_argument("--output", default=_common.default_output("train_flagship3.json"))
    args = p.parse_args(argv)
    payload, ratings = merge(args.paths)
    out = _common.write_json(args.output, payload)
    print(f"wrote {out}")
    print(json.dumps(dict(sorted(payload["bt_ratings"].items(), key=lambda kv: -kv[1])),
                     indent=2))

    from alphazero_tpu_torch.eval import anchors
    from alphazero_tpu_torch.utils.visualization import plot_anchored_curve

    pts = []
    for name, r in ratings.items():
        m = re.fullmatch(r"it_(\d+)", name)
        if m:
            pts.append((int(m.group(1)), r))
        elif name == "scratch":
            pts.append((0, r))
    try:
        png = plot_anchored_curve(
            sorted(pts), {a: ratings[a] for a in anchors.POOL if a in ratings},
            _common.check_output(os.path.splitext(out)[0] + "_elo.png"),
            label="flagship (200 eval sims)",
            xlabel="training iteration (256 games x 800 sims each)",
            ylabel="anchored Bradley-Terry rating",
            title="Round-5 flagship: three-leg cosine-restart run (joint BT fit)")
        print(f"wrote {png}")
    except ImportError as e:  # no matplotlib: the plot is optional, as in JAX
        print(f"plot skipped: {e!r}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
