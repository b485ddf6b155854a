"""What the tools share: the crc32 seeds, the Elo of a match score, the
output rule and JSON writer, and the uniform-anchor ladder with its
round-robin."""
from __future__ import annotations

import json
import math
import os
import time
import zlib

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD = os.path.join(ROOT, "build", "tools")
# The JAX tools' output directories: their files predate the port and stay
# as they are.
PROTECTED = tuple(os.path.join(ROOT, d) for d in ("docs", "models_zoo"))


def _seed(*names) -> int:
    """Stable (non-salted) seed from player names."""
    return zlib.crc32("|".join(names).encode()) & 0x7FFFFFFF


def generator(device, seed: int):
    import torch

    return torch.Generator(device=device).manual_seed(seed)


def elo_from_score(score: float) -> float:
    """Elo difference of a score in [0, 1]; +-inf for a sweep."""
    if 0 < score < 1:
        return -400 * math.log10(1 / min(max(score, 1e-6), 1 - 1e-6) - 1)
    return float("inf") * (1 if score >= 1 else -1)


def elo_interval(wins: int, losses: int, draws: int) -> tuple:
    """The Elo difference at the score -+ 2 standard errors of the mean of
    the games' outcomes (1, 0.5, 0)."""
    n = max(wins + losses + draws, 1)
    score = (wins + 0.5 * draws) / n
    var = (wins + 0.25 * draws) / n - score * score
    se = math.sqrt(max(var, 0.0) / n)
    return (elo_from_score(max(score - 2 * se, 0.0)),
            elo_from_score(min(score + 2 * se, 1.0)))


def default_output(name: str) -> str:
    return os.path.join(BUILD, name)


def check_output(path: str) -> str:
    """``path`` made absolute; refuses one under ``docs/`` or
    ``models_zoo/`` of the checkout."""
    full = os.path.abspath(path)
    for d in PROTECTED:
        if os.path.commonpath([full, d]) == d:
            raise ValueError(f"{path} lies under {d}: these tools write only "
                             "where --output says, never into the JAX tools' "
                             "outputs")
    return full


def beside(output: str, name: str) -> str:
    """A path in ``output``'s directory (checkpoints, bundles, plots)."""
    return check_output(os.path.join(os.path.dirname(check_output(output)), name))


def write_json(path: str, payload) -> str:
    full = check_output(path)
    os.makedirs(os.path.dirname(full), exist_ok=True)
    with open(full, "w") as f:
        json.dump(payload, f, indent=2)
    return full


def append_json(path: str, rec) -> str:
    """Appends ``rec`` to the JSON list in ``path`` (a new list if none)."""
    full = check_output(path)
    hist = []
    if os.path.exists(full):
        with open(full) as f:
            hist = json.load(f)
    hist.append(rec)
    return write_json(full, hist)


def add_args(parser, output: str) -> None:
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu")
    parser.add_argument("--output", default=default_output(output),
                        help="JSON record (default build/tools/%(default)s)")


def train_iterations(pipe, iters: int, on_iteration=None, start: int = 0) -> list:
    """Pipeline iterations ``start`` to ``iters - 1``, each entry printed as
    the JAX tools print it; ``on_iteration(it)`` after each."""
    history = []
    for it in range(start, iters):
        entry = pipe.run_iteration(it)
        history.append(entry)
        print(f"[{time.strftime('%H:%M:%S')}] iter {it}: {json.dumps(entry)}",
              flush=True)
        if on_iteration is not None:
            on_iteration(it)
    return history


def uniform_ladder(env, cand_side, cand: str, pair_tag: str, games: int,
                   max_moves: int, opening: int, device, names=None) -> list:
    """The candidate against each uniform-MCTS anchor of the pool (or
    ``names``), then the anchors' round-robin for the scale; match rows
    ``[a, b, wins_a, wins_b, draws]``.  Seeds: ``_seed(cand, anchor)`` and
    ``_seed(pair_tag, a, b)``."""
    from alphazero_tpu_torch.eval import anchors
    from alphazero_tpu_torch.eval.arena import play_match_sides

    ladder = list(names or [n for n in anchors.POOL if n.startswith("uniform_mcts_")])
    sides = {n: anchors.make_anchor(env, n) for n in ladder}
    matches = []

    def play(a, b, side_a, side_b, seed):
        res = play_match_sides(env, side_a, side_b, generator(device, seed), games,
                               max_moves=max_moves, opening_random_moves=opening,
                               device=device)
        row = [a, b, int(res.wins_a), int(res.wins_b), int(res.draws)]
        matches.append(row)
        print(f"  {a} vs {b}: +{row[2]} -{row[3]} ={row[4]}", flush=True)

    for n in ladder:
        play(cand, n, cand_side, sides[n], _seed(cand, n))
    for i, na in enumerate(ladder):
        for nb in ladder[i + 1:]:
            play(na, nb, sides[na], sides[nb], _seed(pair_tag, na, nb))
    return matches


def fit_anchored(matches) -> dict:
    """Bradley-Terry over ``matches`` with uniform_mcts_256 at 1500 (the
    mean at 1500 where it did not play), rounded as the records keep it."""
    from alphazero_tpu_torch.elo.bradley_terry import fit_bradley_terry
    from alphazero_tpu_torch.eval import anchors

    ratings = fit_bradley_terry([tuple(m) for m in matches], anchor=anchors.CANONICAL,
                                anchor_rating=anchors.CANONICAL_RATING)
    return {k: round(v, 1) for k, v in ratings.items()}
