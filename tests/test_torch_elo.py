"""The port's Elo tracker and Bradley-Terry fit against the JAX package's on
the same series (1e-9), tracker JSON files exchanged both ways, and the
cases of ``tests/test_elo_arena.py`` and ``tests/test_bradley_terry.py``
that need no arena."""
import json
import math
import os

import numpy as np
import pytest

from alphazero_tpu.elo import bradley_terry as jbt
from alphazero_tpu.elo import tracker as jtr
from alphazero_tpu_torch.elo.bradley_terry import (
    fit_bradley_terry, fit_from_series, fit_from_tracker,
)
from alphazero_tpu_torch.elo.tracker import EloTracker, elo_change, expected_score

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _series(seed: int, players: int = 6, pairs: int = 12):
    rng = np.random.RandomState(seed)
    names = [f"p{i}" for i in range(players)]
    out = []
    for _ in range(pairs):
        a, b = rng.choice(players, 2, replace=False)
        out.append((names[a], names[b], int(rng.randint(0, 20)),
                    int(rng.randint(0, 20)), int(rng.randint(0, 4))))
    return out


def _close(a: dict, b: dict, tol: float = 1e-9):
    assert a.keys() == b.keys()
    for k in a:
        assert abs(a[k] - b[k]) <= tol, (k, a[k], b[k])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tracker_matches_jax(seed):
    ours, theirs = EloTracker(k=24.0, initial_rating=1400.0), jtr.EloTracker(
        k=24.0, initial_rating=1400.0)
    for series in _series(seed):
        ours.add_series(*series)
        theirs.add_series(*series)
    _close(ours.ratings, theirs.ratings)
    assert ours.games_played == theirs.games_played
    assert [n for n, _ in ours.leaderboard()] == [n for n, _ in theirs.leaderboard()]


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (1, dict(prior_games=0.0)), (2, dict(anchor="p3", anchor_rating=1200.0)),
    (3, dict(prior_games=4.0, tol=1e-10)),
])
def test_bradley_terry_matches_jax(seed, kw):
    series = _series(seed)
    _close(fit_bradley_terry(series, **kw), jbt.fit_bradley_terry(series, **kw))
    records = [{"player": a, "opponent": b, "wins": wa, "losses": wb, "draws": d}
               for a, b, wa, wb, d in series]
    _close(fit_from_series(records, **kw), jbt.fit_from_series(records, **kw))
    ours, theirs = EloTracker(), jtr.EloTracker()
    for s in series[:5]:
        ours.add_series(*s)
        theirs.add_series(*s)
    _close(fit_from_tracker(ours, **kw), jbt.fit_from_tracker(theirs, **kw))


def test_json_files_exchange_both_ways(tmp_path):
    ours, theirs = EloTracker(), jtr.EloTracker()
    for s in _series(5):
        ours.add_series(*s)
        theirs.add_series(*s)
    p_ours, p_theirs = str(tmp_path / "ours.json"), str(tmp_path / "theirs.json")
    ours.save(p_ours)
    theirs.save(p_theirs)
    for path, loader, src in ((p_theirs, EloTracker, theirs), (p_ours, jtr.EloTracker, ours)):
        back = loader.load(path)
        assert back.ratings == src.ratings and back.games_played == src.games_played
        assert back.k == src.k and back.initial_rating == src.initial_rating
        assert [vars(m) for m in back.history] == [vars(m) for m in src.history]
    with open(p_ours) as f, open(p_theirs) as g:
        a, b = json.load(f), json.load(g)
    assert a.keys() == b.keys()
    for x, y in zip(a["history"], b["history"]):
        assert x.keys() == y.keys()
        assert {k: v for k, v in x.items() if k != "timestamp"} == {
            k: v for k, v in y.items() if k != "timestamp"}


def test_expected_score_and_change():
    assert expected_score(1500, 1500) == 0.5
    np.testing.assert_allclose(expected_score(1700, 1500) + expected_score(1500, 1700), 1.0)
    assert expected_score(1700, 1500) > 0.75
    np.testing.assert_allclose(elo_change(1500, 1500, 1.0), 16.0)
    np.testing.assert_allclose(elo_change(1500, 1500, 0.0), -16.0)
    np.testing.assert_allclose(elo_change(1500, 1500, 0.5), 0.0)


def test_tracker_update_series_and_persistence(tmp_path):
    t = EloTracker()
    t.add_match_result("a", "b", 1.0)
    assert t.get_rating("a") == 1516.0 and t.get_rating("b") == 1484.0
    t = EloTracker()
    t.add_series("strong", "weak", wins_a=8, wins_b=1, draws=1)
    assert t.leaderboard()[0][0] == "strong" and t.games_played["strong"] == 10
    p = str(tmp_path / "elo.json")
    t.save(p)
    t2 = EloTracker.load(p)
    assert t2.ratings == t.ratings and len(t2.history) == 10


def test_bt_even_and_known_strength():
    r = fit_bradley_terry([("a", "b", 50, 50, 0)])
    assert abs(r["a"] - r["b"]) < 1.0 and abs((r["a"] + r["b"]) / 2 - 1500.0) < 1e-6
    p, n = 1.0 / (1.0 + 10 ** (-200 / 400)), 10_000
    r = fit_bradley_terry([("strong", "weak", p * n, (1 - p) * n, 0)], prior_games=0.0)
    assert abs((r["strong"] - r["weak"]) - 200.0) < 1.0


def test_bt_no_sequential_artifact():
    matches = [("X", "Y", 65, 63, 0), ("X", "Z", 128, 0, 0), ("Y", "Z", 128, 0, 0)]
    r = fit_bradley_terry(matches)
    assert abs(r["X"] - r["Y"]) < 30.0 and r["X"] > r["Z"] + 300
    r2 = fit_bradley_terry(list(reversed(matches)))
    assert all(abs(r[k] - r2[k]) < 0.1 for k in r)


def test_bt_sweep_anchor_draws_ladder():
    r = fit_bradley_terry([("a", "b", 128, 0, 0)])
    assert all(map(math.isfinite, r.values())) and 400 < r["a"] - r["b"] < 3000
    r = fit_bradley_terry([("a", "anchor", 70, 30, 0), ("b", "anchor", 30, 70, 0)],
                          anchor="anchor", anchor_rating=1500.0)
    assert abs(r["anchor"] - 1500.0) < 1e-6 and r["a"] > 1500.0 > r["b"]
    r = fit_bradley_terry([("a", "b", 25, 25, 50)])
    assert abs(r["a"] - r["b"]) < 1.0

    def exp(d):
        return 1.0 / (1.0 + 10 ** (-d / 400))

    matches = [(a, b, exp(d) * 1000, (1 - exp(d)) * 1000, 0)
               for a, b, d in (("A", "B", 100), ("B", "C", 100), ("A", "C", 200))]
    r = fit_bradley_terry(matches, prior_games=0.0)
    assert abs((r["A"] - r["B"]) - 100) < 5 and abs((r["B"] - r["C"]) - 100) < 5


def test_bt_from_series_and_tracker():
    r = fit_from_series([{"player": "p1", "opponent": "p0", "wins": 90,
                          "losses": 10, "draws": 0}])
    assert r["p1"] > r["p0"]
    t = EloTracker()
    for _ in range(60):
        t.add_match_result("a", "b", 1.0)
    for _ in range(40):
        t.add_match_result("a", "b", 0.0)
    d = fit_from_tracker(t)
    assert 30 < d["a"] - d["b"] < 120


def test_rerate_flagship_series():
    """The flagship's training series in docs/: the joint fit puts iter_16
    above iter_4 and within 60 of iter_12, equal to JAX's fit."""
    path = os.path.join(ROOT, "docs", "train_flagship_gomoku15.json")
    with open(path) as f:
        series = json.load(f)["arena_series"]
    r = fit_from_series(series)
    assert r["iter_16"] > r["iter_4"] and abs(r["iter_16"] - r["iter_12"]) < 60
    _close(r, jbt.fit_from_series(series))
