"""The self-play traffic: what a seed fixes, and what it varies."""
import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny


def test_seeds_are_63_bit_and_differ_by_tag():
    for seed in (0, 1, 2 ** 31 + 5, 2 ** 40 + 3):
        a, b = harness.seed_for(seed, "open/0"), harness.seed_for(seed, "open/1")
        assert 0 <= a < 2 ** 63 and a != b
        assert harness.seed_for(seed, "open/0") == a
        torch.Generator().manual_seed(a)  # takes it


def _moves(seed):
    cell = tiny.cell("gomoku")
    log = {}
    orig = cell.kind.compare.check

    def spy(env, sc, temp, moves, kinds, ended, env_lanes, *a, **kw):
        log.update(moves=moves, kinds=kinds, lanes=env_lanes)
        return orig(env, sc, temp, moves, kinds, ended, env_lanes, *a, **kw)

    cell.kind.compare.check = spy
    try:
        r = harness.run(cell, seed, 0.3, False, torch.device("cpu"), 0.0,
                        log=lambda m: None)
    finally:
        cell.kind.compare.check = orig
    return r, log


def test_the_same_seed_gives_the_same_games():
    r1, a = _moves(2 ** 35 + 11)
    r2, b = _moves(2 ** 35 + 11)
    n = min(len(a["moves"]), len(b["moves"]))
    assert np.array_equal(a["moves"][:n], b["moves"][:n])
    assert a["lanes"] == b["lanes"]
    assert a["kinds"][:5] == ["open"] * 4 + ["step"]
    _, c = _moves(2 ** 35 + 12)
    assert not np.array_equal(a["moves"][:4], c["moves"][:4])


def test_the_window_is_whole_steps_and_recycles():
    r = tiny.run("gomoku", seconds=1.0)
    info = r["info"]
    assert info["window_s"] >= 1.0
    assert info["moves"] == info["steps"] * 8  # every lane plays every step
    assert len(info["step_s"]) == info["steps"]
    assert sum(info["step_s"]) == pytest.approx(info["window_s"])
    assert r["metrics"]["selfplay_moves_per_s"]["value"] == (
        info["moves"] / info["window_s"])
