"""The anchor evaluation script (``scripts/anchor_eval.py``) against the JAX package's
``tools/anchor_eval.py``: with ``play_match_sides`` replaced in both by the
same fixed results, the records agree (``wall_s`` aside), and the port
writes only to ``--output``."""
import importlib.util
import json
import os
import shutil
import sys
import types

import jax
import pytest

from alphazero_tpu_torch.eval import arena
from alphazero_tpu_torch.scripts import anchor_eval

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNDLE = os.path.join(REPO, "models_zoo", "flagship_gomoku15")
RESULTS = [(5, 2, 1), (4, 3, 1), (2, 5, 1), (1, 6, 1)]  # in POOL order


def _fixed_results(calls):
    def play(env, side_a, side_b, rng, games, **kw):
        calls.append((games, kw["max_moves"], kw["opening_random_moves"]))
        w, l, d = RESULTS[len(calls) - 1]
        return types.SimpleNamespace(wins_a=w, wins_b=l, draws=d)
    return play


@pytest.fixture
def jax_script(monkeypatch):
    """``tools/anchor_eval.py`` imported from its path; it sets JAX's
    compile cache options when imported, which are put back after."""
    keep = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")}
    spec = importlib.util.spec_from_file_location(
        "anchor_eval_jax", os.path.join(REPO, "tools", "anchor_eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    yield mod
    for k, v in keep.items():
        jax.config.update(k, v)


def test_record_matches_jax(tmp_path, monkeypatch, jax_script, capsys):
    from alphazero_tpu.eval import arena as jarena

    monkeypatch.setenv("AE_GAMES", "8")
    monkeypatch.setenv("AE_OPENING", "4")
    # The JAX script reads and writes docs/ under its working directory.
    jdir = tmp_path / "jax"
    (jdir / "docs").mkdir(parents=True)
    shutil.copy(os.path.join(REPO, "docs", "anchor_table.json"), jdir / "docs")
    jcalls, calls = [], []
    monkeypatch.setattr(jarena, "play_match_sides", _fixed_results(jcalls))
    monkeypatch.chdir(jdir)
    monkeypatch.setattr(sys, "argv", ["anchor_eval.py", BUNDLE, "32"])
    jax_script.main()
    (theirs,) = json.loads((jdir / "docs" / "anchor_evals.json").read_text())

    pdir = tmp_path / "port"
    pdir.mkdir()
    monkeypatch.chdir(pdir)
    monkeypatch.setattr(arena, "play_match_sides", _fixed_results(calls))
    evals = os.path.join(REPO, "docs", "anchor_evals.json")
    before = open(evals, "rb").read()
    out = pdir / "out" / "evals.json"
    anchor_eval.main([BUNDLE, "32", "--device", "cpu", "--output", str(out)])
    (ours,) = json.loads(out.read_text())
    assert calls == jcalls == [(8, 225, 4)] * 4
    theirs.pop("wall_s"), ours.pop("wall_s")
    assert ours == theirs
    assert ours["candidate"] == "flagship_gomoku15@32"
    assert os.listdir(pdir) == ["out"] and os.listdir(pdir / "out") == ["evals.json"]
    assert open(evals, "rb").read() == before
    # A second run appends to the same list.
    calls.clear()
    anchor_eval.main([BUNDLE, "32", "--device", "cpu", "--output", str(out)])
    assert len(json.loads(out.read_text())) == 2
