"""``bench_gpu.py`` against ``bench.py``, read from bench.py's source (``ast``):
the same ``BENCH_*`` knobs and defaults (plus ``BENCH_DEVICE``), the same
JSON keys in each mode, the same metric string and stderr summary lines, the
repetition rule, the midgame advance, and no quiet CPU fallback.  The tiny
runs go through ``bench_gpu.main`` on the CPU (B=8, 16 simulations, 2 moves,
one rep, 7x7)."""
import ast
import importlib.util
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench.py"
BENCH_GPU = ROOT / "bench_gpu.py"
JAX_TREE = ast.parse(BENCH.read_text())


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bench_gpu = _load("bench_gpu")
chip_smoke = _load("chip_smoke")


def _env_gets(tree) -> dict:
    """``os.environ.get("BENCH_*", default)`` calls -> {name: default source}."""
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "get" and ast.unparse(node.func.value) == "os.environ"
                and node.args and isinstance(node.args[0], ast.Constant)
                and str(node.args[0].value).startswith("BENCH_")):
            out[node.args[0].value] = ast.unparse(node.args[1]) if len(node.args) > 1 else None
    return out


JAX_KNOBS = _env_gets(JAX_TREE)
PORT_KNOBS = _env_gets(ast.parse(BENCH_GPU.read_text()))


def test_knob_sets():
    """bench.py's 19 knobs, and only BENCH_DEVICE besides."""
    assert len(JAX_KNOBS) == 19
    assert set(PORT_KNOBS) - set(JAX_KNOBS) == {"BENCH_DEVICE"}
    assert PORT_KNOBS["BENCH_DEVICE"] == "'cuda'"


@pytest.mark.parametrize("knob", sorted(JAX_KNOBS))
def test_knob_default(knob):
    """Each knob has bench.py's default expression; one from production.py
    has the same value in both packages."""
    from alphazero_tpu import production as jax_production
    from alphazero_tpu_torch import production

    assert PORT_KNOBS[knob] == JAX_KNOBS[knob]
    for name in re.findall(r"production\.(\w+)", JAX_KNOBS[knob]):
        assert getattr(production, name) == getattr(jax_production, name)


def _jax_result_keys() -> set:
    """Every key bench.py's ``result`` dict is built with or assigned."""
    keys = set()
    for node in ast.walk(JAX_TREE):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and ast.unparse(node.targets[0]) == "result"
                and isinstance(node.value, ast.Dict)):
            keys |= {k.value for k in node.value.keys}
        if (isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store)
                and ast.unparse(node.value) == "result"):
            keys.add(node.slice.value)
    return keys


def test_key_table_is_bench_py():
    """chip_smoke.py's table of bench.py's keys by mode (the keys its [bench]
    phase and these tests hold bench_gpu.py to) names every key bench.py
    writes and no other."""
    assert set().union(*chip_smoke.BENCH_KEYS.values()) == _jax_result_keys()
    assert (ROOT / "tools" / "parity" / "reference_baseline.json").exists()
    assert chip_smoke.bench_keys("midgame", False) == chip_smoke.BENCH_KEYS["base"]
    assert chip_smoke.bench_keys("both", True) == (chip_smoke.BENCH_KEYS["base"]
                                                  | chip_smoke.BENCH_KEYS["midgame"])


def _metric_fstring():
    """bench.py's ``"metric"`` f-string."""
    for node in ast.walk(JAX_TREE):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and k.value == "metric":
                    return v
    raise AssertionError("no metric in bench.py")


def _summary_regex():
    """bench.py's stderr summary f-string (bench.py:327-334) as a regex:
    its text literally, each replacement field any text."""
    for node in ast.walk(JAX_TREE):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "print"
                and node.args and isinstance(node.args[0], ast.JoinedStr)
                and any(kw.arg == "file" for kw in node.keywords)):
            parts = [re.escape(v.value) if isinstance(v, ast.Constant) else "(.+?)"
                     for v in node.args[0].values]
            if parts[0].startswith(re.escape("# ")) and "moves/s" in "".join(parts):
                return re.compile("".join(parts))
    raise AssertionError("no summary print in bench.py")


TINY = dict(BENCH_DEVICE="cpu", BENCH_BATCH="8", BENCH_SIMS="16", BENCH_MOVES="2",
            BENCH_REPS="1", BENCH_MAX_REPS="1", BENCH_BOARD="7")
RUNS = {
    "int8_both": {},
    "folded": {"BENCH_INT8": "0"},
    "stub": {"BENCH_EVAL": "stub"},
    "reuse": {"BENCH_REUSE": "1"},
    "midgame": {"BENCH_MODE": "midgame"},
    "opening_stub": {"BENCH_MODE": "opening", "BENCH_EVAL": "stub"},
    "sustained_stub": {"BENCH_MODE": "sustained", "BENCH_EVAL": "stub"},
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_tiny_run(run, monkeypatch, capsys):
    for name in JAX_KNOBS:
        monkeypatch.delenv(name, raising=False)
    knobs = dict(TINY, **RUNS[run])
    for name, value in knobs.items():
        monkeypatch.setenv(name, value)
    assert bench_gpu.main() == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    mode, reuse = knobs.get("BENCH_MODE", "both"), knobs.get("BENCH_REUSE") == "1"
    assert set(res) == chip_smoke.bench_keys(mode, reuse)
    suffix = "" if mode in ("both", "opening") else f"_{mode}"  # bench.py:288-290
    ns = dict(game="gomoku", board=7, sims=16, suffix=suffix)
    metric = eval(compile(ast.Expression(_metric_fstring()), "bench.py", "eval"), {}, ns)
    assert res["metric"] == metric == f"selfplay_moves_per_s_per_chip_gomoku7_16sims{suffix}"
    assert res["value"] > 0 and len(res["reps"]) == 1 and res["unit"] == "moves/s"
    regimes = {"both": ["opening", "midgame", "sustained"], "opening": ["opening"],
               "midgame": ["midgame"], "sustained": ["sustained"]}[mode]
    if reuse:
        regimes = [r for r in regimes if r != "sustained"]
    summary = [ln for ln in err.splitlines() if ln.startswith("# ") and "moves/s" in ln]
    pattern = _summary_regex()
    assert [ln.split(":")[0][2:] for ln in summary] == regimes
    for ln in summary:
        m = pattern.fullmatch(ln)
        assert m, ln
        assert "batch=8 sims=16 timed_moves=2/rep" in ln and f"reuse={reuse}" in ln


def _jax_rule(values, min_reps, max_reps, stable_pct):
    """bench.py:255-268's loop over a fake rep sequence."""
    reps = []
    for rep in range(max_reps):
        reps.append(values[rep])
        if len(reps) >= min_reps:
            a, b = reps[-2], reps[-1]
            if abs(a - b) / max(a, b) * 100.0 <= stable_pct:
                break
    return reps, sorted(reps)[len(reps) // 2]


@pytest.mark.parametrize("values,min_reps,max_reps,n,med", [
    ([100, 110, 108, 50, 50, 50], 3, 6, 3, 108),  # stable at the third
    ([100, 101, 150, 151, 9, 9], 3, 6, 4, 150),  # a stable pair before REPS runs on
    ([100, 200, 100, 200, 100, 200, 100], 3, 6, 6, 200),  # never stable: MAX_REPS
    ([100, 102.9, 50], 2, 6, 2, 102.9),  # within 3 % of the larger
    ([100, 97, 50, 50], 2, 3, 2, 100),
])
def test_repetition_rule(values, min_reps, max_reps, n, med):
    runs = bench_gpu.repeat_until_stable(lambda rep: (values[rep], rep), min_reps,
                                         max_reps, 3.0)
    reps = [r[0] for r in runs]
    assert [r[1] for r in runs] == list(range(n))
    assert len(reps) == n and bench_gpu.median(reps) == med
    assert (reps, med) == _jax_rule(values, min_reps, max_reps, 3.0)


def test_repetition_rule_one_rep():
    """One rep is no pair: it runs until MAX_REPS (bench.py raises here)."""
    seq = [100, 100, 100]
    runs = bench_gpu.repeat_until_stable(lambda rep: (seq[rep],), 1, 1, 3.0)
    assert runs == [(100,)]
    runs = bench_gpu.repeat_until_stable(lambda rep: (seq[rep],), 1, 3, 3.0)
    assert len(runs) == 2


def test_advance_midgame_plays_legal_plies():
    """The uniform evaluator: every lane 40 legal plies on (or ended), and
    two runs with the same seeds are equal."""
    from alphazero_tpu_torch.core import registry
    from alphazero_tpu_torch.models.stub import make_uniform_eval_fn

    env = registry.create_game("gomoku", 15)
    eval_fn = make_uniform_eval_fn(env.num_actions, value_noise=0.1)
    dev = torch.device("cpu")
    illegal = []

    class Checked:
        def __getattr__(self, name):
            return getattr(env, name)

        def step(self, states, acts):
            live = ~env.terminal_flag(states)
            ok = env.legal_mask(states).gather(1, acts.long()[:, None])[:, 0]
            illegal.append(int((live & ~ok).sum()))
            return env.step(states, acts)

    a = bench_gpu.advance_midgame(Checked(), eval_fn, env.init(64, device=dev), dev)
    b = bench_gpu.advance_midgame(env, eval_fn, env.init(64, device=dev), dev)
    assert illegal == [0] * 40
    assert bool(((a.move_count == 40) | a.terminal).all())
    assert int((a.move_count == 40).sum()) >= 60
    assert torch.equal(a.board, b.board) and torch.equal(a.move_count, b.move_count)


def test_no_cuda_device_exits_nonzero():
    """Without a card and without BENCH_DEVICE=cpu: exit non-zero, print no
    result (CUDA_VISIBLE_DEVICES hides any card)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, str(BENCH_GPU)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert proc.stdout == ""


@pytest.mark.parametrize("mode,reuse", [("sustained", "1"), ("openings", "0")])
def test_modes_with_nothing_to_report_are_refused(mode, reuse, monkeypatch):
    monkeypatch.setenv("BENCH_MODE", mode)
    monkeypatch.setenv("BENCH_REUSE", reuse)
    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    with pytest.raises(ValueError, match="nothing to report"):
        bench_gpu.main()
