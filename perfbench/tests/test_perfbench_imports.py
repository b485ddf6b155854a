"""Nothing the benchmark runs loads JAX or the JAX package."""
import json
import subprocess
import sys
from pathlib import Path

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name in ("alphazero_tpu_torch", "alphazero_tpu_torch.ops", "jaxtyping",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    found = harness.forbidden_modules()
    assert not [m for m in found if m.startswith(("alphazero_tpu_torch",
                                                  "jaxtyping", "flaxen"))]
    monkeypatch.setitem(sys.modules, "alphazero_tpu.games", sys)
    assert "alphazero_tpu.games" in harness.forbidden_modules()


def test_a_run_loads_no_jax():
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from perfbench.tests import tiny\n"
        "from perfbench import harness\n"
        "r = tiny.run('gomoku', lanes=4)\n"
        "import perfbench.control, perfbench.run\n"
        "print(json.dumps({'found': harness.forbidden_modules(),"
        " 'correct': r['correct']}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line == {"found": [], "correct": True}


def test_no_source_imports_jax():
    for path in (ROOT / "perfbench").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in harness.FORBIDDEN, f"{path}: {line}"
