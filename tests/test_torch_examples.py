"""The terminal examples (``alphazero_tpu_torch/examples/``) against the JAX
examples under ``examples/``: the same flags plus ``--device`` (read by
``ast``), and one piped game each on the CPU."""
import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# game -> two legal moves in the example's notation
GAMES = {"gomoku": ("E5", "D4"), "go": ("E5", "D4"), "chess": ("e2e4", "d2d4")}


def _flags(path):
    tree = ast.parse(open(path).read())
    return sorted(n.args[0].value for n in ast.walk(tree)
                  if isinstance(n, ast.Call) and getattr(n.func, "attr", "") == "add_argument"
                  and n.args and isinstance(n.args[0], ast.Constant))


@pytest.mark.parametrize("game", list(GAMES))
def test_flags_are_jax_plus_device(game):
    name = f"play_{game}.py"
    theirs = _flags(os.path.join(REPO, "examples", name))
    ours = _flags(os.path.join(REPO, "alphazero_tpu_torch", "examples", name))
    assert ours == sorted(theirs + ["--device"])


@pytest.mark.parametrize("game", list(GAMES))
def test_piped_game_exits_0(game):
    """``new``, two moves, ``quit``: the engine answers each move."""
    m1, m2 = GAMES[game]
    out = subprocess.run(
        [sys.executable, "-m", f"alphazero_tpu_torch.examples.play_{game}",
         "--device", "cpu", "--simulations", "8"],
        input=f"new\n{m1}\n{m2}\nquit\n", capture_output=True, text=True, cwd=REPO,
        timeout=120, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    engine = "engine action" if game == "chess" else "engine:"
    assert out.stdout.count(engine) == 2
    assert "illegal" not in out.stdout
