"""The port stands alone: no module of ``alphazero_tpu_torch/``, not
``chip_smoke.py`` and not ``bench_gpu.py`` imports jax, flax or the JAX package.

This reads the sources (an AST scan) rather than ``sys.modules``, which
holds JAX in any process where something else imported it."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "alphazero_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "bench_gpu.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "alphazero_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "")
              in ("__import__", "import_module") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN  # "alphazero_tpu_torch" is its own top name


def test_scan_covers_the_package():
    assert len(FILES) > 10 and (ROOT / "chip_smoke.py").exists()


@pytest.mark.parametrize("sub", ["tools", "examples"])
def test_scan_covers_tools_and_examples(sub):
    """The tools and examples subpackages are scanned, every module."""
    mods = sorted((ROOT / "alphazero_tpu_torch" / sub).glob("*.py"))
    assert len(mods) >= 4 and set(mods) <= set(FILES)


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path} imports {bad}"


def test_matcher():
    assert _forbidden("alphazero_tpu.mcts.search")
    assert _forbidden("jax.numpy") and _forbidden("flax")
    assert not _forbidden("alphazero_tpu_torch.mcts.search")
