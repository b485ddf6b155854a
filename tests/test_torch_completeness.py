"""Nothing of the JAX package or of the repo's scripts lacks a counterpart
in the port, unless an allowlist below gives the reason.

* Every ``.py`` under ``alphazero_tpu/`` has a same-named file under
  ``alphazero_tpu_torch/``.
* Every public module-level and class-level name of such a module has a
  counterpart in the port's module: a definition, an assignment, an
  import, or (class level) a method, class attribute, field, attribute
  stored on ``self`` or ``__init__`` parameter (a flax module's fields
  are the port's constructor arguments).
* Every script under ``tools/`` and ``examples/`` (and ``bench.py``) has a
  counterpart under ``alphazero_tpu_torch/tools/`` or ``examples/`` (or
  where ``MOVED`` says).

Each allowlist entry must still be needed: an entry whose module, name or
script now has a counterpart, or no longer exists, fails the test.  Only
``ast`` reads the sources; neither package is imported.
"""
import ast
import fnmatch
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX, PORT = "alphazero_tpu", "alphazero_tpu_torch"
NORTH_STAR = "TPU formulation with no CUDA counterpart (ROADMAP.md, North star)"

# JAX module (relative to alphazero_tpu/) -> why the port has no such file.
MODULES_ALLOWED = {
    "utils/platform.py": "JAX platform selection; every entry point of the port "
                         "takes --device instead",
}

# (JAX module, name) -> why the port's module has no counterpart.
NAMES_ALLOWED = {
    ("ops/gather_rows.py", "LANES_PER_STEP"): NORTH_STAR + ": the Pallas "
        "kernel's lanes a grid step",
    ("parallel/mesh.py", "data_sharding"): NORTH_STAR + ": a jax.sharding "
        "spec; the port shards batches by rank (Mesh.shard_batch)",
    ("parallel/mesh.py", "replicated"): NORTH_STAR + ": a jax.sharding spec; "
        "the port broadcasts from rank 0 (Mesh.replicate)",
    **{(f"games/{game}.py", f"{env}.{method}"): NORTH_STAR + ": the search "
       "arena's f32/bf16 packing; the port's arena stores int rows "
       "(arena_rows / from_arena_rows)"
       for game, env in (("gomoku", "GomokuEnv"), ("go", "GoEnv"), ("chess", "ChessEnv"))
       for method in ("pack_for_arena", "unpack_from_arena")},
    ("models/resnet.py", "init_params"): "flax initialisation; a port module "
        "is initialised when built (AZResNet(..., generator), flax_init_)",
    ("models/resnet.py", "ResNetConfig.param_dtype"): "flax parameter dtype; "
        "the port keeps float32 weights and casts them at use",
    ("models/resnet.py", "SEBlock.dtype"): "flax compute dtype field; the "
        "port passes the compute dtype to forward",
    ("models/randwire.py", "RandWireConfig.param_dtype"): "flax parameter "
        "dtype; the port keeps float32 weights and casts them at use",
    ("training/learner.py", "TrainState.params"): "optax formulation; the "
        "port's TrainState holds the weights in its module",
    ("training/learner.py", "TrainState.opt_state"): "optax formulation; the "
        "port's TrainState holds the optimizer state in its optimizer",
    **{("core/types.py", n): "typing helper of the JAX env protocol; the "
       "port's envs are batched classes with no shared protocol"
       for n in ("Env", "StepResult", "StepResult.state", "StepResult.reward",
                 *(f"Env.{m}" for m in (
                     "game_type", "num_actions", "observation_shape", "init",
                     "step", "legal_mask", "terminal", "result", "to_play",
                     "observation")))},
}

# Script (relative to the repo) -> its counterpart where it is not the
# same name under alphazero_tpu_torch/tools|examples/.
MOVED = {"tools/anchor_eval.py": "alphazero_tpu_torch/scripts/anchor_eval.py",
         "bench.py": "bench_gpu.py"}

# Script glob -> why it has no counterpart.
SCRIPTS_ALLOWED = {
    "tools/profile_*.py": "TPU profilers (ROADMAP.md section 1 item 6); the "
                          "port's profilers are alphazero_tpu_torch/scripts/profile_*.py",
    "tools/parse_trace.py": "reads TPU profiler traces (ROADMAP.md section 1 item 6)",
    "tools/parity/*": "the C++ reference's parity build (ROADMAP.md section 1 "
                      "item 6); the port reads its dumps",
}


def _targets(node):
    if isinstance(node, ast.Name):
        yield node.id
    elif isinstance(node, (ast.Tuple, ast.List)):
        for e in node.elts:
            yield from _targets(e)


def _assigned(stmt):
    if isinstance(stmt, ast.Assign):
        for t in stmt.targets:
            yield from _targets(t)
    elif isinstance(stmt, ast.AnnAssign):
        yield from _targets(stmt.target)


def public_names(path: str, port: bool) -> set:
    """Public module-level and ``Class.name`` names of ``path``; with
    ``port``, also imports, attributes stored on ``self`` and ``__init__``
    parameters (what may stand for a JAX name)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in tree.body:
        out.update(_assigned(node))
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        if port and isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
        if not isinstance(node, ast.ClassDef):
            continue
        for sub in node.body:
            out.update(f"{node.name}.{n}" for n in _assigned(sub))
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.add(f"{node.name}.{sub.name}")
                if port and sub.name == "__init__":
                    out.update(f"{node.name}.{a.arg}" for a in sub.args.args[1:]
                               + sub.args.kwonlyargs)
        if port:
            out.update(f"{node.name}.{n.attr}" for n in ast.walk(node)
                       if isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Store)
                       and isinstance(n.value, ast.Name) and n.value.id == "self")
    return {n for n in out if not any(p.startswith("_") for p in n.split("."))}


def _jax_modules() -> list:
    out = []
    for root, _, files in os.walk(os.path.join(REPO, JAX)):
        out += [os.path.relpath(os.path.join(root, f), os.path.join(REPO, JAX))
                for f in files if f.endswith(".py")]
    return sorted(out)


def _scripts() -> list:
    out = ["bench.py"]
    for d in ("tools", "examples"):
        for root, _, files in os.walk(os.path.join(REPO, d)):
            out += [os.path.relpath(os.path.join(root, f), REPO) for f in files
                    if "__pycache__" not in root]
    return sorted(out)


def _missing(rel: str) -> set:
    """The JAX module's public names without a counterpart in the port's."""
    port = os.path.join(REPO, PORT, rel)
    return public_names(os.path.join(REPO, JAX, rel), False) - public_names(port, True)


@pytest.mark.parametrize("rel", _jax_modules())
def test_module_has_counterpart(rel):
    port = os.path.join(REPO, PORT, rel)
    if rel in MODULES_ALLOWED:
        assert not os.path.exists(port), f"{rel} is ported: drop it from MODULES_ALLOWED"
        return
    assert os.path.exists(port), f"{JAX}/{rel} has no {PORT}/{rel}"
    allowed = {n for m, n in NAMES_ALLOWED if m == rel}
    missing = _missing(rel)
    assert missing <= allowed, f"{JAX}/{rel}: no counterpart for {sorted(missing - allowed)}"
    assert allowed <= missing, f"{rel}: {sorted(allowed - missing)} now have counterparts " \
                               "or are gone: drop them from NAMES_ALLOWED"


def _script_allowed(rel: str):
    return next((g for g in SCRIPTS_ALLOWED if fnmatch.fnmatch(rel, g)), None)


@pytest.mark.parametrize("rel", _scripts())
def test_script_has_counterpart(rel):
    if rel in MOVED:
        target = MOVED[rel]
    else:
        kind, name = (os.path.split(rel) if "/" in rel else ("tools", rel))
        target = os.path.join(PORT, kind.split("/")[0], name)
    exists = os.path.exists(os.path.join(REPO, target))
    if _script_allowed(rel):
        assert not exists, f"{rel} has {target}: drop it from SCRIPTS_ALLOWED"
    else:
        assert exists, f"the script {rel} has no counterpart {target}"


def test_every_allowlist_entry_is_live_and_has_a_reason():
    """Each entry names a JAX module, name or script that exists, and gives
    its reason."""
    modules = set(_jax_modules())
    for table in (MODULES_ALLOWED, NAMES_ALLOWED, SCRIPTS_ALLOWED):
        assert all(isinstance(r, str) and len(r) > 20 for r in table.values())
    assert set(MODULES_ALLOWED) <= modules
    for mod, name in NAMES_ALLOWED:
        assert name in public_names(os.path.join(REPO, JAX, mod), False), (mod, name)
    scripts = _scripts()
    for glob in SCRIPTS_ALLOWED:
        assert any(fnmatch.fnmatch(d, glob) for d in scripts), glob
    for rel, target in MOVED.items():
        assert rel in scripts and os.path.exists(os.path.join(REPO, target))


def test_names_are_read_from_the_sources(tmp_path):
    """What counts as a name on each side, on a made-up pair of modules."""
    jax_src = ("import jax\nA = 1\n_B = 2\ndef f(): pass\n"
               "class C:\n    x: int\n    y = 0\n    def m(self): pass\n    def _p(self): pass\n")
    port_src = ("from m import A\ndef f(): pass\n"
                "class C:\n    def __init__(self, x):\n        self.y = 1\n"
                "    def m(self): pass\n")
    (tmp_path / "j.py").write_text(jax_src)
    (tmp_path / "t.py").write_text(port_src)
    assert public_names(str(tmp_path / "j.py"), False) == {"A", "f", "C", "C.x", "C.y", "C.m"}
    assert public_names(str(tmp_path / "j.py"), False) <= public_names(str(tmp_path / "t.py"), True)
    assert public_names(str(tmp_path / "t.py"), False) == {"f", "C", "C.m"}
