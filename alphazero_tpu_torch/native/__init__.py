"""Native host-side helpers (counterpart of ``alphazero_tpu/native``).

``get_azrecord()`` returns the ``_azrecord`` CPython extension
(``azrecord.cpp``: GameRecord JSON encoding, the same bytes as the ``json``
path), building it with ``g++`` at first use into ``build/native/`` under
the checkout root, keyed by a hash of the source, the flags and the Python
build.  Nothing is built when the package is imported.  If the build fails
the compiler's message is logged once at WARNING and callers use the
Python path.
"""
from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import logging
import os
import subprocess
import sysconfig
from pathlib import Path

log = logging.getLogger("alphazero_tpu_torch.native")

SRC = Path(__file__).resolve().with_name("azrecord.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_module = None
_failed = False


def _target() -> Path:
    suffix = sysconfig.get_config_var("EXT_SUFFIX")
    key = SRC.read_bytes() + " ".join(FLAGS).encode() + suffix.encode()
    return BUILD_DIR / f"_azrecord-{hashlib.sha256(key).hexdigest()[:16]}{suffix}"


def _build(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    include = sysconfig.get_paths()["include"]
    cmd = ["g++", *FLAGS, f"-I{include}", str(SRC), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    os.replace(tmp, target)


def get_azrecord():
    """The compiled module, building it on demand; None if it cannot be
    built or loaded."""
    global _module, _failed
    if _module is not None or _failed:
        return _module
    target = _target()
    try:
        if not target.exists():
            _build(target)
        # A qualified name: the JAX package imports its own build as the
        # top-level ``_azrecord``, and a loaded extension stays in
        # ``sys.modules`` under the name it was loaded as.
        name = f"{__name__}._azrecord"
        loader = importlib.machinery.ExtensionFileLoader(name, str(target))
        spec = importlib.util.spec_from_file_location(name, target, loader=loader)
        mod = importlib.util.module_from_spec(spec)
        loader.exec_module(mod)
        _module = mod
    except (OSError, RuntimeError, ImportError, subprocess.SubprocessError) as e:
        _failed = True
        log.warning("native record encoder unavailable, using json: %s", e)
    return _module
