"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them via ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled for
``sm_90a`` into ``build/kernels/lib<name>-<hash>.so`` under the checkout
root, where the hash covers the source and the flags, so an edited source
rebuilds and an unchanged one is reused.  Builds start in parallel, one
``nvcc`` per source.  Nothing is built when a module is imported: the first
launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
ptxas_log: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").is_file():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str]) -> None:
    """Compile every named source that has no up-to-date library, all
    ``nvcc`` processes at once; raise with the compiler output on failure."""
    todo = [n for n in dict.fromkeys(names) if not _target(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        ptxas_log[n] = log
        if proc.returncode != 0:
            failed.append(f"{n}:\n{log}")
            continue
        os.replace(tmp, _target(n))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return _LIBS[name]


def _cuda_bin(name: str) -> str:
    return str(Path(_nvcc()).with_name(name))


def machine_code(name: str) -> Optional[str]:
    """The SASS of the built library for ``csrc/<name>.cu`` (``cuobjdump``),
    or None where the toolkit has no ``cuobjdump``."""
    build([name])
    if not Path(_cuda_bin("cuobjdump")).is_file():
        return None
    return subprocess.run([_cuda_bin("cuobjdump"), "-sass", str(_target(name))],
                          capture_output=True, text=True, check=True).stdout


def demangle(symbol: str) -> str:
    """A kernel's readable name (``cu++filt``), or the symbol itself."""
    if not Path(_cuda_bin("cu++filt")).is_file():
        return symbol
    out = subprocess.run([_cuda_bin("cu++filt"), symbol], capture_output=True,
                         text=True).stdout.strip()
    return out or symbol


_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_of(x: torch.Tensor) -> int:
    """The current CUDA stream of ``x``'s device, as a C entry point takes it."""
    if _raw_stream is not None:
        return _raw_stream(x.device.index)
    return torch.cuda.current_stream(x.device).cuda_stream


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        lib.az_cuda_error_string.restype = ctypes.c_char_p
        lib.az_cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.az_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
