"""Per-lane arena row gather (counterpart of ``alphazero_tpu/ops/gather_rows.py``).

``gather_rows(arr [B, N, K], idx [B] or [B, M]) -> [B, K] or [B, M, K]``
with ``out[b, m] = arr[b, idx[b, m]]`` and a zero row wherever the index lies
outside ``[0, N)`` (the search's -1 "no child").  Any dtype: it is a byte
copy of rows.  Unlike the TPU kernel, B needs not be a multiple of 8.

``gather_rows_many(arrs, idx)`` gathers several arenas ``[B, N_i, K_i]`` of
any dtypes at the one index ``idx``: one C call and one kernel launch for up
to ``MAX_ARENAS`` arenas, one ``torch.empty`` an output.

On a CUDA tensor both wrappers launch the hand-written kernel
``csrc/gather_rows.cu`` (built at first use) or raise; on a CPU tensor they
take the plain versions ``gather_rows_plain`` / ``gather_rows_many_plain``.
Indices are taken as int32 or int64 as they lie (other integer types are
cast first).  ``gather_rows.launches`` counts kernel launches of either
wrapper.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Sequence, Tuple

import torch

from alphazero_tpu_torch.ops import _build

MAX_ARENAS = 8  # MAX_ARENAS of csrc/gather_rows.cu


def gather_rows_plain(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``torch.gather`` plus an out-of-range mask."""
    B, N, K = arr.shape
    idx2 = idx.reshape(B, -1).long()
    valid = (idx2 >= 0) & (idx2 < N)
    safe = torch.where(valid, idx2, 0)
    out = torch.gather(arr, 1, safe[:, :, None].expand(-1, -1, K))
    out = out.masked_fill(~valid[:, :, None], 0)
    return out[:, 0] if idx.dim() == 1 else out


def gather_rows_many_plain(arrs: Sequence[torch.Tensor],
                           idx: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of ``gather_rows_many``: one gather per arena."""
    return tuple(gather_rows_plain(arr, idx) for arr in arrs)


def _check(arr: torch.Tensor, idx: torch.Tensor) -> None:
    """One test on the way every good call takes; what exactly is wrong is
    worked out only when it fails."""
    if (arr.dim() == 3 and idx.dim() in (1, 2) and idx.shape[0] == arr.shape[0]
            and not idx.dtype.is_floating_point and idx.dtype != torch.bool
            and idx.device == arr.device):
        return
    if arr.dim() != 3:
        raise ValueError(f"arr must be [B, N, K], got {tuple(arr.shape)}")
    if idx.dim() not in (1, 2) or idx.shape[0] != arr.shape[0]:
        raise ValueError(f"idx must be [B] or [B, M] with B={arr.shape[0]}, "
                         f"got {tuple(idx.shape)}")
    if idx.dtype.is_floating_point or idx.dtype == torch.bool:
        raise TypeError(f"idx must be an integer tensor, got {idx.dtype}")
    raise ValueError("arr and idx must be on the same device")


def _check_card(arr: torch.Tensor, what: str) -> None:
    if arr.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {arr.device}")
    if not arr.is_contiguous():
        raise ValueError(f"{what} needs contiguous arenas")
    if arr.device.index != torch.cuda.current_device():
        raise ValueError(f"arr is on {arr.device}, but the current CUDA "
                         f"device is {torch.cuda.current_device()}")


def _kernel_idx(idx: torch.Tensor) -> torch.Tensor:
    """``idx`` as the kernel reads it: int32 or int64, contiguous."""
    if idx.dtype not in (torch.int32, torch.int64):
        idx = idx.to(torch.int32)
    return idx if idx.is_contiguous() else idx.contiguous()


def gather_rows(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    _check(arr, idx)
    if arr.device.type == "cpu":
        return gather_rows_plain(arr, idx)
    _check_card(arr, "gather_rows")
    B, N, K = arr.shape
    idx2 = _kernel_idx(idx)
    M = 1 if idx.dim() == 1 else idx.shape[1]
    shape = (B, K) if idx.dim() == 1 else (B, M, K)
    out = torch.empty(shape, dtype=arr.dtype, device=arr.device)
    fn = _fns or _bind()
    code = fn.one(arr.data_ptr(), idx2.data_ptr(), idx2.element_size(),
                  out.data_ptr(), B, N, M, K * arr.element_size(),
                  _build.stream_of(arr))
    if code:
        _build.check(fn.lib, code, "gather_rows")
    gather_rows.launches += 1
    return out


def gather_rows_many(arrs: Sequence[torch.Tensor],
                     idx: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``tuple(gather_rows(arr, idx) for arr in arrs)`` in one launch."""
    n = len(arrs)
    if not 1 <= n <= MAX_ARENAS:
        raise ValueError(f"gather_rows_many takes 1 to {MAX_ARENAS} arenas, "
                         f"got {n}")
    if idx.device.type == "cpu":
        for arr in arrs:
            _check(arr, idx)
        return gather_rows_many_plain(arrs, idx)
    _check(arrs[0], idx)
    _check_card(arrs[0], "gather_rows_many")
    dev, B = idx.device, idx.shape[0]
    two = idx.dim() == 2
    M = idx.shape[1] if two else 1
    idx2 = _kernel_idx(idx)
    table = getattr(_tables, "table", None)
    if table is None:
        table = _tables.table = (ctypes.c_longlong * (4 * MAX_ARENAS))()
    outs = []
    for k, arr in enumerate(arrs):
        if not (arr.dim() == 3 and arr.shape[0] == B and arr.device == dev
                and arr.is_contiguous()):
            _check(arr, idx)
            _check_card(arr, "gather_rows_many")
        _, N, K = arr.shape
        out = torch.empty((B, M, K) if two else (B, K), dtype=arr.dtype, device=dev)
        outs.append(out)
        table[4 * k] = arr.data_ptr()
        table[4 * k + 1] = out.data_ptr()
        table[4 * k + 2] = N
        table[4 * k + 3] = K * arr.element_size()
    fn = _fns or _bind()
    code = fn.many(table, n, idx2.data_ptr(), idx2.element_size(), B, M,
                   _build.stream_of(idx))
    if code:
        _build.check(fn.lib, code, "gather_rows_many")
    gather_rows.launches += 1
    return tuple(outs)


gather_rows.launches = 0
_fns = None  # the C entry points, bound at the first launch
# The descriptor table gather_rows_many hands over, four int64 an arena, one
# a thread: the C entry point copies it into the launch's parameters before
# it returns, so a thread's table serves all its calls.
_tables = threading.local()


def _bind():
    """Build and load the source and declare its entry points, once."""
    global _fns
    if _fns is None:
        from types import SimpleNamespace

        lib = _build.load("gather_rows")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        one, many = lib.az_gather_rows, lib.az_gather_rows_many
        one.argtypes = [p, p, i, p, ll, ll, ll, ll, p]
        many.argtypes = [ctypes.POINTER(ll), i, p, i, ll, ll, p]
        one.restype = many.restype = ctypes.c_int
        _fns = SimpleNamespace(lib=lib, one=one, many=many)
    return _fns
