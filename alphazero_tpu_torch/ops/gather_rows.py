"""Per-lane arena row gather (counterpart of ``alphazero_tpu/ops/gather_rows.py``).

``gather_rows(arr [B, N, K], idx [B] or [B, M]) -> [B, K] or [B, M, K]``
with ``out[b, m] = arr[b, idx[b, m]]`` and a zero row wherever the index lies
outside ``[0, N)`` (the search's -1 "no child").  Any dtype: it is a byte
copy of rows.  Unlike the TPU kernel, B needs not be a multiple of 8.

On a CUDA tensor the wrapper launches the hand-written kernel
``csrc/gather_rows.cu`` (built at first use) or raises; on a CPU tensor it
takes ``gather_rows_plain``.  ``gather_rows.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from alphazero_tpu_torch.ops import _build


def gather_rows_plain(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``torch.gather`` plus an out-of-range mask."""
    B, N, K = arr.shape
    idx2 = idx.reshape(B, -1).long()
    valid = (idx2 >= 0) & (idx2 < N)
    safe = torch.where(valid, idx2, 0)
    out = torch.gather(arr, 1, safe[:, :, None].expand(-1, -1, K))
    out = out.masked_fill(~valid[:, :, None], 0)
    return out[:, 0] if idx.dim() == 1 else out


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


def gather_rows(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    _check(arr, idx)
    if arr.device.type == "cpu":
        return gather_rows_plain(arr, idx)
    if arr.device.type != "cuda":
        raise ValueError(f"gather_rows runs on cpu or cuda, not {arr.device}")
    if not arr.is_contiguous():
        raise ValueError("gather_rows needs a contiguous arr")
    if arr.device.index != torch.cuda.current_device():
        raise ValueError(f"arr is on {arr.device}, but the current CUDA "
                         f"device is {torch.cuda.current_device()}")
    B, N, K = arr.shape
    idx2 = idx if idx.dtype == torch.int32 else idx.to(torch.int32)
    if not idx2.is_contiguous():
        idx2 = idx2.contiguous()
    M = 1 if idx.dim() == 1 else idx.shape[1]
    shape = (B, K) if idx.dim() == 1 else (B, M, K)
    out = torch.empty(shape, dtype=arr.dtype, device=arr.device)
    fn = _fn or _bind()
    code = fn(arr.data_ptr(), idx2.data_ptr(), out.data_ptr(), B, N, M,
              K * arr.element_size(), _build.stream_of(arr))
    if code:
        _build.check(_build.load("gather_rows"), code, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
_fn = None  # the C entry point, bound at the first launch


def _bind():
    """Build and load the source and declare its entry point, once."""
    global _fn
    if _fn is None:
        fn = _build.load("gather_rows").az_gather_rows
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_void_p,
        ]
        _fn = fn
    return _fn
