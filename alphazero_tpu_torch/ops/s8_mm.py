"""Integer (s8 -> s32) and bf16 (-> f32) matrix products written by hand.

Counterparts of the JAX package's four Pallas probe kernels:

  ``s8_mm(a, b)``            ``tools/profile_fused_shapes.py::pallas_mm``
  ``s8_mm_multi(a, b)``      ``tools/profile_fused_shapes.py::pallas_mm_multi``
  ``chained_dot(a, b, R)``   ``tools/profile_inkernel_dot.py::chained_dot``
  ``tiled_mm(a, b)``         ``tools/profile_pallas_mm.py::make_pallas_mm``

``s8_mm`` is also the product under every convolution of the int8 executor
(``models/quant.py``): PyTorch has no s8 x s8 -> s32 convolution on CUDA.

On a CUDA tensor each wrapper launches its kernel in ``csrc/s8_mm.cu``
(built at first use) or raises; on a CPU tensor it takes the plain version
beside it (``*_plain``).  ``<wrapper>.launches`` counts kernel launches.
Any M, N and K are taken: the wrapper zero-pads K and N to multiples of 16
elements (rows must start on 16-byte boundaries); the kernel masks ragged M.

The plain versions are exact for s8: products of values in [-127, 127]
summed in float32 stay integers below 2**24 while ``K * 127**2 < 2**24``
(K <= 1040, every shape of the int8 trunk), whatever the order of
summation, as long as ``torch.backends.cuda.matmul.allow_tf32`` stays False
(its default); for a longer K they sum in float64 (exact below 2**53).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from alphazero_tpu_torch.ops import _build

_ALIGN = 16  # elements: K and N are padded to multiples of this
_F32_EXACT_K = (1 << 24) // (127 * 127)  # 1040
_SMEM_MAX = 232448  # bytes of shared memory one block may use on sm_90
_CD_ROWS = 64  # rows of `a` per block in the chained-dot kernel


# ------------------------------------------------------------ plain versions

def _int_matmul(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """Exact integer product through a float matmul; ``terms`` products of
    magnitude <= 127**2 are summed per output."""
    dt = torch.float32 if terms <= _F32_EXACT_K else torch.float64
    return a.to(dt) @ b.to(dt)


def s8_mm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _int_matmul(a, b, a.shape[1]).to(torch.int32)


def s8_mm_multi_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    taps, K, N = b.shape
    # sum_t a @ b[t] == [a a .. a] @ vstack(b): one product of taps*K terms.
    return _int_matmul(a.repeat(1, taps), b.reshape(taps * K, N),
                       taps * K).to(torch.int32)


def tiled_mm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.dtype == torch.int8:
        return s8_mm_plain(a, b)
    return a.float() @ b.float()  # bf16 products are exact in f32; f32 sums


def chained_dot_plain(a: torch.Tensor, b: torch.Tensor, R: int) -> torch.Tensor:
    K, N = b.shape
    for _ in range(R):
        if a.dtype == torch.int8:
            acc = s8_mm_plain(a, b)
            # arithmetic shift, then a wrapping cast to s8
            d = (((acc >> 8) + 128) % 256 - 128).to(torch.int8)
        else:
            d = (tiled_mm_plain(a, b) * 0.001).to(a.dtype)
        a = d.repeat(1, K // N)
    return tiled_mm_plain(a, b)


# ------------------------------------------------------------------ checking

def _check_pair(name: str, a: torch.Tensor, b: torch.Tensor, dtypes) -> None:
    if a.dim() != 2 or b.dim() < 2:
        raise ValueError(f"{name}: a must be [M, K] and b [.., K, N], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if b.shape[-2] != a.shape[1]:
        raise ValueError(f"{name}: a is {tuple(a.shape)} but b is "
                         f"{tuple(b.shape)}")
    if a.dtype not in dtypes or b.dtype != a.dtype:
        raise TypeError(f"{name}: a and b must both be one of {dtypes}, got "
                        f"{a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"{name}: a and b must be on the same device")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {a.device}")
    if a.device.type == "cuda" and a.get_device() != torch.cuda.current_device():
        raise ValueError(f"{name}: a is on {a.device}, but the current CUDA "
                         f"device is {torch.cuda.current_device()}")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous with a 16-byte aligned base (a copy only if needed)."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _pad_to(x: torch.Tensor, dim: int, multiple: int) -> torch.Tensor:
    """``x`` zero-padded along ``dim`` (-1 or -2) to a multiple, contiguous
    and 16-byte aligned."""
    extra = -x.shape[dim] % multiple
    if extra:
        x = F.pad(x, (0, extra) if dim == -1 else (0, 0, 0, extra))
    return _aligned(x)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.int32 if dtype == torch.int8 else torch.float32


def _lib() -> ctypes.CDLL:
    lib = _build.load("s8_mm")
    if lib.az_s8_mm.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn, args in ((lib.az_s8_mm, [p, p, p, i, i, i, p]),
                         (lib.az_s8_mm_multi, [p, p, p, i, i, i, i, p]),
                         (lib.az_tiled_mm, [p, p, p, i, i, i, i, p]),
                         (lib.az_chained_dot, [p, p, p, i, i, i, i, i, p])):
            fn.restype = ctypes.c_int
            fn.argtypes = args
    return lib


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _launch_tiled(wrapper, entry: str, a: torch.Tensor, b: torch.Tensor,
                  *extra: int) -> torch.Tensor:
    """Pad, launch the row-tiled kernel behind C function ``entry`` for
    ``wrapper`` and unpad.  ``b`` is [K, N] or [taps, K, N]."""
    M, N = a.shape[0], b.shape[-1]
    a_p = _pad_to(a, -1, _ALIGN)
    b_p = _pad_to(_pad_to(b, -2, _ALIGN), -1, _ALIGN)
    Kp, Np = a_p.shape[1], b_p.shape[-1]
    out = torch.empty((M, Np), dtype=_acc_dtype(a.dtype), device=a.device)
    lib = _lib()
    code = getattr(lib, entry)(a_p.data_ptr(), b_p.data_ptr(), out.data_ptr(),
                               M, Np, Kp, *extra, _stream())
    _build.check(lib, code, wrapper.__name__)
    wrapper.launches += 1
    return out if Np == N else out[:, :N].contiguous()


# ------------------------------------------------------------------ wrappers

def s8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] @ b [K, N]``, s8 x s8 -> s32, exact."""
    _check_pair("s8_mm", a, b, (torch.int8,))
    if b.dim() != 2:
        raise ValueError(f"s8_mm: b must be [K, N], got {tuple(b.shape)}")
    if a.device.type == "cpu":
        return s8_mm_plain(a, b)
    return _launch_tiled(s8_mm, "az_s8_mm", a, b)


def s8_mm_multi(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum_t a [M, K] @ b[t] [K, N]`` for ``b [taps, K, N]``, s8 -> s32:
    the same rows of ``a`` against several weight matrices, accumulated."""
    _check_pair("s8_mm_multi", a, b, (torch.int8,))
    if b.dim() != 3 or b.shape[0] < 1:
        raise ValueError(f"s8_mm_multi: b must be [taps, K, N], got "
                         f"{tuple(b.shape)}")
    if a.device.type == "cpu":
        return s8_mm_multi_plain(a, b)
    return _launch_tiled(s8_mm_multi, "az_s8_mm_multi", a, b, b.shape[0])


def tiled_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] @ b [K, N]``: s8 -> s32 (exact) or bf16 -> f32 (f32 sums)."""
    _check_pair("tiled_mm", a, b, (torch.int8, torch.bfloat16))
    if b.dim() != 2:
        raise ValueError(f"tiled_mm: b must be [K, N], got {tuple(b.shape)}")
    if a.device.type == "cpu":
        return tiled_mm_plain(a, b)
    return _launch_tiled(tiled_mm, "az_tiled_mm", a, b, a.element_size())


def chained_dot(a: torch.Tensor, b: torch.Tensor, R: int) -> torch.Tensor:
    """``R`` data-dependent products with ``a`` kept on chip, then one more:

        repeat R times:  a <- tile(requant(a @ b), K // N)   along columns
        return a @ b                                          [M, N]

    requant is ``(acc >> 8)`` wrapped to s8 for s8 inputs (s32 result) and
    ``acc * 0.001`` rounded to bf16 for bf16 inputs (f32 result).  N must be
    a multiple of 32 and K a multiple of N; ``b`` and a 64-row band of ``a``
    (twice) must fit one block's shared memory."""
    _check_pair("chained_dot", a, b, (torch.int8, torch.bfloat16))
    if b.dim() != 2:
        raise ValueError(f"chained_dot: b must be [K, N], got {tuple(b.shape)}")
    M, K = a.shape
    N = b.shape[1]
    if R < 0 or N % 32 or K % N:
        raise ValueError(f"chained_dot needs R >= 0, N % 32 == 0 and "
                         f"K % N == 0, got R={R}, K={K}, N={N}")
    if a.device.type == "cpu":
        return chained_dot_plain(a, b, R)
    es = a.element_size()
    smem = K * (N * es + 16) + 2 * _CD_ROWS * (K * es + 16)
    if smem > _SMEM_MAX:
        raise ValueError(f"chained_dot: K={K}, N={N} need {smem} bytes of "
                         f"shared memory, more than {_SMEM_MAX}")
    a_p, b_p = _aligned(a), _aligned(b)
    out = torch.empty((M, N), dtype=_acc_dtype(a.dtype), device=a.device)
    lib = _lib()
    code = lib.az_chained_dot(a_p.data_ptr(), b_p.data_ptr(), out.data_ptr(),
                              M, N, K, R, es, _stream())
    _build.check(lib, code, "chained_dot")
    chained_dot.launches += 1
    return out


for _fn in (s8_mm, s8_mm_multi, tiled_mm, chained_dot):
    _fn.launches = 0
