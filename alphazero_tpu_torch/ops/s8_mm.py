"""Integer (s8 -> s32) and bf16 (-> f32) matrix products written by hand.

Counterparts of the JAX package's four Pallas probe kernels:

  ``s8_mm(a, b)``            ``tools/profile_fused_shapes.py::pallas_mm``
  ``s8_mm_multi(a, b)``      ``tools/profile_fused_shapes.py::pallas_mm_multi``
  ``chained_dot(a, b, R)``   ``tools/profile_inkernel_dot.py::chained_dot``
  ``tiled_mm(a, b)``         ``tools/profile_pallas_mm.py::make_pallas_mm``

``s8_mm`` is also the product under every convolution of the int8 executor
(``models/quant.py``): PyTorch has no s8 x s8 -> s32 convolution on CUDA.

On a CUDA tensor each wrapper launches its kernel (built at first use) or
raises; on a CPU tensor it takes the plain version beside it (``*_plain``).
``<wrapper>.launches`` counts calls that launched a kernel.  Any M, N and K
are taken.

Every wrapper runs the wgmma / TMA kernels of ``csrc/wgmma_mm.cu``.
``s8_mm`` takes the kernel that keeps all of ``b``
in shared memory where ``b`` fits (``s8_mm_route``: N <= 128 and the padded
``b`` within ``RESIDENT_B_MAX`` bytes) and the tiled kernel otherwise;
``tiled_mm`` always takes the tiled kernel, which for s8 first transposes
``b`` into scratch (a second launch of the same call).  Their tensor maps
know the true sizes, so nothing is padded for size; a matrix is copied only
when the TMA unit cannot read it as it lies (``_rows16``: a base or a row
pitch that is no multiple of 16 bytes, such as K = 99 packed densely).
``chained_dot`` keeps all of ``b`` in one block's shared memory and a band
of 64 rows of ``a`` in its registers; ``chained_dot_smem`` is the rule for
the shapes it takes.  ``s8_mm_multi`` runs the same two product kernels
with a tap count (``s8_mm_multi_route``): the resident one where every
tap's ``b`` fits one block's shared memory together, each box of ``a`` run
against all taps as it arrives, else the tiled one over (tap, K panel)
stages, its scratch holding the taps' transposed ``b`` side by side.

The plain versions are exact for s8: products of values in [-128, 127]
summed in float32 stay integers below 2**24 while ``K * 128**2 <= 2**24``
(K <= 1024, every shape of the int8 trunk), whatever the order of
summation, as long as ``torch.backends.cuda.matmul.allow_tf32`` stays False
(its default); for a longer K they sum in float64 (exact below 2**53).
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace

import torch

from alphazero_tpu_torch.ops import _build

_F32_EXACT_K = (1 << 24) // (128 * 128)  # 1024
RESIDENT_B_MAX = 96 * 1024  # bytes; RESIDENT_B_MAX of csrc/wgmma_mm.cu
_SMEM_MAX = 232448  # bytes of shared memory one block may use on sm_90
_CD_ROWS = 64  # rows of `a` a band in the chained-dot kernel


# ------------------------------------------------------------ plain versions

def _int_matmul(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """Exact integer product through a float matmul; ``terms`` products of
    magnitude <= 128**2 are summed per output."""
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


# ------------------------------------------------------------------- routing

def resident_b_bytes(N: int, K: int) -> int:
    """Shared memory the resident kernel needs for ``b [K, N]``: panels of
    128 bytes of K for N padded up to 32, 64 or 128 rows."""
    padded_n = 32 if N <= 32 else 64 if N <= 64 else 128
    return -(-K // 128) * 128 * padded_n


def s8_mm_route(N: int, K: int) -> str:
    """The kernel ``s8_mm`` takes for ``[M, K] x [K, N]`` on the card, a
    pure function of the shape: ``"resident"`` where all of ``b`` fits one
    block's shared memory beside the ring of ``a`` tiles, else ``"tiled"``."""
    if N <= 128 and resident_b_bytes(N, K) <= RESIDENT_B_MAX:
        return "resident"
    return "tiled"


def s8_mm_multi_route(taps: int, N: int, K: int) -> str:
    """The kernel ``s8_mm_multi`` takes for ``[M, K] x [taps, K, N]`` on the
    card (``az_s8_mm_multi_route`` of ``csrc/wgmma_mm.cu``), a pure function
    of the shape: ``"resident"`` where the images of all ``taps`` matrices
    fit one block's shared memory together, else ``"tiled"``.  One tap is
    ``s8_mm_route``."""
    if N <= 128 and taps * resident_b_bytes(N, K) <= RESIDENT_B_MAX:
        return "resident"
    return "tiled"


def tap_pitch(taps: int, K: int) -> int:
    """Columns a tap takes in the tiled route's transposed ``b``: K rounded
    up to 16 bytes (the TMA unit's pitch) for one tap, and to 128 (one
    stage) for several, so that each tap starts a stage."""
    return -(-K // 16) * 16 if taps == 1 else -(-K // 128) * 128


def kernel_accepts(route: str, M: int, N: int, K: int, dtype: torch.dtype,
                   taps: int = 1) -> bool:
    """Whether the kernel behind ``route`` takes the shape (the checks its C
    entry point makes, after ``_rows16`` has seen to alignment); ``taps``
    matrices of ``b`` summed over (s8)."""
    if min(M, N) <= 0:
        return True  # nothing to compute, nothing is launched
    if K <= 0 or taps < 1 or (taps > 1 and dtype != torch.int8):
        return False
    if route == "resident":
        return (dtype == torch.int8 and N <= 128
                and taps * resident_b_bytes(N, K) <= RESIDENT_B_MAX)
    if route == "tiled":
        # the s8 transposition's grid spans N in blocks of 64 and the taps
        # in its third dimension; its output's rows fit an int
        return (dtype == torch.bfloat16
                or (dtype == torch.int8 and -(-N // 64) <= 65535
                    and taps <= 65535 and taps * tap_pitch(taps, K) < 2**31))
    raise ValueError(f"unknown route {route!r}")


def chained_dot_smem(N: int, K: int, dtype: torch.dtype):
    """Dynamic shared memory one block of the chained-dot kernel asks for at
    ``b [K, N]``, or None where it does not take the shape
    (``az_chained_smem`` of ``csrc/wgmma_mm.cu``): N in {32, 64, 128} for s8
    and {64, 128} for bf16, K a positive multiple of N, ``b`` (s8: K-major
    panels of 128 bytes of K; bf16: as it lies) and the band of ``a`` (64
    rows, K up to a multiple of 128 bytes) within one block's shared
    memory."""
    es = {torch.int8: 1, torch.bfloat16: 2}.get(dtype)
    if (es is None or N not in ((32, 64, 128) if es == 1 else (64, 128))
            or K <= 0 or K > 1 << 16 or K % N):
        return None
    panels = -(-K * es // 128)
    b_bytes = panels * 128 * N if es == 1 else K * 128 * (N // 64)
    total = 1024 + b_bytes + panels * _CD_ROWS * 128 + 16
    return total if total <= _SMEM_MAX else None


# Plain twins of the two ways the kernels turn the row-major s8 ``b [K, N]``
# into the K-major operand wgmma wants; the tests hold them against numpy.

def swizzled_offset(row: int, kbyte: int) -> int:
    """Byte offset of (row, byte of K) in a tile of 128-byte rows under the
    128-byte swizzle: the 16-byte chunk index is XORed with ``row % 8``."""
    return row * 128 + ((((kbyte >> 4) ^ (row & 7)) << 4) | (kbyte & 15))


def pack_b_resident_plain(b: torch.Tensor) -> torch.Tensor:
    """The shared-memory image the resident kernel builds of ``b``:
    ``[panels, padded_n * 128]`` bytes, panel p holding K bytes
    ``[128 p, 128 p + 128)`` of every column as one swizzled row, zeros where
    ``b`` ends."""
    K, N = b.shape
    panels = -(-K // 128)
    padded_n = resident_b_bytes(N, K) // (panels * 128)
    k = torch.arange(K)[:, None].expand(K, N)
    n = torch.arange(N)[None, :].expand(K, N)
    kb = k % 128
    off = n * 128 + ((((kb >> 4) ^ (n & 7)) << 4) | (kb & 15))
    img = torch.zeros((panels, padded_n * 128), dtype=b.dtype)
    img[k // 128, off] = b.cpu()
    return img


def pack_b_multi_plain(b: torch.Tensor) -> torch.Tensor:
    """The image the resident kernel builds of ``b [taps, K, N]``: each
    tap's ``pack_b_resident_plain`` after the one before, ``[taps * panels,
    padded_n * 128]`` bytes (every panel starts on a 1024-byte boundary)."""
    return torch.cat([pack_b_resident_plain(bt) for bt in b])


def transpose_b_plain(b: torch.Tensor) -> torch.Tensor:
    """What the tiled kernel's transposition pass writes of ``b [K, N]`` or
    ``[taps, K, N]``: ``[N, taps * tap_pitch(taps, K)]``, tap t's ``b[t]``
    transposed at columns ``t * tap_pitch`` onwards, zeros past K."""
    bs = b[None] if b.dim() == 2 else b
    taps, K, N = bs.shape
    kp = tap_pitch(taps, K)
    out = torch.zeros((N, taps, kp), dtype=b.dtype, device=b.device)
    out[:, :, :K] = bs.permute(2, 0, 1)
    return out.reshape(N, taps * kp)


# ------------------------------------------------------------------ checking

def _check_pair(name: str, a: torch.Tensor, b: torch.Tensor, dtypes,
                b_dims: int = 2) -> None:
    """One test on the way every good call takes; what exactly is wrong is
    worked out only when it fails."""
    if (a.dim() == 2 and b.dim() == b_dims and b.shape[-2] == a.shape[1]
            and a.dtype in dtypes and b.dtype == a.dtype
            and a.device == b.device
            and (a.device.type == "cpu" or (
                a.is_cuda and a.device.index == torch.cuda.current_device()))):
        return
    if a.dim() != 2 or b.dim() != b_dims:
        raise ValueError(f"{name}: a must be [M, K] and b "
                         f"{'[K, N]' if b_dims == 2 else '[taps, K, N]'}, got "
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
    raise ValueError(f"{name}: a is on {a.device}, but the current CUDA "
                     f"device is {torch.cuda.current_device()}")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous with a 16-byte aligned base (a copy only if needed)."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.int32 if dtype == torch.int8 else torch.float32


_fns = None  # the C entry points, bound at the first launch


def _bind() -> SimpleNamespace:
    """Build and load the source and declare every entry point, once."""
    global _fns
    if _fns is None:
        wg = _build.load("wgmma_mm")
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn, args in ((wg.az_s8_mm_resident, [p, p, p, i, i, i, i, p]),
                         (wg.az_wgmma_tiled, [p, p, p, p, i, i, i, i, i, i, p]),
                         (wg.az_resident_b_max, []), (wg.az_tiled_smem, []),
                         (wg.az_resident_smem_fixed, []),
                         (wg.az_chained_dot, [p, p, p, i, i, i, i, i, i, p]),
                         (wg.az_chained_smem, [i, i, i]),
                         (wg.az_s8_mm_multi, [p, p, p, p, i, i, i, i, i, p]),
                         (wg.az_s8_mm_multi_route, [i, i, i])):
            fn.restype = ctypes.c_int
            fn.argtypes = args
        if wg.az_resident_b_max() != RESIDENT_B_MAX:
            raise RuntimeError("RESIDENT_B_MAX differs between ops/s8_mm.py "
                               "and csrc/wgmma_mm.cu")
        _fns = SimpleNamespace(
            wg=wg, resident=wg.az_s8_mm_resident, tiled=wg.az_wgmma_tiled,
            multi=wg.az_s8_mm_multi, chained=wg.az_chained_dot)
    return _fns


def dynamic_smem_bytes(route: str, N: int = 0, K: int = 0, taps: int = 1) -> int:
    """Dynamic shared memory one block of the kernel behind ``route`` asks
    for (the resident kernel's depends on ``taps`` matrices ``b [K, N]``);
    builds the source."""
    fns = _fns or _bind()
    if route == "tiled":
        return fns.wg.az_tiled_smem()
    return fns.wg.az_resident_smem_fixed() + taps * resident_b_bytes(N, K)


def _rows16(x: torch.Tensor) -> torch.Tensor:
    """``x [R, C]`` as the TMA unit can read it: unit column stride, base
    and row pitch multiples of 16 bytes (the pitch is ``stride(0)``).  ``x``
    itself where it qualifies, else one copy into rows of such a pitch.
    What lies between a row's end and the next row is never read: the
    tensor map ends at column C."""
    es = x.element_size()
    R, C = x.shape
    if (x.stride(1) == 1 and x.stride(0) >= C
            and x.stride(0) * es % 16 == 0 and x.data_ptr() % 16 == 0):
        return x
    buf = x.new_empty((R, C + -C % (16 // es)))[:, :C]
    return buf.copy_(x)


def _launch_resident(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``s8_mm`` through the kernel that keeps ``b`` in shared memory."""
    M, K = a.shape
    N = b.shape[1]
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    if M == 0 or N == 0:
        return out
    fns = _fns or _bind()
    a = _rows16(a)
    if not b.is_contiguous():
        b = b.contiguous()
    code = fns.resident(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
                        a.stride(0), _build.stream_of(a))
    if code:
        _build.check(fns.wg, code, "s8_mm")
    s8_mm.launches += 1
    return out


def _launch_wgmma_tiled(wrapper, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``wrapper``'s product through the tiled wgmma kernel; for s8 the same
    call first transposes ``b`` into scratch allocated here."""
    M, K = a.shape
    N = b.shape[1]
    es = a.element_size()
    out = torch.empty((M, N), dtype=_acc_dtype(a.dtype), device=a.device)
    if M == 0 or N == 0:
        return out
    fns = _fns or _bind()
    a = _rows16(a)
    if es == 1:
        if not b.is_contiguous():
            b = b.contiguous()
        scratch = torch.empty((N, -(-K // 16) * 16), dtype=torch.int8,
                              device=a.device)
        bt, ldb = scratch.data_ptr(), N
    else:
        b = _rows16(b)
        bt, ldb = None, b.stride(0)
    code = fns.tiled(a.data_ptr(), b.data_ptr(), bt, out.data_ptr(), M, N, K,
                     a.stride(0), ldb, es, _build.stream_of(a))
    if code:
        _build.check(fns.wg, code, wrapper.__name__)
    wrapper.launches += 1
    return out


def _launch_multi(a: torch.Tensor, b: torch.Tensor, route: str) -> torch.Tensor:
    """``s8_mm_multi`` for ``b [taps, K, N]`` through ``az_s8_mm_multi``,
    which takes ``route`` (``s8_mm_multi_route``); the tiled route's scratch
    for the transposed taps is allocated here."""
    M, K = a.shape
    taps, _, N = b.shape
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    if M == 0 or N == 0:
        return out
    fns = _fns or _bind()
    a = _rows16(a)
    if not b.is_contiguous():
        b = b.contiguous()
    scratch = None
    if route == "tiled":
        scratch = torch.empty((N, taps * tap_pitch(taps, K)), dtype=torch.int8,
                              device=a.device)
    code = fns.multi(a.data_ptr(), b.data_ptr(),
                     None if scratch is None else scratch.data_ptr(),
                     out.data_ptr(), M, N, K, a.stride(0), taps,
                     _build.stream_of(a))
    if code:
        _build.check(fns.wg, code, "s8_mm_multi")
    s8_mm_multi.launches += 1
    return out


# ------------------------------------------------------------------ wrappers

def s8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] @ b [K, N]``, s8 x s8 -> s32, exact."""
    _check_pair("s8_mm", a, b, (torch.int8,))
    if a.device.type == "cpu":
        return s8_mm_plain(a, b)
    if s8_mm_route(b.shape[1], a.shape[1]) == "resident":
        return _launch_resident(a, b)
    return _launch_wgmma_tiled(s8_mm, a, b)


def s8_mm_multi(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum_t a [M, K] @ b[t] [K, N]`` for ``b [taps, K, N]``, s8 -> s32:
    the same rows of ``a`` against several weight matrices, accumulated."""
    _check_pair("s8_mm_multi", a, b, (torch.int8,), b_dims=3)
    if b.shape[0] < 1:
        raise ValueError(f"s8_mm_multi: b must be [taps, K, N], got "
                         f"{tuple(b.shape)}")
    if a.device.type == "cpu":
        return s8_mm_multi_plain(a, b)
    taps, K, N = b.shape
    return _launch_multi(a, b, s8_mm_multi_route(taps, N, K))


def tiled_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] @ b [K, N]``: s8 -> s32 (exact) or bf16 -> f32 (f32 sums)."""
    _check_pair("tiled_mm", a, b, (torch.int8, torch.bfloat16))
    if a.device.type == "cpu":
        return tiled_mm_plain(a, b)
    return _launch_wgmma_tiled(tiled_mm, a, b)


def chained_dot(a: torch.Tensor, b: torch.Tensor, R: int) -> torch.Tensor:
    """``R`` data-dependent products with ``a`` kept on chip, then one more:

        repeat R times:  a <- tile(requant(a @ b), K // N)   along columns
        return a @ b                                          [M, N]

    requant is ``(acc >> 8)`` wrapped to s8 for s8 inputs (s32 result) and
    ``acc * 0.001`` rounded to bf16 for bf16 inputs (f32 result).  Shapes as
    ``chained_dot_smem`` takes them."""
    _check_pair("chained_dot", a, b, (torch.int8, torch.bfloat16))
    M, K = a.shape
    N = b.shape[1]
    if R < 0 or chained_dot_smem(N, K, a.dtype) is None:
        raise ValueError(f"chained_dot takes R >= 0 and, for {a.dtype}, K a "
                         f"multiple of N with N in "
                         f"{'(32, 64, 128)' if a.dtype == torch.int8 else '(64, 128)'}"
                         f" and b within shared memory; got R={R}, K={K}, N={N}")
    if a.device.type == "cpu":
        return chained_dot_plain(a, b, R)
    out = torch.empty((M, N), dtype=_acc_dtype(a.dtype), device=a.device)
    if M == 0:
        return out
    a_p, b_p = _rows16(a), _aligned(b)
    fns = _fns or _bind()
    code = fns.chained(a_p.data_ptr(), b_p.data_ptr(), out.data_ptr(), M, N, K,
                       a_p.stride(0), R, a.element_size(), _build.stream_of(a))
    if code:
        _build.check(fns.wg, code, "chained_dot")
    chained_dot.launches += 1
    return out


for _fn in (s8_mm, s8_mm_multi, tiled_mm, chained_dot):
    _fn.launches = 0
