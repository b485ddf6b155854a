"""The epilogue of each 3x3 trunk conv of the int8 executor in one pass.

``int8_epilogue(form, acc, m, bias, qmul, ...)`` takes the s32 product
``acc [B, H, W, O]`` that ``s8_mm`` returned for a conv and writes what the
next product reads, in one launch of ``csrc/int8_epilogue.cu`` (built at
first use):

  ``"stem"``   ``(q, a)``: ``a = bf16(relu(acc * m + bias))`` and its s8
               quantisation ``q``; ``a`` only where ``want_a``, else None
  ``"conv1"``  ``(q, taps)``: ``q`` quantised with the ReLU in the clip, and
               the ``[B, 9, O]`` i32 tap sums of ``q`` (``models/quant.py``
               ``_tap_sums``)
  ``"conv2"``  ``(q, a)``: ``a = relu(r + bf16(h2 * gate))`` with
               ``h2 = bf16(acc * m + bias)`` and the residual ``r`` (``residual``
               bf16 as it is, or s8 times the bf16 ``res_scale``), and ``q``

``qmul`` is the 0-dim f32 ``127 / scale`` of the output's quantiser, as
``models/quant.py`` computes it.  The results equal the plain passes of
``models/quant.py`` (``_epilogue_stem_plain``, ``_epilogue_conv1_plain``,
``_epilogue_conv2_plain``, the plain versions of this kernel) bit for bit on
the card.  Those are what a CPU tensor takes in ``models/quant.py``; this
wrapper launches the kernel or raises, as for O channels that are not a
multiple of 4 from 4 to ``MAX_CHANNELS``.  ``int8_epilogue.launches`` counts
its launches.
"""
from __future__ import annotations

import ctypes

import torch

from alphazero_tpu_torch.ops import _build

MAX_CHANNELS = 1024  # MAX_CHANNELS of csrc/int8_epilogue.cu
FORMS = {"stem": 0, "conv1": 1, "conv2": 2}


def _fits(t: torch.Tensor, dtype: torch.dtype, dev: torch.device) -> bool:
    return t.dtype == dtype and t.device == dev and t.is_contiguous()


def int8_epilogue(form: str, acc: torch.Tensor, m: torch.Tensor,
                  bias: torch.Tensor, qmul: torch.Tensor, *,
                  want_a: bool = False, gate: torch.Tensor | None = None,
                  residual: torch.Tensor | None = None,
                  res_scale: torch.Tensor | None = None):
    """One form of the epilogue (module docstring).  ``gate`` is the SE gate
    ``[B, O]`` bf16 and ``residual`` the previous block's activation
    ``[B, H, W, O]``, bf16 or s8 (then with the 0-dim bf16 ``res_scale``),
    both for ``"conv2"`` alone."""
    code_form = FORMS.get(form)
    if code_form is None:
        raise ValueError(f"form is one of {sorted(FORMS)}, got {form!r}")
    if acc.dim() != 4:
        raise ValueError(f"int8_epilogue takes a [B, H, W, O] accumulator, got "
                         f"{tuple(acc.shape)}")
    B, H, W, O = acc.shape
    if O % 4 or not 4 <= O <= MAX_CHANNELS:
        raise ValueError(f"int8_epilogue takes O channels a multiple of 4 from "
                         f"4 to {MAX_CHANNELS}, got O={O}")
    dev = acc.device
    if dev.type != "cuda":
        raise ValueError(f"int8_epilogue takes a CUDA accumulator, got one on {dev}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"acc is on {dev}, but the current CUDA device is "
                         f"{torch.cuda.current_device()}")
    f32 = torch.float32
    ok = (_fits(acc, torch.int32, dev) and _fits(m, f32, dev)
          and _fits(bias, f32, dev) and _fits(qmul, f32, dev)
          and m.numel() == O and bias.numel() == O and qmul.numel() == 1)
    res_q = res_a = None
    if form == "conv2":
        ok = ok and gate is not None and residual is not None
        ok = ok and _fits(gate, torch.bfloat16, dev) and gate.shape == (B, O)
        ok = ok and residual.shape == acc.shape and residual.is_contiguous()
        if ok and residual.dtype == torch.int8:
            res_q = residual
            ok = (res_scale is not None and _fits(res_scale, torch.bfloat16, dev)
                  and res_scale.numel() == 1)
        elif ok:
            res_a = residual
            ok = residual.dtype == torch.bfloat16 and residual.device == dev
    if not ok:
        raise ValueError(f"int8_epilogue({form!r}) takes contiguous tensors on "
                         f"{dev}: s32 acc, f32 m, bias [O] and qmul [], and for "
                         "conv2 a bf16 gate [B, O] and a bf16 or s8 residual "
                         "shaped as acc (s8 with a bf16 res_scale [])")
    out_q = torch.empty(acc.shape, dtype=torch.int8, device=dev)
    out_a = taps = None
    if form == "conv1":
        taps = torch.empty((B, 9, O), dtype=torch.int32, device=dev)
    elif want_a:
        out_a = torch.empty(acc.shape, dtype=torch.bfloat16, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = _fns or _bind()
    code = fn.run(code_form, acc.data_ptr(), m.data_ptr(), bias.data_ptr(),
                  qmul.data_ptr(), out_q.data_ptr(), ptr(out_a), ptr(taps),
                  ptr(gate), ptr(res_a), ptr(res_q), ptr(res_scale),
                  B, H, W, O, _build.stream_of(acc))
    if code:
        _build.check(fn.lib, code, "int8_epilogue")
    int8_epilogue.launches += 1
    return out_q, (taps if form == "conv1" else out_a)


int8_epilogue.launches = 0
_fns = None  # the C entry points, bound at the first launch


def _bind():
    """Build and load the source and declare its entry points, once."""
    global _fns
    if _fns is None:
        from types import SimpleNamespace

        lib = _build.load("int8_epilogue")
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        run = lib.az_int8_epilogue
        run.argtypes = [ctypes.c_int] + [p] * 11 + [ll] * 4 + [p]
        run.restype = ctypes.c_int
        _fns = SimpleNamespace(lib=lib, run=run)
    return _fns
