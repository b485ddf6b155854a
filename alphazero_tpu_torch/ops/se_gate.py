"""The SE gate of each int8 trunk block in one launch.

``se_gate(taps, hw, weights)`` maps conv1's ``[B, 9, C]`` i32 tap sums over
boards of ``hw`` cells (what ``int8_epilogue("conv1")`` writes) to the
``[B, O]`` bf16 gate that ``int8_epilogue("conv2")`` reads, in one launch of
``csrc/se_gate.cu`` (built at first use): the contraction with conv2's s8
weight, ``* m / hw + bias``, the bf16 cast and the SE MLP with its sigmoid.
``weights`` is one block's constants as ``gate_weights`` lays them out,
once, in ``models/quant.py`` ``_executor_params``: a call converts nothing
and passes the constants' addresses as one pointer.

The kernel rounds where the plain chain (``models/quant.py``
``_se_gate_from_taps``, what a CPU tensor takes) rounds on the card, but
sums in another order than cuBLAS: the two gates agree to within a bf16
ulp, not bit for bit by design.  This wrapper launches the kernel or
raises, as for widths it does not take (``C`` from 1 to ``MAX_WIDTH``,
``O`` a multiple of 4 from 4 to ``MAX_WIDTH``, the MLP's hidden width from
1 to ``MAX_HIDDEN``).  ``se_gate.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes

import torch

from alphazero_tpu_torch.ops import _build

MAX_WIDTH = 256  # MAX_WIDTH of csrc/se_gate.cu
MAX_HIDDEN = 128  # MAX_HIDDEN of csrc/se_gate.cu


class GateWeights:
    """One block's constants of the gate as the kernel reads them, all
    contiguous on one device: conv2's s8 weight ``w`` ``[9C, O]``, its f32
    requant ``m`` and ``bias`` ``[O]``, and the SE MLP in bf16 (``w1``
    ``[O, hidden]``, ``b1``, ``w2`` ``[hidden, O]``, ``b2``).  ``args`` is
    the address of their addresses and widths (``Weights`` of
    ``csrc/se_gate.cu``), kept beside the tensors it points into; a copy or
    an unpickled object is made anew from its tensors."""

    __slots__ = ("w", "m", "bias", "w1", "b1", "w2", "b2", "C", "O", "hidden",
                 "device", "_block", "args")

    def __init__(self, w, m, bias, w1, b1, w2, b2):
        ts = (w, m, bias, w1, b1, w2, b2)
        K, O = w.shape
        hidden = w1.shape[1]
        dtypes = (torch.int8, torch.float32, torch.float32) + (torch.bfloat16,) * 4
        shapes = ((K, O), (O,), (O,), (O, hidden), (hidden,), (hidden, O), (O,))
        if (K % 9 or any(t.dtype != d or tuple(t.shape) != s or not t.is_contiguous()
                         or t.device != w.device for t, d, s in zip(ts, dtypes, shapes))):
            raise ValueError(
                "GateWeights takes contiguous tensors on one device: s8 w [9C, O], "
                "f32 m and bias [O], bf16 w1 [O, hidden], b1 [hidden], w2 "
                f"[hidden, O], b2 [O]; got {[(t.dtype, tuple(t.shape)) for t in ts]}")
        self.w, self.m, self.bias, self.w1, self.b1, self.w2, self.b2 = ts
        self.C, self.O, self.hidden, self.device = K // 9, O, hidden, w.device
        self._block = (ctypes.c_longlong * 10)(
            *(t.data_ptr() for t in ts), K // 9, O, hidden)
        self.args = ctypes.addressof(self._block)

    def __reduce__(self):
        return GateWeights, (self.w, self.m, self.bias, self.w1, self.b1, self.w2,
                             self.b2)


def gate_weights(wq2: torch.Tensor, m: torch.Tensor, bias: torch.Tensor,
                 se1: dict, se2: dict) -> GateWeights:
    """``GateWeights`` from a block's conv2 weight ``wq2`` (s8 HWIO
    ``[3, 3, C, O]``), its requant ``m`` and ``bias``, and the SE layers
    ``se1``, ``se2`` (``{"kernel": [in, out], "bias": [out]}``); a tensor
    already in the kernel's type and layout is used as it is."""
    C, O = wq2.shape[2], wq2.shape[3]
    ts = (wq2.to(torch.int8).reshape(9 * C, O), m.float(), bias.float(),
          se1["kernel"].to(torch.bfloat16), se1["bias"].to(torch.bfloat16),
          se2["kernel"].to(torch.bfloat16), se2["bias"].to(torch.bfloat16))
    return GateWeights(*(t.contiguous() for t in ts))


def se_gate(taps: torch.Tensor, hw: int, weights: GateWeights) -> torch.Tensor:
    """The gate ``[B, O]`` bf16 (module docstring)."""
    C, O, hidden = weights.C, weights.O, weights.hidden
    if not (1 <= C <= MAX_WIDTH and O % 4 == 0 and 4 <= O <= MAX_WIDTH
            and 1 <= hidden <= MAX_HIDDEN):
        raise ValueError(f"se_gate takes C from 1 to {MAX_WIDTH} channels, O a "
                         f"multiple of 4 from 4 to {MAX_WIDTH} and a hidden width "
                         f"from 1 to {MAX_HIDDEN}, got C={C}, O={O}, hidden={hidden}")
    dev = taps.get_device()
    if dev < 0:
        raise ValueError(f"se_gate takes CUDA tap sums, got them on {taps.device}")
    if dev != weights.device.index or dev != torch.cuda.current_device():
        raise ValueError(f"se_gate: tap sums on cuda:{dev}, weights on "
                         f"{weights.device}, current CUDA device "
                         f"{torch.cuda.current_device()}")
    shape = taps.shape
    if (taps.dtype != torch.int32 or len(shape) != 3 or shape[1] != 9
            or shape[2] != C or not taps.is_contiguous()):
        raise ValueError(f"se_gate takes contiguous i32 tap sums [B, 9, {C}], got "
                         f"{taps.dtype} {tuple(shape)}")
    gate = taps.new_empty((shape[0], O), dtype=torch.bfloat16)
    fn = _fns or _bind()
    code = fn.run(taps.data_ptr(), weights.args, gate.data_ptr(), shape[0], hw,
                  _build.stream_of(taps))
    if code:
        _build.check(fn.lib, code, "se_gate")
    se_gate.launches += 1
    return gate


se_gate.launches = 0
_fns = None  # the C entry point, bound at the first launch


def _bind():
    """Build and load the source and declare its entry point, once."""
    global _fns
    if _fns is None:
        from types import SimpleNamespace

        lib = _build.load("se_gate")
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        run = lib.az_se_gate
        run.argtypes = [p, p, p, ll, ll, p]
        run.restype = ctypes.c_int
        _fns = SimpleNamespace(lib=lib, run=run)
    return _fns
