"""int8 inference trunk for the SE-ResNet (counterpart of
``alphazero_tpu/models/quant.py``, same function names).

Turns a trained ``AZResNet`` into a quantised inference function:

  * BN is folded into the convs (``models/resnet.fold_batch_norm``),
  * trunk 3x3 conv weights are quantised per output channel to int8,
  * activations are quantised per layer with symmetric scales calibrated
    from sample observations (maxima, or an abs-percentile),
  * each conv runs s8 x s8 -> s32 through the hand-written ``ops.s8_mm``
    product (the 3x3 conv as an im2col matrix), followed by an f32 requant
    epilogue (scale, bias, ReLU, round); on the card the trunk's epilogues,
    with the residual add, the SE scale and the gate's tap sums, are one
    hand-written pass each (``ops.int8_epilogue``), and each block's SE
    gate is one hand-written launch (``ops.se_gate``),
  * SE gating, residual adds and the dense head layers stay bf16.

Layouts are the JAX package's, so its quantised parameters carry across
unchanged (``models/convert.quant_params_from_jax``): activations NHWC,
conv weights HWIO, dense kernels [in, out]; the ``[9 * C_in, O]`` matrix of
a conv is a reshape of its HWIO weight in ``(ky, kx, c)`` order.

``fp`` and ``qp`` are plain nested dicts of tensors on one device.  No
function here is differentiated; the public evaluators run under
``torch.no_grad``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from alphazero_tpu_torch.models.resnet import (
    AZResNet, fold_batch_norm, make_inference_eval_fn, require_se_block,
)
from alphazero_tpu_torch.ops.int8_epilogue import int8_epilogue
from alphazero_tpu_torch.ops.s8_mm import s8_mm
from alphazero_tpu_torch.ops.se_gate import gate_weights, se_gate
from alphazero_tpu_torch.utils import telemetry

BF16 = torch.bfloat16


# --------------------------------------------------------------------------
# Folded-parameter extraction

def extract_folded(model: AZResNet) -> Dict[str, Any]:
    """Fold BN and pull the conv/dense weights out of the module into the
    flat dict the executors below consume.  Works for ``norm="batch"``
    (folds first) and ``norm="none"`` (already folded) models."""
    cfg = model.cfg
    require_se_block(cfg, "the int8 executor and the ONNX export")
    if cfg.norm == "batch":
        model = fold_batch_norm(model)
    elif cfg.norm != "none":
        raise ValueError("int8 path needs a batch- or none-norm model")

    def conv(m):  # OIHW -> HWIO
        return {"kernel": m.weight.detach().float().permute(2, 3, 1, 0).contiguous(),
                "bias": m.bias.detach().float().clone()}

    def dense(m):  # [out, in] -> [in, out]
        return {"kernel": m.weight.detach().float().t().contiguous(),
                "bias": m.bias.detach().float().clone()}

    blocks = [{"conv1": conv(b.conv1), "conv2": conv(b.conv2),
               "se1": dense(b.se.fc1), "se2": dense(b.se.fc2)}
              for b in model.blocks]
    return {
        "stem": conv(model.stem),
        "blocks": blocks,
        "policy_conv": conv(model.policy_conv),
        "policy_dense": dense(model.policy_fc),
        "value_conv": conv(model.value_conv),
        "value_dense1": dense(model.value_fc1),
        "value_dense2": dense(model.value_fc2),
        "num_blocks": cfg.num_blocks,
    }


# --------------------------------------------------------------------------
# bf16 reference executor (also the calibration pass)

def _conv_bf16(x, w):
    """3x3 SAME conv of NHWC ``x`` with an HWIO kernel, in bf16."""
    k = w["kernel"].to(BF16).permute(3, 2, 0, 1)  # OIHW view
    y = F.conv2d(x.to(BF16).permute(0, 3, 1, 2), k, padding="same")
    return y.permute(0, 2, 3, 1) + w["bias"].to(BF16)


def _conv1x1(x, w):
    return x.to(BF16) @ w["kernel"][0, 0].to(BF16) + w["bias"].to(BF16)


def _se_gate_from_mean(s, se1, se2):
    s = torch.relu(s @ se1["kernel"].to(s.dtype) + se1["bias"].to(s.dtype))
    return torch.sigmoid(s @ se2["kernel"].to(s.dtype) + se2["bias"].to(s.dtype))


def _se_gate(h, se1, se2):
    return _se_gate_from_mean(h.mean(dim=(1, 2)), se1, se2)[:, None, None, :]


def _dense_heads(fp, p, v):
    """The dense layers of both heads from the ReLU'd bf16 head-conv
    features ``p``, ``v`` [B, H, W, c] (NHWC, so the flatten needs no
    permute)."""
    logits = (p.reshape(p.shape[0], -1) @ fp["policy_dense"]["kernel"].to(BF16)
              + fp["policy_dense"]["bias"].to(BF16))
    v = v.reshape(v.shape[0], -1)
    v = torch.relu(v @ fp["value_dense1"]["kernel"].to(BF16)
                   + fp["value_dense1"]["bias"].to(BF16))
    v = (v @ fp["value_dense2"]["kernel"].to(BF16)
         + fp["value_dense2"]["bias"].to(BF16))
    return logits.float(), torch.tanh(v.float()).squeeze(-1)


def _heads(fp, x):
    """Policy/value heads in bf16 from trunk features x [B,H,W,C]."""
    return _dense_heads(fp, torch.relu(_conv1x1(x, fp["policy_conv"])),
                        torch.relu(_conv1x1(x, fp["value_conv"])))


def _abs_percentile(a: torch.Tensor, percentile: float) -> torch.Tensor:
    """``percentile`` of the flattened f32 ``a`` with linear interpolation,
    computed as ``jnp.percentile`` does in float32: the fractional index
    ``q / 100 * (n - 1)`` is formed in f32.  From a sort; ``torch.quantile``
    refuses inputs above 2**24 elements."""
    flat, _ = torch.sort(a.reshape(-1))
    n = np.float32(flat.numel())
    pos = np.float32(percentile) / np.float32(100) * (n - np.float32(1))
    lo, hi = np.floor(pos), np.ceil(pos)
    hi_w = np.float32(pos - lo)
    lo_w = np.float32(1) - hi_w
    lo_i = int(min(max(lo, 0), n - 1))
    hi_i = int(min(max(hi, 0), n - 1))
    return flat[lo_i] * float(lo_w) + flat[hi_i] * float(hi_w)


def forward_bf16(fp, obs, collect_stats: bool = False,
                 percentile: float = 0.0):
    """Folded bf16 forward (NCHW obs).  With ``collect_stats`` also returns
    the per-quant-point activation maxima used for calibration (or the
    given abs-activation ``percentile`` in (0, 100): clipping calibration,
    trades outlier range for bulk resolution)."""
    x = obs.to(BF16).permute(0, 2, 3, 1)
    stats: List[torch.Tensor] = []

    def note(t):
        if collect_stats:
            a = t.float().abs()
            stats.append(_abs_percentile(a, percentile) if percentile
                         else a.max())

    note(x)
    a = torch.relu(_conv_bf16(x, fp["stem"]))
    note(a)
    for blk in fp["blocks"]:
        h = torch.relu(_conv_bf16(a, blk["conv1"]))
        note(h)
        h2 = _conv_bf16(h, blk["conv2"])
        a = torch.relu(a + h2 * _se_gate(h2, blk["se1"], blk["se2"]))
        note(a)
    logits, value = _heads(fp, a)
    if collect_stats:
        return (logits, value), torch.stack(stats)
    return logits, value


@torch.no_grad()
def calibrate(fp, obs_batches, percentile: float = 0.0) -> torch.Tensor:
    """Max-abs activation scales at every quant point over sample
    observations (the standard static-range calibration), or, with
    ``percentile`` in (0, 100), abs-percentile scales (max across batches
    of the per-batch percentile)."""
    mx = None
    for obs in obs_batches:
        s = forward_bf16(fp, obs, collect_stats=True, percentile=percentile)[1]
        mx = s if mx is None else torch.maximum(mx, s)
    return mx.clamp(min=1e-6)


# --------------------------------------------------------------------------
# int8 executor

def quantize(fp, act_scales) -> Dict[str, Any]:
    """Build int8 weights + requant multipliers.

    ``act_scales``: [1 + 1 + 2*num_blocks] calibration maxima in graph
    order (input, stem out, then per block: mid, out)."""
    qp: Dict[str, Any] = {"blocks": []}
    dev = fp["stem"]["kernel"].device
    scales = [torch.as_tensor(s, dtype=torch.float32, device=dev)
              for s in act_scales]
    idx = 0

    def qconv(w, s_in):
        k = w["kernel"]
        sw = k.abs().amax(dim=(0, 1, 2)).clamp(min=1e-8)  # [O]
        wq = torch.round(k / sw * 127.0).clamp(-127, 127).to(torch.int8)
        # x_q = x/s_in*127, w_q = w/sw*127  =>  conv_i32 * m == conv(x, w)
        m = (s_in * sw) / (127.0 * 127.0)
        return wq, m

    s_in = scales[idx]; idx += 1
    wq, m = qconv(fp["stem"], s_in)
    s_stem = scales[idx]; idx += 1
    qp["in_scale"] = s_in
    qp["stem"] = {"wq": wq, "m": m, "bias": fp["stem"]["bias"],
                  "out_scale": s_stem}
    s_prev = s_stem
    for blk in fp["blocks"]:
        wq1, m1 = qconv(blk["conv1"], s_prev)
        s_mid = scales[idx]; idx += 1
        wq2, m2 = qconv(blk["conv2"], s_mid)
        s_out = scales[idx]; idx += 1
        qp["blocks"].append({
            "wq1": wq1, "m1": m1, "b1": blk["conv1"]["bias"],
            "mid_scale": s_mid,
            "wq2": wq2, "m2": m2, "b2": blk["conv2"]["bias"],
            "out_scale": s_out,
            "se1": blk["se1"], "se2": blk["se2"],
        })
        s_prev = s_out
    for k in ("policy_conv", "policy_dense", "value_conv", "value_dense1",
              "value_dense2"):
        qp[k] = fp[k]

    # int8 head convs (heads="int8"): 1x1 convs on the final trunk
    # activation quantised like the trunk (input scale = last block out).
    def q1x1(w, s_in):
        wq, m = qconv(w, s_in)
        return {"wq": wq, "m": m, "bias": w["bias"]}

    qp["policy_conv_q"] = q1x1(fp["policy_conv"], s_prev)
    qp["value_conv_q"] = q1x1(fp["value_conv"], s_prev)
    return qp


def _im2col(xq, kh: int, kw: int):
    """[B*H*W, kh*kw*C] matrix of the SAME-padded ``kh x kw`` patches of an
    NHWC s8 tensor, columns in ``(ky, kx, c)`` order: one zero-pad and one
    strided copy, no arithmetic.  Where C is a multiple of 4 the copy moves
    4-byte words (a third of the byte-wise copy's time on an H100).  The
    matrix's rows lie a multiple of 16 bytes apart: where ``kh*kw*C`` is none
    (the stem's 99) the result is the first columns of a wider buffer, which
    ``s8_mm`` reads in place instead of copying it to such a pitch."""
    B, H, W, C = xq.shape
    xp = F.pad(xq, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    if C % 4 == 0:
        xp = xp.view(torch.int32)
    sB, sH, sW, sC = xp.stride()
    cols = xp.as_strided((B, H, W, kh, kw, xp.shape[3]),
                         (sB, sH, sW, sH, sW, sC))
    K = kh * kw * C
    pitch = -(-K // 16) * 16
    if pitch == K:
        return cols.reshape(B * H * W, -1).view(torch.int8)
    buf = xq.new_empty((B * H * W, pitch))
    dst = buf.view(xp.dtype)[:, :K // xp.element_size()]
    dst.view(B, H, W, kh, kw, xp.shape[3]).copy_(cols)
    return buf[:, :K]


def _conv_i8(xq, wq):
    """s8 NHWC x s8 HWIO -> s32 NHWC, stride 1, SAME padding: the patches
    gathered into a matrix (data movement only), then ``s8_mm``."""
    B, H, W, C = xq.shape
    kh, kw, _, O = wq.shape
    a = xq.reshape(B * H * W, C) if kh == kw == 1 else _im2col(xq, kh, kw)
    return s8_mm(a, wq.reshape(kh * kw * C, O)).reshape(B, H, W, O)


def _tap_sums(xq):
    """[B,9,C] i32 tap sums of an s8 NHWC input: ``T[ky*3+kx]`` is the sum
    of the input cells a SAME-padded 3x3 conv tap ``(ky, kx)`` touches over
    ALL output positions.  Output position p reads input row ``p + ky - 1``,
    so tap (ky, kx) covers every cell except one border row/column.
    Integer sums are exact in any order, so this takes them in two steps
    (over rows, then over columns, each as "all", "all but the last" and
    "all but the first") instead of the JAX package's nine inclusion-
    exclusion terms: 8 launches rather than 30 on a path that the host's
    launch rate bounds."""
    rows = xq.sum(1, dtype=torch.int32)  # [B,W,C]: all input rows
    # ky=0 never reads the last input row, ky=2 never the first.
    by_ky = torch.stack([rows - xq[:, -1], rows, rows - xq[:, 0]], 1)  # [B,3,W,C]
    cols = by_ky.sum(2, dtype=torch.int32)  # [B,3,C]: all input columns
    taps = torch.stack([cols - by_ky[:, :, -1], cols, cols - by_ky[:, :, 0]], 2)
    return taps.reshape(xq.shape[0], 9, xq.shape[3])


def _se_gate_precomputed(hq, blk):
    """SE gate [B,1,1,O] computed from the QUANTISED conv2 input.

    ``mean_hw(conv2(h))`` is a linear functional of the input: with SAME
    padding it equals ``sum_taps K[tap]^T . tap_sum(h) / HW``: one small
    [B, 9C] x [9C, O] f32 contraction on exact i32 tap sums instead of a
    reduction over the materialised [B,H,W,O] conv output, so the gate does
    not wait for conv2."""
    B, H, W, C = hq.shape
    return _se_gate_from_taps(_tap_sums(hq), H * W, blk)[:, None, None, :]


def _se_gate_from_taps(taps, hw: int, blk):
    """``_se_gate_precomputed``'s gate [B,O] from the [B,9,C] i32 tap sums
    of conv2's quantised input over a board of ``hw`` cells."""
    B, _, C = taps.shape
    wq2 = blk["wq2_f32"] if "wq2_f32" in blk else blk["wq2"].float()
    wq2 = wq2.reshape(9 * C, -1)
    s = taps.float().reshape(B, 9 * C) @ wq2
    mean = (s * blk["m2"]) / hw + blk["b2"]  # == mean_hw(h2), [B,O]
    return _se_gate_from_mean(mean.to(BF16), blk["se1"], blk["se2"])


def _quant_act(a, scale, lo: float = -127.0):
    """bf16/f32 activation -> int8 with symmetric scale.  ``lo=0`` folds a
    preceding ReLU into the clip: ``_quant_act(relu(a), s)`` and
    ``_quant_act(a, s, lo=0)`` are equal bit for bit (the scale is
    positive, so a negative input rounds to a value the clip sends to 0),
    with one pass over the tensor fewer."""
    q = torch.round(a.float() * _quant_mul(scale))
    return q.clamp_(lo, 127).to(torch.int8)


def _quant_mul(scale):
    """The multiplier ``127 / scale`` of ``_quant_act``."""
    return 127.0 / scale


def _res_scale(s_prev):
    """The bf16 ``s_prev / 127`` that dequantises the int8 residual."""
    return (s_prev.float() / 127.0).to(BF16)


def _requant(acc, m, bias):
    """s32 conv accumulator -> f32 pre-activation ``acc * m + bias``.  The
    s32 -> f32 conversion happens inside the multiply (type promotion): the
    same values as ``acc.float() * m`` in one pass over the tensor."""
    return (acc * m).add_(bias)


def _epilogue_stem_plain(acc, st):
    """The stem conv's epilogue from its s32 product: ``(aq, a)``, the s8
    activation and the bf16 one it quantises (``int8_epilogue("stem")``)."""
    a = torch.relu_(_requant(acc, st["m"], st["bias"])).to(BF16)
    return _quant_act(a, st["out_scale"]), a


def _epilogue_conv1_plain(acc, blk):
    """conv1's epilogue: ``(hq, taps)``, the s8 activation (ReLU in the
    clip) and its tap sums for the SE gate (``int8_epilogue("conv1")``)."""
    hq = _quant_act(_requant(acc, blk["m1"], blk["b1"]), blk["mid_scale"],
                    lo=0.0)
    return hq, _tap_sums(hq)


def _epilogue_conv2_plain(acc, blk, g, a, aq, s_prev, residual):
    """conv2's epilogue with the SE scale ``g`` [B,O] and the residual add:
    ``(aq, a)``, the block's s8 and bf16 outputs.  The residual is the bf16
    ``a``, or with ``residual="int8"`` the s8 ``aq`` dequantised by a bf16
    ``s_prev / 127`` (``int8_epilogue("conv2")``)."""
    h2 = _requant(acc, blk["m2"], blk["b2"]).to(BF16)
    if residual == "int8":
        a = aq.to(BF16) * _res_scale(s_prev)
    a = torch.relu(a + h2 * g[:, None, None, :])
    return _quant_act(a, blk["out_scale"]), a


def _fused(acc) -> bool:
    """Whether a trunk conv's epilogue takes the kernel: on the card; each
    conv counted under the path it took."""
    telemetry.count("eval.epilogue_fused" if acc.is_cuda else "eval.epilogue_plain")
    return acc.is_cuda


def _epilogue_stem(acc, st, want_a):
    """``_epilogue_stem_plain``, or the kernel where ``_fused``; the kernel
    writes the bf16 ``a`` only where ``want_a`` (else None)."""
    if _fused(acc):
        return int8_epilogue("stem", acc, st["m"], st["bias"], st["out_qmul"],
                             want_a=want_a)
    return _epilogue_stem_plain(acc, st)


def _epilogue_conv1(acc, blk):
    if _fused(acc):
        return int8_epilogue("conv1", acc, blk["m1"], blk["b1"], blk["mid_qmul"])
    return _epilogue_conv1_plain(acc, blk)


def _epilogue_conv2(acc, blk, g, a, aq, s_prev, residual, want_a):
    """``_epilogue_conv2_plain``, or the kernel where ``_fused`` (the bf16
    ``a`` only where ``want_a``, else None)."""
    if _fused(acc):
        int8 = residual == "int8"
        return int8_epilogue("conv2", acc, blk["m2"], blk["b2"], blk["out_qmul"],
                             want_a=want_a, gate=g, residual=aq if int8 else a,
                             res_scale=blk["res_scale"] if int8 else None)
    return _epilogue_conv2_plain(acc, blk, g, a, aq, s_prev, residual)


def _gate_fused(taps) -> bool:
    """Whether a block's SE gate takes the kernel: on the card; each block
    counted under the path it took."""
    telemetry.count("eval.se_gate_fused" if taps.is_cuda else "eval.se_gate_plain")
    return taps.is_cuda


def _se_gate_block(taps, hw: int, blk):
    """``_se_gate_from_taps``, or the ``se_gate`` kernel (within a bf16 ulp
    of it) where ``_gate_fused``."""
    if _gate_fused(taps):
        return se_gate(taps, hw, blk["gate"])
    return _se_gate_from_taps(taps, hw, blk)


def _heads_int8(qp, aq):
    """Policy/value heads from the QUANTISED trunk activation: the 1x1
    head convs run s8 x s8 -> s32 with an f32 requant, so the final bf16
    trunk copy never materialises (heads="int8"; the dense layers stay
    bf16)."""
    pq, vq = qp["policy_conv_q"], qp["value_conv_q"]
    p = torch.relu_(_requant(_conv_i8(aq, pq["wq"]), pq["m"], pq["bias"]))
    v = torch.relu_(_requant(_conv_i8(aq, vq["wq"]), vq["m"], vq["bias"]))
    return _dense_heads(qp, p.to(BF16), v.to(BF16))


def forward_int8(qp, obs, residual: str = "bf16", heads: str = "bf16"):
    """Quantised forward (NCHW obs) -> (logits f32, value f32)."""
    x = obs.float().permute(0, 2, 3, 1)
    xq = _quant_act(x, qp["in_scale"]).contiguous()
    return forward_int8_from_q(qp, xq, residual, heads)


def forward_int8_from_q(qp, xq, residual: str = "bf16",
                        heads: str = "bf16"):
    """Quantised forward from pre-quantised NHWC s8 input (the chunked
    eval path quantises ONCE over the whole leaf batch before the chunk
    loop, so the obs is not re-read and permuted per chunk).

    ``residual``: "bf16" keeps a bf16 master copy of the trunk stream for
    the residual adds; "int8" carries ONLY the s8 activation between blocks
    and dequantises it (in bf16, by a bf16 scale) at the next residual
    add.

    On the card ``qp`` is the executor's (``_executor_params``): the fused
    epilogues and the SE gate's kernel read the constants it stores."""
    if residual not in ("bf16", "int8") or heads not in ("bf16", "int8"):
        raise ValueError(f"residual and heads are 'bf16' or 'int8', got "
                         f"{residual!r}, {heads!r}")
    st, blocks = qp["stem"], qp["blocks"]
    if xq.is_cuda and "out_qmul" not in st:
        raise ValueError("on the card the int8 executor takes the parameters "
                         "of _executor_params(qp)")
    # The bf16 stream is read by the next residual add (residual="bf16") and
    # by the bf16 heads after the last block; the kernel writes it only there.
    keep_a = residual == "bf16"
    last_a = heads == "bf16"
    aq, a = _epilogue_stem(_conv_i8(xq, st["wq"]), st,
                           keep_a or (last_a and not blocks))
    s_prev = st["out_scale"]
    for i, blk in enumerate(blocks):
        hq, taps = _epilogue_conv1(_conv_i8(aq, blk["wq1"]), blk)
        # Gate from tap sums of hq: it does not need conv2's output.
        g = _se_gate_block(taps, hq.shape[1] * hq.shape[2], blk)
        aq, a = _epilogue_conv2(_conv_i8(hq, blk["wq2"]), blk, g, a, aq,
                                s_prev, residual,
                                keep_a or (last_a and i == len(blocks) - 1))
        s_prev = blk["out_scale"]
    if heads == "int8":
        return _heads_int8(qp, aq)
    return _heads(qp, a)


# --------------------------------------------------------------------------
# Calibration-observation generation

def make_rollout_calib_fn(env, eval_fn, n: int = 256, plies: int = 12,
                          every: int = 4, with_params: bool = False,
                          device="cuda"):
    """Build ``calib(params, generator) -> obs`` producing MID-GAME
    observations for activation-range calibration: ``n`` games advanced
    ``plies`` policy-sampled moves with the net being calibrated,
    observations snapshotted at the start and every ``every`` plies
    (``[(1 + plies // every) * n, C, H, W]``).

    ``eval_fn(obs, to_play)`` (or ``eval_fn(params, obs, to_play)`` with
    ``with_params``) supplies the policy; pass the raw/folded forward of the
    same model.  ``generator`` is a ``torch.Generator`` on ``device``."""
    if with_params:
        param_eval = eval_fn
    else:
        def param_eval(_, obs, to_play):
            return eval_fn(obs, to_play)

    @torch.no_grad()
    def calib(params, generator: torch.Generator | None = None):
        states = env.init(n, device=device)
        snaps = [env.observation(states)]
        for ply in range(plies):
            logits, _ = param_eval(params, env.observation(states),
                                   env.to_play(states))
            legal = env.legal_mask(states)
            masked = torch.where(legal, logits.float(), -1e9)
            acts = torch.multinomial(torch.softmax(masked, -1), 1,
                                     generator=generator)[:, 0]
            states = env.step(states, acts)
            if (ply + 1) % every == 0:
                snaps.append(env.observation(states))
        return torch.cat(snaps)

    return calib


# --------------------------------------------------------------------------
# public entry

def build_quantized_params(model: AZResNet, calib_obs=None,
                           calib_percentile: float = 0.0):
    """BN-fold, calibrate and quantise ``model`` -> the flat ``qp`` dict
    the int8 executors consume, on the model's device.
    ``calib_percentile`` in (0, 100) switches from max-abs to clipping
    (percentile) calibration."""
    fp = extract_folded(model)
    dev = fp["stem"]["kernel"].device
    if calib_obs is None:
        calib_obs = [torch.zeros((8,) + _infer_obs_shape(model))]
    elif not isinstance(calib_obs, (list, tuple)):
        calib_obs = [calib_obs]
    scales = calibrate(fp, [o.to(dev) for o in calib_obs],
                       percentile=calib_percentile)
    return quantize(fp, scales)


def _executor_params(qp):
    """``qp`` with the casts the executor would repeat on every call done
    once: the SE and head weights that are consumed in bf16 stored in bf16,
    and conv2's s8 weight also in f32 for the gate's contraction (the JAX
    package leaves these to XLA's constant folding).  Rounding to bf16 once
    gives the same values as rounding at every call, and ``.to`` of a
    tensor that already has the type launches nothing.  The fused
    epilogues' constants, ``_quant_mul`` of each quantiser and the int8
    residual's ``_res_scale``, are made here by the functions the plain
    passes call, on the scales' device, so they hold the same values.  The
    SE gate's kernel reads each block's ``gate``: conv2's weight as a
    ``[9C, O]`` matrix and the SE weights in contiguous bf16
    (``ops.se_gate.gate_weights``)."""
    def bf16(d):
        return {k: v.to(BF16) for k, v in d.items()}

    out = dict(qp)
    st = qp["stem"]
    out["stem"] = dict(st, out_qmul=_quant_mul(st["out_scale"]))
    blocks, s_prev = [], st["out_scale"]
    for b in qp["blocks"]:
        se1, se2 = bf16(b["se1"]), bf16(b["se2"])
        blocks.append(dict(b, se1=se1, se2=se2, wq2_f32=b["wq2"].float(),
                           gate=gate_weights(b["wq2"], b["m2"], b["b2"], se1, se2),
                           mid_qmul=_quant_mul(b["mid_scale"]),
                           out_qmul=_quant_mul(b["out_scale"]),
                           res_scale=_res_scale(s_prev)))
        s_prev = b["out_scale"]
    out["blocks"] = blocks
    for k in ("policy_conv", "policy_dense", "value_conv", "value_dense1",
              "value_dense2"):
        out[k] = bf16(qp[k])
    return out


def _chunked_int8_eval(qp, obs, chunk, chunk_mode, residual="bf16",
                       heads="bf16"):
    # JAX's "map" is an XLA loop over the same chunks; in eager PyTorch both
    # forms are this Python loop.
    if chunk_mode not in ("unroll", "map"):
        raise ValueError(f"unknown chunk_mode {chunk_mode!r}")
    B = obs.shape[0]
    if chunk and B > chunk and B % chunk == 0:
        x = obs.float().permute(0, 2, 3, 1)
        xq = _quant_act(x, qp["in_scale"]).contiguous()
        outs = []
        for i in range(B // chunk):
            with telemetry.span("eval.chunk"):
                outs.append(forward_int8_from_q(
                    qp, xq[i * chunk:(i + 1) * chunk], residual, heads))
        return (torch.cat([a for a, _ in outs]),
                torch.cat([b for _, b in outs]))
    return forward_int8(qp, obs, residual, heads)


def make_int8_eval_params(model: AZResNet, calib_obs=None, chunk: int = 512,
                          chunk_mode: str = "unroll",
                          residual: str = "bf16", heads: str = "bf16",
                          calib_percentile: float = 0.0):
    """Params-style int8 evaluator: returns ``(eval_fn, qp)`` where
    ``eval_fn(qp, obs, to_play)`` takes the quantised parameters as an
    argument, so a weight refresh swaps ``qp`` without rebuilding the
    evaluator."""
    qp = _executor_params(
        build_quantized_params(model, calib_obs, calib_percentile))

    @torch.no_grad()
    def eval_fn(params, obs, to_play=None):
        return _chunked_int8_eval(params, obs, chunk, chunk_mode, residual,
                                  heads)

    return eval_fn, qp


def make_int8_eval_fn(model: AZResNet, calib_obs=None, chunk: int = 512,
                      chunk_mode: str = "unroll", residual: str = "bf16",
                      heads: str = "bf16", calib_percentile: float = 0.0):
    """BN-fold, calibrate and quantise ``model`` into an int8 EvalFn
    ``eval_fn(obs, to_play=None) -> (logits f32, value f32)``.

    ``calib_obs``: observation tensor(s) for activation-range calibration;
    defaults to zeros (exact for freshly initialised nets; pass real
    self-play observations for trained nets).

    ``chunk``: a batch larger than this, and a multiple of it, is quantised
    once and then evaluated ``chunk`` positions at a time.

    ``chunk_mode``: "unroll" or "map", the JAX package's two loop forms;
    in eager PyTorch both run the chunks in one Python loop."""
    qp = _executor_params(
        build_quantized_params(model, calib_obs, calib_percentile))

    @torch.no_grad()
    def eval_fn(obs, to_play=None):
        return _chunked_int8_eval(qp, obs, chunk, chunk_mode, residual, heads)

    return eval_fn


def make_production_eval_params(env, model: AZResNet, device="cuda",
                                generator: torch.Generator | None = None,
                                chunk: int | None = None,
                                residual: str | None = None,
                                calib_percentile: float | None = None):
    """The production executor of ``production.py`` for ``model``, in the
    params style of ``make_int8_eval_params``: rollout calibration
    observations from the folded net's own policy, then the int8 evaluator
    with the pinned heads and the percentile, residual and chunk given
    (``production.py``'s where None; a chunk of 0 evaluates the batch in
    one piece).  Returns ``(eval_fn, qp, calib_obs)``;
    ``eval_fn(qp, obs, to_play)``."""
    from alphazero_tpu_torch import production

    calib = make_rollout_calib_fn(
        env, make_inference_eval_fn(model), n=production.CALIB_GAMES,
        plies=production.CALIB_PLIES, every=production.CALIB_EVERY,
        device=device)(None, generator)

    def pick(value, default):
        return default if value is None else value

    eval_fn, qp = make_int8_eval_params(
        model, calib_obs=calib, chunk=pick(chunk, production.INT8_CHUNK),
        residual=pick(residual, production.INT8_RESIDUAL),
        heads=production.INT8_HEADS,
        calib_percentile=pick(calib_percentile,
                              production.INT8_CALIB_PERCENTILE))
    return eval_fn, qp, calib


def make_production_eval_fn(env, model: AZResNet, device="cuda",
                            generator: torch.Generator | None = None):
    """``make_production_eval_params`` with its parameters bound: returns
    ``(eval_fn, calib_obs)``; ``eval_fn(obs, to_play=None)``."""
    eval_fn, qp, calib = make_production_eval_params(env, model, device,
                                                     generator)
    return (lambda obs, to_play=None: eval_fn(qp, obs, to_play)), calib


def _infer_obs_shape(model: AZResNet) -> Tuple[int, int, int]:
    c_in = model.stem.weight.shape[1]
    # Board size is not recorded in the weights; assume a square board via
    # the policy dense fan-in: H*W*policy_channels.
    hw = model.policy_fc.in_features // model.cfg.policy_channels
    side = int(round(hw ** 0.5))
    return (c_in, side, side)
