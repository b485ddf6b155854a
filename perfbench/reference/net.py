"""Plain float32 forward pass of the SE-ResNet policy/value net.

The net (AlphaZero's residual tower with squeeze-and-excitation gates):
a 3x3 stem conv, ``num_blocks`` residual blocks of two 3x3 convs with
BatchNorm on running statistics (eps 1e-5), an SE gate (global mean ->
dense -> ReLU -> dense -> sigmoid) and a residual add, then a policy head
(1x1 conv with bias -> ReLU -> dense over the NHWC-flattened features) and
a value head (1x1 conv -> ReLU -> dense -> ReLU -> dense -> tanh).
Parameters are named as ``perfbench/weights.py`` makes them.

``forward(w, obs, bits=None)`` computes in float32 with TF32 off.  With
``bits`` it is the lower-precision control: every trunk conv takes its
input rounded to ``bits``-bit integers on a per-position symmetric scale and
its BN-folded weight rounded to ``bits``-bit integers on a per-output-channel
symmetric scale, the rest as in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BN_EPS = 1e-5


def _fold(w, conv: str, bn: str):
    s = w[f"{bn}.weight"] / torch.sqrt(w[f"{bn}.running_var"] + BN_EPS)
    return (w[f"{conv}.weight"] * s[:, None, None, None],
            w[f"{bn}.bias"] - w[f"{bn}.running_mean"] * s)


def _fake_quant(x: torch.Tensor, dims, bits: int) -> torch.Tensor:
    qmax = 2 ** (bits - 1) - 1
    scale = x.abs().amax(dim=dims, keepdim=True).clamp(min=1e-12) / qmax
    return torch.round(x / scale).clamp(-qmax, qmax) * scale


def _conv_bn(w, x, conv: str, bn: str, bits):
    weight, bias = _fold(w, conv, bn)
    if bits:
        x = _fake_quant(x, (1, 2, 3), bits)
        weight = _fake_quant(weight, (1, 2, 3), bits)
    return F.conv2d(x, weight, bias, padding=weight.shape[-1] // 2)


def _dense(w, name: str, x):
    return F.linear(x, w[f"{name}.weight"], w[f"{name}.bias"])


def _flat_nhwc(x):
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


@torch.no_grad()
def forward(w: dict, obs: torch.Tensor, num_blocks: int, bits: int | None = None):
    """(logits f32 [B, A], value f32 [B]) of observations [B, C, H, W]."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        x = torch.relu(_conv_bn(w, obs.float(), "stem", "stem_bn", bits))
        for i in range(num_blocks):
            b = f"blocks.{i}"
            h = torch.relu(_conv_bn(w, x, f"{b}.conv1", f"{b}.bn1", bits))
            h = _conv_bn(w, h, f"{b}.conv2", f"{b}.bn2", bits)
            g = torch.relu(_dense(w, f"{b}.se.fc1", h.mean(dim=(2, 3))))
            g = torch.sigmoid(_dense(w, f"{b}.se.fc2", g))
            x = torch.relu(x + h * g[:, :, None, None])
        p = torch.relu(F.conv2d(x, w["policy_conv.weight"], w["policy_conv.bias"]))
        logits = _dense(w, "policy_fc", _flat_nhwc(p))
        v = torch.relu(F.conv2d(x, w["value_conv.weight"], w["value_conv.bias"]))
        v = torch.relu(_dense(w, "value_fc1", _flat_nhwc(v)))
        value = torch.tanh(_dense(w, "value_fc2", v))[:, 0]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return logits, value


def forward_blocks(w: dict, obs: torch.Tensor, num_blocks: int,
                   bits: int | None = None, rows: int = 4096):
    """``forward`` in blocks of ``rows`` positions, results on the host."""
    outs = [forward(w, obs[i:i + rows], num_blocks, bits)
            for i in range(0, obs.shape[0], rows)]
    return (torch.cat([o[0].cpu() for o in outs]),
            torch.cat([o[1].cpu() for o in outs]))
