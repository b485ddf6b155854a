"""Plain float32 forward pass of KataGo's nested-bottleneck (b18c384nbt)
policy/value net, written from its layer equations.

``A_*`` is a norm on fixed statistics, ``A(x) = (x - mean) / sqrt(var +
1e-5) * gamma + beta`` per channel; ``mish(x) = x * tanh(softplus(x))``;
convs are 'same'-padded and have no bias.

    stem:   x = conv3x3(obs)
    block:  u = conv1x1_p(mish(A_p(x)))
            u = R_1(u); u = R_2(u)
            x = x + conv1x1_q(mish(A_q(u)))
    plain inner block:
            R(u) = u + conv3x3_b(mish(A_b(conv3x3_a(mish(A_a(u))))))
    pooling inner block (R_1 where the weights hold ``conv_g``):
            a = mish(A_a(u)); r = conv3x3_r(a); g = mish(A_g(conv3x3_g(a)))
            p = [mean(g), mean(g) * (sqrt(H * W) - 14) / 10, max(g)] over the board
            R(u) = u + conv3x3_b(mish(A_b(r + W_g p)))
    trunk:  y = mish(A_f(x))
    heads:  policy dense(relu(conv1x1(y))) over the NHWC-flattened features;
            value tanh(dense(relu(dense(relu(conv1x1(y)))))).

Parameters are named as ``perfbench/weights.py`` draws them for the port's
module (``blocks.<k>.pre_bn``, ``.conv_p``, ``.inner.<i>.bn_a``, ...,
``final_bn``, ``policy_conv``, ...); the widths are read from the weights.

``forward(w, obs, num_blocks, bits=None)`` computes in float32 with TF32
off.  With ``bits`` it is the lower-precision control: every trunk conv
takes its input rounded to ``bits``-bit integers on a per-position
symmetric scale and its weight rounded to ``bits``-bit integers on a
per-output-channel symmetric scale, the rest as in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BN_EPS = 1e-5


def _norm(w, name: str, x):
    scale = w[f"{name}.weight"] / torch.sqrt(w[f"{name}.running_var"] + BN_EPS)
    shift = w[f"{name}.bias"] - w[f"{name}.running_mean"] * scale
    return x * scale[:, None, None] + shift[:, None, None]


def _mish(x):
    return x * torch.tanh(F.softplus(x))


def _fake_quant(x: torch.Tensor, dims, bits: int) -> torch.Tensor:
    qmax = 2 ** (bits - 1) - 1
    scale = x.abs().amax(dim=dims, keepdim=True).clamp(min=1e-12) / qmax
    return torch.round(x / scale).clamp(-qmax, qmax) * scale


def _conv(w, name: str, x, bits):
    weight = w[f"{name}.weight"]
    if bits:
        x = _fake_quant(x, (1, 2, 3), bits)
        weight = _fake_quant(weight, (1, 2, 3), bits)
    return F.conv2d(x, weight, padding=weight.shape[-1] // 2)


def _pool(g):
    mean = g.mean(dim=(2, 3))
    size = (g.shape[2] * g.shape[3]) ** 0.5
    return torch.cat([mean, mean * (size - 14.0) / 10.0, g.amax(dim=(2, 3))], dim=1)


def _inner(w, b: str, u, bits):
    a = _mish(_norm(w, f"{b}.bn_a", u))
    if f"{b}.conv_g.weight" in w:
        r = _conv(w, f"{b}.conv_r", a, bits)
        g = _mish(_norm(w, f"{b}.bn_g", _conv(w, f"{b}.conv_g", a, bits)))
        t = r + F.linear(_pool(g), w[f"{b}.gpool_fc.weight"])[:, :, None, None]
    else:
        t = _conv(w, f"{b}.conv_a", a, bits)
    return u + _conv(w, f"{b}.conv_b", _mish(_norm(w, f"{b}.bn_b", t)), bits)


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
        x = _conv(w, "stem", obs.float(), bits)
        for k in range(num_blocks):
            b = f"blocks.{k}"
            u = _conv(w, f"{b}.conv_p", _mish(_norm(w, f"{b}.pre_bn", x)), bits)
            u = _inner(w, f"{b}.inner.0", u, bits)
            u = _inner(w, f"{b}.inner.1", u, bits)
            x = x + _conv(w, f"{b}.conv_q", _mish(_norm(w, f"{b}.post_bn", u)), bits)
        y = _mish(_norm(w, "final_bn", x))
        p = torch.relu(F.conv2d(y, w["policy_conv.weight"], w["policy_conv.bias"]))
        logits = _dense(w, "policy_fc", _flat_nhwc(p))
        v = torch.relu(F.conv2d(y, w["value_conv.weight"], w["value_conv.bias"]))
        v = torch.relu(_dense(w, "value_fc1", _flat_nhwc(v)))
        value = torch.tanh(_dense(w, "value_fc2", v))[:, 0]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return logits, value


def forward_blocks(w: dict, obs: torch.Tensor, num_blocks: int,
                   bits: int | None = None, rows: int = 1024):
    """``forward`` in blocks of ``rows`` positions, results on the host."""
    outs = [forward(w, obs[i:i + rows], num_blocks, bits)
            for i in range(0, obs.shape[0], rows)]
    return (torch.cat([o[0].cpu() for o in outs]),
            torch.cat([o[1].cpu() for o in outs]))
