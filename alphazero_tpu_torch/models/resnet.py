"""SE-ResNet policy/value network (counterpart of
``alphazero_tpu/models/resnet.py``).

``AZResNet`` takes NCHW observation planes like the JAX model and keeps its
structure: a 3x3 stem, ``num_blocks`` residual blocks (two 3x3 convs, SE
gate, residual add), a policy head (1x1 conv -> dense) and a value head
(1x1 conv -> dense -> dense -> tanh).  flax flattens the head features in
NHWC order, so the heads permute to NHWC before flattening and the dense
weights carry over unchanged.

``forward(obs, train=False)`` runs in the parameters' dtype (cast the
module, as ``make_inference_eval_fn`` does, for bf16), BatchNorm on its
running statistics; ``forward(obs, dtype=cfg.dtype)`` runs it under
flax's dtype policy below, as JAX's ``model.apply(variables, obs)`` does
(``make_raw_eval_fn``).  ``forward(obs, train=True)`` follows flax's dtype
policy for ``dtype=cfg.dtype, param_dtype=float32``: the parameters stay
float32 master weights, every conv and dense layer computes in ``cfg.dtype``
from cast inputs and weights, the norms compute their statistics and affine
in float32 and cast back, and BatchNorm updates its running statistics as
flax does, with the *biased* batch variance (torch's ``BatchNorm2d`` uses
the unbiased one).  Which mode runs is the ``train`` argument alone;
torch's ``Module.train()``/``eval()`` flag plays no part.

``norm="batch"`` holds BatchNorm layers (eps 1e-5, as in flax);
``fold_batch_norm`` folds them into the conv weights, giving the
``norm="none"`` inference form that self-play runs.  ``norm="group"`` holds
GroupNorm layers (eps 1e-6, as in flax; torch's default is 1e-5).
``reset_parameters`` draws flax's initial distributions, with the policy
dense kernel and the last value dense kernel at zero, so a fresh net gives
uniform logits and value 0.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from alphazero_tpu_torch.parallel import distributed

BN_EPS = 1e-5  # flax nn.BatchNorm default
GN_EPS = 1e-6  # flax nn.GroupNorm default
# flax's truncated-normal variance scaling divides the std by the std of a
# standard normal truncated to [-2, 2], so the draws have variance 1/fan_in.
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    num_blocks: int = 6
    channels: int = 64
    se_ratio: int = 4
    policy_channels: int = 32
    value_channels: int = 32
    value_hidden: int = 256
    norm: str = "batch"  # "batch" | "group" | "none"
    group_size: int = 32
    bn_momentum: float = 0.9
    dtype: torch.dtype = torch.bfloat16


class Identity(nn.Identity):
    """The ``norm="none"`` (folded) layer."""

    def forward(self, x, train: bool = False):
        return x


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm over NCHW with flax's statistics.  ``momentum`` is flax's
    (the running average keeps ``momentum`` of its old value).  Under a
    process group of several ranks, train mode averages the per-channel
    mean and mean of squares over the ranks before the variance and the
    running statistics (a differentiable all-reduce), so every rank
    normalises by the global batch's statistics."""

    def __init__(self, channels: int, momentum: float):
        super().__init__(channels, eps=BN_EPS, momentum=1.0 - momentum)
        self.flax_momentum = momentum

    def forward(self, x, train: bool = False):
        if not train:
            # In float32 and cast back, as flax's ``dtype=float32`` layer.
            y = F.batch_norm(x.float(), self.running_mean.float(),
                             self.running_var.float(), self.weight.float(),
                             self.bias.float(), False, 0.0, self.eps)
            return y.to(x.dtype)
        x32 = x.float()
        mean = x32.mean((0, 2, 3))
        sq = (x32 * x32).mean((0, 2, 3))
        n = distributed.world_size()
        if n > 1:
            # The global batch's moments, as GSPMD gives the JAX learner:
            # each rank holds an equal share of the batch.
            mean, sq = distributed.all_sum(torch.stack([mean, sq])) / n
        var = (sq - mean * mean).clamp(min=0.0)
        with torch.no_grad():
            m = self.flax_momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(x.dtype)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` over NCHW: statistics over each group's
    channels and the board, computed in float32."""

    def __init__(self, channels: int, num_groups: int):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, train: bool = False):
        B, C, H, W = x.shape
        G = self.num_groups
        g = x.float().reshape(B, G, C // G, H, W)
        mean = g.mean((2, 3, 4))
        var = ((g * g).mean((2, 3, 4)) - mean * mean).clamp(min=0.0)
        mean_c = mean.repeat_interleave(C // G, 1)[:, :, None, None]
        var_c = var.repeat_interleave(C // G, 1)[:, :, None, None]
        mul = torch.rsqrt(var_c + GN_EPS) * self.weight[:, None, None]
        y = (x.float() - mean_c) * mul + self.bias[:, None, None]
        return y.to(x.dtype)


def _norm(cfg: ResNetConfig) -> nn.Module:
    if cfg.norm == "batch":
        return BatchNorm(cfg.channels, cfg.bn_momentum)
    if cfg.norm == "group":
        return GroupNorm(cfg.channels, max(1, cfg.channels // cfg.group_size))
    if cfg.norm == "none":
        return Identity()
    raise ValueError(f"unknown norm {cfg.norm!r}")


def _conv(m: nn.Conv2d, x, dt):
    bias = None if m.bias is None else m.bias.to(dt)
    return F.conv2d(x, m.weight.to(dt), bias, padding=m.padding)


def _dense(m: nn.Linear, x, dt):
    return F.linear(x, m.weight.to(dt), m.bias.to(dt))


class SEBlock(nn.Module):
    def __init__(self, channels: int, ratio: int):
        super().__init__()
        self.fc1 = nn.Linear(channels, channels // ratio)
        self.fc2 = nn.Linear(channels // ratio, channels)

    def forward(self, x, dt):  # [B, C, H, W]
        s = x.mean(dim=(2, 3))
        g = torch.sigmoid(_dense(self.fc2, torch.relu(_dense(self.fc1, s, dt)), dt))
        return x * g[:, :, None, None]


class ResBlock(nn.Module):
    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        c, bias = cfg.channels, cfg.norm == "none"
        self.conv1 = nn.Conv2d(c, c, 3, padding=1, bias=bias)
        self.bn1 = _norm(cfg)
        self.conv2 = nn.Conv2d(c, c, 3, padding=1, bias=bias)
        self.bn2 = _norm(cfg)
        self.se = SEBlock(c, cfg.se_ratio)

    def forward(self, x, train: bool, dt):
        h = torch.relu(self.bn1(_conv(self.conv1, x, dt), train))
        h = self.se(self.bn2(_conv(self.conv2, h, dt), train), dt)
        return torch.relu(x + h)


@torch.no_grad()
def flax_init_(module: nn.Module, generator: torch.Generator | None = None):
    """flax's initial distributions for every layer of ``module``, in
    place: conv and dense kernels lecun-normal (a normal truncated at two
    standard deviations, variance 1/fan_in), every bias 0, norm scales 1,
    BN running mean 0 and variance 1."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            std = (1.0 / m.weight[0].numel()) ** 0.5 / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (BatchNorm, GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, BatchNorm):
                m.reset_running_stats()


class AZResNet(nn.Module):
    """(logits f32 [B, A], value f32 [B]) from obs [B, C, H, W]."""

    def __init__(self, num_actions: int, cfg: ResNetConfig = ResNetConfig(),
                 obs_shape: Tuple[int, int, int] = (11, 15, 15),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_actions = num_actions
        self.cfg = cfg
        self.obs_shape = tuple(obs_shape)
        cin, h, w = self.obs_shape
        c = cfg.channels
        self.stem = nn.Conv2d(cin, c, 3, padding=1, bias=cfg.norm == "none")
        self.stem_bn = _norm(cfg)
        self.blocks = nn.ModuleList(ResBlock(cfg) for _ in range(cfg.num_blocks))
        self.policy_conv = nn.Conv2d(c, cfg.policy_channels, 1)
        self.policy_fc = nn.Linear(cfg.policy_channels * h * w, num_actions)
        self.value_conv = nn.Conv2d(c, cfg.value_channels, 1)
        self.value_fc1 = nn.Linear(cfg.value_channels * h * w, cfg.value_hidden)
        self.value_fc2 = nn.Linear(cfg.value_hidden, 1)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's initial distributions (``flax_init_``), with the policy
        dense kernel and the last value dense kernel 0 (a fan-in init there
        saturates the value tanh within tens of Adam steps)."""
        flax_init_(self, generator)
        self.policy_fc.weight.zero_()
        self.value_fc2.weight.zero_()

    def forward(self, obs: torch.Tensor, train: bool = False,
                dtype: torch.dtype | None = None):
        """``dtype``: the convs' and dense layers' compute dtype (default
        ``cfg.dtype`` in train mode, the weights' dtype in eval mode)."""
        dt = dtype or (self.cfg.dtype if train else self.stem.weight.dtype)
        x = obs.to(dt)
        x = torch.relu(self.stem_bn(_conv(self.stem, x, dt), train))
        for blk in self.blocks:
            x = blk(x, train, dt)
        p = torch.relu(_conv(self.policy_conv, x, dt))
        p = p.permute(0, 2, 3, 1).reshape(p.shape[0], -1)  # flax NHWC order
        logits = _dense(self.policy_fc, p, dt)
        v = torch.relu(_conv(self.value_conv, x, dt))
        v = v.permute(0, 2, 3, 1).reshape(v.shape[0], -1)
        v = _dense(self.value_fc2, torch.relu(_dense(self.value_fc1, v, dt)), dt)
        value = torch.tanh(v.float()).squeeze(-1)
        return logits.float(), value


def _fold(conv: nn.Conv2d, bn: nn.BatchNorm2d) -> nn.Conv2d:
    s = bn.weight / torch.sqrt(bn.running_var + BN_EPS)
    b = bn.bias - bn.running_mean * s
    out = nn.Conv2d(conv.in_channels, conv.out_channels, conv.kernel_size,
                    padding=conv.padding, bias=True)
    out.weight.data = conv.weight.data * s[:, None, None, None]  # OIHW
    out.bias.data = b.detach().clone()
    return out.to(conv.weight.device)


@torch.no_grad()
def fold_batch_norm(model: AZResNet) -> AZResNet:
    """A ``norm="none"`` copy of a ``norm="batch"`` model with every BN
    folded into its conv: W' = W * s[out], b' = beta - mean * s,
    s = gamma / sqrt(var + eps)."""
    if model.cfg.norm != "batch":
        raise ValueError("fold_batch_norm needs a norm='batch' model")
    folded = copy.deepcopy(model)
    folded.cfg = dataclasses.replace(model.cfg, norm="none")
    folded.stem = _fold(model.stem, model.stem_bn)
    folded.stem_bn = Identity()
    for blk, src in zip(folded.blocks, model.blocks):
        blk.conv1, blk.bn1 = _fold(src.conv1, src.bn1), Identity()
        blk.conv2, blk.bn2 = _fold(src.conv2, src.bn2), Identity()
    return folded.eval()


def make_eval_fn(model: nn.Module):
    """Close the model into the search's EvalFn signature."""

    @torch.no_grad()
    def eval_fn(obs, to_play=None):
        return model(obs)

    return eval_fn


def make_raw_eval_fn(model: AZResNet):
    """The raw net in eval mode as JAX's ``model.apply(variables, obs)``
    runs it (the evaluator of JAX's ``tools/train_flagship.py`` and
    ``tools/train_demo.py`` arenas): the float32 master weights cast to
    ``cfg.dtype`` for every conv and dense layer, BatchNorm's running
    statistics and affine in float32.  Neither the folded net (BN folded
    into bf16 weights and biases) nor ``forward``'s eval default (float32
    throughout for float32 weights) is that net."""

    @torch.no_grad()
    def eval_fn(obs, to_play=None):
        return model(obs, dtype=model.cfg.dtype)

    return eval_fn


def make_inference_eval_fn(model: AZResNet, dtype: torch.dtype | None = None):
    """BN-fold when applicable, cast to ``dtype`` (default ``cfg.dtype``)
    and return the eval fn: the self-play fast path."""
    if model.cfg.norm == "batch":
        model = fold_batch_norm(model)
    else:
        model = copy.deepcopy(model).eval()
    model = model.to(dtype or model.cfg.dtype)
    return make_eval_fn(model)
