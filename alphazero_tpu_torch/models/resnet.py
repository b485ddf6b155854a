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

``block="nbt"`` builds another trunk under the same heads: KataGo's
nested-bottleneck residual blocks (``NBTBlock``; ``b18c384nbt`` in KataGo's
``modelconfigs.py``), pre-activation, with global pooling in the first
inner block of every ``gpool_every``-th block and Mish.  It has no JAX
counterpart.  Its norms are BatchNorm (``norm="batch"``); the fold puts the
ones that follow an inner block's first conv into that conv (and into the
pooling's dense kernel) and keeps the others, which act on residual sums,
as per-channel ``Affine`` layers (``norm="none"``).  Its forward marks each
trunk conv, each pre-activation pass and each global pooling with a
``telemetry`` span, and counts the unfoldable pre-activations and the
poolings.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from alphazero_tpu_torch.parallel import distributed
from alphazero_tpu_torch.utils import telemetry

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
    # The trunk's block: "se" (the SE-ResNet) or "nbt" (``NBTBlock``, inner
    # width channels // 2, Mish); the keys below shape the "nbt" trunk alone.
    block: str = "se"
    gpool_channels: int = 64
    gpool_every: int = 3  # blocks gpool_every, 2 * gpool_every, ... pool; 0: none

    def json_fields(self) -> tuple:
        """The fields a bundle or config file holds: an "se" net's are
        JAX's ``ResNetConfig``'s, without ``NBT_KEYS``."""
        return tuple(f.name for f in dataclasses.fields(self)
                     if self.block != "se" or f.name not in NBT_KEYS)


# The keys an "se" net leaves out of its bundle, whose JSON is JAX's.
NBT_KEYS = ("block", "gpool_channels", "gpool_every")


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


def _norm_nbt(cfg: ResNetConfig, channels: int, foldable: bool) -> nn.Module:
    """An "nbt" norm: BatchNorm, or in the folded form nothing where the
    norm folds into the conv before it and a per-channel affine where it
    does not."""
    if cfg.norm == "batch":
        return BatchNorm(channels, cfg.bn_momentum)
    return Identity() if foldable else Affine(channels)


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


# --------------------------------------------------------------------------
# KataGo's nested-bottleneck trunk (block="nbt")

CONV = "eval.nbt.conv"  # span: one trunk conv
PREACT = "eval.nbt.preact"  # span: a pre-activation pass; counter: the unfoldable ones
GPOOL = "eval.nbt.gpool"  # span and counter: a global pooling and its dense layer


class Affine(nn.Module):
    """A norm on fixed statistics as its per-channel scale (``weight``) and
    shift (``bias``): the folded form of a norm that acts on a residual sum
    and has no conv to fold into."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, train: bool = False):
        return torch.addcmul(self.bias[:, None, None].to(x.dtype), x,
                             self.weight[:, None, None].to(x.dtype))


def _preact(x, h, norm: nn.Module, train: bool):
    """``(x + h, mish(norm(x + h)))``, ``h`` the residual branch still to
    add (or None): one unfoldable pre-activation and the add before it, in
    one ``PREACT`` span, counted."""
    with telemetry.span(PREACT):
        telemetry.count(PREACT)
        if h is not None:
            x = x + h
        return x, F.mish(norm(x, train))


def _conv_span(m: nn.Conv2d, x, dt):
    with telemetry.span(CONV):
        return _conv(m, x, dt)


def global_pool(g: torch.Tensor) -> torch.Tensor:
    """KataGo's ``KataGPool`` over a whole board: [mean, mean * (sqrt(H *
    W) - 14) / 10, max] of each channel, [B, 3C]."""
    mean = g.mean(dim=(2, 3))
    scale = ((g.shape[2] * g.shape[3]) ** 0.5 - 14.0) / 10.0
    return torch.cat([mean, mean * scale, g.amax(dim=(2, 3))], dim=1)


class InnerBlock(nn.Module):
    """A pre-activation residual block at the bottleneck width:
    ``u + conv_b(mish(bn_b(conv_a(mish(bn_a(u))))))``.  With ``gpool``
    channels the first conv splits into ``conv_r`` (c - gpool channels) and
    ``conv_g`` (gpool channels, ``mish(bn_g(.))``, pooled over the board,
    a dense layer ``gpool_fc`` without bias added to ``conv_r``'s output as
    a per-channel bias); ``bn_b`` then follows that sum (KataGo's
    ``KataConvAndGPool``)."""

    def __init__(self, cfg: ResNetConfig, c: int, gpool: int):
        super().__init__()
        bias = cfg.norm == "none"  # a norm folded into the conv
        self.gpool = gpool
        self.bn_a = _norm_nbt(cfg, c, foldable=False)
        if gpool:
            r = c - gpool
            self.conv_r = nn.Conv2d(c, r, 3, padding=1, bias=bias)
            self.conv_g = nn.Conv2d(c, gpool, 3, padding=1, bias=bias)
            self.bn_g = _norm_nbt(cfg, gpool, foldable=True)
            self.gpool_fc = nn.Linear(3 * gpool, r, bias=False)
        else:
            r = c
            self.conv_a = nn.Conv2d(c, c, 3, padding=1, bias=bias)
        self.bn_b = _norm_nbt(cfg, r, foldable=True)
        self.conv_b = nn.Conv2d(r, c, 3, padding=1, bias=False)

    def forward(self, u, h, train: bool, dt):
        """``(u + h, the branch)``: the branch is left for the next
        pre-activation to add."""
        u, a = _preact(u, h, self.bn_a, train)
        if self.gpool:
            t = _conv_span(self.conv_r, a, dt)
            g = _conv_span(self.conv_g, a, dt)
            with telemetry.span(PREACT):
                g = F.mish(self.bn_g(g, train))
            with telemetry.span(GPOOL):
                telemetry.count(GPOOL)
                p = F.linear(global_pool(g), self.gpool_fc.weight.to(dt))
                t = t + p[:, :, None, None]
        else:
            t = _conv_span(self.conv_a, a, dt)
        with telemetry.span(PREACT):
            t = F.mish(self.bn_b(t, train))
        return u, _conv_span(self.conv_b, t, dt)


class NBTBlock(nn.Module):
    """KataGo's nested-bottleneck residual block (``NestedBottleneckResBlock``
    of its ``model_pytorch.py``): ``x + conv_q(mish(post_bn(R2(R1(conv_p(
    mish(pre_bn(x))))))))``, 1x1 convs from and to the trunk width, two
    ``InnerBlock``s at half of it, the first pooling where ``gpool``."""

    def __init__(self, cfg: ResNetConfig, gpool: int):
        super().__init__()
        c = cfg.channels
        m = c // 2
        self.pre_bn = _norm_nbt(cfg, c, foldable=False)
        self.conv_p = nn.Conv2d(c, m, 1, bias=False)
        self.inner = nn.ModuleList([InnerBlock(cfg, m, gpool),
                                    InnerBlock(cfg, m, 0)])
        self.post_bn = _norm_nbt(cfg, m, foldable=False)
        self.conv_q = nn.Conv2d(m, c, 1, bias=False)

    def forward(self, x, h, train: bool, dt):
        """``(x + h, the branch)``, as ``InnerBlock.forward``."""
        x, a = _preact(x, h, self.pre_bn, train)
        u, g = _conv_span(self.conv_p, a, dt), None
        for blk in self.inner:
            u, g = blk(u, g, train, dt)
        _, a = _preact(u, g, self.post_bn, train)
        return x, _conv_span(self.conv_q, a, dt)


def _gpool_width(cfg: ResNetConfig, k: int) -> int:
    """The pooling channels of block ``k`` (0-based): blocks
    ``gpool_every``, ``2 * gpool_every``, ... (1-based) pool."""
    every = cfg.gpool_every
    return cfg.gpool_channels if every and (k + 1) % every == 0 else 0


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
        elif isinstance(m, (BatchNorm, GroupNorm, Affine)):
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
        if cfg.block == "nbt":
            if cfg.norm not in ("batch", "none"):
                raise ValueError(f"block 'nbt' needs norm 'batch' or 'none', not {cfg.norm!r}")
            self.stem = nn.Conv2d(cin, c, 3, padding=1, bias=False)
            self.blocks = nn.ModuleList(NBTBlock(cfg, _gpool_width(cfg, k))
                                        for k in range(cfg.num_blocks))
            self.final_bn = _norm_nbt(cfg, c, foldable=False)
        elif cfg.block == "se":
            self.stem = nn.Conv2d(cin, c, 3, padding=1, bias=cfg.norm == "none")
            self.stem_bn = _norm(cfg)
            self.blocks = nn.ModuleList(ResBlock(cfg) for _ in range(cfg.num_blocks))
        else:
            raise ValueError(f"unknown block {cfg.block!r}")
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
        if self.cfg.block == "nbt":
            x, h = _conv_span(self.stem, x, dt), None
            for blk in self.blocks:
                x, h = blk(x, h, train, dt)
            _, x = _preact(x, h, self.final_bn, train)
        else:
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


def _bn_affine(bn: nn.BatchNorm2d):
    """(scale, shift) of a BatchNorm on its running statistics."""
    s = bn.weight / torch.sqrt(bn.running_var + BN_EPS)
    return s, bn.bias - bn.running_mean * s


def _fold(conv: nn.Conv2d, bn: nn.BatchNorm2d) -> nn.Conv2d:
    s, b = _bn_affine(bn)
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
    if model.cfg.block == "nbt":
        return _fold_nbt(folded)
    folded.stem = _fold(model.stem, model.stem_bn)
    folded.stem_bn = Identity()
    for blk, src in zip(folded.blocks, model.blocks):
        blk.conv1, blk.bn1 = _fold(src.conv1, src.bn1), Identity()
        blk.conv2, blk.bn2 = _fold(src.conv2, src.bn2), Identity()
    return folded.eval()


def _affine(bn: nn.BatchNorm2d) -> Affine:
    out = Affine(bn.num_features).to(bn.weight.device)
    out.weight.data, out.bias.data = (t.detach().clone() for t in _bn_affine(bn))
    return out


def _fold_nbt(folded: AZResNet) -> AZResNet:
    """The "nbt" fold, in place on a copy: ``bn_b`` into the first conv of
    each inner block (``conv_a``, or ``conv_r`` and ``gpool_fc``), ``bn_g``
    into ``conv_g``; the norms on residual sums (``pre_bn``, ``bn_a``,
    ``post_bn``, ``final_bn``) become ``Affine``."""
    for blk in folded.blocks:
        blk.pre_bn, blk.post_bn = _affine(blk.pre_bn), _affine(blk.post_bn)
        for inner in blk.inner:
            inner.bn_a = _affine(inner.bn_a)
            if inner.gpool:
                s, _ = _bn_affine(inner.bn_b)
                inner.conv_r = _fold(inner.conv_r, inner.bn_b)
                inner.conv_g, inner.bn_g = _fold(inner.conv_g, inner.bn_g), Identity()
                inner.gpool_fc.weight.data = inner.gpool_fc.weight.data * s[:, None]
            else:
                inner.conv_a = _fold(inner.conv_a, inner.bn_b)
            inner.bn_b = Identity()
    folded.final_bn = _affine(folded.final_bn)
    return folded.eval()


def require_se_block(cfg: ResNetConfig, what: str) -> None:
    """Refuse a net whose trunk is not the SE-ResNet's: ``what`` (the int8
    executor, the exports) runs only that trunk."""
    if cfg.block != "se":
        raise ValueError(f"{what} runs the SE-ResNet trunk only, not block "
                         f"{cfg.block!r} (KataGo's nested bottleneck)")


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
