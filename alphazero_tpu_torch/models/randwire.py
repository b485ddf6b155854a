"""DDW-RandWireResNet: the randomly wired policy/value network (counterpart
of ``alphazero_tpu/models/randwire.py``).

A 3x3 stem, ``num_blocks`` RandWire blocks and the standard heads.  Each
block is a Watts-Strogatz small-world graph over ``nodes_per_block``
SE-residual nodes, oriented from low to high index (a DAG) and run in that
topological order; a node with several predecessors merges them with a 1x1
conv over their concatenation (the router), a node with one takes it as it
is, and a node with none takes the block's input.  The block's output is
the mean of its sinks.  Block ``b``'s wiring comes from
``watts_strogatz_dag`` seeded with ``seed * 1000 + b``, on Python's
``random``, so the port's graphs are the JAX package's edge for edge.

Like the JAX module, every layer computes in ``cfg.dtype`` (bf16 by
default) from float32 parameters, the GroupNorms in float32 (flax's
policy); there is no BatchNorm, hence no folded or int8 form, and the
training and inference forward are the same function.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Tuple

import torch
from torch import nn

from alphazero_tpu_torch.models.resnet import (
    GroupNorm, SEBlock, _conv, _dense, flax_init_,
)


def watts_strogatz_dag(num_nodes: int, k: int, p: float, seed: int
                       ) -> List[Tuple[int, int]]:
    """Watts-Strogatz ring graph, rewired, then oriented low->high index
    (a DAG).  A copy of the JAX package's generator: the edges are what
    ``random.Random(seed)`` draws, in this order."""
    rng = random.Random(seed)
    edges = set()
    for i in range(num_nodes):
        for j in range(1, k // 2 + 1):
            edges.add(tuple(sorted((i, (i + j) % num_nodes))))
    rewired = set()
    for (u, v) in sorted(edges):
        if rng.random() < p:
            w = rng.randrange(num_nodes)
            tries = 0
            while (w == u or tuple(sorted((u, w))) in edges
                   or tuple(sorted((u, w))) in rewired) and tries < 16:
                w = rng.randrange(num_nodes)
                tries += 1
            if w != u:
                rewired.add(tuple(sorted((u, w))))
                continue
        rewired.add((u, v))
    return sorted({(min(u, v), max(u, v)) for (u, v) in rewired if u != v})


@dataclasses.dataclass(frozen=True)
class RandWireConfig:
    num_blocks: int = 4
    nodes_per_block: int = 8
    ws_k: int = 4
    ws_p: float = 0.75
    channels: int = 64
    se_ratio: int = 4
    policy_channels: int = 32
    value_channels: int = 32
    value_hidden: int = 256
    seed: int = 0
    dtype: torch.dtype = torch.bfloat16


def _groups(c: int) -> int:
    return max(1, c // 32)


class _Node(nn.Module):
    """SE-residual node: conv, GroupNorm, ReLU, conv, GroupNorm, SE gate,
    residual add, ReLU."""

    def __init__(self, cfg: RandWireConfig):
        super().__init__()
        c = cfg.channels
        self.conv1 = nn.Conv2d(c, c, 3, padding=1, bias=False)
        self.gn1 = GroupNorm(c, _groups(c))
        self.conv2 = nn.Conv2d(c, c, 3, padding=1, bias=False)
        self.gn2 = GroupNorm(c, _groups(c))
        self.se = SEBlock(c, cfg.se_ratio)

    def forward(self, x, dt):
        h = torch.relu(self.gn1(_conv(self.conv1, x, dt)))
        h = self.se(self.gn2(_conv(self.conv2, h, dt)), dt)
        return torch.relu(x + h)


class RandWireBlock(nn.Module):
    """One random-wire block; ``routers[str(i)]`` exists for the nodes with
    more than one predecessor."""

    def __init__(self, cfg: RandWireConfig, block_index: int):
        super().__init__()
        n, c = cfg.nodes_per_block, cfg.channels
        self.edges = watts_strogatz_dag(n, cfg.ws_k, cfg.ws_p,
                                        seed=cfg.seed * 1000 + block_index)
        self.preds: Dict[int, List[int]] = {i: [] for i in range(n)}
        for u, v in self.edges:
            self.preds[v].append(u)
        has_succ = {u for u, _ in self.edges}
        self.sinks = [i for i in range(n) if i not in has_succ] or [n - 1]
        self.routers = nn.ModuleDict({
            str(i): nn.Conv2d(c * len(p), c, 1, bias=False)
            for i, p in self.preds.items() if len(p) > 1})
        self.nodes = nn.ModuleList(_Node(cfg) for _ in range(n))

    def forward(self, x, dt):
        outs: Dict[int, torch.Tensor] = {}
        for i, node in enumerate(self.nodes):
            ins = [outs[j] for j in self.preds[i]] or [x]
            merged = (_conv(self.routers[str(i)], torch.cat(ins, 1), dt)
                      if len(ins) > 1 else ins[0])
            outs[i] = node(merged, dt)
        # Python's sum from 0, then the division: the JAX package's order.
        return sum(outs[i] for i in self.sinks) / len(self.sinks)


class DDWRandWireResNet(nn.Module):
    """(logits f32 [B, A], value f32 [B]) from obs [B, C, H, W]."""

    def __init__(self, num_actions: int, cfg: RandWireConfig = RandWireConfig(),
                 obs_shape: Tuple[int, int, int] = (11, 15, 15),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_actions = num_actions
        self.cfg = cfg
        self.obs_shape = tuple(obs_shape)
        cin, h, w = self.obs_shape
        c = cfg.channels
        self.stem = nn.Conv2d(cin, c, 3, padding=1, bias=False)
        self.stem_gn = GroupNorm(c, _groups(c))
        self.blocks = nn.ModuleList(RandWireBlock(cfg, b)
                                    for b in range(cfg.num_blocks))
        self.policy_conv = nn.Conv2d(c, cfg.policy_channels, 1)
        self.policy_fc = nn.Linear(cfg.policy_channels * h * w, num_actions)
        self.value_conv = nn.Conv2d(c, cfg.value_channels, 1)
        self.value_fc1 = nn.Linear(cfg.value_channels * h * w, cfg.value_hidden)
        self.value_fc2 = nn.Linear(cfg.value_hidden, 1)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's initial distributions, the policy dense kernel and the
        last value dense kernel 0 (as in the JAX module)."""
        flax_init_(self, generator)
        self.policy_fc.weight.zero_()
        self.value_fc2.weight.zero_()

    def forward(self, obs: torch.Tensor, train: bool = False):
        # ``train`` is accepted for the learner's call: the GroupNorm trunk
        # is the same function in both modes.
        dt = self.cfg.dtype
        x = torch.relu(self.stem_gn(_conv(self.stem, obs.to(dt), dt)))
        for blk in self.blocks:
            x = blk(x, dt)
        p = torch.relu(_conv(self.policy_conv, x, dt))
        p = p.permute(0, 2, 3, 1).reshape(p.shape[0], -1)  # flax NHWC order
        logits = _dense(self.policy_fc, p, dt)
        v = torch.relu(_conv(self.value_conv, x, dt))
        v = v.permute(0, 2, 3, 1).reshape(v.shape[0], -1)
        v = _dense(self.value_fc2, torch.relu(_dense(self.value_fc1, v, dt)), dt)
        return logits.float(), torch.tanh(v.float()).squeeze(-1)
