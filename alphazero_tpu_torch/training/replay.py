"""Replay ring with dihedral augmentation (counterpart of
``alphazero_tpu/training/replay.py``).

The ring stores compact env states (the batched state dataclass itself,
every field with a leading capacity axis) plus the (pi, z) targets on the
device, and regenerates observations with ``env.observation`` when it
samples.  Augmentation applies one of the 8 board symmetries to each
sample: ``rot90``/``flip`` on the planes, grouped by symmetry, and a static
index permutation of the policy that leaves trailing non-spatial actions
(Go's pass) where they are.  Chess has no board symmetry (pawns move one
way, castling belongs to one side, and its 4,672 actions are 73 move types
a from-square), so its samples are never augmented (``has_dihedral``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from alphazero_tpu_torch.core.types import GameType


@dataclasses.dataclass
class ReplayBuffer:
    states: Any  # env state dataclass, fields [capacity, ...]
    policy: torch.Tensor  # f32 [capacity, A]
    value: torch.Tensor  # f32 [capacity]
    position: int = 0  # next write slot
    size: int = 0  # valid entries

    @property
    def capacity(self) -> int:
        return self.policy.shape[0]


def create(env, capacity: int, num_actions: int, device="cuda") -> ReplayBuffer:
    proto = env.init(1, device=device)
    return ReplayBuffer(
        states=proto.map(lambda x: torch.zeros((capacity,) + x.shape[1:],
                                               dtype=x.dtype, device=x.device)),
        policy=torch.zeros((capacity, num_actions), dtype=torch.float32,
                           device=device),
        value=torch.zeros((capacity,), dtype=torch.float32, device=device),
    )


def add(buffer: ReplayBuffer, states, policy, value, mask) -> ReplayBuffer:
    """Append the rows of ``states``/``policy``/``value`` (leading axis n)
    that ``mask`` [n] selects, in order, at ``position`` with wrap-around;
    only those rows are written.  Updates ``buffer`` in place and returns
    it.  Where more than ``capacity`` rows are valid, the later ones win, as
    they would writing one after another."""
    cap = buffer.capacity
    order = torch.argsort((~mask).to(torch.int8), stable=True)  # valid first
    n_valid = int(mask.sum())
    keep = min(n_valid, cap)
    rows = order[n_valid - keep:n_valid]
    slots = (buffer.position + (n_valid - keep)
             + torch.arange(keep, device=rows.device)) % cap

    pairs = [(getattr(buffer.states, f.name), getattr(states, f.name))
             for f in dataclasses.fields(buffer.states)]
    for dst, src in pairs + [(buffer.policy, policy), (buffer.value, value)]:
        dst[slots] = src[rows].to(dst.dtype)
    buffer.position = (buffer.position + n_valid) % cap
    buffer.size = min(buffer.size + n_valid, cap)
    return buffer


class Batch(NamedTuple):
    obs: torch.Tensor  # [B, C, H, W]
    policy: torch.Tensor  # f32 [B, A]
    value: torch.Tensor  # f32 [B]


@functools.lru_cache(maxsize=None)
def _dihedral_policy_perms(board_size: int, extra_actions: int = 0) -> np.ndarray:
    """[8, A] int32 permutation table of the 8 board symmetries, identity
    on trailing non-spatial actions.  Symmetry k = 2 * rot + flip applied
    to a policy p: p_aug[i] = p[perm[k, i]]."""
    n = board_size
    grid = np.arange(n * n).reshape(n, n)
    perms = []
    for k in range(4):
        rot = np.rot90(grid, k)
        for flip in (False, True):
            g = np.fliplr(rot) if flip else rot
            # g[r, c] = original index now displayed at (r, c)
            perms.append(g.reshape(-1).astype(np.int32))
    perms = np.stack(perms)  # [8, n*n]
    if extra_actions:
        tail = np.tile(n * n + np.arange(extra_actions, dtype=np.int32), (8, 1))
        perms = np.concatenate([perms, tail], axis=1)
    return perms


def augment(obs: torch.Tensor, policy: torch.Tensor, syms: torch.Tensor,
            board_size: int):
    """Apply symmetry ``syms[b]`` in [0, 8) to sample b of ``obs``
    [B, C, H, W] and ``policy`` [B, A]: k = 2 * rot + flip is ``rot``
    quarter turns of the board, then a left-right flip."""
    extra = policy.shape[-1] - board_size * board_size
    perms = torch.from_numpy(_dihedral_policy_perms(board_size, extra))
    perms = perms.to(policy.device).long()
    pol_aug = torch.gather(policy, 1, perms[syms.long()])
    obs_aug = torch.empty_like(obs)
    order = torch.argsort(syms, stable=True)
    counts = torch.bincount(syms.long(), minlength=8).tolist()
    for k, group in enumerate(torch.split(order, counts)):
        if not counts[k]:
            continue
        rot, flip = divmod(k, 2)
        o = torch.rot90(obs[group], rot, dims=(2, 3))
        obs_aug[group] = o.flip(3) if flip else o
    return obs_aug, pol_aug


def has_dihedral(env) -> bool:
    """Whether the 8 board symmetries map the env's positions and policies
    onto equivalent ones: Gomoku and Go, not chess.  (The JAX sampler
    augments chess too: it turns the planes and permutes only policy
    entries 0-63, the 73 move types of square a1.)"""
    return env.game_type != GameType.CHESS


def sample(buffer: ReplayBuffer, env, generator: Optional[torch.Generator],
           batch_size: int, augment_symmetries: bool = True,
           idx: Optional[torch.Tensor] = None,
           syms: Optional[torch.Tensor] = None) -> Batch:
    """Uniform sample with observation regeneration and a random symmetry
    per sample.  ``idx`` [B] and ``syms`` [B], where given, replace the
    draws (tests use them to match the JAX sampler).  Envs without board
    symmetry (``has_dihedral``) are sampled as stored."""
    dev = buffer.policy.device
    if idx is None:
        idx = torch.randint(0, max(buffer.size, 1), (batch_size,),
                            generator=generator, device=dev)
    idx = idx.to(dev).long()
    obs = env.observation(buffer.states.map(lambda x: x[idx]))
    policy = buffer.policy[idx]
    value = buffer.value[idx]
    if augment_symmetries and has_dihedral(env):
        if syms is None:
            syms = torch.randint(0, 8, (batch_size,), generator=generator,
                                 device=dev)
        obs, policy = augment(obs, policy, syms.to(dev), env.board_size)
    return Batch(obs=obs, policy=policy, value=value)
