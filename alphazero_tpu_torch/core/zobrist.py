"""Zobrist hashing (counterpart of ``alphazero_tpu/core/zobrist.py``).

The tables are regenerated bit-identically from ``np.random.RandomState``
with the reference seed.  The JAX package keeps each 64-bit key as a
``uint32`` pair ``[k0, k1]``; torch has little ``uint32`` support, so the
port keeps each key as one ``int64`` holding ``k0 << 32 | k1`` (two's
complement: the bit pattern is what matters) and xors whole keys.

Go's hashes are additive instead (JAX's two u32 lanes, each summed mod
2**32): the port keeps each lane as an int64 in [0, 2**32) (``split_key``),
adds and subtracts lane by lane, masks with ``LANE_MASK``, and packs a key
with ``pack_lanes`` only where a whole key is wanted (a table slot).
Adding packed keys would carry the low lane into the high one.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

DEFAULT_SEED = 20240512
LANE_MASK = 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def _host_table(shape: tuple, seed: int) -> np.ndarray:
    """int64 keys of ``shape``, from the same draws as the JAX tables."""
    rng = np.random.RandomState(seed)
    pair = rng.randint(0, 2**32, size=shape + (2,), dtype=np.uint64)
    pair = pair.astype(np.uint32).astype(np.uint64)
    return ((pair[..., 0] << np.uint64(32)) | pair[..., 1]).view(np.int64)


def split_key(h: torch.Tensor):
    """int64 keys -> (k0, k1) as int64 values in [0, 2^32): the JAX pair."""
    return (h >> 32) & LANE_MASK, h & LANE_MASK


def pack_lanes(k0: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    """The inverse of ``split_key``: lanes in [0, 2^32) -> int64 keys."""
    return (k0 << 32) | k1


class ZobristTable:
    """Keys for ``num_pieces`` piece kinds over ``num_positions`` cells plus
    per-player keys and ``num_features`` feature keys; device copies are made
    once per device."""

    def __init__(self, num_pieces: int, num_positions: int,
                 num_features: int = 0, feature_cardinality: int = 64,
                 seed: int = DEFAULT_SEED):
        self._piece = _host_table((num_pieces, num_positions), seed)
        self._player = _host_table((2,), seed + 1)
        self._feature = _host_table(
            (max(num_features, 1), feature_cardinality), seed + 2
        )
        self._on_device = {}

    def _tables(self, device) -> tuple:
        key = str(torch.device(device))
        if key not in self._on_device:
            self._on_device[key] = tuple(
                torch.from_numpy(t.copy()).to(device)
                for t in (self._piece, self._player, self._feature)
            )
        return self._on_device[key]

    def piece(self, device) -> torch.Tensor:  # int64 [P, S]
        return self._tables(device)[0]

    def player(self, device) -> torch.Tensor:  # int64 [2]
        return self._tables(device)[1]

    def feature(self, device) -> torch.Tensor:  # int64 [F, C]
        return self._tables(device)[2]

    def piece_key(self, piece, pos) -> torch.Tensor:
        """The key of ``piece`` on ``pos`` (ints or tensors): int64."""
        return _lookup(self.piece, piece, pos)

    def player_key(self, player) -> torch.Tensor:
        return _lookup(self.player, player)

    def feature_key(self, feature: int, value) -> torch.Tensor:
        return _lookup(self.feature, feature, value)


def _lookup(table, *idx) -> torch.Tensor:
    """``table(device)[idx]`` on the device of the first tensor index (the
    CPU if none is a tensor)."""
    dev = next((i.device for i in idx if isinstance(i, torch.Tensor)), torch.device("cpu"))
    return table(dev)[tuple(torch.as_tensor(i, device=dev).long() for i in idx)]


def empty_hash(device="cpu") -> torch.Tensor:
    """The hash of an empty position: the int64 key 0 (JAX's pair [0, 0])."""
    return torch.zeros((), dtype=torch.int64, device=device)


def hxor(*keys: torch.Tensor) -> torch.Tensor:
    """XOR-combine int64 keys."""
    out = keys[0]
    for k in keys[1:]:
        out = out ^ k
    return out


def xor_reduce(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Bitwise-xor reduction along ``dim`` by pairwise halving."""
    x = x.movedim(dim, -1)
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
        x = x[..., 0::2] ^ x[..., 1::2]
    return x[..., 0]


def board_hash(table: ZobristTable, board: torch.Tensor,
               to_play: torch.Tensor) -> torch.Tensor:
    """Full-board hash of ``board`` int [..., S] (negative = empty, else the
    piece kind) with ``to_play`` [...]: int64 [...]."""
    piece = table.piece(board.device)
    S = board.shape[-1]
    pos = torch.arange(S, device=board.device)
    keys = piece[board.long().clamp(min=0), pos]
    keys = torch.where(board >= 0, keys, torch.zeros_like(keys))
    return xor_reduce(keys) ^ table.player(board.device)[to_play.long()]
