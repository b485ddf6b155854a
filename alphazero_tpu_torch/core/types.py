"""Core types shared across the port (counterpart of
``alphazero_tpu/core/types.py``).

Games are batched: every state field has a leading batch axis and every env
function works on the whole batch at once (the JAX package writes unbatched
functions and ``vmap``s them).
"""
from __future__ import annotations

import dataclasses
import enum

import torch


class GameType(enum.IntEnum):
    UNKNOWN = 0
    GOMOKU = 1
    CHESS = 2
    GO = 3


class GameResult(enum.IntEnum):
    ONGOING = 0
    DRAW = 1
    WIN_PLAYER1 = 2
    WIN_PLAYER2 = 3


# Player encoding in states: 0 = the side that moves first, 1 = the other.
PLAYER1 = 0
PLAYER2 = 1


def to_reference_player(p: torch.Tensor) -> torch.Tensor:
    """0/1 player index -> the reference's 1/2 convention."""
    return p + 1


def result_from_winner(winner: torch.Tensor, terminal: torch.Tensor) -> torch.Tensor:
    """Map (winner in {-1 none, 0 p1, 1 p2}, terminal) to GameResult codes."""
    res = torch.full_like(winner, int(GameResult.DRAW), dtype=torch.int32)
    res = torch.where(winner == PLAYER1, int(GameResult.WIN_PLAYER1), res)
    res = torch.where(winner == PLAYER2, int(GameResult.WIN_PLAYER2), res)
    return torch.where(terminal, res, int(GameResult.ONGOING)).to(torch.int32)


def terminal_value(winner: torch.Tensor, to_play: torch.Tensor) -> torch.Tensor:
    """Value of a terminal position from the perspective of ``to_play``.

    winner: -1 = draw/none, 0 = player1, 1 = player2.
    """
    won = torch.where(winner == to_play, 1.0, -1.0)
    return torch.where(winner < 0, 0.0, won).to(torch.float32)


def where_lanes(mask: torch.Tensor, a, b):
    """Per-lane select between two batched state dataclasses: lane i of
    ``a`` where ``mask[i]``, else lane i of ``b``."""
    out = {}
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        m = mask.reshape((-1,) + (1,) * (x.dim() - 1))
        out[f.name] = torch.where(m, x, y)
    return type(a)(**out)


def stack_states(states):
    """Stack a sequence of batched state dataclasses along a new leading
    axis: fields [B, ...] -> [T, B, ...]."""
    return type(states[0])(**{
        f.name: torch.stack([getattr(s, f.name) for s in states])
        for f in dataclasses.fields(states[0])})


def cat_states(states):
    """Concatenate a sequence of batched state dataclasses along the batch
    axis."""
    return type(states[0])(**{
        f.name: torch.cat([getattr(s, f.name) for s in states])
        for f in dataclasses.fields(states[0])})
