"""Batched Gomoku attack/defense move bonuses (counterpart of
``alphazero_tpu/ops/attack_defense.py``).

For every empty cell at once: the fours, open threes and fives a stone of
each colour would make there (the Gomoku env's window machinery), then
bonus = attack_weight * own threats + defense_weight * the opponent's.
An optional prior-shaping layer: ``policy_bias_eval_fn`` adds the bonuses
to an evaluator's logits (the ``attack_defense_64`` anchor).  Plain
PyTorch over [B, N, N] planes, as the JAX version is one XLA fusion.
"""
from __future__ import annotations

import torch

from alphazero_tpu_torch.games.gomoku import (
    _DIRS, _covers, _run_through_maps, _shift_plane, _window_sum,
)


def _threat_counts(stones: torch.Tensor, opponent: torch.Tensor):
    """(fours int32, open threes int32, fives bool), each [B, N, N]: what a
    ``stones``-colour stone makes on each empty cell (0 elsewhere)."""
    empty = ~(stones | opponent)
    fours = torch.zeros(stones.shape, dtype=torch.int32, device=stones.device)
    threes = torch.zeros_like(fours)
    for dr, dc in _DIRS:
        b5 = _window_sum(stones, dr, dc, 5)
        w5 = _window_sum(opponent, dr, dc, 5)
        four_window = (b5 == 3) & (w5 == 0)
        fours += _window_sum(four_window, -dr, -dc, 5)

        mid4_b = _shift_plane(_window_sum(stones, dr, dc, 4), dr, dc)
        mid4_w = _shift_plane(_window_sum(opponent, dr, dc, 4), dr, dc)
        ends = empty & _shift_plane(empty, 5 * dr, 5 * dc)
        three_window = ends & (mid4_b == 2) & (mid4_w == 0)
        threes += _covers(three_window, dr, dc, range(1, 5))
    wins = (_run_through_maps(stones) >= 5).any(dim=0)
    return (torch.where(empty, fours, 0), torch.where(empty, threes, 0),
            wins & empty)


def compute_bonuses(
    board: torch.Tensor,  # int8 [B, N, N]: -1 empty, 0 black, 1 white
    to_play: torch.Tensor,  # int32 [B]
    attack_weight: float = 1.0,
    defense_weight: float = 0.7,
    win_bonus: float = 10.0,
    four_weight: float = 1.0,
    three_weight: float = 0.5,
) -> torch.Tensor:
    """f32 [B, N*N]: each move's bonus for the side to move (higher is more
    urgent)."""
    tp = to_play.to(torch.int8)[:, None, None]
    me, opp = board == tp, board == 1 - tp
    my4, my3, mywin = _threat_counts(me, opp)
    op4, op3, opwin = _threat_counts(opp, me)
    attack = win_bonus * mywin.float() + four_weight * my4 + three_weight * my3
    defense = win_bonus * opwin.float() + four_weight * op4 + three_weight * op3
    return (attack_weight * attack + defense_weight * defense).reshape(board.shape[0], -1)


def policy_bias_eval_fn(base_eval_fn, board_size: int, scale: float = 0.5):
    """Wrap an evaluator to add ``scale`` times the bonuses to its policy
    logits; the board is rebuilt from observation planes 0 (the mover's
    stones) and 1 (the opponent's) and ``to_play``."""

    def eval_fn(obs, to_play):
        logits, value = base_eval_fn(obs, to_play)
        me, op = obs[:, 0] > 0.5, obs[:, 1] > 0.5
        tp = to_play.to(torch.int8)[:, None, None]
        board = torch.where(me, tp, torch.where(op, 1 - tp, torch.full_like(tp, -1)))
        return logits + scale * compute_bonuses(board, to_play), value

    return eval_fn
