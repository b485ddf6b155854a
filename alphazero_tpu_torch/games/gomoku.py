"""Gomoku over a leading batch axis (counterpart of
``alphazero_tpu/games/gomoku.py``): freestyle, the Renju and Omok
forbidden-move variants and the pro-long opening.

A state is a ``GomokuState`` of tensors that all share the batch axis B.
``step`` on a terminal lane is a no-op, as in the JAX env: the batched
search steps every lane every simulation.  The board stays ``int8``; the
search arena stores it as plain ``int8`` rows (``arena_rows``) and reads
them back with the ``gather_rows`` kernel, with no bit-packing.

Forbidden points are window arithmetic over whole [B, N, N] planes
(zero-filled shifts, window sums, covers), for every empty cell at once, as
in the JAX env; Renju's allowed-double-three resolution is the same bounded
fixed point of ``_RENJU_REFINE_PASSES`` passes.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from alphazero_tpu_torch.core import zobrist
from alphazero_tpu_torch.core.types import (
    GameType, result_from_winner, where_lanes,
)

_DIRS = ((0, 1), (1, 0), (1, 1), (1, -1))
# 8 half-directions (the 4 lines, then their negations) x distances 1..5:
# the 40 cells step()'s win check samples around the placed stone.
_HALF_DIRS = _DIRS + tuple((-dr, -dc) for dr, dc in _DIRS)
_LINE_DR = np.array([[i * dr for i in range(1, 6)] for dr, _ in _HALF_DIRS],
                    np.int64)
_LINE_DC = np.array([[i * dc for i in range(1, 6)] for _, dc in _HALF_DIRS],
                    np.int64)

# Bounded fixed-point passes standing in for the reference's depth-3
# recursive double-three resolution (as the JAX env).
_RENJU_REFINE_PASSES = 2


def _shift_plane(x: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """out[..., r, c] = x[..., r + dr, c + dc], zero where that is off the
    board (static shifts of the last two axes)."""
    n, m = x.shape[-2:]
    out = torch.zeros_like(x)
    if abs(dr) >= n or abs(dc) >= m:
        return out
    out[..., max(0, -dr):n - max(0, dr), max(0, -dc):m - max(0, dc)] = \
        x[..., max(0, dr):n + min(0, dr), max(0, dc):m + min(0, dc)]
    return out


def _consecutive_counts(plane: torch.Tensor, dr: int, dc: int, cap: int) -> torch.Tensor:
    """For every cell: the number of consecutive set cells at c+d, c+2d,
    ... (c itself excluded), capped at ``cap``; int32."""
    count = torch.zeros(plane.shape, dtype=torch.int32, device=plane.device)
    run = torch.ones_like(plane, dtype=torch.bool)
    for i in range(1, cap + 1):
        run = run & _shift_plane(plane, i * dr, i * dc)
        count += run
    return count


def _run_through_maps(plane: torch.Tensor, cap: int = 5) -> torch.Tensor:
    """int32 [4, ..., N, N]: per direction, the length of the longest run of
    ``plane`` through each cell if a stone were placed there."""
    return torch.stack([
        _consecutive_counts(plane, dr, dc, cap)
        + _consecutive_counts(plane, -dr, -dc, cap) + 1
        for dr, dc in _DIRS])


def _window_sum(plane: torch.Tensor, dr: int, dc: int, k: int) -> torch.Tensor:
    """out[s] = the sum of ``plane`` over cells s, s+d, ..., s+(k-1)d; int32."""
    acc = plane.to(torch.int32)
    for i in range(1, k):
        acc = acc + _shift_plane(plane, i * dr, i * dc)
    return acc


def _covers(window_pred: torch.Tensor, dr: int, dc: int, offsets) -> torch.Tensor:
    """bool map of the cells s + i*d (i in ``offsets``) of every window whose
    start cell s satisfies ``window_pred``."""
    out = torch.zeros_like(window_pred)
    for i in offsets:
        out = out | _shift_plane(window_pred, -i * dr, -i * dc)
    return out


@functools.lru_cache(maxsize=None)
def _line_offsets(device: str):
    """(dr, dc) int64 [8, 5] on ``device``, made once per device."""
    return (torch.from_numpy(_LINE_DR).to(device),
            torch.from_numpy(_LINE_DC).to(device))


# Arena meta row layout (int32): to_play, last_moves[2, 3], move_count,
# terminal, winner, hash k0, hash k1.
META_WIDTH = 12


@dataclasses.dataclass
class GomokuState:
    board: torch.Tensor  # int8 [B, n, n]: -1 empty, 0 black, 1 white
    to_play: torch.Tensor  # int32 [B]
    last_moves: torch.Tensor  # int32 [B, 2, 3] most-recent-first, -1 none
    move_count: torch.Tensor  # int32 [B]
    terminal: torch.Tensor  # bool [B]
    winner: torch.Tensor  # int32 [B]: -1 none/draw, 0 black, 1 white
    hash: torch.Tensor  # int64 [B]: k0 << 32 | k1

    @property
    def batch_size(self) -> int:
        return self.board.shape[0]

    @property
    def device(self) -> torch.device:
        return self.board.device

    def map(self, fn) -> "GomokuState":
        return GomokuState(**{f.name: fn(getattr(self, f.name))
                              for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class GomokuEnv:
    board_size: int = 15
    use_renju: bool = False
    use_omok: bool = False
    use_pro_long_opening: bool = False

    game_type: GameType = GameType.GOMOKU

    @property
    def num_actions(self) -> int:
        return self.board_size * self.board_size

    @property
    def observation_shape(self) -> Tuple[int, int, int]:
        return (11, self.board_size, self.board_size)

    @functools.cached_property
    def zobrist(self) -> zobrist.ZobristTable:
        return zobrist.ZobristTable(num_pieces=2, num_positions=self.num_actions)

    # ---- lifecycle -------------------------------------------------------

    def init(self, batch_size: int, device="cuda") -> GomokuState:
        n, B = self.board_size, batch_size
        dev = torch.device(device)
        i32 = dict(dtype=torch.int32, device=dev)
        return GomokuState(
            board=torch.full((B, n, n), -1, dtype=torch.int8, device=dev),
            to_play=torch.zeros(B, **i32),
            last_moves=torch.full((B, 2, 3), -1, **i32),
            move_count=torch.zeros(B, **i32),
            terminal=torch.zeros(B, dtype=torch.bool, device=dev),
            winner=torch.full((B,), -1, **i32),
            hash=self.zobrist.player(dev)[0].expand(B).clone(),
        )

    def step(self, state: GomokuState, action: torch.Tensor) -> GomokuState:
        """Place a stone at flat ``action`` [B] for every lane; terminal
        lanes are left as they are.  A win can only pass through the placed
        stone, so only the 40 line cells around it are sampled."""
        n, B, dev = self.board_size, state.batch_size, state.device
        # A terminal lane may carry a placeholder action (the search passes
        # -1 for walkers stopped on a terminal node); clamp it so indexing
        # stays in bounds; such lanes keep their old state below.
        action = action.to(torch.int64).clamp(0, self.num_actions - 1)
        r, c = action // n, action % n
        player = state.to_play

        dr, dc = _line_offsets(str(dev))
        rr = r[:, None, None] + dr  # [B, 8, 5]
        cc = c[:, None, None] + dc
        valid = (rr >= 0) & (rr < n) & (cc >= 0) & (cc < n)
        idx = torch.where(valid, rr * n + cc, 0).reshape(B, 40)
        flat = state.board.reshape(B, n * n)
        cells = torch.gather(flat, 1, idx).reshape(B, 8, 5)
        samples = (cells == player.to(torch.int8)[:, None, None]) & valid
        consec = torch.cumprod(samples.to(torch.int32), dim=2).sum(dim=2)
        run_here = consec[:, :4] + consec[:, 4:] + 1  # [B, 4]
        if self.use_renju or self.use_omok:
            # Black wins on an exact five only, white on five or more.
            win = torch.where(player == 0, (run_here == 5).any(dim=1),
                              (run_here >= 5).any(dim=1))
        else:
            win = (run_here >= 5).any(dim=1)

        new_count = state.move_count + 1
        terminal = win | (new_count >= self.num_actions)
        winner = torch.where(win, player, -1).to(torch.int32)

        board = flat.clone()
        board.scatter_(1, action[:, None], player.to(torch.int8)[:, None])

        lm = state.last_moves
        prev_row = torch.where((player == 0)[:, None], lm[:, 0], lm[:, 1])
        new_row = torch.cat([action.to(torch.int32)[:, None], prev_row[:, :2]], 1)
        mine = torch.arange(2, device=dev)[None, :] == player[:, None]  # [B, 2]
        last = torch.where(mine[:, :, None], new_row[:, None, :], lm)

        piece = self.zobrist.piece(dev)  # [2, S]
        pkeys = self.zobrist.player(dev)  # [2]
        p = player.long()
        new_hash = (state.hash ^ piece[p, action] ^ pkeys[p] ^ pkeys[1 - p])

        new_state = GomokuState(
            board=board.reshape(B, n, n),
            to_play=(1 - player).to(torch.int32),
            last_moves=last.to(torch.int32),
            move_count=new_count.to(torch.int32),
            terminal=terminal,
            winner=winner,
            hash=new_hash,
        )
        return where_lanes(state.terminal, state, new_state)

    # ---- legality and observations ---------------------------------------

    def legal_mask(self, state: GomokuState) -> torch.Tensor:
        """bool [B, A]: empty cells of live games, minus the variant's
        forbidden points where black is to move (a forbidden point that
        makes an exact five stays legal), and under the pro-long opening
        the center alone at move 0 and cells at Chebyshev distance >= 3
        from it at move 2."""
        B = state.batch_size
        empty = (state.board == -1).reshape(B, -1)
        legal = empty & ~state.terminal[:, None]

        if self.use_renju or self.use_omok:
            forbidden, five = self.forbidden_map(state.board == 0,
                                                 state.board == 1)
            black_legal = legal & (~forbidden | five).reshape(B, -1)
            legal = torch.where((state.to_play == 0)[:, None], black_legal, legal)

        if self.use_pro_long_opening:
            n = self.board_size
            idx = torch.arange(self.num_actions, device=state.device)
            cheb = torch.maximum((idx // n - n // 2).abs(), (idx % n - n // 2).abs())
            first = legal & (cheb == 0)
            third = legal & (cheb >= 3)
            mc = state.move_count[:, None]
            legal = torch.where(mc == 0, first, torch.where(mc == 2, third, legal))
        return legal

    def _three_maps(self, black, white, empty, forbidden_prev=None):
        """Per direction, where a black stone on an empty cell makes an open
        three: a 6-window [empty, mid4, empty] whose mid4 holds 2 blacks, the
        candidate and one empty completion cell, and no white.  With
        ``forbidden_prev`` (Renju refinement) a window whose completion cell
        is a forbidden empty does not count."""
        maps = []
        fbad = None if forbidden_prev is None else (empty & forbidden_prev).to(torch.int32)
        for dr, dc in _DIRS:
            mid4_b = _shift_plane(_window_sum(black, dr, dc, 4), dr, dc)
            mid4_w = _shift_plane(_window_sum(white, dr, dc, 4), dr, dc)
            ends = empty & _shift_plane(empty, 5 * dr, 5 * dc)
            base = ends & (mid4_b == 2) & (mid4_w == 0)
            if fbad is None:
                three = _covers(base, dr, dc, range(1, 5)) & empty
            else:
                mid4_bad = _shift_plane(_window_sum(fbad, dr, dc, 4), dr, dc)
                three = torch.zeros_like(black)
                for i in range(1, 5):
                    bad_at_p = _shift_plane(fbad, i * dr, i * dc)
                    ok = base & (mid4_bad - bad_at_p <= 0)
                    three = three | _shift_plane(ok, -i * dr, -i * dc)
                three = three & empty
            maps.append(three)
        return maps  # 4 x bool [B, N, N]

    def _four_counts(self, black, white, empty):
        """Per direction, the fours a black stone on each empty cell makes:
        fully in-bounds 5-windows with 4 blacks and one empty after the
        placement, no white, and no black just outside either end (its
        completion would be an overline); the two windows of a straight
        four count as one."""
        counts = []
        ones = torch.ones_like(black)
        for dr, dc in _DIRS:
            b5 = _window_sum(black, dr, dc, 5)
            w5 = _window_sum(white, dr, dc, 5)
            in5 = _window_sum(ones, dr, dc, 5) == 5
            b_before = _shift_plane(black, -dr, -dc)
            b_after = _shift_plane(black, 5 * dr, 5 * dc)
            four_window = (b5 == 3) & (w5 == 0) & in5 & ~b_before & ~b_after
            cnt = _window_sum(four_window, -dr, -dc, 5)
            mid4_b = _shift_plane(_window_sum(black, dr, dc, 4), dr, dc)
            mid4_w = _shift_plane(_window_sum(white, dr, dc, 4), dr, dc)
            ends = empty & _shift_plane(empty, 5 * dr, 5 * dc)
            s4_window = ends & (mid4_b == 3) & (mid4_w == 0)
            s4 = _covers(s4_window, dr, dc, range(1, 5)) & empty
            cnt = torch.where(s4, cnt - 1, cnt)
            counts.append(torch.where(empty, cnt, 0))
        return counts  # 4 x int32 [B, N, N]

    def forbidden_map(self, black: torch.Tensor, white: torch.Tensor):
        """(forbidden, exact_five), bool [B, N, N] each: black's forbidden
        points at every empty cell, and where a black stone makes an exact
        five.  Renju: overline, double four, double three (with the
        allowed-double-three refinement); Omok: overline and strict double
        three.  Callers keep a five legal (``forbidden & ~five``)."""
        empty = ~(black | white)
        runs = _run_through_maps(black, cap=6)
        five = (runs == 5).any(dim=0) & empty
        overline = (runs >= 6).any(dim=0) & empty

        n_threes = sum(t.to(torch.int32) for t in self._three_maps(black, white, empty))
        double_three = n_threes >= 2
        if self.use_omok and not self.use_renju:
            return (overline | double_three) & empty, five

        double_four = sum(self._four_counts(black, white, empty)) >= 2
        forbidden = (overline | double_four | double_three) & empty
        for _ in range(_RENJU_REFINE_PASSES):
            threes = self._three_maps(black, white, empty, forbidden_prev=forbidden)
            n_threes = sum(t.to(torch.int32) for t in threes)
            forbidden = (overline | double_four | (n_threes >= 2)) & empty
        return forbidden, five

    def observation_basic(self, state: GomokuState) -> torch.Tensor:
        """The basic planes (me, opp, black to move): bf16 [B, 3, n, n]."""
        return self.observation(state)[:, :3]

    def observation(self, state: GomokuState) -> torch.Tensor:
        """bf16 [B, 11, n, n]: me, opp, black-to-move, 3x previous black
        moves one-hot, 3x previous white moves one-hot, 2x CoordConv."""
        dt = torch.bfloat16
        n, B, dev = self.board_size, state.batch_size, state.device
        tp = state.to_play.to(torch.int8)[:, None, None]
        me = (state.board == tp).to(dt)
        opp = (state.board == 1 - tp).to(dt)
        black = (state.to_play == 0).to(dt)[:, None, None].expand(B, n, n)
        cells = torch.arange(n * n, device=dev)
        lm = state.last_moves.reshape(B, 6, 1)
        prev = ((cells[None, None, :] == lm) & (lm >= 0)).to(dt)
        prev = prev.reshape(B, 6, n, n)
        coord = torch.arange(n, dtype=dt, device=dev) / (n - 1)
        cx = coord[:, None].expand(n, n)
        cy = coord[None, :].expand(n, n)
        coords = torch.stack([cx, cy])[None].expand(B, 2, n, n)
        return torch.cat([torch.stack([me, opp, black], 1), prev, coords], 1)

    # ---- search arena rows -----------------------------------------------

    def arena_rows(self, state: GomokuState):
        """(board int8 [B, S], meta int32 [B, META_WIDTH]): the rows the
        search arena stores per node."""
        B = state.batch_size
        k0, k1 = zobrist.split_key(state.hash)
        meta = torch.cat([
            state.to_play[:, None],
            state.last_moves.reshape(B, 6),
            state.move_count[:, None],
            state.terminal.to(torch.int32)[:, None],
            state.winner[:, None],
            k0.to(torch.int32)[:, None],
            k1.to(torch.int32)[:, None],
        ], dim=1).to(torch.int32)
        return state.board.reshape(B, -1), meta

    def from_arena_rows(self, board: torch.Tensor, meta: torch.Tensor) -> GomokuState:
        n = self.board_size
        B = board.shape[0]
        k0 = meta[:, 10].long() & 0xFFFFFFFF
        k1 = meta[:, 11].long() & 0xFFFFFFFF
        return GomokuState(
            board=board.reshape(B, n, n),
            to_play=meta[:, 0].contiguous(),
            last_moves=meta[:, 1:7].reshape(B, 2, 3).contiguous(),
            move_count=meta[:, 7].contiguous(),
            terminal=meta[:, 8] != 0,
            winner=meta[:, 9].contiguous(),
            hash=(k0 << 32) | k1,
        )

    # ---- accessors -------------------------------------------------------

    def terminal_flag(self, state: GomokuState) -> torch.Tensor:
        return state.terminal

    def result(self, state: GomokuState) -> torch.Tensor:
        return result_from_winner(state.winner, state.terminal)

    def to_play(self, state: GomokuState) -> torch.Tensor:
        return state.to_play

    def winner(self, state: GomokuState) -> torch.Tensor:
        return state.winner

    def position_hash(self, state: GomokuState) -> torch.Tensor:
        """int64 [B] situational Zobrist key (board + side to move)."""
        return state.hash
