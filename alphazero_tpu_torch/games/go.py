"""Go over a leading batch axis (counterpart of ``alphazero_tpu/games/go.py``):
capture, suicide ban, simple ko, the positional-superko ring, pass and
two-pass ends, area (Chinese) and territory (Japanese) scoring with komi,
dead-stone scoring, territory ownership and the 8-plane observation.

Every rule and every field is the JAX env's, bit for bit; the formulation
is the GPU's:

* Group statistics come from one labelling per board and integer scatters
  over the group ids into [M, S + 1] tables (the last column takes every
  non-stone), where JAX builds a dense [S, S] reach matrix per board and
  takes its products (the TPU has no batched scatter).  The labelling
  hooks parent pointers across the board's edges (``scatter_reduce``
  amin) and compresses them by pointer jumping, to the unique fixed
  point, tested every ``_CHECK_EVERY`` rounds (one host read each).
* The stones of a colour are the same before and after the captures a move
  makes, and so are their groups, except the captured ones, which vanish;
  the empty regions after it are those before plus each captured group.
  So ``step`` labels the board once, after the placement (stones of both
  colours and empty regions), and reuses those labels for the board after
  the captures; the colour statistics of the state it returns are kept on
  that state, where ``legal_mask`` and ``observation`` read them instead
  of labelling the same board again (the search calls all three on every
  leaf).  The labelling's fixed-point reads are the step's only host
  reads: scores come from the same labels for every lane, the winner kept
  where a game ends.
* Hashes are additive, as in JAX: two independent 32-bit lanes, each held
  as an int64 in [0, 2**32) and masked after every sum.  Only
  ``position_hash`` packs them, ``k0 << 32 | k1``, the key the search's
  table takes (``core/zobrist.py``).
* The search arena stores a state as an int8 board row and an int32 meta
  row (the scalars, both hash lanes and the superko ring), with no
  bit-packing (JAX's ``pack_for_arena`` packs f32 rows for the TPU).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from alphazero_tpu_torch.core import zobrist
from alphazero_tpu_torch.core.types import (
    GameType, result_from_winner, where_lanes,
)
from alphazero_tpu_torch.utils import telemetry

_STEPS4 = ((-1, 0), (1, 0), (0, -1), (0, 1))
# Labelling: pointer jumps a round, and rounds between two tests of the
# fixed point (one host read each): at 1,024 random-playout positions the
# stones and the empty regions of 9x9 and 19x19 boards settle in 4 rounds,
# so one test, after the fifth, sees the fixed point.
_COMPRESS = 2
_CHECK_EVERY = 5


def _shifts(x: torch.Tensor, fill) -> list:
    """For each (dr, dc) of ``_STEPS4`` the view out[..., r, c] = x[..., r +
    dr, c + dc] of one padded copy of ``x``, ``fill`` off the board (the
    last two axes are the board's)."""
    n, m = x.shape[-2:]
    xp = F.pad(x, (1, 1, 1, 1), value=fill)
    return [xp[..., 1 + dr:1 + dr + n, 1 + dc:1 + dc + m] for dr, dc in _STEPS4]


def _neighbors(x: torch.Tensor) -> torch.Tensor:
    """OR of the 4-neighbourhood of bool planes [..., N, N]."""
    up, down, left, right = _shifts(x, False)
    return up | down | left | right


@functools.lru_cache(maxsize=None)
def _edges(n: int, device: str):
    """(a, b) int64 [4 n (n - 1)]: both ends of every 4-neighbour edge of
    the N x N board, each edge in both directions."""
    idx = torch.arange(n * n, device=device).view(n, n)
    u = torch.cat([idx[:, :-1].reshape(-1), idx[:-1, :].reshape(-1)])
    v = torch.cat([idx[:, 1:].reshape(-1), idx[1:, :].reshape(-1)])
    return torch.cat([u, v]), torch.cat([v, u])


def group_labels(stones: torch.Tensor) -> torch.Tensor:
    """int64 [M, S]: for each stone of ``stones`` (bool [M, N, N]) the least
    flat index in its 4-connected group; S for a non-stone.

    Parent pointers over the cells, hooked and compressed to a fixed point:
    each round every edge between two stones lowers the parent of one end's
    parent to the other end's parent (``scatter_reduce`` amin), then
    ``_COMPRESS`` pointer jumps.  Parents only fall and stay within the
    group, so the one fixed point is every stone pointing at its group's
    least cell; it is tested every ``_CHECK_EVERY`` rounds."""
    M, n, _ = stones.shape
    S = n * n
    dev = stones.device
    a, b = _edges(n, str(dev))
    flat = stones.reshape(M, S)
    live = (flat[:, a] & flat[:, b])  # [M, E]: edges between two stones
    parent = torch.where(flat, torch.arange(S, device=dev), S)
    parent = torch.cat([parent, parent.new_full((M, 1), S)], 1)  # column S: sink

    def one_round(parent):
        pa = torch.gather(parent, 1, a.expand(M, -1))
        pb = torch.gather(parent, 1, b.expand(M, -1))
        parent = parent.scatter_reduce(1, torch.where(live, pa, S), pb, "amin")
        parent[:, S] = S
        for _ in range(_COMPRESS):
            parent = torch.gather(parent, 1, parent)
        return parent

    while True:
        for _ in range(_CHECK_EVERY - 1):
            parent = one_round(parent)
        prev, parent = parent, one_round(parent)
        with telemetry.host_sync("go.group_labels"):
            fixed = torch.equal(prev, parent)
        if fixed:
            return parent[:, :S].contiguous()


class GroupStats(NamedTuple):
    """Per-cell group quantities, flat [M, S] (JAX's ``GroupStats``; a
    non-stone cell holds the value noted)."""

    ids: torch.Tensor  # int64: least flat index of the cell's group; S
    libs: torch.Tensor  # int64: distinct empty cells next to the group; 0
    libpos: torch.Tensor  # int64: the least of them; S if none
    size: torch.Tensor  # int64: stones in the group; 0
    keysum: torch.Tensor  # int64 [M, S, 2]: the group's key sum per lane; 0


def _liberty_tables(ids: torch.Tensor, empty: torch.Tensor, n: int):
    """(libs, libpos) int64 [M, S + 1] per group id: the distinct empty
    cells next to the group and the least of them (S if none)."""
    M, S = ids.shape
    g = ids.view(M, n, n)
    seen, cols = [], []
    for cand in _shifts(g, S):
        fresh = empty.view(M, n, n) & (cand < S)
        for prev in seen:
            fresh = fresh & (cand != prev)
        seen.append(cand)
        cols.append(torch.where(fresh, cand, S).view(M, S))
    index = torch.cat(cols, 1)
    libs = torch.zeros((M, S + 1), dtype=torch.int64, device=ids.device)
    libs.scatter_add_(1, index, torch.ones_like(index))
    cell = torch.arange(S, device=ids.device).repeat(4).expand(M, -1)
    libpos = torch.full((M, S + 1), S, dtype=torch.int64, device=ids.device)
    libpos.scatter_reduce_(1, index, cell, "amin")
    libs[:, S] = 0  # the non-stones' column
    libpos[:, S] = S
    return libs, libpos


def group_stats(ids: torch.Tensor, empty: torch.Tensor, k0: torch.Tensor,
                k1: torch.Tensor, n: int) -> GroupStats:
    """``GroupStats`` of the groups labelled ``ids`` (int64 [M, S], S for a
    non-stone) on boards whose empty cells are ``empty`` (bool [M, S]);
    ``k0``/``k1`` (int64 [M, S], lanes in [0, 2**32)) are each cell's piece
    keys for the colour."""
    M, S = ids.shape
    libs_g, libpos_g = _liberty_tables(ids, empty, n)
    size_g = torch.zeros((M, S + 1), dtype=torch.int64, device=ids.device)
    size_g.scatter_add_(1, ids, torch.ones_like(ids))
    keys_g = torch.zeros((M, 2 * (S + 1)), dtype=torch.int64, device=ids.device)
    keys_g.scatter_add_(1, torch.cat([ids, ids + S + 1], 1),
                        torch.cat([k0.expand(M, S), k1.expand(M, S)], 1))
    keys_g &= zobrist.LANE_MASK
    keys_g[:, S] = 0
    keys_g[:, 2 * S + 1] = 0
    size_g[:, S] = 0

    def cell(t):
        return torch.gather(t, 1, ids)

    keysum = torch.stack([cell(keys_g[:, :S + 1]), cell(keys_g[:, S + 1:])], -1)
    return GroupStats(ids=ids, libs=cell(libs_g), libpos=cell(libpos_g),
                      size=cell(size_g), keysum=keysum)


def _select(stats: GroupStats, colour: torch.Tensor) -> GroupStats:
    """The [B, ...] stats of ``colour`` [B] from stats of both colours
    stacked [2 * B, ...] (black's lanes first)."""
    B = colour.shape[0]
    rows = colour.long() * B + torch.arange(B, device=colour.device)
    return GroupStats(*(t[rows] for t in stats))


@dataclasses.dataclass
class GoState:
    board: torch.Tensor  # int8 [B, n, n]: -1 empty, 0 black, 1 white
    to_play: torch.Tensor  # int32 [B]
    ko_point: torch.Tensor  # int32 [B] flat index, -1 = none
    consecutive_passes: torch.Tensor  # int32 [B]
    move_count: torch.Tensor  # int32 [B]
    prisoners: torch.Tensor  # int32 [B, 2]: stones captured BY player i
    terminal: torch.Tensor  # bool [B]
    winner: torch.Tensor  # int32 [B]: -1 none/draw, 0 black, 1 white
    board_hash: torch.Tensor  # int64 [B, 2] additive lanes, stones only
    history: torch.Tensor  # int64 [B, H, 2] ring of past board hashes
    last_move: torch.Tensor  # int32 [B] flat action (-1 none; N*N = pass)

    @property
    def batch_size(self) -> int:
        return self.board.shape[0]

    @property
    def device(self) -> torch.device:
        return self.board.device

    def map(self, fn) -> "GoState":
        return GoState(**{f.name: fn(getattr(self, f.name))
                          for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class GoEnv:
    """Go with ``komi``, area scoring (``chinese_rules``) or territory
    scoring, a ``history_len``-slot superko ring and at most ``max_moves``
    plies (default 2 N**2)."""

    board_size: int = 9
    komi: float = 7.5
    chinese_rules: bool = True
    history_len: int = 16
    max_moves: int | None = None

    game_type: GameType = GameType.GO

    @property
    def num_actions(self) -> int:
        return self.board_size * self.board_size + 1  # + pass

    @property
    def pass_action(self) -> int:
        return self.board_size * self.board_size

    @property
    def observation_shape(self) -> Tuple[int, int, int]:
        return (8, self.board_size, self.board_size)

    @property
    def move_limit(self) -> int:
        return self.max_moves or (2 * self.board_size * self.board_size)

    @functools.cached_property
    def zobrist(self) -> zobrist.ZobristTable:
        # Feature 0 is the ko point (S + 1 values; S = no ko), read only by
        # position_hash.
        s = self.board_size * self.board_size
        return zobrist.ZobristTable(num_pieces=2, num_positions=s,
                                    num_features=1, feature_cardinality=s + 1)

    @functools.cached_property
    def _lane_tables(self) -> dict:
        return {}

    def _lanes(self, device):
        """(piece [2, 2, S], player [2, 2], ko feature [2, S + 1]) key lanes
        on ``device``, lane first: int64 values in [0, 2**32)."""
        key = str(torch.device(device))
        if key not in self._lane_tables:
            z = self.zobrist
            self._lane_tables[key] = tuple(
                torch.stack(zobrist.split_key(t)) for t in
                (z.piece(device), z.player(device), z.feature(device)[0]))
        return self._lane_tables[key]

    # ---- lifecycle -------------------------------------------------------

    def init(self, batch_size: int, device="cuda") -> GoState:
        n, B, H = self.board_size, batch_size, self.history_len
        dev = torch.device(device)
        i32 = dict(dtype=torch.int32, device=dev)
        i64 = dict(dtype=torch.int64, device=dev)
        # Every ring slot starts at the empty board's hash (0), slot 0 as
        # the position at move 0.
        return GoState(
            board=torch.full((B, n, n), -1, dtype=torch.int8, device=dev),
            to_play=torch.zeros(B, **i32),
            ko_point=torch.full((B,), -1, **i32),
            consecutive_passes=torch.zeros(B, **i32),
            move_count=torch.zeros(B, **i32),
            prisoners=torch.zeros((B, 2), **i32),
            terminal=torch.zeros(B, dtype=torch.bool, device=dev),
            winner=torch.full((B,), -1, **i32),
            board_hash=torch.zeros((B, 2), **i64),
            history=torch.zeros((B, H, 2), **i64),
            last_move=torch.full((B,), -1, **i32),
        )

    # ---- group statistics ------------------------------------------------

    def _colour_stats(self, board: torch.Tensor, ids: torch.Tensor | None = None):
        """``GroupStats`` of black's and white's groups on ``board`` [B, n,
        n], stacked [2 * B, ...] (black first); ``ids`` are the labels
        where the caller has them."""
        n = self.board_size
        B = board.shape[0]
        S = n * n
        if ids is None:
            ids = group_labels(torch.cat([board == 0, board == 1]))
        empty = (board == -1).view(B, S).repeat(2, 1)
        keys = self._lanes(board.device)[0]  # [lane, colour, S]
        k0 = keys[0].repeat_interleave(B, 0)
        k1 = keys[1].repeat_interleave(B, 0)
        return group_stats(ids, empty, k0, k1, n)

    def _stats(self, state: GoState) -> GroupStats:
        """Both colours' stats of ``state.board``: the ones ``step`` left on
        the state where the board is still the one they were taken of."""
        kept = getattr(state, "_kept_stats", None)
        if (kept is not None and kept[0] is state.board
                and kept[1] == state.board._version):
            return kept[2]
        stats = self._colour_stats(state.board)
        _keep(state, stats)
        return stats

    # ---- step ------------------------------------------------------------

    def step(self, state: GoState, action: torch.Tensor) -> GoState:
        """Play flat ``action`` [B] (``pass_action`` passes) in every lane;
        terminal lanes are left as they are.  Legality is not checked."""
        n, B, dev = self.board_size, state.batch_size, state.device
        S = n * n
        action = action.to(torch.int32)
        mover = state.to_play
        is_pass = action >= S
        place = ~is_pass & ~state.terminal
        cell = action.long().clamp(0, S - 1)
        flat = state.board.view(B, S)
        oh = (torch.arange(S, device=dev)[None, :] == cell[:, None]) & place[:, None]
        board1 = torch.where(oh, mover.to(torch.int8)[:, None], flat)

        # One labelling of board1: black's and white's groups and the empty
        # regions.  The opponent's groups left without an empty neighbour
        # are captured (only those next to the new stone can be).
        empty1 = board1 == -1
        ids = group_labels(torch.cat([board1 == 0, board1 == 1, empty1]).view(3 * B, n, n))
        opp_ids = ids[(1 - mover).long() * B + torch.arange(B, device=dev)]
        breathing = _neighbors(empty1.view(B, n, n)).view(B, S) & (opp_ids < S)
        alive = torch.zeros((B, S + 1), dtype=torch.int64, device=dev)
        alive.scatter_add_(1, opp_ids, breathing.long())
        captured = (opp_ids < S) & (torch.gather(alive, 1, opp_ids) == 0) & place[:, None]
        with telemetry.host_sync("go.step"):  # a blocking host-to-device copy
            hole = torch.tensor(-1, dtype=torch.int8, device=dev)
        board2 = torch.where(captured, hole, board1)
        ccount = captured.sum(1)

        # Additive hash: + the placed key - the captured keys, per lane.
        keys = self._lanes(dev)[0]  # [lane, colour, S]
        me, opp = mover.long(), (1 - mover).long()
        place_k = (keys[:, me] * oh).sum(-1)  # [lane, B]
        cap_k = (keys[:, opp] * captured).sum(-1)
        new_hash = ((state.board_hash.T + place_k - cap_k)
                    & zobrist.LANE_MASK).T.contiguous()

        # The board after the captures keeps board1's groups but the
        # captured ones; its stats are the returned state's.  Its empty
        # regions are board1's plus each captured group, alone: no empty
        # cell was next to it.
        ids2 = torch.where(captured.repeat(2, 1), S, ids[:2 * B])
        stats = self._colour_stats(board2.view(B, n, n), ids2)
        regions = torch.where(captured, opp_ids, ids[2 * B:])

        # Simple ko: one stone captured by a single stone left with a
        # single liberty; the ko point is the first captured cell.
        own = mover.long() * B + torch.arange(B, device=dev)  # rows of stats
        own_size, own_libs = stats.size[own, cell], stats.libs[own, cell]
        cap_cell = torch.argmax(captured.to(torch.uint8), 1).to(torch.int32)
        ko = ~is_pass & (ccount == 1) & (own_size == 1) & (own_libs == 1)
        ko_point = torch.where(ko, cap_cell, -1)

        passes = torch.where(is_pass, state.consecutive_passes + 1, 0)
        move_count = state.move_count + 1
        terminal = (passes >= 2) | (move_count >= self.move_limit)
        mine = torch.arange(2, device=dev)[None, :] == mover[:, None]
        prisoners = state.prisoners + torch.where(mine, ccount[:, None], 0)

        # Every lane is scored, from the regions above: selecting the lanes
        # that end would cost a host read.  The winner is -1 elsewhere.
        sb, sw = self._scores(board2.view(B, n, n), prisoners, regions)
        winner = torch.where(terminal & (sb > sw), 0,
                             torch.where(terminal & (sw > sb), 1, -1)).to(torch.int32)

        slot = move_count % self.history_len
        ring = torch.arange(self.history_len, device=dev)[None, :] == slot[:, None]
        history = torch.where(ring[:, :, None], new_hash[:, None, :], state.history)

        new_state = GoState(
            board=board2.view(B, n, n),
            to_play=(1 - mover).to(torch.int32),
            ko_point=ko_point.to(torch.int32),
            consecutive_passes=passes.to(torch.int32),
            move_count=move_count.to(torch.int32),
            prisoners=prisoners.to(torch.int32),
            terminal=terminal,
            winner=winner,
            board_hash=new_hash,
            history=history,
            last_move=action,
        )
        out = where_lanes(state.terminal, state, new_state)
        # Terminal lanes placed nothing, so board2 is their board too.
        _keep(out, stats)
        return out

    # ---- legality --------------------------------------------------------

    def legal_mask(self, state: GoState) -> torch.Tensor:
        """bool [B, N*N + 1]: empty, not suicide, not the ko point, and not
        recreating a board hash of the ring (positional superko), for every
        candidate at once; pass while the game runs.  None at a terminal
        state."""
        n, B, dev = self.board_size, state.batch_size, state.device
        S = n * n
        stats = self._stats(state)
        mover = state.to_play
        opp = _select(stats, 1 - mover)
        own = _select(stats, mover)
        board = state.board
        empty = board == -1
        idx = torch.arange(S, device=dev).view(1, n, n)

        # What a stone at each cell captures: the distinct adjacent opponent
        # groups in atari whose liberty is that cell.
        ids_o = opp.ids.view(B, n, n)
        atari = (opp.libs == 1).view(B, n, n)
        libpos = opp.libpos.view(B, n, n)
        size = opp.size.view(B, n, n)
        ks = opp.keysum.view(B, n, n, 2)
        cap_count = torch.zeros((B, n, n), dtype=torch.int64, device=dev)
        cap_keys = torch.zeros((B, n, n, 2), dtype=torch.int64, device=dev)
        seen = []
        for cand, at, lp, sz, k in zip(_shifts(ids_o, S), _shifts(atari, False),
                                       _shifts(libpos, S), _shifts(size, 0),
                                       _shifts(ks.movedim(-1, 1), 0)):
            qual = (cand < S) & at & (lp == idx)
            for prev in seen:
                qual = qual & (cand != prev)
            seen.append(cand)
            cap_count += torch.where(qual, sz, 0)
            cap_keys += torch.where(qual[..., None], k.movedim(1, -1), 0)

        # Not suicide: an empty neighbour, a capture, or a neighbouring own
        # group with two liberties or more.
        roomy = ((own.ids < S) & (own.libs >= 2)).view(B, n, n)
        safe = _neighbors(empty) | (cap_count > 0) | _neighbors(roomy)

        # Positional superko: the board hash after the move and its
        # captures against every ring slot.
        place = self._lanes(dev)[0][:, mover.long()]  # [lane, B, S]
        cand = (state.board_hash.T[:, :, None] + place
                - cap_keys.view(B, S, 2).movedim(-1, 0)) & zobrist.LANE_MASK
        cand = zobrist.pack_lanes(cand[0], cand[1])  # [B, S]
        ring = zobrist.pack_lanes(state.history[..., 0], state.history[..., 1])
        repeats = (cand[:, :, None] == ring[:, None, :]).any(-1)

        ko = idx.view(1, S) == state.ko_point[:, None]
        moves = empty.view(B, S) & safe.view(B, S) & ~ko & ~repeats
        live = ~state.terminal[:, None]
        return torch.cat([moves & live, live], 1)

    # ---- scoring ---------------------------------------------------------

    def _territory(self, board: torch.Tensor, regions: torch.Tensor | None = None):
        """(black, white) territory, bool [M, n, n] each: empty regions that
        touch only that colour's stones; ``regions`` are the empty cells'
        labels where the caller has them."""
        n = self.board_size
        M, S = board.shape[0], n * n
        empty = board == -1
        ids = group_labels(empty) if regions is None else regions
        touch = []
        for colour in (0, 1):
            seed = (_neighbors(board == colour) & empty).view(M, S)
            t = torch.zeros((M, S + 1), dtype=torch.int64, device=board.device)
            t.scatter_add_(1, ids, seed.long())
            touch.append(torch.gather(t, 1, ids).view(M, n, n) > 0)
        reach_b, reach_w = touch
        return empty & reach_b & ~reach_w, empty & reach_w & ~reach_b

    def _scores(self, board: torch.Tensor, prisoners: torch.Tensor,
                regions: torch.Tensor | None = None):
        terr_b, terr_w = self._territory(board, regions)
        if self.chinese_rules:
            sb = terr_b.sum((1, 2)) + (board == 0).sum((1, 2))
            sw = terr_w.sum((1, 2)) + (board == 1).sum((1, 2))
        else:
            sb = terr_b.sum((1, 2)) + prisoners[:, 0]
            sw = terr_w.sum((1, 2)) + prisoners[:, 1]
        return sb.float(), sw.float() + self.komi

    def score(self, state: GoState, dead_stones: torch.Tensor | None = None):
        """(score_black, score_white) f32 [B]; ``dead_stones`` (bool [B, N,
        N]) are removed before the territory count and credited to the
        other side as prisoners."""
        if dead_stones is None:
            return self._scores(state.board, state.prisoners)
        board = torch.where(dead_stones, torch.tensor(-1, dtype=torch.int8,
                                                      device=state.device),
                            state.board)
        dead_black = (dead_stones & (state.board == 0)).sum((1, 2))
        dead_white = (dead_stones & (state.board == 1)).sum((1, 2))
        prisoners = state.prisoners + torch.stack([dead_white, dead_black], 1)
        return self._scores(board, prisoners)

    def territory_ownership(self, state: GoState) -> torch.Tensor:
        """int8 [B, N, N]: -1 neutral, 0 black territory, 1 white."""
        terr_b, terr_w = self._territory(state.board)
        out = torch.where(terr_w, 1, -1)
        return torch.where(terr_b, 0, out).to(torch.int8)

    # ---- observations ----------------------------------------------------

    def observation(self, state: GoState) -> torch.Tensor:
        """bf16 [B, 8, N, N]: me, opp, black-to-move, my and the opponent's
        group liberties / 10 (clipped to 1), the ko point, and the distance
        to the nearer border by rows and by columns, in bf16 arithmetic as
        JAX computes them."""
        dt = torch.bfloat16
        n, B, dev = self.board_size, state.batch_size, state.device
        S = n * n
        stats = self._stats(state)
        tp = state.to_play.to(torch.int8)[:, None, None]
        me = (state.board == tp).to(dt)
        opp = (state.board == 1 - tp).to(dt)
        black = (state.to_play == 0).to(dt)[:, None, None].expand(B, n, n)

        def lib_plane(colour):
            libs = _select(stats, colour).libs.view(B, n, n)
            return torch.clamp(libs.to(dt) / 10.0, 0.0, 1.0)

        ko = (torch.arange(S, device=dev)[None, :] == state.ko_point[:, None])
        rows = torch.arange(n, dtype=dt, device=dev)
        dist = torch.minimum(rows, rows.flip(0)) / max((n - 1) / 2, 1)
        border = torch.stack([dist[:, None].expand(n, n),
                              dist[None, :].expand(n, n)])[None].expand(B, 2, n, n)
        planes = torch.stack([me, opp, black, lib_plane(state.to_play),
                              lib_plane(1 - state.to_play),
                              ko.view(B, n, n).to(dt)], 1)
        return torch.cat([planes, border], 1)

    def observation_basic(self, state: GoState) -> torch.Tensor:
        return self.observation(state)[:, :3]

    # ---- search arena rows -----------------------------------------------

    def arena_rows(self, state: GoState):
        """(board int8 [B, S], meta int32 [B, 11 + 2 H]): the rows the search
        arena stores per node; hash lanes as their 32-bit patterns."""
        B = state.batch_size
        meta = torch.cat([
            state.to_play[:, None], state.ko_point[:, None],
            state.consecutive_passes[:, None], state.move_count[:, None],
            state.prisoners, state.terminal.to(torch.int32)[:, None],
            state.winner[:, None], state.last_move[:, None],
            state.board_hash.to(torch.int32),
            state.history.reshape(B, -1).to(torch.int32),
        ], dim=1).to(torch.int32)
        return state.board.reshape(B, -1), meta

    def from_arena_rows(self, board: torch.Tensor, meta: torch.Tensor) -> GoState:
        n, B = self.board_size, board.shape[0]
        lanes = meta[:, 9:].long() & zobrist.LANE_MASK
        return GoState(
            board=board.reshape(B, n, n),
            to_play=meta[:, 0].contiguous(),
            ko_point=meta[:, 1].contiguous(),
            consecutive_passes=meta[:, 2].contiguous(),
            move_count=meta[:, 3].contiguous(),
            prisoners=meta[:, 4:6].contiguous(),
            terminal=meta[:, 6] != 0,
            winner=meta[:, 7].contiguous(),
            last_move=meta[:, 8].contiguous(),
            board_hash=lanes[:, :2].contiguous(),
            history=lanes[:, 2:].reshape(B, self.history_len, 2),
        )

    # ---- accessors -------------------------------------------------------

    def terminal_flag(self, state: GoState) -> torch.Tensor:
        return state.terminal

    def result(self, state: GoState) -> torch.Tensor:
        return result_from_winner(state.winner, state.terminal)

    def to_play(self, state: GoState) -> torch.Tensor:
        return state.to_play

    def winner(self, state: GoState) -> torch.Tensor:
        return state.winner

    def position_hash(self, state: GoState) -> torch.Tensor:
        """int64 [B] situational key: the board hash plus the side to move's
        and the ko point's keys, lane by lane (S = no ko), packed."""
        S = self.board_size * self.board_size
        _, player, feature = self._lanes(state.device)
        ko = torch.where(state.ko_point >= 0, state.ko_point, S).long()
        h = (state.board_hash.T + player[:, state.to_play.long()]
             + feature[:, ko]) & zobrist.LANE_MASK
        return zobrist.pack_lanes(h[0], h[1])


def _keep(state: GoState, stats: GroupStats) -> None:
    """Keep ``stats`` (both colours, of ``state.board``) on ``state`` for
    as long as its board tensor is neither replaced nor written in place."""
    state._kept_stats = (state.board, state.board._version, stats)
