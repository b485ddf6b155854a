"""Chess and Chess960 over a leading batch axis (counterpart of
``alphazero_tpu/games/chess.py``): full legal move generation (castling,
Chess960 castling, en passant, promotions), check, checkmate, stalemate,
threefold repetition through a 16-slot hash ring, the 50-move rule,
insufficient material, the ply cap, and the 18-plane observation.

Every rule and every field is the JAX env's, bit for bit; the formulation
is the GPU's:

* Boards are int64 bitboards (bit s = square s = row * 8 + col), one per
  piece set and lane, where JAX shifts whole [8, 8] boolean planes.  One
  step along a displacement is a right shift, a left shift (one of the two
  by 0) and one mask of the squares whose source lies on the board; the
  mask also clears what an arithmetic right shift copies out of square 63,
  the sign bit.  The shift amounts and masks are tensors, so the 8 ray
  directions, the 18 contact attacks and the 73 move types each advance in
  one call (``_sh``).
* The legal moves of a lane are 73 bitboards, one a move type, of the
  squares the move starts from (``_legal_bits``); action = from * 73 +
  type.  The state keeps them (``ChessState.legal``, int64 [B, 73]: 584
  bytes, where JAX keeps 4,672 booleans), ``legal_mask`` expands them, and
  the search arena stores them as 146 int32 words.
* A pinned piece may move only parallel to its pin (JAX: along its pin
  line).  The two agree: every move the other conditions let through stays
  between the king and the pinner.
* Hashes are additive, as in JAX: two independent 32-bit lanes, each held
  as an int64 in [0, 2**32) and masked after every sum; 32-bit products
  (``position_hash``) are formed from 16-bit halves of the constant, so no
  int64 product overflows.
* ``step``, ``legal_mask`` and ``observation`` read nothing back to the
  host.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from alphazero_tpu_torch.core import zobrist
from alphazero_tpu_torch.core.types import (
    GameType, result_from_winner, where_lanes,
)
from alphazero_tpu_torch.games import chess_tables as T
from alphazero_tpu_torch.games.chess_tables import (
    BISHOP, KING, KNIGHT, PAWN, QUEEN, ROOK,
)

ALL = -1  # every bit of an int64 bitboard
_KNIGHT_TYPES = range(56, 64)


def _i64(u: int) -> int:
    """An unsigned 64-bit pattern as the int64 value with those bits."""
    return u - (1 << 64) if u >= 1 << 63 else u


def _squares(pred) -> int:
    """int64 bitboard of the squares (r, c) where ``pred(r, c)``."""
    return _i64(sum(1 << (r * 8 + c) for r in range(8) for c in range(8)
                    if pred(r, c)))


def _on(r, c) -> bool:
    return 0 <= r < 8 and 0 <= c < 8


def _back_shift(dr: int, dc: int):
    """(left, right, mask) that view a bitboard from the squares a
    displacement (dr, dc) starts at: out[s] = x[s + (dr, dc)], 0 where
    s + (dr, dc) is off the board."""
    sh = 8 * dr + dc
    return max(-sh, 0), max(sh, 0), _squares(lambda r, c: _on(r + dr, c + dc))


def _fwd_shift(dr: int, dc: int):
    """(left, right, mask) that move bitboard contents by (dr, dc):
    out[t] = x[t - (dr, dc)], 0 where t - (dr, dc) is off the board."""
    sh = 8 * dr + dc
    return max(sh, 0), max(-sh, 0), _squares(lambda r, c: _on(r - dr, c - dc))


def _sh(x: torch.Tensor, left, right, mask) -> torch.Tensor:
    """Shift ``x`` by (``left``, ``right``) and keep ``mask`` (broadcast)."""
    return ((x >> right) << left) & mask


def _or_reduce(x: torch.Tensor) -> torch.Tensor:
    """Bitwise OR over the last axis, by pairwise halving."""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
        x = x[..., 0::2] | x[..., 1::2]
    return x[..., 0]


def _rays(origin, empty, left, right, mask) -> torch.Tensor:
    """Squares reached from each ``origin`` bitboard along its column's
    direction, up to and including the first square not in ``empty``."""
    att = _sh(origin, left, right, mask)
    for _ in range(6):
        att = att | _sh(att & empty, left, right, mask)
    return att


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 ``a`` in [0, 2**32) and a 32-bit
    constant ``c``, from c's 16-bit halves: no product passes 2**48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & zobrist.LANE_MASK


@functools.lru_cache(maxsize=None)
def _host_tables() -> dict:
    """numpy tables of the move generator and ``step`` (int64 bitboards)."""
    t = {}
    bit = np.array([_i64(1 << s) for s in range(64)], np.int64)
    t["bit"] = bit
    # Backward views of the 73 move types, per colour: [2, 3, 73].
    back = np.zeros((2, 3, 73), np.int64)
    for c in (0, 1):
        for mt in range(73):
            back[c, :, mt] = _back_shift(*T.move_delta(mt, c))
    t["back"] = back
    fwd8 = np.array([_fwd_shift(*d) for d in T.QUEEN_DIRS], np.int64).T  # [3, 8]
    t["fwd8"] = fwd8
    # Contact attacks per colour: the colour's 2 pawn captures, the 8
    # knight jumps, the 8 king steps: [2, 3, 18].
    contact = np.zeros((2, 3, 18), np.int64)
    for c in (0, 1):
        fwd = 1 if c == 0 else -1
        deltas = [(fwd, 1), (fwd, -1)] + list(T.KNIGHT_OFFSETS) + list(T.QUEEN_DIRS)
        contact[c] = np.array([_fwd_shift(*d) for d in deltas], np.int64).T
    t["contact"] = contact
    t["contact_piece"] = np.array([PAWN] * 2 + [KNIGHT] * 8 + [KING] * 8)
    # The king's rays: 8 directions through ``empty``, the 4 diagonals
    # with the en-passant victim gone and the landing square taken, and
    # east and west with both pawns of each en-passant side gone.
    dirs = list(range(8)) + [1, 3, 5, 7] + [2, 6, 2, 6]
    t["rays_a"] = fwd8[:, list(range(8)) + dirs]  # their sliders' 8 first
    t["alt8"] = np.arange(8) % 2  # rook/queen sliders on even dirs
    # The en-passant victim (behind the landing square, per colour), and
    # the from square of a capture toward file - 1 (the pawn east of the
    # victim) and toward file + 1 (west of it).
    t["victim"] = np.array([_fwd_shift(-1, 0), _fwd_shift(1, 0)], np.int64)
    t["ep_side"] = np.array([_fwd_shift(0, 1), _fwd_shift(0, -1)], np.int64).T
    # Move classes: sliding movers (0 rook/queen, 1 bishop/queen, 2 none).
    t["cls"] = np.array([d % 2 for d in range(8) for _ in range(7)] + [2] * 17)
    # Pin filter: the two directions parallel to a type's move (8 = none,
    # the knights).
    par = np.full((2, 2, 73), 8)
    for c in (0, 1):
        for mt in range(73):
            if mt in _KNIGHT_TYPES:
                continue
            dr, dc = T.move_delta(mt, c)
            d = T.QUEEN_DIRS.index((int(np.sign(dr)), int(np.sign(dc))))
            par[c, :, mt] = (d, (d + 4) % 8)
    t["par"] = par
    # Type masks (ALL or 0): pawn push, double push and captures per
    # colour, king steps, knights, underpromotion pushes and captures.
    def mask(types):
        m = np.zeros(73, np.int64)
        m[list(types)] = ALL
        return m
    t["pawn_masks"] = np.stack([
        np.stack([mask([0]), mask([1]), mask([7, 49])]),
        np.stack([mask([28]), mask([29]), mask([21, 35])])])  # [2, 3, 73]
    t["king_mask"] = mask(range(0, 56, 7))
    t["knight_mask"] = mask(_KNIGHT_TYPES)
    t["up_push"] = mask([64, 65, 66])
    t["up_cap"] = mask(range(67, 73))
    t["dc_pos"] = np.isin(np.arange(73), [7, 21])  # pawn captures toward file + 1
    t["start_row"] = np.array([_squares(lambda r, c: r == 1),
                               _squares(lambda r, c: r == 6)], np.int64)
    t["pre_promo_row"] = t["start_row"][::-1].copy()
    # step: (drow, dcol) of each type (underpromotions: dcol only; drow is
    # the mover's forward) and the underpromotion piece.
    dr = np.zeros(73, np.int64)
    dc = np.zeros(73, np.int64)
    for mt in range(73):
        dr[mt], dc[mt] = T.move_delta(mt, 0)
    t["dr"], t["dc"] = dr, dc
    t["up_piece"] = np.array([0] * 64 + [T.UNDERPROMO_PIECES[i % 3] for i in range(9)])
    t["castle_dest"] = np.array([[6, 5], [2, 3]])  # per side: king, rook file
    return t


@functools.lru_cache(maxsize=None)
def _tables(device: str) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in _host_tables().items()}


def legal_bits_to_mask(bits: torch.Tensor) -> torch.Tensor:
    """int64 [B, 73] from-square bitboards -> bool [B, 4672] by action."""
    B = bits.shape[0]
    by = bits.contiguous().view(torch.uint8).view(B, 73, 8)  # byte k: rank k
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    m = (by[..., None] >> shifts) & 1  # [B, 73, rank, file]
    return m.view(B, 73, 64).transpose(1, 2).reshape(B, T.NUM_ACTIONS).bool()


def _default_start_board() -> np.ndarray:
    b = np.full((8, 8), -1, np.int8)
    back = [ROOK, KNIGHT, BISHOP, QUEEN, KING, BISHOP, KNIGHT, ROOK]
    for c, p in enumerate(back):
        b[0, c] = p
        b[7, c] = 6 + p
    b[1, :] = PAWN
    b[6, :] = 6 + PAWN
    return b


def chess960_back_rank(number: int) -> list:
    """Back-rank piece order for Chess960 position ``number`` in [0, 960)
    (Scharnagl numbering)."""
    if not 0 <= number < 960:
        raise ValueError("chess960 number must be in [0, 960)")
    n, b1 = divmod(number, 4)
    n, b2 = divmod(n, 4)
    n, q = divmod(n, 6)
    free = [None] * 8
    free[b1 * 2 + 1] = BISHOP
    free[b2 * 2] = BISHOP
    empties = [i for i in range(8) if free[i] is None]
    free[empties[q]] = QUEEN
    empties = [i for i in range(8) if free[i] is None]
    pairs = [(i, j) for i in range(5) for j in range(i + 1, 5)]
    ni, nj = pairs[n]
    free[empties[ni]] = KNIGHT
    free[empties[nj]] = KNIGHT
    empties = [i for i in range(8) if free[i] is None]
    free[empties[0]] = ROOK
    free[empties[1]] = KING
    free[empties[2]] = ROOK
    return free


@dataclasses.dataclass
class ChessState:
    board: torch.Tensor  # int8 [B, 8, 8]: -1 empty, else colour * 6 + type
    to_play: torch.Tensor  # int32 [B]: 0 white, 1 black
    castling: torch.Tensor  # bool [B, 2, 2]: [colour][0 kingside, 1 queenside]
    rook_start: torch.Tensor  # int32 [B, 2, 2]: castling rooks' start files
    king_start: torch.Tensor  # int32 [B, 2]: the kings' start files
    ep_square: torch.Tensor  # int32 [B]: en-passant target square, -1 none
    halfmove: torch.Tensor  # int32 [B]: 50-move-rule clock (plies)
    move_count: torch.Tensor  # int32 [B]: plies played
    terminal: torch.Tensor  # bool [B]
    winner: torch.Tensor  # int32 [B]: -1 draw/none, 0 white, 1 black
    in_check: torch.Tensor  # bool [B]: the side to move is in check
    legal: torch.Tensor  # int64 [B, 73]: from-square bitboard of each type
    hash: torch.Tensor  # int64 [B, 2] additive lanes in [0, 2**32)
    history: torch.Tensor  # int64 [B, H, 2] repetition ring of hashes
    rep_count: torch.Tensor  # int32 [B]: occurrences of the position, now incl.

    @property
    def batch_size(self) -> int:
        return self.board.shape[0]

    @property
    def device(self) -> torch.device:
        return self.board.device

    def map(self, fn) -> "ChessState":
        return ChessState(**{f.name: fn(getattr(self, f.name))
                             for f in dataclasses.fields(self)})


# Scalar fields of the arena's int32 meta row, in order; then castling (4),
# rook starts (4), king starts (2), the hash lanes (2) and the ring (2 H).
_META_SCALARS = ("to_play", "ep_square", "halfmove", "move_count", "terminal",
                 "winner", "in_check", "rep_count")


@dataclasses.dataclass(frozen=True)
class ChessEnv:
    """Chess; ``chess960_position`` selects a fixed Chess960 start (None =
    standard).  ``board_size`` is carried for the records and the CLIs
    (always 8 in play)."""

    chess960_position: Optional[int] = None
    history_len: int = 16
    max_moves: int = 512  # ply cap -> draw
    board_size: int = 8

    game_type: GameType = GameType.CHESS

    @property
    def num_actions(self) -> int:
        return T.NUM_ACTIONS

    @property
    def observation_shape(self) -> Tuple[int, int, int]:
        return (18, 8, 8)

    @functools.cached_property
    def zobrist(self) -> zobrist.ZobristTable:
        return zobrist.ZobristTable(num_pieces=12, num_positions=64,
                                    num_features=2, feature_cardinality=64)

    @functools.cached_property
    def _lane_tables(self) -> dict:
        return {}

    def _lanes(self, device):
        """(piece [2, 12 * 64], player [2, 2], feature [2, 2, 64]) key
        lanes on ``device``, lane first: int64 values in [0, 2**32)."""
        key = str(torch.device(device))
        if key not in self._lane_tables:
            z = self.zobrist
            self._lane_tables[key] = tuple(
                torch.stack(zobrist.split_key(t)) for t in
                (z.piece(device).reshape(-1), z.player(device), z.feature(device)))
        return self._lane_tables[key]

    @functools.cached_property
    def _start(self):
        if self.chess960_position is None:
            return _default_start_board(), 4, (7, 0)
        back = chess960_back_rank(self.chess960_position)
        board = np.full((8, 8), -1, np.int8)
        for c, p in enumerate(back):
            board[0, c] = p
            board[7, c] = 6 + p
        board[1, :] = PAWN
        board[6, :] = 6 + PAWN
        rook_files = [i for i, p in enumerate(back) if p == ROOK]
        return board, back.index(KING), (max(rook_files), min(rook_files))

    # ---- hashing ---------------------------------------------------------

    def _hash_board(self, board: torch.Tensor) -> torch.Tensor:
        """int64 [B, 2]: the lanes' sums of the occupied squares' keys."""
        B = board.shape[0]
        flat = board.reshape(B, 64).long()
        piece = self._lanes(board.device)[0]
        idx = flat.clamp(min=0) * 64 + torch.arange(64, device=board.device)
        k = torch.where(flat >= 0, piece[:, idx], 0)  # [2, B, 64]
        return (k.sum(-1) & zobrist.LANE_MASK).T

    def _hash_extras(self, castling, ep_square, to_play) -> torch.Tensor:
        """int64 [B, 2]: castling-rights, en-passant-file and side keys."""
        _, player, feature = self._lanes(castling.device)
        c = castling.reshape(-1, 4).long()
        code = c[:, 0] + 2 * c[:, 1] + 4 * c[:, 2] + 8 * c[:, 3]
        ep_file = torch.where(ep_square >= 0, ep_square % 8, 8).long()
        k = feature[:, 0, code] + feature[:, 1, ep_file] + player[:, to_play.long()]
        return (k & zobrist.LANE_MASK).T

    # ---- lifecycle -------------------------------------------------------

    def init(self, batch_size: int, device="cuda") -> ChessState:
        B, dev = batch_size, torch.device(device)
        board_np, king_file, rooks = self._start
        board = torch.from_numpy(board_np).to(dev).expand(B, 8, 8).contiguous()
        i32 = dict(dtype=torch.int32, device=dev)
        castling = torch.ones((B, 2, 2), dtype=torch.bool, device=dev)
        ep = torch.full((B,), -1, **i32)
        to_play = torch.zeros(B, **i32)
        h = (self._hash_board(board) + self._hash_extras(castling, ep, to_play)
             ) & zobrist.LANE_MASK
        history = torch.zeros((B, self.history_len, 2), dtype=torch.int64, device=dev)
        history[:, 0] = h
        rook_start = torch.tensor([rooks, rooks], **i32).expand(B, 2, 2).contiguous()
        king_start = torch.full((B, 2), king_file, **i32)
        legal, in_check = self._legal_bits(board, to_play, castling, rook_start,
                                           king_start, ep)
        return ChessState(
            board=board, to_play=to_play, castling=castling,
            rook_start=rook_start, king_start=king_start, ep_square=ep,
            halfmove=torch.zeros(B, **i32), move_count=torch.zeros(B, **i32),
            terminal=torch.zeros(B, dtype=torch.bool, device=dev),
            winner=torch.full((B,), -1, **i32), in_check=in_check,
            legal=legal, hash=h, history=history,
            rep_count=torch.ones(B, **i32))

    # ---- legality --------------------------------------------------------

    def legal_mask(self, state: ChessState) -> torch.Tensor:
        """bool [B, 4672]; none at a terminal state."""
        return legal_bits_to_mask(state.legal) & ~state.terminal[:, None]

    def _legal_bits(self, board, to_play, castling, rook_start, king_start,
                    ep_square):
        """(legal int64 [B, 73], in_check bool [B]) of the side to move:
        JAX's ``_legal_mask_impl`` on bitboards."""
        B, dev = board.shape[0], board.device
        tb = _tables(str(dev))
        bit = tb["bit"]
        flat = board.reshape(B, 64).long()
        codes = torch.arange(12, device=dev)
        # Piece bitboards; the bits of distinct squares sum to their union.
        P = torch.where(flat[:, None, :] == codes[None, :, None], bit, 0).sum(-1)
        P = P.view(B, 2, 6)
        white = to_play == 0
        us = to_play.long()
        them = 1 - us
        mine = torch.where(white[:, None], P[:, 0], P[:, 1])
        theirs = torch.where(white[:, None], P[:, 1], P[:, 0])
        own, enemy = mine.sum(1), theirs.sum(1)
        occ = own | enemy
        empty = ~occ
        king = mine[:, KING]
        rq = theirs[:, ROOK] | theirs[:, QUEEN]
        bq = theirs[:, BISHOP] | theirs[:, QUEEN]
        sliders = torch.stack([rq, bq], 1)[:, tb["alt8"]]  # [B, 8] per dir

        # En passant: the landing square, the victim behind it, and each
        # capture side's from square.
        ep = ep_square.long()
        ep_plane = torch.where(ep >= 0, bit[ep.clamp(min=0)], 0)
        vt = tb["victim"][us]
        ep_victim = _sh(ep_plane, vt[:, 0], vt[:, 1], vt[:, 2])
        empty_b = (empty | ep_victim) & ~ep_plane
        es = tb["ep_side"]
        frm_side = _sh(ep_victim[:, None], es[0], es[1], es[2]) & mine[:, PAWN:PAWN + 1]
        empty_a = empty[:, None] | ep_victim[:, None] | frm_side  # [B, 2]

        # Every ray of the position in one walk: their sliders' attacks
        # (through our king: x-ray), the king's rays, and the en-passant
        # discovered-check rays.
        ra = tb["rays_a"]
        origins = torch.cat([sliders, king[:, None].expand(B, 16)], 1)
        empties = torch.cat([(empty | king)[:, None].expand(B, 8),
                             empty[:, None].expand(B, 8),
                             empty_b[:, None].expand(B, 4),
                             empty_a.repeat_interleave(2, 1)], 1)
        att = _rays(origins, empties, ra[0], ra[1], ra[2])
        ct = tb["contact"][them]
        contact = _sh(theirs[:, tb["contact_piece"]], ct[:, 0], ct[:, 1], ct[:, 2])
        danger = _or_reduce(torch.cat([contact, att[:, :8]], 1))
        in_check = (king & danger) != 0

        # Checkers and the squares that answer a single check.
        kt = tb["contact"][us][:, :, :10]
        kc = _sh(king[:, None], kt[:, 0], kt[:, 1], kt[:, 2])
        pw_check = (kc[:, 0] | kc[:, 1]) & theirs[:, PAWN]
        kn_check = _or_reduce(kc[:, 2:]) & theirs[:, KNIGHT]
        contact_checkers = kn_check | pw_check
        r1 = att[:, 8:16]
        hit1 = r1 & occ[:, None]
        has_check = (hit1 & sliders) != 0
        n_checkers = (((contact_checkers[:, None] >> torch.arange(64, device=dev)) & 1).sum(1)
                      + has_check.sum(1))
        check_ray = contact_checkers | _or_reduce(torch.where(has_check, r1, 0))
        single, double = n_checkers == 1, n_checkers >= 2
        evasion = torch.where(double, 0, torch.where(single, check_ray, ALL))

        # En-passant discovered checks: a diagonal newly opened through the
        # victim's square, or the rank opened by both pawns leaving it.
        pre_bad = has_check[:, 1::2].any(1)
        hit_b = att[:, 16:20] & ~empty_b[:, None]
        bad_new = ((hit_b & bq[:, None]) != 0).any(1) & ~pre_bad
        hit_a = (att[:, 20:24] & ~empties[:, 20:24]).view(B, 2, 2)
        bad = (((hit_a[:, :, 0] | hit_a[:, :, 1]) & rq[:, None]) != 0) | bad_new[:, None]
        ep_ok = torch.where(bad, ~frm_side, ALL)  # [B, 2]: side -1, +1
        ep_resolves = single & ((ep_victim & pw_check) != 0)

        # Pins: the first own piece on a king ray with one of their sliders
        # behind it.
        blocker = hit1 & own[:, None]
        e2 = empty[:, None] | blocker
        f8 = tb["fwd8"]
        r2 = _rays(king[:, None].expand(B, 8), e2, f8[0], f8[1], f8[2])
        is_pin = (blocker != 0) & ((r2 & ~e2 & sliders) != 0)
        pinned_by_dir = torch.where(is_pin, blocker, 0)
        pinned = pinned_by_dir.sum(1)  # one blocker a direction: a union

        # The 73 move types' from squares: each target condition viewed from
        # the from square, for every type at once.
        bt = tb["back"][us]  # [B, 3, 73]
        seen = torch.stack([~own, evasion, empty, enemy, ep_plane, ~own & ~danger], 1)
        X = _sh(seen[:, :, None], bt[:, None, 0], bt[:, None, 1], bt[:, None, 2])
        not_own, ev, emp, ene, epb, king_ok = X.unbind(1)
        pbx = torch.cat([pinned_by_dir, torch.zeros_like(pinned_by_dir[:, :1])], 1)
        par = tb["par"][us]
        pin_ok = (~pinned)[:, None] | pbx.gather(1, par[:, 0]) | pbx.gather(1, par[:, 1])
        mf = ev & pin_ok

        movers = torch.stack([mine[:, ROOK] | mine[:, QUEEN],
                              mine[:, BISHOP] | mine[:, QUEEN],
                              torch.zeros_like(king)], 1)[:, tb["cls"]]
        path_e = emp[:, :56].view(B, 8, 7)
        path = [torch.full_like(path_e[:, :, 0], ALL)]
        for k in range(6):
            path.append(path[-1] & path_e[:, :, k])
        path = torch.cat([torch.stack(path, 2).view(B, 56),
                          torch.full_like(emp[:, :17], ALL)], 1)
        act = movers & path & not_own & mf
        act = act | (king[:, None] & king_ok & tb["king_mask"])
        pm = tb["pawn_masks"][us]  # [B, 3, 73]
        emp_prev = torch.cat([torch.full_like(emp[:, :1], ALL), emp[:, :-1]], 1)
        ep_side_ok = torch.where(tb["dc_pos"], ep_ok[:, 1:2], ep_ok[:, 0:1])
        ep_pin = torch.where(ep_resolves[:, None], pin_ok, 0)
        pawn = ((emp & mf & pm[:, 0])
                | (emp_prev & emp & mf & tb["start_row"][us][:, None] & pm[:, 1])
                | (((ene & mf) | (epb & (mf | ep_pin) & ep_side_ok)) & pm[:, 2])
                | (tb["pre_promo_row"][us][:, None] & mf
                   & ((emp & tb["up_push"]) | (ene & tb["up_cap"]))))
        act = act | (mine[:, PAWN:PAWN + 1] & pawn)
        act = act | ((mine[:, KNIGHT] & ~pinned)[:, None] & not_own & ev
                     & tb["knight_mask"])
        return self._castling(act, board, us, castling, rook_start, king_start,
                              empty, danger, in_check), in_check

    def _castling(self, act, board, us, castling, rook_start, king_start,
                  empty, danger, in_check):
        """KxR castling: the king's queen-type move toward its rook, dist =
        |rook file - king file|, where the rights hold, the king is not in
        check, the span of king and rook is clear but for the two, and no
        square the king crosses is attacked."""
        B, dev = act.shape[0], act.device
        bit = _tables(str(dev))["bit"]
        row = torch.where(us == 0, 0, 56)[:, None]
        kf = king_start.long().gather(1, us[:, None])  # [B, 1]
        rf = rook_start.long().gather(1, us[:, None, None].expand(B, 1, 2))[:, 0]
        right = castling.gather(1, us[:, None, None].expand(B, 1, 2))[:, 0]
        right = right & ~in_check[:, None]  # [B, 2]
        row_empty = (empty[:, None] >> row) & 0xFF
        row_danger = (danger[:, None] >> row) & 0xFF
        dest = _tables(str(dev))["castle_dest"]
        lo_k, hi_k = torch.minimum(kf, dest[:, 0]), torch.maximum(kf, dest[:, 0])
        lo_r, hi_r = torch.minimum(rf, dest[:, 1]), torch.maximum(rf, dest[:, 1])
        span = bit[torch.maximum(hi_k, hi_r) + 1] - bit[torch.minimum(lo_k, lo_r)]
        principals = bit[kf] | bit[rf]
        clear = (span & ~principals & ~row_empty) == 0
        kpath = bit[hi_k + 1] - bit[lo_k]
        safe = (kpath & ~bit[rf] & row_danger) == 0
        dist = (rf - kf).abs()
        ok = right & clear & safe & (dist >= 1)
        mt = torch.where(rf > kf, 2, 6) * 7 + dist.clamp(min=1) - 1  # [B, 2]
        types = torch.arange(73, device=dev)
        add = torch.where((types == mt[:, :, None]) & ok[:, :, None],
                          bit[row + kf][:, :, None], 0)
        return act | add[:, 0] | add[:, 1]

    # ---- step ------------------------------------------------------------

    def step(self, state: ChessState, action: torch.Tensor) -> ChessState:
        """Play ``action`` [B] in every lane; terminal lanes are left as they
        are.  Legality is not checked; an action outside [0, 4672) (the
        search hands terminal leaves -1) is read as action 0."""
        B, dev = state.batch_size, state.device
        tb = _tables(str(dev))
        a = action.long().clamp(0, T.NUM_ACTIONS - 1)
        frm, mt = a // 73, a % 73
        fr, fc = frm // 8, frm % 8
        flat = state.board.reshape(B, 64)
        moving = flat.gather(1, frm[:, None])[:, 0].long()
        pt = torch.where(moving >= 0, moving % 6, -1)
        us = state.to_play.long()
        them = 1 - us
        fwd = torch.where(us == 0, 1, -1)
        is_up = mt >= 64
        dr = torch.where(is_up, fwd, tb["dr"][mt])
        dc = tb["dc"][mt]
        tr, tc = (fr + dr).clamp(0, 7), (fc + dc).clamp(0, 7)
        to = tr * 8 + tc
        target = flat.gather(1, to[:, None])[:, 0].long()
        is_castle = ((pt == KING) & (target >= 0) & (target // 6 == us)
                     & (target % 6 == ROOK))
        side = torch.where(tc > fc, 0, 1)
        is_ep = (pt == PAWN) & (to == state.ep_square.long()) & (dc.abs() == 1)
        ep_cap = (tr - fwd).clamp(0, 7) * 8 + tc
        captured = torch.where(is_ep, flat.gather(1, ep_cap[:, None])[:, 0].long(),
                               target)
        is_capture = (captured >= 0) & ~is_castle
        is_promo = (pt == PAWN) & (tr == torch.where(us == 0, 7, 0))
        new_piece = torch.where(is_up, us * 6 + tb["up_piece"][mt],
                                torch.where(is_promo, us * 6 + QUEEN, moving))

        sq = torch.arange(64, device=dev)
        at_from, at_to = sq == frm[:, None], sq == to[:, None]
        empty8 = flat.new_full((), -1)
        b = torch.where(at_from | (is_ep[:, None] & (sq == ep_cap[:, None])), empty8, flat)
        b_normal = torch.where(at_to, new_piece.to(torch.int8)[:, None], b)
        back = torch.where(us == 0, 0, 56)
        dest = tb["castle_dest"][side]  # [B, 2]: king, rook file
        bc = torch.where(at_from | at_to, empty8, flat)
        bc = torch.where(sq == (back + dest[:, 0])[:, None],
                         (us * 6 + KING).to(torch.int8)[:, None], bc)
        bc = torch.where(sq == (back + dest[:, 1])[:, None],
                         (us * 6 + ROOK).to(torch.int8)[:, None], bc)
        nb = torch.where(is_castle[:, None], bc, b_normal).view(B, 8, 8)

        # Castling rights: the mover's go with a king move or castling, a
        # side's with its rook leaving its start square or taken there.
        colour = torch.arange(2, device=dev)[None, :]
        mover, other = (colour == us[:, None]), (colour == them[:, None])
        rs = state.rook_start.long()
        rs_us = rs.gather(1, us[:, None, None].expand(B, 1, 2))[:, 0]
        rs_them = rs.gather(1, them[:, None, None].expand(B, 1, 2))[:, 0]
        rook_from = (pt == ROOK) & (fr * 8 == back) & ~is_castle
        lose_us = (((pt == KING) | is_castle)[:, None]
                   | (rook_from[:, None] & (fc[:, None] == rs_us)))
        rook_taken = (is_capture & (captured % 6 == ROOK)
                      & (tr * 8 == torch.where(them == 0, 0, 56)))
        lose_them = rook_taken[:, None] & (tc[:, None] == rs_them)
        cast = (state.castling & ~(mover[:, :, None] & lose_us[:, None, :])
                & ~(other[:, :, None] & lose_them[:, None, :]))

        dbl_push = (pt == PAWN) & ((tr - fr).abs() == 2)
        new_ep = torch.where(dbl_push, (fr + fwd) * 8 + fc, -1).to(torch.int32)
        halfmove = torch.where((pt == PAWN) | is_capture, 0,
                               state.halfmove + 1).to(torch.int32)
        move_count = state.move_count + 1

        nh = (self._hash_board(nb) + self._hash_extras(cast, new_ep, them)
              ) & zobrist.LANE_MASK
        slot = move_count % self.history_len
        ring = torch.arange(self.history_len, device=dev)[None, :] == slot[:, None]
        history = torch.where(ring[:, :, None], nh[:, None, :], state.history)
        packed = zobrist.pack_lanes(history[..., 0], history[..., 1])
        rep = (packed == zobrist.pack_lanes(nh[:, 0], nh[:, 1])[:, None]).sum(1)

        to_play = them.to(torch.int32)
        legal, in_check = self._legal_bits(nb, to_play, cast, state.rook_start,
                                           state.king_start, new_ep)
        no_moves = ~(legal != 0).any(1)
        checkmate = no_moves & in_check
        terminal = (no_moves | (halfmove >= 100) | (rep >= 3)
                    | (move_count >= self.max_moves) | _insufficient_material(nb))
        new_state = ChessState(
            board=nb, to_play=to_play, castling=cast,
            rook_start=state.rook_start, king_start=state.king_start,
            ep_square=new_ep, halfmove=halfmove, move_count=move_count,
            terminal=terminal,
            winner=torch.where(checkmate, us, -1).to(torch.int32),
            in_check=in_check,
            legal=torch.where(terminal[:, None], 0, legal),
            hash=nh, history=history, rep_count=rep.to(torch.int32))
        return where_lanes(state.terminal, state, new_state)

    # ---- observations ----------------------------------------------------

    def observation(self, state: ChessState) -> torch.Tensor:
        """bf16 [B, 18, 8, 8]: 12 piece planes, then white to move, castling
        rights * 0.25, the en-passant square, halfmove / 100 and
        repetitions / 3 (each clipped to 1, formed in f32, then rounded to
        bf16, as JAX), and the Chess960 flag."""
        dt = torch.bfloat16
        B, dev = state.batch_size, state.device
        flat = state.board.reshape(B, 1, 64)
        pieces = (flat == torch.arange(12, device=dev, dtype=torch.int8)[None, :, None]).to(dt)
        ep = (torch.arange(64, device=dev)[None, :] == state.ep_square[:, None]).to(dt)
        scalars = torch.stack([
            (state.to_play == 0).to(dt),
            state.castling.reshape(B, 4).to(dt).sum(1) * 0.25,
            (state.halfmove / 100.0).clamp(max=1.0).to(dt),
            torch.full((B,), 0.0 if self.chess960_position is None else 1.0,
                       dtype=dt, device=dev),
            (state.rep_count / 3.0).clamp(max=1.0).to(dt)], 1)
        s = scalars[:, :, None].expand(B, 5, 64)
        planes = torch.cat([pieces, s[:, :2], ep[:, None], s[:, 2:]], 1)
        return planes.view(B, 18, 8, 8)

    def observation_basic(self, state: ChessState) -> torch.Tensor:
        return self.observation(state)[:, :12]

    # ---- search arena rows -----------------------------------------------

    def arena_rows(self, state: ChessState):
        """(board int8 [B, 64], meta int32 [B, 20 + 2 H], legal int32
        [B, 146]): the rows the search arena stores per node; hash lanes as
        their 32-bit patterns, the legal bitboards as their words."""
        B = state.batch_size
        meta = torch.cat(
            [getattr(state, f).to(torch.int32)[:, None] for f in _META_SCALARS]
            + [state.castling.reshape(B, 4).to(torch.int32),
               state.rook_start.reshape(B, 4), state.king_start,
               state.hash.to(torch.int32),
               state.history.reshape(B, -1).to(torch.int32)], 1)
        return (state.board.reshape(B, 64), meta,
                state.legal.contiguous().view(torch.int32))

    def from_arena_rows(self, board: torch.Tensor, meta: torch.Tensor,
                        legal: torch.Tensor) -> ChessState:
        B = board.shape[0]
        n = len(_META_SCALARS)
        sc = {f: meta[:, i].contiguous() for i, f in enumerate(_META_SCALARS)}
        lanes = meta[:, n + 10:].long() & zobrist.LANE_MASK
        return ChessState(
            board=board.reshape(B, 8, 8),
            to_play=sc["to_play"], castling=meta[:, n:n + 4].reshape(B, 2, 2) != 0,
            rook_start=meta[:, n + 4:n + 8].reshape(B, 2, 2),
            king_start=meta[:, n + 8:n + 10].contiguous(),
            ep_square=sc["ep_square"], halfmove=sc["halfmove"],
            move_count=sc["move_count"], terminal=sc["terminal"] != 0,
            winner=sc["winner"], in_check=sc["in_check"] != 0,
            legal=legal.contiguous().view(torch.int64),
            hash=lanes[:, :2].contiguous(),
            history=lanes[:, 2:].reshape(B, self.history_len, 2),
            rep_count=sc["rep_count"])

    # ---- accessors -------------------------------------------------------

    def terminal_flag(self, state: ChessState) -> torch.Tensor:
        return state.terminal

    def result(self, state: ChessState) -> torch.Tensor:
        return result_from_winner(state.winner, state.terminal)

    def to_play(self, state: ChessState) -> torch.Tensor:
        return state.to_play

    def winner(self, state: ChessState) -> torch.Tensor:
        return state.winner

    def position_hash(self, state: ChessState) -> torch.Tensor:
        """int64 [B] table key: the board hash with the halfmove clock and
        the repetition count mixed in (both feed the observation), lane by
        lane as JAX's u32 arithmetic, packed."""
        extra = (_mul32(state.halfmove.long(), 0x9E3779B1)
                 ^ _mul32(state.rep_count.long(), 0x85EBCA77))
        h0 = state.hash[:, 0] ^ extra
        h1 = state.hash[:, 1] ^ ((_mul32(extra, 0xC2B2AE3D) + 1) & zobrist.LANE_MASK)
        return zobrist.pack_lanes(h0, h1)


def _insufficient_material(board: torch.Tensor) -> torch.Tensor:
    """K vs K, K + minor vs K, K + minor vs K + minor."""
    B = board.shape[0]
    codes = board.reshape(B, 64).long() + 1
    n = torch.zeros((B, 13), dtype=torch.int64, device=board.device)
    n.scatter_add_(1, codes, torch.ones_like(codes))
    n = n[:, 1:]
    heavy = (n[:, PAWN] + n[:, 6 + PAWN] + n[:, ROOK] + n[:, 6 + ROOK]
             + n[:, QUEEN] + n[:, 6 + QUEEN])
    return ((heavy == 0) & (n[:, KNIGHT] + n[:, BISHOP] <= 1)
            & (n[:, 6 + KNIGHT] + n[:, 6 + BISHOP] <= 1))
