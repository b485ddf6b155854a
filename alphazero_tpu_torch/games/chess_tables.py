"""Static host-side tables of the chess environment (the port's own copy of
``alphazero_tpu/games/chess_tables.py``: numpy only, the same values).

Board frame: row 0 = rank 1 (white's back rank), col = file a..h.  Flat
square = row * 8 + col.

Action space: AlphaZero-style 8x8x73 = 4672, absolute orientation (no board
flip), action = from_square * 73 + move_type:
  * types 0..55: "queen moves" dir * 7 + (dist - 1); dirs in order
    N, NE, E, SE, S, SW, W, NW  (N = +row = towards rank 8).
  * types 56..63: knight moves, in ``KNIGHT_OFFSETS`` order.
  * types 64..72: underpromotions 64 + di * 3 + pi: file delta (0, -1, +1)
    by di, piece (N, B, R) by pi; the row delta is the mover's forward.
  * Queen promotion rides the ordinary queen-move encoding.
  * Castling is encoded as the king "capturing" its own rook (KxR), which is
    unambiguous in both standard chess and Chess960.
"""
from __future__ import annotations

import numpy as np

NUM_ACTIONS = 64 * 73

# Directions: N, NE, E, SE, S, SW, W, NW as (drow, dcol).
QUEEN_DIRS = (
    (1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1)
)
KNIGHT_OFFSETS = (
    (2, 1), (1, 2), (-1, 2), (-2, 1), (-2, -1), (-1, -2), (1, -2), (2, -1)
)
UNDERPROMO_DCS = (0, -1, 1)
UNDERPROMO_PIECES = (1, 2, 3)  # N, B, R type codes

# Piece type codes (colour-relative): P=0 N=1 B=2 R=3 Q=4 K=5; a board cell
# holds colour * 6 + type, -1 when empty.
PAWN, KNIGHT, BISHOP, ROOK, QUEEN, KING = range(6)


def _onboard(r, c):
    return 0 <= r < 8 and 0 <= c < 8


def build_tables():
    """Returns dict of numpy tables:
    to_sq   [64, 73] int32  target square, -1 invalid (off-board; the
                            underpromotions are resolved by the env)
    dir_of  [73]     int32  queen-dir index or -1
    dist_of [73]     int32  queen distance or 0
    is_knight [73]   bool
    promo_piece [2, 73] int32  piece type of the underpromotions, -1
    promo_dc [2, 73] int32  file delta of the underpromotion types
    """
    to_sq = np.full((64, 73), -1, np.int32)
    dir_of = np.full((73,), -1, np.int32)
    dist_of = np.zeros((73,), np.int32)
    is_knight = np.zeros((73,), bool)
    promo_piece = np.full((2, 73), -1, np.int32)
    promo_dc = np.zeros((2, 73), np.int32)

    for t in range(56):
        d, dist = divmod(t, 7)
        dir_of[t] = d
        dist_of[t] = dist + 1
    for i in range(8):
        is_knight[56 + i] = True
    for color in (0, 1):
        for di, dc in enumerate(UNDERPROMO_DCS):
            for pi, piece in enumerate(UNDERPROMO_PIECES):
                t = 64 + di * 3 + pi
                promo_piece[color, t] = piece
                promo_dc[color, t] = dc

    for s in range(64):
        r, c = divmod(s, 8)
        for t in range(56):
            d = QUEEN_DIRS[dir_of[t]]
            nr, nc = r + d[0] * dist_of[t], c + d[1] * dist_of[t]
            if _onboard(nr, nc):
                to_sq[s, t] = nr * 8 + nc
        for i, (dr, dc) in enumerate(KNIGHT_OFFSETS):
            nr, nc = r + dr, c + dc
            if _onboard(nr, nc):
                to_sq[s, 56 + i] = nr * 8 + nc
    return {
        "to_sq": to_sq,
        "dir_of": dir_of,
        "dist_of": dist_of,
        "is_knight": is_knight,
        "promo_piece": promo_piece,
        "promo_dc": promo_dc,
    }


TABLES = build_tables()


def move_delta(move_type: int, color: int = 0):
    """(drow, dcol) of ``move_type`` for the side ``color``."""
    if move_type >= 64:
        return (1 if color == 0 else -1), UNDERPROMO_DCS[(move_type - 64) // 3]
    if move_type >= 56:
        return KNIGHT_OFFSETS[move_type - 56]
    d, dist = divmod(move_type, 7)
    return QUEEN_DIRS[d][0] * (dist + 1), QUEEN_DIRS[d][1] * (dist + 1)


def encode_move(from_sq: int, to_sq: int, promo: int | None = None,
                color: int = 0) -> int:
    """Host-side move -> action encoding (tests / UIs).  ``promo`` is a
    colour-relative piece type (KNIGHT/BISHOP/ROOK for underpromotions;
    QUEEN or None rides the queen-move path); ``color`` is unused (the
    underpromotion types carry the absolute file delta)."""
    fr, fc = divmod(from_sq, 8)
    tr, tc = divmod(to_sq, 8)
    dr, dc = tr - fr, tc - fc
    if promo in (KNIGHT, BISHOP, ROOK):
        di = UNDERPROMO_DCS.index(dc)
        pi = UNDERPROMO_PIECES.index(promo)
        return from_sq * 73 + 64 + di * 3 + pi
    if (dr, dc) in KNIGHT_OFFSETS:
        return from_sq * 73 + 56 + KNIGHT_OFFSETS.index((dr, dc))
    dist = max(abs(dr), abs(dc))
    ur, uc = (dr // dist if dr else 0), (dc // dist if dc else 0)
    d = QUEEN_DIRS.index((ur, uc))
    return from_sq * 73 + d * 7 + (dist - 1)


def decode_action(action: int):
    """Host-side action -> (from_sq, move_type)."""
    return divmod(action, 73)
