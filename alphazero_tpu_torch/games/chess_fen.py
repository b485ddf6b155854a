"""FEN and SAN for the chess environment (counterpart of
``alphazero_tpu/games/chess_fen.py``; host-side).

Standard FEN; castling rights KQkq (Chess960 starts are configured through
``ChessEnv`` instead of Shredder-FEN).  States are batched: ``state_from_fen``
takes a list of FENs, ``fen_from_state`` returns one FEN a lane, and the SAN
functions read one lane (``lane``).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from alphazero_tpu_torch.core import zobrist
from alphazero_tpu_torch.games import chess_tables as T
from alphazero_tpu_torch.games.chess_tables import (
    BISHOP, KING, KNIGHT, PAWN, QUEEN, ROOK,
)

_PIECE_CHARS = {
    PAWN: "P", KNIGHT: "N", BISHOP: "B", ROOK: "R", QUEEN: "Q", KING: "K",
}
_CHAR_PIECES = {}
for _p, _ch in _PIECE_CHARS.items():
    _CHAR_PIECES[_ch] = _p  # white
    _CHAR_PIECES[_ch.lower()] = 6 + _p  # black


def board_from_fen(placement: str) -> np.ndarray:
    board = np.full((8, 8), -1, np.int8)
    ranks = placement.split("/")
    if len(ranks) != 8:
        raise ValueError(f"bad FEN placement {placement!r}")
    for i, rank in enumerate(ranks):
        r = 7 - i  # FEN starts at rank 8
        c = 0
        for ch in rank:
            if ch.isdigit():
                c += int(ch)
            else:
                board[r, c] = _CHAR_PIECES[ch]
                c += 1
        if c != 8:
            raise ValueError(f"bad FEN rank {rank!r}")
    return board


def square_from_alg(s: str) -> int:
    return (int(s[1]) - 1) * 8 + (ord(s[0]) - ord("a"))


def alg_from_square(sq: int) -> str:
    return chr(ord("a") + sq % 8) + str(sq // 8 + 1)


def _parse(fen: str):
    parts = fen.split()
    board = board_from_fen(parts[0])
    to_play = 0 if parts[1] == "w" else 1
    cast = np.zeros((2, 2), bool)
    if len(parts) > 2 and parts[2] != "-":
        cast[0, 0] = "K" in parts[2]
        cast[0, 1] = "Q" in parts[2]
        cast[1, 0] = "k" in parts[2]
        cast[1, 1] = "q" in parts[2]
    ep = square_from_alg(parts[3]) if len(parts) > 3 and parts[3] != "-" else -1
    halfmove = int(parts[4]) if len(parts) > 4 else 0
    fullmove = int(parts[5]) if len(parts) > 5 else 1
    return board, to_play, cast, ep, halfmove, (fullmove - 1) * 2 + to_play


def state_from_fen(env, fens: str | Sequence[str], device="cuda"):
    """A batched ``ChessState`` from FENs (one lane each; a single string
    is one lane), with the legal moves and the hash computed, adjudicated
    as ``step`` would adjudicate it (mate, stalemate, the 50-move rule,
    insufficient material).  The ring holds the position in slot 0, the
    repetition count is 1, and the castling rooks and kings start on the
    standard files."""
    from alphazero_tpu_torch.games.chess import (
        ChessState, _insufficient_material,
    )

    if isinstance(fens, str):
        fens = [fens]
    rows = [_parse(f) for f in fens]
    dev = torch.device(device)
    B = len(rows)

    def col(i, dtype):
        return torch.from_numpy(np.stack([np.asarray(r[i]) for r in rows])).to(
            device=dev, dtype=dtype)

    board = col(0, torch.int8)
    to_play, cast, ep = col(1, torch.int32), col(2, torch.bool), col(3, torch.int32)
    halfmove, move_count = col(4, torch.int32), col(5, torch.int32)
    h = (env._hash_board(board) + env._hash_extras(cast, ep, to_play)
         ) & zobrist.LANE_MASK
    history = torch.zeros((B, env.history_len, 2), dtype=torch.int64, device=dev)
    history[:, 0] = h
    i32 = dict(dtype=torch.int32, device=dev)
    rook_start = torch.tensor([[7, 0], [7, 0]], **i32).expand(B, 2, 2).contiguous()
    king_start = torch.full((B, 2), 4, **i32)
    legal, in_check = env._legal_bits(board, to_play, cast, rook_start,
                                      king_start, ep)
    no_moves = ~(legal != 0).any(1)
    terminal = no_moves | (halfmove >= 100) | _insufficient_material(board)
    winner = torch.where(no_moves & in_check, 1 - to_play, -1).to(torch.int32)
    return ChessState(
        board=board, to_play=to_play, castling=cast, rook_start=rook_start,
        king_start=king_start, ep_square=ep, halfmove=halfmove,
        move_count=move_count, terminal=terminal, winner=winner,
        in_check=in_check, legal=torch.where(terminal[:, None], 0, legal),
        hash=h, history=history, rep_count=torch.ones(B, **i32))


def fen_from_state(state) -> list:
    """One FEN a lane."""
    boards = state.board.cpu().numpy()
    fens = []
    for b in range(boards.shape[0]):
        ranks = []
        for r in range(7, -1, -1):
            out, empties = "", 0
            for c in range(8):
                p = int(boards[b, r, c])
                if p < 0:
                    empties += 1
                    continue
                if empties:
                    out += str(empties)
                    empties = 0
                ch = _PIECE_CHARS[p % 6]
                out += ch if p < 6 else ch.lower()
            if empties:
                out += str(empties)
            ranks.append(out)
        cast = state.castling[b].cpu().numpy()
        rights = (("K" if cast[0, 0] else "") + ("Q" if cast[0, 1] else "")
                  + ("k" if cast[1, 0] else "") + ("q" if cast[1, 1] else "")
                  ) or "-"
        ep = int(state.ep_square[b])
        fens.append(" ".join([
            "/".join(ranks), "w" if int(state.to_play[b]) == 0 else "b", rights,
            alg_from_square(ep) if ep >= 0 else "-", str(int(state.halfmove[b])),
            str(int(state.move_count[b]) // 2 + 1)]))
    return fens


def _lane(state, lane: int):
    return state.map(lambda x: x[lane:lane + 1])


def action_to_san(env, state, action: int, lane: int = 0) -> str:
    """Standard Algebraic Notation of a legal ``action`` in lane ``lane``."""
    return _sans(env, _lane(state, lane), [int(action)])[0]


def _sans(env, one, actions) -> list:
    """The SAN of each of ``actions`` (legal) in the one-lane state ``one``,
    from one batched step for the check and mate marks."""
    board = one.board[0].cpu().numpy()
    legal = env.legal_mask(one)[0].cpu().numpy()
    if not all(legal[a] for a in actions):
        raise ValueError("action is not legal in this position")
    n = len(actions)
    after = env.step(one.map(lambda x: x.expand((n,) + x.shape[1:])),
                     torch.tensor(actions, device=one.device))
    mate = (after.terminal & (after.winner >= 0)).tolist()
    check = after.in_check.tolist()
    legal2 = legal.reshape(64, 73)
    piece_letter = {KNIGHT: "N", BISHOP: "B", ROOK: "R", QUEEN: "Q", KING: "K"}
    out = []
    for i, action in enumerate(actions):
        suffix = "#" if mate[i] else "+" if check[i] else ""
        from_sq, mtype = divmod(action, 73)
        fr, fc = divmod(from_sq, 8)
        p = int(board[fr, fc])
        ptype, us = p % 6, p // 6
        dr, dc = T.move_delta(mtype, us)
        tr, tc = fr + dr, fc + dc
        target = int(board[tr, tc])
        if ptype == KING and target >= 0 and target // 6 == us and target % 6 == ROOK:
            out.append(("O-O" if tc > fc else "O-O-O") + suffix)  # KxR castling
            continue
        dest = alg_from_square(tr * 8 + tc)
        capture = target >= 0 or (ptype == PAWN and dc != 0)  # en passant
        if ptype == PAWN:
            san = (chr(ord("a") + fc) + "x" + dest) if capture else dest
            if mtype >= 64:
                san += "=" + piece_letter[T.UNDERPROMO_PIECES[(mtype - 64) % 3]]
            elif tr in (0, 7):
                san += "=Q"
            out.append(san + suffix)
            continue
        # Disambiguation: other pieces of the same kind that reach dest.
        amb_file = amb_rank = need = False
        for s in range(64):
            if s == from_sq or int(board[s // 8, s % 8]) != p:
                continue
            for t in np.flatnonzero(legal2[s]):
                if t >= 64:
                    continue
                odr, odc = T.move_delta(int(t), us)
                if (s // 8 + odr, s % 8 + odc) == (tr, tc):
                    need = True
                    if s % 8 == fc:
                        amb_rank = True
                    else:
                        amb_file = True
        dis = ""
        if need:
            if amb_file and amb_rank:
                dis = alg_from_square(from_sq)
            elif amb_rank:
                dis = str(fr + 1)
            else:
                dis = chr(ord("a") + fc)
        out.append(piece_letter[ptype] + dis + ("x" if capture else "") + dest
                   + suffix)
    return out


def _normalize_san(s: str) -> str:
    """Strip decorations that don't identify the move: check/mate marks,
    annotations (!?), e.p. tag; normalize zero-castling to O-O form."""
    s = s.strip().rstrip("+#!?").replace("e.p.", "").strip()
    s = s.replace("0-0-0", "O-O-O")
    if s == "0-0":
        s = "O-O"
    return s


def _strip_disambiguation(s: str) -> str:
    if not s or s[0] not in "NBRQK":
        return s  # pawn moves / castling carry no disambiguation field
    body, tail = s[1:], ""
    if "=" in body:
        body, tail = body.split("=", 1)
        tail = "=" + tail
    cap = "x" in body
    body = body.replace("x", "")
    return s[0] + ("x" if cap else "") + body[-2:] + tail


def san_to_action(env, state, san: str, lane: int = 0) -> int:
    """The action of ``san`` in lane ``lane``: matched against the SAN of
    every legal action, tolerating missing check/mate suffixes, annotations
    and redundant disambiguation (``Ngf3`` where ``Nf3`` is unambiguous)."""
    want = _normalize_san(san)
    one = _lane(state, lane)
    actions = np.flatnonzero(env.legal_mask(one)[0].cpu().numpy()).tolist()
    candidates = []
    for a, got in zip(actions, _sans(env, one, actions)):
        got = _normalize_san(got)
        if got == want:
            return int(a)
        if _strip_disambiguation(got) == _strip_disambiguation(want):
            candidates.append(int(a))
    if len(candidates) == 1:
        return candidates[0]
    if candidates:
        raise ValueError(f"ambiguous SAN {san!r}")
    raise ValueError(f"no legal move matches SAN {san!r}")
