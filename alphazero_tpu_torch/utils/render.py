"""Text board renderers (counterpart of ``alphazero_tpu/utils/render.py``):
one lane of a batched state -> the same string as the JAX package's
renderer gives for that position, for the CLI and REST surfaces."""
from __future__ import annotations

import numpy as np

_GOMOKU_STONES = {-1: ".", 0: "X", 1: "O"}
_GO_STONES = {-1: ".", 0: "#", 1: "O"}
_CHESS_PIECES = "PNBRQK"


def render_board_game(board, stones) -> str:
    """Render an int8 [N, N] stone board with column letters / row numbers
    (gomoku & go)."""
    board = np.asarray(board)
    n = board.shape[0]
    cols = "".join(chr(ord("A") + i) for i in range(n))
    lines = ["   " + " ".join(cols)]
    for r in range(n - 1, -1, -1):
        cells = [stones[int(board[r, c])] for c in range(n)]
        lines.append(f"{r + 1:2d} " + " ".join(cells))
    return "\n".join(lines)


def _board(state, lane: int) -> np.ndarray:
    return state.board[lane].cpu().numpy()


def render_gomoku(state, lane: int = 0) -> str:
    return render_board_game(_board(state, lane), _GOMOKU_STONES)


def render_go(state, lane: int = 0) -> str:
    board = render_board_game(_board(state, lane), _GO_STONES)
    prisoners = state.prisoners[lane].tolist()
    extra = (
        f"\npasses: {int(state.consecutive_passes[lane])}  "
        f"prisoners B/W: {prisoners[0]}/{prisoners[1]}"
    )
    return board + extra


def render_chess(state, lane: int = 0) -> str:
    board = _board(state, lane)
    lines = ["   a b c d e f g h"]
    for r in range(7, -1, -1):
        cells = []
        for c in range(8):
            p = int(board[r, c])
            if p < 0:
                cells.append(".")
            else:
                ch = _CHESS_PIECES[p % 6]
                cells.append(ch if p < 6 else ch.lower())
        lines.append(f" {r + 1} " + " ".join(cells))
    lines.append("   a b c d e f g h")
    return "\n".join(lines)


def render(env, state, lane: int = 0) -> str:
    from alphazero_tpu_torch.core.types import GameType

    if env.game_type == GameType.CHESS:
        return render_chess(state, lane)
    if env.game_type == GameType.GO:
        return render_go(state, lane)
    return render_gomoku(state, lane)
