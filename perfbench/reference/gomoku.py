"""Plain Gomoku (freestyle) for one game at a time, in NumPy.

The rules: black (0) moves first, a stone goes on any empty cell, five or
more in a row wins, a full board is a draw.  The observation is the
11-plane encoding the benchmarked program's nets take: stones of the side
to move, the opponent's stones, a black-to-move plane, the last three
moves of black and of white as one-hot planes (most recent first), and two
coordinate planes i / (n - 1) rounded to bfloat16.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

EMPTY = -1
_LINES = ((0, 1), (1, 0), (1, 1), (1, -1))


@dataclasses.dataclass
class State:
    board: np.ndarray  # int8 [n, n]: -1 empty, 0 black, 1 white
    to_play: int
    last_moves: np.ndarray  # int32 [2, 3]: per player, most recent first
    move_count: int
    terminal: bool
    winner: int  # -1 none or draw, else the player who made five

    def copy(self) -> "State":
        return State(self.board.copy(), self.to_play, self.last_moves.copy(),
                     self.move_count, self.terminal, self.winner)


class Gomoku:
    channels = 11

    def __init__(self, board_size: int = 15):
        self.n = board_size
        self.num_actions = board_size * board_size
        coord = (torch.arange(board_size, dtype=torch.bfloat16)
                 / (board_size - 1)).float().numpy()
        self._coords = np.stack([np.repeat(coord[:, None], board_size, 1),
                                 np.repeat(coord[None, :], board_size, 0)])

    def init(self) -> State:
        n = self.n
        return State(np.full((n, n), EMPTY, np.int8), 0,
                     np.full((2, 3), -1, np.int32), 0, False, -1)

    def legal(self, s: State) -> np.ndarray:
        """bool [A]: the empty cells, none once the game is over."""
        if s.terminal:
            return np.zeros(self.num_actions, bool)
        return (s.board == EMPTY).reshape(-1)

    def is_legal(self, s: State, action: int) -> bool:
        return (not s.terminal and 0 <= action < self.num_actions
                and s.board.flat[action] == EMPTY)

    def _run(self, board, r, c, dr, dc, player) -> int:
        k, n = 0, self.n
        r, c = r + dr, c + dc
        while 0 <= r < n and 0 <= c < n and board[r, c] == player:
            k += 1
            r, c = r + dr, c + dc
        return k

    def step(self, s: State, action: int) -> State:
        """The state after ``action``; a finished game stays as it is."""
        if s.terminal:
            return s.copy()
        n, p = self.n, s.to_play
        r, c = divmod(int(action), n)
        if s.board[r, c] != EMPTY:
            raise ValueError(f"cell {action} is taken")
        out = s.copy()
        out.board[r, c] = p
        win = any(self._run(out.board, r, c, dr, dc, p)
                  + self._run(out.board, r, c, -dr, -dc, p) + 1 >= 5
                  for dr, dc in _LINES)
        out.move_count = s.move_count + 1
        out.terminal = win or out.move_count >= self.num_actions
        out.winner = p if win else -1
        out.last_moves[p] = [int(action), s.last_moves[p, 0], s.last_moves[p, 1]]
        out.to_play = 1 - p
        return out

    def observation(self, s: State) -> np.ndarray:
        """float32 [11, n, n] holding the bfloat16 planes' values."""
        n = self.n
        obs = np.zeros((self.channels, n, n), np.float32)
        obs[0] = s.board == s.to_play
        obs[1] = s.board == 1 - s.to_play
        obs[2] = 1.0 if s.to_play == 0 else 0.0
        for i, a in enumerate(s.last_moves.reshape(-1)):
            if a >= 0:
                obs[3 + i].flat[a] = 1.0
        obs[9:] = self._coords
        return obs

    def terminal_value(self, s: State) -> float:
        """The finished game's value to the side to move."""
        if s.winner < 0:
            return 0.0
        return 1.0 if s.winner == s.to_play else -1.0

    def same_position(self, s: State, board: np.ndarray, to_play: int,
                      move_count: int) -> bool:
        return (np.array_equal(s.board, board) and s.to_play == to_play
                and s.move_count == move_count)
