"""Plain Go for one game at a time, in NumPy.

Area (Chinese) scoring with komi, captures, no suicide, the simple-ko point,
and positional superko against the last ``history`` positions, where the
ring starts filled with the empty board; two passes in a row or
``2 n**2`` moves end the game.  The observation is the 8-plane encoding
the benchmarked program's nets take: the side to move's stones, the
opponent's, a black-to-move plane, the liberties of the side to move's
groups and of the opponent's, each divided by 10 and clipped to 1, the ko
point, and the distance to the nearer edge by rows and by columns divided
by (n - 1) / 2; the planes hold bfloat16 values.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

EMPTY = -1


@dataclasses.dataclass
class State:
    board: np.ndarray  # int8 [n, n]: -1 empty, 0 black, 1 white
    to_play: int
    ko_point: int  # flat cell or -1
    passes: int  # consecutive passes
    move_count: int
    terminal: bool
    winner: int  # -1 none, else the player with more points
    history: list  # boards of the last ``history`` positions (ring)

    def copy(self) -> "State":
        return State(self.board.copy(), self.to_play, self.ko_point,
                     self.passes, self.move_count, self.terminal, self.winner,
                     list(self.history))


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


class Go:
    channels = 8

    def __init__(self, board_size: int = 9, komi: float = 7.5,
                 history: int = 16):
        n = board_size
        self.n, self.komi, self.history = n, komi, history
        self.num_actions = n * n + 1
        self.pass_action = n * n
        self.move_limit = 2 * n * n
        nbrs = []
        for cell in range(n * n):
            r, c = divmod(cell, n)
            nbrs.append([rr * n + cc for rr, cc in
                         ((r - 1, c), (r + 1, c), (r, c - 1), (r, c + 1))
                         if 0 <= rr < n and 0 <= cc < n])
        self._nbrs = nbrs
        rows = torch.arange(n, dtype=torch.bfloat16)
        dist = (torch.minimum(rows, rows.flip(0))
                / max((n - 1) / 2, 1)).float().numpy()
        self._border = np.stack([np.repeat(dist[:, None], n, 1),
                                 np.repeat(dist[None, :], n, 0)])

    def init(self) -> State:
        n = self.n
        empty = np.full((n, n), EMPTY, np.int8)
        return State(empty, 0, -1, 0, 0, False, -1,
                     [empty.copy() for _ in range(self.history)])

    # ---- groups ----------------------------------------------------------

    def _group(self, flat: np.ndarray, cell: int):
        """(cells, liberties) of the group at ``cell``: sets of flat cells."""
        colour = flat[cell]
        cells, libs, todo = {cell}, set(), [cell]
        while todo:
            x = todo.pop()
            for y in self._nbrs[x]:
                if flat[y] == EMPTY:
                    libs.add(y)
                elif flat[y] == colour and y not in cells:
                    cells.add(y)
                    todo.append(y)
        return cells, libs

    def _play(self, board: np.ndarray, player: int, cell: int):
        """(board after the stone and its captures, captured cells), or None
        for a suicide."""
        flat = board.reshape(-1).copy()
        flat[cell] = player
        captured = set()
        for y in self._nbrs[cell]:
            if flat[y] == 1 - player and y not in captured:
                cells, libs = self._group(flat, y)
                if not libs:
                    captured |= cells
        for y in captured:
            flat[y] = EMPTY
        if not self._group(flat, cell)[1]:
            return None
        return flat.reshape(board.shape), captured

    # ---- rules -----------------------------------------------------------

    def legal(self, s: State) -> np.ndarray:
        """bool [n*n + 1]: empty, not suicide, not the ko point, no repeat
        of a position in the ring; pass while the game runs."""
        out = np.zeros(self.num_actions, bool)
        for cell in np.flatnonzero(s.board.reshape(-1) == EMPTY):
            out[cell] = self.is_legal(s, int(cell))
        out[self.pass_action] = not s.terminal
        return out

    def is_legal(self, s: State, action: int) -> bool:
        if s.terminal:
            return False
        if action == self.pass_action:
            return True
        if s.board.reshape(-1)[action] != EMPTY or action == s.ko_point:
            return False
        played = self._play(s.board, s.to_play, action)
        if played is None:
            return False
        return not any(np.array_equal(played[0], h) for h in s.history)

    def step(self, s: State, action: int) -> State:
        """The state after ``action``; a finished game stays as it is."""
        if s.terminal:
            return s.copy()
        n, p = self.n, s.to_play
        out = s.copy()
        action = int(action)
        if action == self.pass_action:
            out.passes = s.passes + 1
            out.ko_point = -1
        else:
            if s.board.reshape(-1)[action] != EMPTY:
                raise ValueError(f"cell {action} is taken")
            played = self._play(s.board, p, action)
            if played is None:
                raise ValueError(f"cell {action} is suicide")
            out.board, captured = played
            out.passes = 0
            out.ko_point = -1
            if len(captured) == 1:
                cells, libs = self._group(out.board.reshape(-1), action)
                if len(cells) == 1 and len(libs) == 1:
                    out.ko_point = next(iter(captured))
        out.move_count = s.move_count + 1
        out.history[out.move_count % self.history] = out.board.copy()
        out.to_play = 1 - p
        out.terminal = out.passes >= 2 or out.move_count >= self.move_limit
        if out.terminal:
            black, white = self.area(out.board)
            white += self.komi
            out.winner = 0 if black > white else (1 if white > black else -1)
        return out

    def area(self, board: np.ndarray):
        """(black, white) stones plus the empty regions that touch only that
        colour's stones."""
        flat = board.reshape(-1)
        score = [float(np.sum(flat == 0)), float(np.sum(flat == 1))]
        seen = set()
        for cell in np.flatnonzero(flat == EMPTY):
            if cell in seen:
                continue
            region, touch, todo = {int(cell)}, set(), [int(cell)]
            while todo:
                x = todo.pop()
                for y in self._nbrs[x]:
                    if flat[y] == EMPTY:
                        if y not in region:
                            region.add(y)
                            todo.append(y)
                    else:
                        touch.add(int(flat[y]))
            seen |= region
            if len(touch) == 1:
                score[touch.pop()] += len(region)
        return score[0], score[1]

    # ---- observation -----------------------------------------------------

    def _liberty_plane(self, flat: np.ndarray, colour: int) -> np.ndarray:
        libs = np.zeros(flat.shape, np.float32)
        done = set()
        for cell in np.flatnonzero(flat == colour):
            if cell in done:
                continue
            cells, lib = self._group(flat, int(cell))
            done |= cells
            for x in cells:
                libs[x] = len(lib)
        return np.clip(_bf16(_bf16(libs) / np.float32(10.0)), 0.0, 1.0)

    def observation(self, s: State) -> np.ndarray:
        """float32 [8, n, n] holding the bfloat16 planes' values."""
        n = self.n
        flat = s.board.reshape(-1)
        obs = np.zeros((self.channels, n, n), np.float32)
        obs[0] = s.board == s.to_play
        obs[1] = s.board == 1 - s.to_play
        obs[2] = 1.0 if s.to_play == 0 else 0.0
        obs[3] = self._liberty_plane(flat, s.to_play).reshape(n, n)
        obs[4] = self._liberty_plane(flat, 1 - s.to_play).reshape(n, n)
        if s.ko_point >= 0:
            obs[5].flat[s.ko_point] = 1.0
        obs[6:] = self._border
        return obs

    def terminal_value(self, s: State) -> float:
        if s.winner < 0:
            return 0.0
        return 1.0 if s.winner == s.to_play else -1.0

    def same_position(self, s: State, board: np.ndarray, to_play: int,
                      move_count: int) -> bool:
        return (np.array_equal(s.board, board) and s.to_play == to_play
                and s.move_count == move_count)
