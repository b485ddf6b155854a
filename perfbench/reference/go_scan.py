"""``reference/go.py``'s plain Go with ``legal`` computed from one scan of
the board's groups: the same rules, the same answers, in time for 19x19.

``Go.legal`` plays every empty cell out (a copy of the board, its
neighbours' groups flooded again, every history board compared), which
costs tens of milliseconds a 19x19 position; the search replay asks it of
every position the search expands.  Here the groups and their liberties
are flooded once a position, and an empty cell, not the ko point, is
legal where the stone keeps a liberty (an empty neighbour, a friendly
neighbour group with another liberty, or an opponent neighbour group whose
only liberty it is, which it captures) and the board it leaves is in no
history slot: without a capture, no history board differs from this one
in that cell alone with the mover's stone there.  ``tests/test_perfbench_go_scan.py`` holds the two against
each other on random games.
"""
from __future__ import annotations

import numpy as np

from perfbench.reference import go as plain
from perfbench.reference.go import EMPTY, State  # noqa: F401


class Go(plain.Go):
    def _groups(self, flat: np.ndarray):
        """(group id of each cell, -1 where empty; each group's cells and
        liberties)."""
        gid = np.full(flat.shape, -1, np.int64)
        groups = []
        for cell in np.flatnonzero(flat != EMPTY):
            if gid[cell] < 0:
                cells, libs = self._group(flat, int(cell))
                for x in cells:
                    gid[x] = len(groups)
                groups.append((cells, libs))
        return gid, groups

    def legal(self, s: State) -> np.ndarray:
        out = np.zeros(self.num_actions, bool)
        out[self.pass_action] = not s.terminal
        if s.terminal:
            return out
        flat = s.board.reshape(-1)
        p = s.to_play
        gid, groups = self._groups(flat)
        seen = {h.tobytes() for h in s.history}
        # A stone that captures nothing leaves the board plus itself: a
        # history board that differs from this one in that cell alone,
        # holding the mover's stone there.
        repeats = set()
        for h in s.history:
            d = np.flatnonzero(h.reshape(-1) != flat)
            if len(d) == 1 and h.reshape(-1)[d[0]] == p:
                repeats.add(int(d[0]))
        for cell in np.flatnonzero(flat == EMPTY):
            cell = int(cell)
            if cell == s.ko_point:
                continue
            breath, captured = False, []
            for y in self._nbrs[cell]:
                if flat[y] == EMPTY:
                    breath = True
                elif flat[y] == p:
                    breath = breath or len(groups[gid[y]][1]) > 1
                elif groups[gid[y]][1] == {cell} and gid[y] not in captured:
                    captured.append(gid[y])
            if not (breath or captured):
                continue  # suicide
            if not captured:
                out[cell] = cell not in repeats
                continue
            board = flat.copy()
            board[cell] = p
            for g in captured:
                board[list(groups[g][0])] = EMPTY
            out[cell] = board.tobytes() not in seen
        return out
