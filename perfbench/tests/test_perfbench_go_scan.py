"""``reference/go_scan.py``'s ``legal`` against ``reference/go.py``'s on
random games: every position equal, positional superko and captures
included."""
import numpy as np
import pytest

from perfbench.reference import go, go_scan


def _superko_cells(env, s) -> int:
    """Empty cells that ``go.Go.legal`` refuses for a repeat alone."""
    n = 0
    for cell in np.flatnonzero(s.board.reshape(-1) == go.EMPTY):
        played = env._play(s.board, s.to_play, int(cell))
        if played is not None and cell != s.ko_point and any(
                np.array_equal(played[0], h) for h in s.history):
            n += 1
    return n


@pytest.mark.parametrize("n,games", [(5, 60), (9, 12), (19, 1)])
def test_legal_equals_the_plain_envs(n, games):
    plain, scan = go.Go(n, 7.5, 16), go_scan.Go(n, 7.5, 16)
    rng = np.random.default_rng(n)
    positions = repeats = 0
    for _ in range(games):
        s = plain.init()
        while not s.terminal:
            want = plain.legal(s)
            assert np.array_equal(scan.legal(s), want), s.move_count
            positions += 1
            if n == 5:
                repeats += _superko_cells(plain, s)
            moves = np.flatnonzero(want)
            p = np.where(moves == plain.pass_action, 0.01, 1.0)
            s = plain.step(s, int(rng.choice(moves, p=p / p.sum())))
    assert positions > 200
    if n == 5:
        assert repeats > 0  # the superko branch was taken
