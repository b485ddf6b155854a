"""The port's Renju, Omok and pro-long Gomoku against the JAX package,
exactly (tolerance 0): random-playout fuzz of every state field and the
legal mask, ``forbidden_map`` on random boards, the round-2 fuzz finds of
``tests/test_renju_fuzz.py`` and the variant cases of
``tests/test_gomoku.py``."""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.games.gomoku import GomokuEnv as JaxGomoku
from alphazero_tpu_torch.core import registry
from alphazero_tpu_torch.games.gomoku import GomokuEnv, _run_through_maps
from test_torch_core_gomoku import _pair
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

VARIANTS = {
    "renju": dict(use_renju=True),
    "omok": dict(use_omok=True),
    "pro_long": dict(use_pro_long_opening=True),
    "renju_pro_long": dict(use_renju=True, use_pro_long_opening=True),
}


@functools.lru_cache(maxsize=None)
def _jax_forbidden(n: int, variant: str):
    return jax.jit(jax.vmap(JaxGomoku(board_size=n, **VARIANTS[variant]).forbidden_map))


def _compare(jfns, jst, tenv, tst):
    """Every state field, the legal mask and the observation equal;
    ``jfns`` = the JAX env's jitted, vmapped (legal_mask, observation)."""
    for f in ("board", "to_play", "last_moves", "move_count", "terminal", "winner"):
        np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                      np.asarray(getattr(jst, f)), err_msg=f)
    np.testing.assert_array_equal(_pair(tst.hash), np.asarray(jst.hash))
    legal, obs = jfns
    np.testing.assert_array_equal(tenv.legal_mask(tst).numpy(), np.asarray(legal(jst)))
    np.testing.assert_array_equal(tenv.observation(tst).float().numpy(),
                                  np.asarray(obs(jst)).astype(np.float32))


def _random_boards(rng, B: int, n: int, max_stones: int) -> np.ndarray:
    """int8 [B, n, n]: a random number of stones of random colours."""
    boards = np.full((B, n, n), -1, np.int8)
    for b in range(B):
        k = rng.randint(0, max_stones + 1)
        cells = rng.choice(n * n, k, replace=False)
        boards[b].flat[cells] = rng.randint(0, 2, k)
    return boards


def _board(n, black, white=()):
    b = np.full((n, n), -1, np.int8)
    for r, c in black:
        b[r, c] = 0
    for r, c in white:
        b[r, c] = 1
    return b


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_random_playout_fuzz(variant):
    """16 random legal playouts at 15x15 under each variant (half the lanes
    kept near the center, so fives, overlines and forbidden points come
    early), board, hash, terminal, winner, legal mask and observation equal
    to JAX at every ply."""
    B, n = 16, 15
    jenv = JaxGomoku(board_size=n, **VARIANTS[variant])
    tenv = GomokuEnv(board_size=n, **VARIANTS[variant])
    jst = jax.vmap(lambda _: jenv.init())(jnp.arange(B))
    tst = tenv.init(B, device="cpu")
    jstep = jax.jit(jax.vmap(jenv.step))
    jfns = (jax.jit(jax.vmap(jenv.legal_mask)), jax.jit(jax.vmap(jenv.observation)))
    rng = np.random.RandomState(sorted(VARIANTS).index(variant))
    _compare(jfns, jst, tenv, tst)
    for _ in range(n * n):
        legal = tenv.legal_mask(tst).numpy()
        acts = np.zeros(B, np.int64)
        for b in range(B):
            cand = np.flatnonzero(legal[b])
            if b % 2 and cand.size:
                r, c = cand // n, cand % n
                near = cand[(abs(r - 7) <= 3) & (abs(c - 7) <= 3)]
                cand = near if near.size else cand
            acts[b] = rng.choice(cand) if cand.size else 0
        jst = jstep(jst, jnp.asarray(acts, jnp.int32))
        tst = tenv.step(tst, torch.from_numpy(acts))
        _compare(jfns, jst, tenv, tst)
        if bool(tst.terminal.all()):
            break
    assert bool(tst.terminal.all())


@pytest.mark.parametrize("variant", ["renju", "omok"])
@pytest.mark.parametrize("n,max_stones", [(15, 90), (9, 45)])
def test_forbidden_map_matches_jax(variant, n, max_stones):
    """1,024 random boards a case (4,096 in all): both maps equal JAX's."""
    rng = np.random.RandomState(n + len(variant))
    boards = _random_boards(rng, 1024, n, max_stones)
    tenv = GomokuEnv(board_size=n, **VARIANTS[variant])
    jb, tb = jnp.asarray(boards), torch.from_numpy(boards)
    jf, j5 = _jax_forbidden(n, variant)(jb == 0, jb == 1)
    tf, t5 = tenv.forbidden_map(tb == 0, tb == 1)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(t5.numpy(), np.asarray(j5))
    assert tf.any() and t5.any()


def test_pieces_match_jax():
    """``_three_maps`` (plain and refined) and ``_four_counts`` equal JAX's
    on random 15x15 boards."""
    n = 15
    boards = _random_boards(np.random.RandomState(4), 64, n, 90)
    jenv, tenv = JaxGomoku(board_size=n, use_renju=True), GomokuEnv(board_size=n, use_renju=True)

    def jax_pieces(black, white):
        empty = ~(black | white)
        forb, _ = jenv.forbidden_map(black, white)
        return (jnp.stack(jenv._three_maps(black, white, empty)),
                jnp.stack(jenv._three_maps(black, white, empty, forb)),
                jnp.stack(jenv._four_counts(black, white, empty)))

    jb, tb = jnp.asarray(boards), torch.from_numpy(boards)
    want = jax.jit(jax.vmap(jax_pieces))(jb == 0, jb == 1)
    black, white = tb == 0, tb == 1
    empty = ~(black | white)
    forb, _ = tenv.forbidden_map(black, white)
    got = (torch.stack(tenv._three_maps(black, white, empty), 1),
           torch.stack(tenv._three_maps(black, white, empty, forb), 1),
           torch.stack(tenv._four_counts(black, white, empty), 1))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _fours(board_12):
    """The port's per-direction four counts on a 9x9 board coded as
    tests/test_renju_fuzz.py codes it (1 black, 2 white)."""
    env = GomokuEnv(board_size=9, use_renju=True)
    b = torch.from_numpy(board_12)[None]
    black, white = b == 1, b == 2
    return env._four_counts(black, white, ~(black | white))


def test_edge_truncated_window_is_not_a_four():
    board = np.zeros((9, 9), np.int8)
    for x, y in ((4, 5), (5, 6), (6, 7)):
        board[x, y] = 1
    board[3, 4] = 2
    assert sum(int(c[0, 7, 8]) for c in _fours(board)) == 0


def test_overline_completion_is_not_a_four():
    board = np.zeros((9, 9), np.int8)
    board[0, 8] = 2
    for r in (1, 3, 4, 6):
        board[r, 8] = 1
    board[8, 8] = 2
    assert sum(int(c[0, 2, 8]) for c in _fours(board)) == 0


def test_real_four_still_counts():
    board = np.zeros((9, 9), np.int8)
    for c in (2, 3, 4):
        board[4, c] = 1
    assert sum(int(c[0, 4, 5]) for c in _fours(board)) >= 1


# name: (variant, black, white, cell, forbidden there, exact five there)
CASES = {
    "renju_overline": ("renju", [(7, 3), (7, 4), (7, 5), (7, 6), (7, 8)], [], (7, 7), True, False),
    "renju_exact_five": ("renju", [(7, 3), (7, 4), (7, 5), (7, 6)], [], (7, 7), False, True),
    "renju_exact_five_left": ("renju", [(7, 3), (7, 4), (7, 5), (7, 6)], [], (7, 2), False, True),
    "renju_double_three": ("renju", [(7, 5), (7, 6), (5, 7), (6, 7)], [], (7, 7), True, False),
    "renju_single_three": ("renju", [(7, 5), (7, 6)], [], (7, 7), False, False),
    "renju_blocked_three": ("renju", [(7, 5), (7, 6), (5, 7), (6, 7)], [(4, 7), (8, 7)],
                            (7, 7), False, False),
    "renju_double_four": ("renju", [(7, 4), (7, 5), (7, 6), (4, 7), (5, 7), (6, 7)],
                          [(7, 3), (3, 7)], (7, 7), True, False),
    "renju_four_three": ("renju", [(7, 4), (7, 5), (7, 6), (5, 7), (6, 7)], [(7, 3)],
                         (7, 7), False, False),
    "renju_edge_three": ("renju", [(0, 7), (2, 7), (1, 5), (1, 6)], [], (1, 7), False, False),
    "renju_diagonal_threes": ("renju", [(5, 5), (6, 6), (5, 9), (6, 8)], [], (7, 7), True, False),
    "renju_overline_gap": ("renju", [(7, 3), (7, 4), (7, 6), (7, 7), (7, 8)], [], (7, 5),
                           True, False),
    "omok_double_three": ("omok", [(7, 5), (7, 6), (5, 7), (6, 7)], [], (7, 7), True, False),
    "omok_double_four_allowed": ("omok", [(7, 4), (7, 5), (7, 6), (4, 7), (5, 7), (6, 7)],
                                 [(7, 3), (3, 7), (7, 8), (8, 7)], (7, 7), False, False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_classic_positions(name):
    """The forbidden-point cases of tests/test_gomoku.py, each also equal to
    JAX's maps on the whole board."""
    variant, black, white, (r, c), want_f, want_5 = CASES[name]
    b = _board(15, black, white)
    tb, jb = torch.from_numpy(b)[None], jnp.asarray(b)[None]
    tf, t5 = GomokuEnv(board_size=15, **VARIANTS[variant]).forbidden_map(tb == 0, tb == 1)
    jf, j5 = _jax_forbidden(15, variant)(jb == 0, jb == 1)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(t5.numpy(), np.asarray(j5))
    assert bool(tf[0, r, c]) == want_f and bool(t5[0, r, c]) == want_5


def _play(env, moves, B=1):
    st = env.init(B, device="cpu")
    for m in moves:
        st = env.step(st, torch.full((B,), m))
    return st


def test_white_not_restricted():
    env, n = GomokuEnv(board_size=15, use_renju=True), 15
    st = _play(env, [7 * n + 5, 0, 7 * n + 6, 1, 5 * n + 7, 2, 6 * n + 7, 3])
    assert int(st.to_play[0]) == 0
    assert not bool(env.legal_mask(st)[0, 7 * n + 7])
    st = env.step(st, torch.tensor([n + 1]))
    assert bool(env.legal_mask(st)[0, 7 * n + 7])


@pytest.mark.parametrize("variant", ["renju", "omok"])
def test_overline_is_no_win_for_black(variant):
    """Black fills the gap of B B B B . B: six, no win for black; white
    making six wins."""
    n = 15
    env = GomokuEnv(board_size=n, **VARIANTS[variant])
    moves = []
    for i, col in enumerate([3, 4, 5, 6, 8]):
        moves += [7 * n + col, 2 * i]
    st = env.step(_play(env, moves), torch.tensor([7 * n + 7]))
    assert not bool(st.terminal[0])
    # The same shape for white: white's six wins.
    moves = [14 * n + 14]
    for i, col in enumerate([3, 4, 5, 6, 8]):
        moves += [7 * n + col, 2 * i]
    st = env.step(_play(env, moves), torch.tensor([7 * n + 7]))
    assert bool(st.terminal[0]) and int(st.winner[0]) == 1
    # Freestyle: the same six wins for black.
    free = GomokuEnv(board_size=n)
    moves = []
    for i, col in enumerate([3, 4, 5, 6, 8]):
        moves += [7 * n + col, 2 * i]
    st = free.step(_play(free, moves), torch.tensor([7 * n + 7]))
    assert bool(st.terminal[0]) and int(st.winner[0]) == 0


def test_pro_long_masks():
    n = 15
    env = GomokuEnv(board_size=n, use_pro_long_opening=True)
    st = env.init(1, device="cpu")
    legal = env.legal_mask(st)[0]
    assert int(legal.sum()) == 1 and bool(legal[7 * n + 7])
    st = _play(env, [7 * n + 7, 7 * n + 8])
    legal = env.legal_mask(st)[0]
    assert not bool(legal[7 * n + 6]) and not bool(legal[9 * n + 9])
    assert bool(legal[7 * n + 10])
    st = env.step(st, torch.tensor([7 * n + 10]))
    assert int(env.legal_mask(st)[0].sum()) == n * n - 3  # unrestricted


def test_step_win_agrees_with_run_maps():
    """``step``'s 40-cell line sample against the whole-board run maps: a
    move wins exactly where the run through it reaches five (black: exactly
    five under Renju)."""
    n, B = 9, 64
    rng = np.random.RandomState(11)
    for kw in ({}, {"use_renju": True}):
        env = GomokuEnv(board_size=n, **kw)
        st = env.init(B, device="cpu")
        for _ in range(40):
            legal = env.legal_mask(st).numpy()
            acts = np.array([rng.choice(np.flatnonzero(legal[b])) if legal[b].any() else 0
                             for b in range(B)])
            mover = st.board == st.to_play.to(torch.int8)[:, None, None]
            runs = _run_through_maps(mover, cap=6).flatten(2)[:, torch.arange(B), acts]
            black = st.to_play == 0
            win = (runs >= 5).any(0)
            if kw:
                win = torch.where(black, (runs == 5).any(0), win)
            live = ~st.terminal
            nxt = env.step(st, torch.from_numpy(acts))
            got = nxt.terminal & (nxt.winner == st.to_play)
            assert torch.equal(got[live], win[live])
            st = nxt


def test_registry_builds_variants():
    for kw in VARIANTS.values():
        env = registry.create_game("gomoku", 15, **kw)
        assert isinstance(env, GomokuEnv)
        assert all(getattr(env, k) for k in kw)


@pytest.mark.parametrize("flag,field", [("--use-renju", "use_renju"),
                                        ("--use-omok", "use_omok")])
def test_train_cli_trains_a_variant(flag, field, tmp_path, monkeypatch):
    """``scripts/train.py`` with a variant flag runs an iteration at 7x7 on
    the CPU, on the variant's env."""
    from alphazero_tpu_torch.scripts import train as train_cli

    made = []
    create = registry.create_game

    def recording(*args, **kw):
        made.append(create(*args, **kw))
        return made[-1]

    monkeypatch.setattr(registry, "create_game", recording)
    train_cli.main(["--device", "cpu", "--board-size", "7", "--blocks", "1",
                    "--channels", "8", "--iterations", "1", "--games-per-iteration", "4",
                    "--simulations", "8", "--wave", "4", "--train-steps", "1",
                    "--train-batch-size", "16", "--min-replay", "1",
                    "--checkpoint-dir", str(tmp_path), flag])
    assert made and all(getattr(env, field) for env in made)
    with open(tmp_path / "history.json") as f:
        history = json.load(f)
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
