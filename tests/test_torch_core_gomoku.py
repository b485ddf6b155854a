"""The port's Zobrist tables and Gomoku env against the JAX package, exactly.

Random legal playouts are chosen with numpy and fed to both envs; board,
hash, winner, terminal, legal mask and observation must agree at every ply.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.core import zobrist as jzob
from alphazero_tpu.games.gomoku import GomokuEnv as JaxGomoku
from alphazero_tpu_torch.core import registry, zobrist
from alphazero_tpu_torch.core.types import GameResult, result_from_winner
from alphazero_tpu_torch.games.gomoku import GomokuEnv


def _pair(h: torch.Tensor) -> np.ndarray:
    k0, k1 = zobrist.split_key(h)
    return np.stack([k0.numpy(), k1.numpy()], -1).astype(np.uint32)


def test_zobrist_tables_match():
    jt = jzob.ZobristTable(num_pieces=2, num_positions=225, num_features=3)
    tt = zobrist.ZobristTable(num_pieces=2, num_positions=225, num_features=3)
    np.testing.assert_array_equal(_pair(tt.piece("cpu")), np.asarray(jt.piece))
    np.testing.assert_array_equal(_pair(tt.player("cpu")),
                                  np.asarray(jt.player))
    np.testing.assert_array_equal(_pair(tt.feature("cpu")),
                                  np.asarray(jt._feature))


def test_board_hash_matches():
    rng = np.random.RandomState(3)
    boards = rng.randint(-1, 2, size=(6, 49)).astype(np.int8)
    to_play = rng.randint(0, 2, size=6).astype(np.int32)
    jt = jzob.ZobristTable(num_pieces=2, num_positions=49)
    tt = zobrist.ZobristTable(num_pieces=2, num_positions=49)
    want = np.stack([
        np.asarray(jzob.board_hash(jt, jnp.asarray(b), jnp.asarray(p)))
        for b, p in zip(boards, to_play)
    ])
    got = zobrist.board_hash(tt, torch.from_numpy(boards),
                             torch.from_numpy(to_play))
    np.testing.assert_array_equal(_pair(got), want)


def test_registry():
    env = registry.create_game("gomoku", 9)
    assert env.num_actions == 81
    assert registry.create_game("chess").num_actions == 4672
    assert registry.registered_games() == ["chess", "go", "gomoku"]
    with pytest.raises(KeyError):
        registry.create_game("shogi")
    assert registry.create_game("gomoku", 15, use_renju=True).use_renju


def test_result_from_winner():
    w = torch.tensor([-1, 0, 1, 0])
    t = torch.tensor([True, True, True, False])
    assert result_from_winner(w, t).tolist() == [
        GameResult.DRAW, GameResult.WIN_PLAYER1, GameResult.WIN_PLAYER2,
        GameResult.ONGOING]


def _compare(jenv, jst, tenv, tst):
    np.testing.assert_array_equal(tst.board.numpy(), np.asarray(jst.board))
    np.testing.assert_array_equal(tst.to_play.numpy(), np.asarray(jst.to_play))
    np.testing.assert_array_equal(tst.last_moves.numpy(),
                                  np.asarray(jst.last_moves))
    np.testing.assert_array_equal(tst.move_count.numpy(),
                                  np.asarray(jst.move_count))
    np.testing.assert_array_equal(tst.terminal.numpy(), np.asarray(jst.terminal))
    np.testing.assert_array_equal(tst.winner.numpy(), np.asarray(jst.winner))
    np.testing.assert_array_equal(_pair(tst.hash), np.asarray(jst.hash))
    np.testing.assert_array_equal(
        tenv.legal_mask(tst).numpy(),
        np.asarray(jax.vmap(jenv.legal_mask)(jst)))
    np.testing.assert_array_equal(
        tenv.observation(tst).float().numpy(),
        np.asarray(jax.vmap(jenv.observation)(jst)).astype(np.float32))


def test_random_playout_fuzz_15x15():
    """B=32 random legal playouts to terminal (terminal lanes keep playing
    no-op moves), compared field by field at every ply."""
    B, n = 32, 15
    jenv, tenv = JaxGomoku(board_size=n), GomokuEnv(board_size=n)
    jst = jax.vmap(lambda _: jenv.init())(jnp.arange(B))
    tst = tenv.init(B, device="cpu")
    jstep = jax.jit(jax.vmap(jenv.step))
    rng = np.random.RandomState(0)
    # Dense openings (no five possible early) would make games long: bias
    # half the lanes toward a small central region so wins come quickly.
    _compare(jenv, jst, tenv, tst)
    for ply in range(n * n):
        legal = tenv.legal_mask(tst).numpy()
        acts = np.zeros(B, np.int64)
        for b in range(B):
            cand = np.flatnonzero(legal[b])
            if b % 2 and cand.size:
                r, c = cand // n, cand % n
                near = cand[(abs(r - 7) <= 2) & (abs(c - 7) <= 2)]
                cand = near if near.size else cand
            acts[b] = rng.choice(cand) if cand.size else 0
        jst = jstep(jst, jnp.asarray(acts, jnp.int32))
        tst = tenv.step(tst, torch.from_numpy(acts))
        _compare(jenv, jst, tenv, tst)
        if bool(tst.terminal.all()):
            break
    assert bool(tst.terminal.all())
    assert int((tst.winner >= 0).sum()) > 0


def test_arena_rows_roundtrip():
    env = GomokuEnv(board_size=7)
    st = env.init(4, device="cpu")
    st = env.step(st, torch.tensor([3, 10, 24, 48]))
    st = env.step(st, torch.tensor([4, 11, 25, 47]))
    board, meta = env.arena_rows(st)
    assert board.dtype == torch.int8 and meta.dtype == torch.int32
    back = env.from_arena_rows(board, meta)
    for f in ("board", "to_play", "last_moves", "move_count", "terminal",
              "winner", "hash"):
        assert torch.equal(getattr(back, f), getattr(st, f)), f
