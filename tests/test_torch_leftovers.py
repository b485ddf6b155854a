"""The small public names of the JAX package that a caller may use, against
their JAX originals on the same inputs: ``GomokuEnv.observation_basic``,
``core/types.to_reference_player``, ``models/stub.uniform_eval_fn``,
``mcts/search.ROOT`` and the ``core/zobrist`` helpers (``empty_hash``,
``hxor``, ``ZobristTable.{piece,player,feature}_key``), hashes as JAX's
uint32 pairs."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from alphazero_tpu.core import types as jtypes
from alphazero_tpu.core import zobrist as jzob
from alphazero_tpu.games.gomoku import GomokuEnv as JaxGomoku
from alphazero_tpu.mcts import search as jsearch
from alphazero_tpu.models import stub as jstub
from alphazero_tpu_torch.core import types, zobrist
from alphazero_tpu_torch.games.gomoku import GomokuEnv
from alphazero_tpu_torch.mcts import search
from alphazero_tpu_torch.models import stub


def _pair(h: torch.Tensor) -> np.ndarray:
    k0, k1 = zobrist.split_key(h)
    return np.stack([k0.numpy(), k1.numpy()], -1).astype(np.uint32)


def test_gomoku_observation_basic_equals_jax():
    """16 lanes after 0..15 random legal plies on 9x9."""
    B, n = 16, 9
    jenv, tenv = JaxGomoku(board_size=n), GomokuEnv(board_size=n)
    jst = jax.vmap(lambda _: jenv.init())(jnp.arange(B))
    tst = tenv.init(B, device="cpu")
    jstep = jax.jit(jax.vmap(jenv.step))
    rng = np.random.RandomState(5)
    for ply in range(B):
        legal = tenv.legal_mask(tst).numpy()
        acts = np.array([rng.choice(np.flatnonzero(legal[b])) if b > ply else 0
                         for b in range(B)])
        live = np.arange(B) > ply
        nxt_j = jstep(jst, jnp.asarray(acts, jnp.int32))
        jst = jax.tree_util.tree_map(
            lambda new, old: jnp.where(
                jnp.asarray(live).reshape((B,) + (1,) * (new.ndim - 1)), new, old),
            nxt_j, jst)
        tst = types.where_lanes(torch.from_numpy(live), tenv.step(tst, torch.from_numpy(acts)),
                                tst)
    got = tenv.observation_basic(tst)
    want = np.asarray(jax.vmap(jenv.observation_basic)(jst)).astype(np.float32)
    assert got.shape == (B, 3, n, n)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert set(np.unique(tst.move_count.numpy())) == set(range(B))


def test_to_reference_player_equals_jax():
    p = np.array([0, 1, 1, 0, 1], np.int32)
    np.testing.assert_array_equal(
        types.to_reference_player(torch.from_numpy(p)).numpy(),
        np.asarray(jtypes.to_reference_player(jnp.asarray(p))))


def test_uniform_eval_fn_equals_jax():
    obs = np.random.RandomState(2).rand(3, 11, 7, 7).astype(np.float32)
    logits, value = stub.uniform_eval_fn(torch.from_numpy(obs))
    jl, jv = jstub.uniform_eval_fn(jnp.asarray(obs))
    for got, want in ((logits, jl), (value, jv)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_root_equals_jax():
    assert search.ROOT == int(jsearch.ROOT) == 0


def test_zobrist_keys_and_helpers_equal_jax():
    """Each key method on scalars and on index tensors, the empty hash, and
    hxor of several keys: the port's int64 keys split into JAX's pairs."""
    kw = dict(num_pieces=3, num_positions=81, num_features=2, feature_cardinality=16)
    jt, tt = jzob.ZobristTable(**kw), zobrist.ZobristTable(**kw)
    rng = np.random.RandomState(9)
    pieces, pos = rng.randint(0, 3, 12), rng.randint(0, 81, 12)
    vals = rng.randint(0, 16, 12)
    np.testing.assert_array_equal(
        _pair(tt.piece_key(torch.from_numpy(pieces), torch.from_numpy(pos))),
        np.asarray(jt.piece_key(jnp.asarray(pieces), jnp.asarray(pos))))
    np.testing.assert_array_equal(_pair(tt.piece_key(2, 40)),
                                  np.asarray(jt.piece_key(2, 40)))
    for pl in (0, 1):
        np.testing.assert_array_equal(_pair(tt.player_key(pl)),
                                      np.asarray(jt.player_key(pl)))
    np.testing.assert_array_equal(
        _pair(tt.feature_key(1, torch.from_numpy(vals))),
        np.asarray(jt.feature_key(1, jnp.asarray(vals))))
    np.testing.assert_array_equal(_pair(zobrist.empty_hash()), np.asarray(jzob.empty_hash()))
    keys = [tt.piece_key(int(a), int(b)) for a, b in zip(pieces[:5], pos[:5])]
    jkeys = [jt.piece_key(int(a), int(b)) for a, b in zip(pieces[:5], pos[:5])]
    combined = zobrist.hxor(zobrist.empty_hash(), *keys, tt.player_key(1))
    np.testing.assert_array_equal(
        _pair(combined), np.asarray(jzob.hxor(jzob.empty_hash(), *jkeys, jt.player_key(1))))
    assert int(zobrist.hxor(combined, combined)) == int(zobrist.empty_hash())
