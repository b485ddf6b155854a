"""The port's transposition table (``MCTSConfig.tt_size``): analogs of
tests/test_tt.py's Gomoku tests, and the wave path's hits and stores
against the JAX package's."""
import jax
import numpy as np
import pytest
import torch

from alphazero_tpu.mcts import search as jsearch
from alphazero_tpu_torch.games.gomoku import GomokuEnv
from alphazero_tpu_torch.mcts import search as S
from alphazero_tpu_torch.mcts.search import MCTSConfig, search
from alphazero_tpu_torch.models.stub import make_uniform_eval_fn
from test_torch_search import evaluators, roots


def _play(env, actions, B=1):
    s = env.init(B, device="cpu")
    for a in actions:
        s = env.step(s, torch.full((B,), a))
    return s


def _entry(K=4):
    v = torch.full((1, 1), 0.625)
    tv = torch.full((1, 1, K), 0.25)
    ta = torch.arange(K)[None, None]
    return v, tv, ta


def test_store_then_lookup_hit():
    env = GomokuEnv(board_size=5)
    h = env.position_hash(_play(env, (0, 1, 2, 3)))[:, None]  # [1, 1]
    tt = S._tt_init(1, 16, 4, "cpu")
    el = torch.ones((1, 1), dtype=torch.bool)
    v, tv, ta = _entry()
    v2, _, _ = S._tt_process(tt, h, el, el, v, tv, ta)
    assert float(v2[0, 0]) == 0.625 and int(tt.stores[0]) == 1
    assert int(tt.hits[0]) == 0
    # The same position again: the cached entry replaces the new one.
    v3, tv3, ta3 = S._tt_process(tt, h, el, el, torch.zeros((1, 1)),
                                 torch.zeros((1, 1, 4)),
                                 torch.full((1, 1, 4), 9))
    assert float(v3[0, 0]) == 0.625
    assert ta3[0, 0].tolist() == [0, 1, 2, 3] and tv3[0, 0].tolist() == [0.25] * 4
    assert int(tt.hits[0]) == 1 and int(tt.stores[0]) == 1


def test_collision_is_a_miss():
    """A different position in the same slot does not hit: all 64 bits of
    the key are compared."""
    env = GomokuEnv(board_size=5)
    h1 = env.position_hash(_play(env, (0, 1, 2, 3)))[:, None]
    h2 = env.position_hash(_play(env, (5, 6, 7, 8)))[:, None]
    tt = S._tt_init(1, 1, 4, "cpu")  # one slot: every store collides
    el = torch.ones((1, 1), dtype=torch.bool)
    S._tt_process(tt, h1, el, el, *_entry())
    v, _, _ = S._tt_process(tt, h2, el, el, torch.ones((1, 1)),
                            *_entry()[1:])
    assert int(tt.hits[0]) == 0 and float(v[0, 0]) == 1.0
    assert int(tt.key[0, 0]) == int(h2[0, 0])  # always replace


def test_same_slot_other_high_word_is_a_miss():
    """Keys that share the slot bits and the low word but differ in the
    high word miss (the compare covers the whole key)."""
    tt = S._tt_init(1, 8, 4, "cpu")
    el = torch.ones((1, 1), dtype=torch.bool)
    h1 = torch.tensor([[(7 << 32) | 5]])
    h2 = torch.tensor([[(9 << 32) | 5]])
    S._tt_process(tt, h1, el, el, *_entry())
    S._tt_process(tt, h2, el, el, *_entry())
    assert int(tt.hits[0]) == 0 and int(tt.stores[0]) == 2


def test_first_writer_in_a_wave_wins():
    """Two canonical misses on one slot in one wave: the first stores, both
    count as store attempts; a duplicate walker shares the verdict but is
    not counted."""
    tt = S._tt_init(1, 4, 2, "cpu")
    h = torch.tensor([[1, 5, 1]])  # slots 1, 1, 1
    lookup = torch.ones((1, 3), dtype=torch.bool)
    store = torch.tensor([[True, True, False]])
    value = torch.tensor([[0.5, -0.5, 0.5]])
    S._tt_process(tt, h, lookup, store, value, torch.ones((1, 3, 2)),
                  torch.zeros((1, 3, 2), dtype=torch.long))
    assert int(tt.key[0, 1]) == 1 and float(tt.value[0, 1]) == 0.5
    assert int(tt.stores[0]) == 2 and int(tt.hits[0]) == 0
    assert bool(tt.valid[0, 1]) and int(tt.valid.sum()) == 1


def test_transposed_orders_share_hash():
    env = GomokuEnv(board_size=5)

    def h(actions):
        return int(env.position_hash(_play(env, actions))[0])

    assert h([0, 1, 2, 3]) == h([2, 1, 0, 3])
    assert h([0, 1, 2, 3]) != h([0, 1, 2, 4])


@pytest.mark.parametrize("wave", [1, 4])
def test_search_invariant_with_tt(wave):
    """With a deterministic evaluator the table changes nothing: it
    substitutes a copy of what the evaluator returns (bit for bit in the
    port)."""
    env = GomokuEnv(board_size=4)
    eval_fn = make_uniform_eval_fn(env.num_actions, value_noise=0.1)
    states = _play(env, range(8), B=2)  # 8 empty cells: deep trees
    kw = dict(num_simulations=192, wave_size=wave, max_children=16,
              dirichlet_epsilon=0.0)
    on = search(env, eval_fn, states, MCTSConfig(tt_size=1024, **kw))
    off = search(env, eval_fn, states, MCTSConfig(**kw))
    assert torch.equal(on.visit_counts, off.visit_counts)
    assert torch.equal(on.tree.value_sum, off.tree.value_sum)
    assert int(on.tree.tt.stores.sum()) > 0 and int(on.tree.tt.hits.sum()) > 0


@pytest.mark.parametrize("wave", [1, 4])
def test_warm_table_hits_across_searches(wave):
    """A second identical search over the first one's table hits on every
    expansion that stored, and leaves the first table untouched."""
    env = GomokuEnv(board_size=5)
    eval_fn = make_uniform_eval_fn(env.num_actions, value_noise=0.1)
    states = env.init(2, device="cpu")
    cfg = MCTSConfig(num_simulations=64, wave_size=wave, tt_size=512,
                     max_children=8, dirichlet_epsilon=0.0)
    out1 = search(env, eval_fn, states, cfg)
    stores1 = out1.tree.tt.stores.clone()
    assert (stores1 > 0).all()
    out2 = search(env, eval_fn, states, cfg, tt=out1.tree.tt)
    assert torch.equal(out1.tree.tt.stores, stores1)
    hits2 = out2.tree.tt.hits
    stores2 = out2.tree.tt.stores - stores1
    assert (hits2 >= stores1 * 0.8).all()
    assert (stores2 <= stores1 * 0.2 + 1).all()
    assert torch.equal(out1.visit_counts, out2.visit_counts)


def test_tt_survives_reroot():
    env = GomokuEnv(board_size=5)
    eval_fn = make_uniform_eval_fn(env.num_actions, value_noise=0.1)
    config = MCTSConfig(num_simulations=32, wave_size=4, tt_size=64,
                        max_children=8, tree_reuse=True, reuse_cap=16)
    states = env.init(2, device="cpu")
    out = search(env, eval_fn, states, config)
    stores = int(out.tree.tt.stores.sum())
    assert stores > 0
    action = out.visit_counts.argmax(-1).int()
    new_states = env.step(states, action)
    logits, value = eval_fn(env.observation(new_states), env.to_play(new_states))
    tree2 = S.reroot(env, out.tree, action, new_states, logits, value, config)
    assert tree2.tt is out.tree.tt and int(tree2.tt.stores.sum()) == stores


def test_tt_hit_rate_accounting_canonical():
    """hits + stores is the number of canonical expansions: duplicates and
    terminal walkers count in neither."""
    env = GomokuEnv(board_size=4)
    eval_fn = make_uniform_eval_fn(env.num_actions, value_noise=0.1)
    out = search(env, eval_fn, env.init(1, device="cpu"),
                 MCTSConfig(num_simulations=64, wave_size=4, tt_size=256,
                            max_children=8))
    tree = out.tree
    lookups = int(tree.tt.hits.sum() + tree.tt.stores.sum())
    expanded = int((tree.visits[0, 1:] > 0).sum())  # canonical nodes
    assert 0 < lookups <= 64 and lookups == expanded - int(tree.terminal[0, 1:].sum())


@pytest.mark.parametrize("wave,n,seed,plies,tt", [
    (4, 4, 1, 8, 64), (16, 5, 2, 10, 256), (16, 7, 3, 30, 16),
])
def test_wave_table_counts_match_jax(wave, n, seed, plies, tt):
    """Hits and stores of the wave path equal JAX's, wave duplicates and
    same-slot stores included.  Zero values keep every statistic integral,
    so the JAX wave path's bf16 reads of child statistics are exact."""
    jenv, jst, tenv, tst = roots(n, 8, seed, plies)
    jev, tev = evaluators(n * n)
    kw = dict(num_simulations=64, wave_size=wave, max_children=16,
              dirichlet_epsilon=0.0, tt_size=tt)
    jout = jsearch.make_host_search(jenv, jev, jsearch.MCTSConfig(**kw))(
        jst, jax.random.key(0))
    tout = S.make_host_search(tenv, tev, MCTSConfig(**kw))(tst)
    np.testing.assert_array_equal(tout.visit_counts.numpy(),
                                  np.asarray(jout.visit_counts))
    np.testing.assert_array_equal(tout.tree.tt.hits.numpy(),
                                  np.asarray(jout.tree.tt.hits))
    np.testing.assert_array_equal(tout.tree.tt.stores.numpy(),
                                  np.asarray(jout.tree.tt.stores))
    assert int(tout.tree.tt.stores.sum()) > 0
