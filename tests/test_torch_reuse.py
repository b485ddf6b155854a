"""Tree reuse in the port (``reroot``, ``HostReuseSearch``, the actor's
reuse branch): every array of a rerooted tree and every move's fresh
simulations against the JAX package, and analogs of tests/test_reuse.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.mcts import search as jsearch
from alphazero_tpu_torch.games.gomoku import GomokuEnv
from alphazero_tpu_torch.mcts import search as tsearch
from alphazero_tpu_torch.mcts.search import HostReuseSearch, MCTSConfig, reroot, search
from alphazero_tpu_torch.models.stub import make_uniform_eval_fn
from alphazero_tpu_torch.selfplay.actor import SelfPlayConfig, make_host_actor
from test_torch_search import evaluators, peaked_evaluators, roots
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N = 7
A = N * N
B = 4
ENV = GomokuEnv(board_size=N)
ARRAYS = ("root_child", "root_evisits", "root_evalue", "visits", "value_sum",
          "parent", "terminal", "tvalue", "depth", "paction", "pslot",
          "prior", "cchild", "caction")


def _fresh(config, eval_fn=None):
    eval_fn = eval_fn or make_uniform_eval_fn(A)
    states = ENV.init(B, device="cpu")
    return states, search(ENV, eval_fn, states, config), eval_fn


def _reroot(states, tree, action, config, eval_fn):
    new_states = ENV.step(states, action)
    logits, value = eval_fn(ENV.observation(new_states), ENV.to_play(new_states))
    return reroot(ENV, tree, action, new_states, logits, value, config)


def _argmax(out):
    return out.visit_counts.argmax(-1).int()


@pytest.mark.parametrize("wave,cap,sims,plies,unexpanded", [
    (1, 64, 48, 4, False), (1, 64, 32, 4, True), (4, 16, 48, 10, False),
    (4, 16, 24, 4, True), (1, 8, 32, 20, False),
])
def test_reroot_arrays_match_jax(wave, cap, sims, plies, unexpanded):
    """Every array of the rerooted tree equals JAX ``reroot``'s on the same
    tree (odd lanes play a never-expanded action when ``unexpanded``), and
    the states of every allocated node are the same positions.  The root
    prior is the masked softmax of the fresh logits, equal to JAX's up to
    the order of its f32 sums (a few ulp)."""
    jenv, jst, tenv, tst = roots(N, B, 1, plies)
    jev, tev = evaluators(A)
    kw = dict(num_simulations=sims, dirichlet_epsilon=0.0, tree_reuse=True,
              reuse_cap=cap, wave_size=wave)
    jcfg, tcfg = jsearch.MCTSConfig(**kw), MCTSConfig(**kw)
    jout = jsearch.make_host_search(jenv, jev, jcfg)(jst, jax.random.key(0))
    tout = search(tenv, tev, tst, tcfg)
    counts = tout.visit_counts.numpy()
    np.testing.assert_array_equal(counts, np.asarray(jout.visit_counts))
    act = counts.argmax(-1)
    if unexpanded:
        legal = tenv.legal_mask(tst).numpy()
        for b in range(1, B, 2):
            act[b] = np.flatnonzero(legal[b] & (counts[b] == 0))[0]
    jns = jax.vmap(jenv.step)(jst, jnp.asarray(act, jnp.int32))
    tns = tenv.step(tst, torch.from_numpy(act))
    jl, jv = jev(jax.vmap(jenv.observation)(jns))
    tl, tv = tev(tenv.observation(tns))
    jt = jax.jit(lambda *a: jsearch.reroot(jenv, *a, jcfg))(
        jout.tree, jnp.asarray(act, jnp.int32), jns, jl, jv)
    tt = reroot(tenv, tout.tree, torch.from_numpy(act).int(), tns, tl, tv, tcfg)
    for name in ARRAYS:
        want = np.asarray(getattr(jt, name)).astype(np.float64)
        got = getattr(tt, name).double().numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_allclose(tt.root_prior.numpy(), np.asarray(jt.root_prior),
                               rtol=1e-6, atol=0)
    assert (tt.visits[1::2, 0] == 1).all() == unexpanded
    # The state rows of every allocated node hold the same positions.
    live = tt.visits > 0
    tstate = tenv.from_arena_rows(*(x[live] for x in tt.states))
    jstate = jsearch._unpack_state(
        jax.tree_util.tree_map(lambda x: x[np.asarray(live)], jt.states),
        jenv.init(), jenv)
    np.testing.assert_array_equal(tstate.board.numpy(), np.asarray(jstate.board))
    np.testing.assert_array_equal(tstate.move_count.numpy(),
                                  np.asarray(jstate.move_count))


class TestReroot:
    CFG = MCTSConfig(num_simulations=48, dirichlet_epsilon=0.0,
                     tree_reuse=True, reuse_cap=64)

    def test_root_stats_equal_played_child(self):
        states, out, eval_fn = _fresh(self.CFG)
        action = _argmax(out)
        child0 = out.tree.root_child.gather(1, action.long()[:, None])[:, 0]
        assert (child0 >= 0).all()
        old_v = out.tree.visits.gather(1, child0.long()[:, None])[:, 0].clone()
        old_w = out.tree.value_sum.gather(1, child0.long()[:, None])[:, 0].clone()
        new = _reroot(states, out.tree, action, self.CFG, eval_fn)
        assert torch.equal(new.visits[:, 0], old_v)
        assert torch.equal(new.value_sum[:, 0], old_w)

    def test_root_edges_equal_grandchild_stats(self):
        states, out, eval_fn = _fresh(self.CFG)
        tree = out.tree
        action = _argmax(out)
        child0 = tree.root_child.gather(1, action.long()[:, None])[:, 0].numpy()
        parent, visits = tree.parent.numpy(), tree.visits.numpy().copy()
        vsum, pact = tree.value_sum.numpy().copy(), tree.paction.numpy()
        new = _reroot(states, tree, action, self.CFG, eval_fn)
        for b in range(B):
            expect_v, expect_w = np.zeros(A, np.int64), np.zeros(A, np.float32)
            for k in np.nonzero(parent[b] == child0[b])[0]:
                expect_v[pact[b, k]] += visits[b, k]
                expect_w[pact[b, k]] += vsum[b, k]
            np.testing.assert_array_equal(new.root_evisits[b].numpy(), expect_v)
            np.testing.assert_array_equal(new.root_evalue[b].numpy(), expect_w)

    def test_unexpanded_action_gives_fresh_root(self):
        states, out, eval_fn = _fresh(self.CFG)
        counts = out.visit_counts.numpy()
        legal = ENV.legal_mask(states).numpy()
        action = torch.tensor([int(np.nonzero(legal[b] & (counts[b] == 0))[0][0])
                               for b in range(B)], dtype=torch.int32)
        new = _reroot(states, out.tree, action, self.CFG, eval_fn)
        assert (new.visits[:, 0] == 1).all()
        assert (new.root_evisits == 0).all() and (new.root_child == -1).all()
        assert (new.visits[:, 1:] == 0).all() and (new.parent == -1).all()

    def test_subtree_invariant_after_reroot(self):
        """Every surviving non-terminal node: visits == 1 + its children's
        visits."""
        states, out, eval_fn = _fresh(self.CFG)
        new = _reroot(states, out.tree, _argmax(out), self.CFG, eval_fn)
        nv, parent, term = new.visits.numpy(), new.parent.numpy(), new.terminal.numpy()
        for b in range(B):
            for j in np.nonzero(nv[b] > 0)[0]:
                if term[b, j]:
                    continue
                kids = (new.root_evisits[b].sum().item() if j == 0
                        else nv[b][parent[b] == j].sum())
                assert nv[b, j] == 1 + kids, (b, j)

    def test_truncation_keeps_root_stats(self):
        cfg = MCTSConfig(num_simulations=48, dirichlet_epsilon=0.0,
                         tree_reuse=True, reuse_cap=4)
        states, out, eval_fn = _fresh(cfg)
        action = _argmax(out)
        child0 = out.tree.root_child.gather(1, action.long()[:, None])[:, 0]
        old_v = out.tree.visits.gather(1, child0.long()[:, None])[:, 0].clone()
        new = _reroot(states, out.tree, action, cfg, eval_fn)
        assert torch.equal(new.visits[:, 0], old_v)
        assert ((new.visits[:, 4:] == 0) & (new.parent[:, 4:] == -1)).all()
        # Links to dropped nodes are gone: every child pointer is in range.
        assert (new.cchild < 4).all() and (new.root_child < 4).all()


def _reuse_pair(budget, wave, sims, cap, seed=0, plies=3):
    jenv, jst, tenv, tst = roots(N, B, seed, plies)
    jev, tev = peaked_evaluators(A)
    kw = dict(num_simulations=sims, dirichlet_epsilon=0.0, tree_reuse=True,
              reuse_cap=cap, reuse_budget=budget, wave_size=wave)
    return (jsearch.HostReuseSearch(jenv, jev, jsearch.MCTSConfig(**kw)), jenv,
            jst, HostReuseSearch(tenv, tev, MCTSConfig(**kw)), tenv, tst)


@pytest.mark.parametrize("budget,wave,sims,cap", [
    ("topup", 1, 32, 48), ("fixed", 1, 16, 32), ("topup", 4, 32, 48),
    ("fixed", 4, 32, 16),
])
def test_host_reuse_matches_jax(budget, wave, sims, cap):
    """Four moves: the same fresh simulations a move (``last_fresh_sims``),
    visit counts and root visits as JAX ``HostReuseSearch``."""
    jh, jenv, jst, th, tenv, tst = _reuse_pair(budget, wave, sims, cap)
    rng = jax.random.key(1)
    fresh = []
    for move in range(4):
        rng, sub = jax.random.split(rng)
        jout, tout = jh(jst, sub), th(tst)
        assert th.last_fresh_sims == jh.last_fresh_sims, move
        fresh.append(th.last_fresh_sims)
        np.testing.assert_array_equal(tout.visit_counts.numpy(),
                                      np.asarray(jout.visit_counts))
        np.testing.assert_array_equal(tout.tree.visits[:, 0].numpy(),
                                      np.asarray(jout.tree.visits[:, 0]))
        act = tout.visit_counts.numpy().argmax(-1)
        jh.notify_action(jnp.asarray(act, jnp.int32))
        th.notify_action(torch.from_numpy(act).int())
        jst = jax.vmap(jenv.step)(jst, jnp.asarray(act, jnp.int32))
        tst = tenv.step(tst, torch.from_numpy(act))
    if budget == "topup":
        assert fresh[0] == sims and min(fresh[1:]) < sims
    else:
        assert fresh == [sims] * 4


def test_topup_reaches_target_visits():
    cfg = MCTSConfig(num_simulations=32, dirichlet_epsilon=0.0,
                     tree_reuse=True, reuse_cap=48, reuse_budget="topup")
    hs = HostReuseSearch(ENV, peaked_evaluators(A)[1], cfg)
    states = ENV.init(B, device="cpu")
    for move in range(3):
        out = hs(states)
        assert (out.tree.visits[:, 0] >= cfg.num_simulations + 1).all(), move
        action = _argmax(out)
        hs.notify_action(action)
        states = ENV.step(states, action)
    assert hs.last_fresh_sims < cfg.num_simulations


def test_fixed_budget_runs_full_sims():
    cfg = MCTSConfig(num_simulations=16, dirichlet_epsilon=0.0,
                     tree_reuse=True, reuse_cap=32, reuse_budget="fixed")
    hs = HostReuseSearch(ENV, peaked_evaluators(A)[1], cfg)
    states = ENV.init(B, device="cpu")
    out = hs(states)
    action = _argmax(out)
    hs.notify_action(action)
    out2 = hs(ENV.step(states, action))
    assert hs.last_fresh_sims == 16
    assert (out2.tree.visits[:, 0] > 17).all()  # reused + fresh


def test_advance_equals_notify():
    """Re-rooting through ``advance`` (an opponent's move searched
    elsewhere) gives the tree that ``notify_action`` and ``run`` give."""
    cfg = MCTSConfig(num_simulations=24, dirichlet_epsilon=0.0,
                     tree_reuse=True, reuse_cap=32, renoise_every=1)
    ev = peaked_evaluators(A)[1]
    states = ENV.init(B, device="cpu")
    a, b = HostReuseSearch(ENV, ev, cfg), HostReuseSearch(ENV, ev, cfg)
    action = _argmax(a(states))
    b(states)
    new_states = ENV.step(states, action)
    a.notify_action(action)
    out_a = a(new_states)
    b.advance(action, new_states, noise_on=True)
    out_b = b(new_states)
    assert a.last_fresh_sims == b.last_fresh_sims
    assert torch.equal(out_a.visit_counts, out_b.visit_counts)
    assert torch.equal(out_a.tree.visits, out_b.tree.visits)


def test_reuse_needs_tree_reuse():
    with pytest.raises(ValueError):
        HostReuseSearch(ENV, make_uniform_eval_fn(A), MCTSConfig())


def test_actor_plays_games_with_reuse():
    cfg = SelfPlayConfig(mcts=MCTSConfig(num_simulations=24, tree_reuse=True,
                                         reuse_cap=32), max_moves=10)
    eval_fn = make_uniform_eval_fn(A, value_noise=0.1)
    step, states = make_host_actor(ENV, eval_fn, cfg, B, device="cpu")
    gen = torch.Generator().manual_seed(3)
    fresh = []
    for _ in range(6):
        states, rec = step(states, gen)
        np.testing.assert_allclose(rec.policy.sum(-1).numpy(), 1.0, atol=1e-5)
        fresh.append(step.search.last_fresh_sims)
    assert (states.move_count == 6).all()
    assert fresh[0] == 24 and max(fresh) <= 24
    step.reset()  # fresh games
    states2, _ = step(ENV.init(B, device="cpu"), gen)
    assert (states2.move_count == 1).all() and step.search.last_fresh_sims == 24


def test_recycle_with_reuse_raises():
    cfg = SelfPlayConfig(mcts=MCTSConfig(num_simulations=8, tree_reuse=True,
                                         reuse_cap=8), recycle=True)
    step, states = make_host_actor(ENV, make_uniform_eval_fn(A), cfg, B,
                                   device="cpu")
    with pytest.raises(ValueError, match="recycle"):
        step(states)


def test_depth1_ancestor_matches_jax():
    jenv, jst, tenv, tst = roots(N, B, 2, 6)
    jev, tev = evaluators(A)
    kw = dict(num_simulations=48, dirichlet_epsilon=0.0, wave_size=4)
    jt = jsearch.make_host_search(jenv, jev, jsearch.MCTSConfig(**kw))(
        jst, jax.random.key(0)).tree
    tt = search(tenv, tev, tst, MCTSConfig(**kw)).tree
    np.testing.assert_array_equal(
        tsearch._depth1_ancestor(tt.parent, 130).numpy(),
        np.asarray(jsearch._depth1_ancestor(jt.parent, 130)))
