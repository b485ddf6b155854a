"""The port's search on Go against JAX ``make_host_search``: root visit
counts at 5x5 and 9x9, at W=1 and W=16, and the table's hits and stores,
exactly.

The settings are those of ``tests/test_torch_search.py``, where the two
must agree exactly: the uniform evaluator with zero value, no Dirichlet
noise, and no non-root count above 256 (the JAX wave path reads child
statistics through bf16).  The roots are numpy-chosen random playouts, so
captures, ko points and passes lie in the trees.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.mcts import search as jsearch
from alphazero_tpu.models.stub import make_uniform_eval_fn as jax_uniform
from alphazero_tpu_torch.core.types import where_lanes
from alphazero_tpu_torch.mcts import search as tsearch
from alphazero_tpu_torch.models.stub import make_uniform_eval_fn
from test_torch_go import choose, envs, jax_fns, jax_init
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

B = 8


def go_roots(n: int, seed: int, plies: int):
    """(jax env, jax states, port env, port states): lane b after ``plies
    + b % 4`` numpy-chosen legal moves (passes rare), games still live."""
    jenv, tenv = envs(n)
    jstep, _ = jax_fns(jenv)
    rng = np.random.RandomState(seed)
    jst, tst = jax_init(jenv, B), tenv.init(B, device="cpu")
    for ply in range(plies + 3):
        acts = choose(rng, tenv.legal_mask(tst).numpy(), 0.02)
        live = np.array([ply < plies + b % 4 for b in range(B)])
        # A lane that stops plays no more: it keeps its state.
        nxt_j, nxt_t = jstep(jst, jnp.asarray(acts)), tenv.step(tst, torch.from_numpy(acts))
        tst = where_lanes(torch.from_numpy(live), nxt_t, tst)
        jst = jax.tree_util.tree_map(
            lambda a, b: jnp.where(jnp.asarray(live).reshape((-1,) + (1,) * (a.ndim - 1)),
                                   a, b), nxt_j, jst)
    assert not bool(tst.terminal.any())
    return jenv, jst, tenv, tst


@pytest.mark.parametrize("n,wave,sims,seed,plies,extra", [
    (5, 1, 48, 1, 10, {}),
    (9, 16, 64, 2, 30, {}),
    (9, 1, 32, 3, 20, {}),
    (5, 1, 48, 4, 4, dict(tt_size=64)),
    (5, 16, 64, 5, 12, dict(tt_size=256)),
])
def test_go_visit_counts_match_jax(n, wave, sims, seed, plies, extra):
    jenv, jst, tenv, tst = go_roots(n, seed, plies)
    A = n * n + 1
    # K below A: at K = A, JAX's approx_max_k returns tied priors out of
    # index order (test_jax_slot_order_at_k_equal_a).
    kw = dict(num_simulations=sims, wave_size=wave, max_children=min(32, A - 2),
              dirichlet_epsilon=0.0, **extra)
    jout = jsearch.make_host_search(jenv, jax_uniform(A), jsearch.MCTSConfig(**kw))(
        jst, jax.random.key(0))
    tout = tsearch.make_host_search(tenv, make_uniform_eval_fn(A),
                                    tsearch.MCTSConfig(**kw))(tst)
    got = tout.visit_counts.numpy()
    np.testing.assert_array_equal(got, np.asarray(jout.visit_counts))
    assert (got.sum(-1) == -(-sims // wave) * wave).all()
    if extra:
        np.testing.assert_array_equal(tout.tree.tt.hits.numpy(),
                                      np.asarray(jout.tree.tt.hits))
        np.testing.assert_array_equal(tout.tree.tt.stores.numpy(),
                                      np.asarray(jout.tree.tt.stores))
        assert int(tout.tree.tt.stores.sum()) > 0


def test_jax_slot_order_at_k_equal_a():
    """A JAX deviation the port does not copy: where K equals the number of
    actions (5x5 Go, 26 actions, K = min(32, 26)), JAX's ``approx_max_k``
    on the CPU returns tied priors out of index order; below that, and in
    the port everywhere, ties go lowest action first (the stable sort of
    ``_topk_masked_prior``).  So the search comparisons above keep K < A."""
    A, legal_cells = 26, [3, 5, 10, 12, 13, 14, 16, 17, 18, 19, 20, 23, 25]
    prior = jnp.zeros((1, A)).at[0, jnp.asarray(legal_cells)].set(1 / 13)
    jax_full = np.asarray(jax.lax.approx_max_k(prior, A)[1])[0, :13]
    jax_cut = np.asarray(jax.lax.approx_max_k(prior, 16)[1])[0, :13]
    assert sorted(jax_full) == legal_cells and list(jax_full) != legal_cells
    assert list(jax_cut) == legal_cells
    legal = torch.zeros((1, A), dtype=torch.bool)
    legal[0, legal_cells] = True
    for K in (A, 16):
        _, topa = tsearch._topk_masked_prior(torch.zeros((1, A)), legal, K)
        assert topa[0, :13].tolist() == legal_cells
