"""The port's wave search against JAX ``make_host_search``: exact root visit
counts and chosen actions.  Its input helpers (``roots``, ``evaluators``,
``peaked_evaluators``) serve the port's other search tests too.

Settings where the two must agree exactly: the uniform evaluator with zero
value, no Dirichlet noise (epsilon 0), greedy selection (T 0), and at most
64 simulations.  Zero values keep every value sum integral and every count
below 256, so the JAX path's bf16 reads of child statistics are exact there
(the port reads them exactly everywhere).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.games.gomoku import GomokuEnv as JaxGomoku
from alphazero_tpu.mcts import search as jsearch
from alphazero_tpu.models.stub import make_uniform_eval_fn as jax_uniform
from alphazero_tpu_torch.core.types import where_lanes
from alphazero_tpu_torch.games.gomoku import GomokuEnv
from alphazero_tpu_torch.mcts import search as tsearch
from alphazero_tpu_torch.models.stub import make_uniform_eval_fn

N = 7
B = 8


def roots(n: int, B: int, seed: int, plies: int):
    """(jax env, jax states, torch env, torch states): the same positions,
    lane b after ``plies + b % 4`` numpy-chosen moves that do not end the
    game (late positions leave few legal moves, so trees grow deep)."""
    jenv, tenv = JaxGomoku(board_size=n), GomokuEnv(board_size=n)
    A = n * n
    rng = np.random.RandomState(seed)
    jst = jax.vmap(lambda _: jenv.init())(jnp.arange(B))
    tst = tenv.init(B, device="cpu")
    jstep = jax.jit(jax.vmap(jenv.step))
    for ply in range(plies + 3):
        rep = tst.map(lambda x: x.repeat_interleave(A, 0))
        ends = tenv.step(rep, torch.arange(A).repeat(B)).terminal.reshape(B, A)
        ok = (tenv.legal_mask(tst) & ~ends).numpy()
        acts = np.array([rng.choice(np.flatnonzero(ok[b])) for b in range(B)])
        live = np.array([ply < plies + b % 4 for b in range(B)])
        nxt = jstep(jst, jnp.asarray(acts, jnp.int32))
        jst = jax.tree_util.tree_map(
            lambda n_, o: jnp.where(
                jnp.asarray(live).reshape((-1,) + (1,) * (o.ndim - 1)), n_, o),
            nxt, jst)
        tst = where_lanes(torch.from_numpy(live),
                          tenv.step(tst, torch.from_numpy(acts)), tst)
    assert not bool(tst.terminal.any())
    return jenv, jst, tenv, tst


def evaluators(A: int, value_noise: float = 0.0, bf16_value: bool = False):
    """(jax eval_fn, torch eval_fn): the uniform stubs.  ``bf16_value``
    rounds the value to bf16 on both sides.  XLA keeps or drops the JAX
    stub's last bf16 rounding depending on what consumes the value (the
    transposition table's contractions keep it, the backprop drops it), so
    a search with a table compares equal only with the rounding made
    explicit (``reduce_precision``, which XLA never removes)."""
    jfn, tfn = jax_uniform(A, value_noise), make_uniform_eval_fn(A, value_noise)
    if not bf16_value:
        return jfn, tfn

    def jev(obs, to_play=None):
        logits, value = jfn(obs, to_play)
        return logits, jax.lax.reduce_precision(value.astype(jnp.float32), 8, 7)

    def tev(obs, to_play=None):
        logits, value = tfn(obs, to_play)
        return logits, value.to(torch.bfloat16).float()

    return jev, tev


def peaked_evaluators(A: int):
    """(jax, torch) evaluators preferring low actions strongly (a trained
    net's regime: visits concentrate, so reuse is substantial)."""
    def jev(obs, to_play=None):
        logits = jnp.tile(-0.2 * jnp.arange(A, dtype=jnp.float32),
                          (obs.shape[0], 1))
        return logits, jnp.zeros((obs.shape[0],), jnp.float32)

    def tev(obs, to_play=None):
        logits = (-0.2 * torch.arange(A, dtype=torch.float32)).repeat(obs.shape[0], 1)
        return logits, torch.zeros((obs.shape[0],))

    return jev, tev


@pytest.mark.parametrize("wave,sims,seed,plies,k", [
    (4, 64, 0, 3, 32), (16, 64, 1, 6, 32), (4, 48, 2, 24, 32),
    (16, 64, 3, 0, 32), (16, 64, 4, 36, 32), (4, 64, 5, 12, 4),
    (16, 64, 6, 40, 32),
])
def test_visit_counts_match_jax(wave, sims, seed, plies, k):
    jenv, jst, tenv, tst = roots(N, B, seed, plies)
    cfg_kw = dict(num_simulations=sims, wave_size=wave, max_children=k,
                  dirichlet_epsilon=0.0)
    jcfg = jsearch.MCTSConfig(**cfg_kw)
    tcfg = tsearch.MCTSConfig(**cfg_kw)
    jout = jsearch.make_host_search(jenv, jax_uniform(N * N), jcfg)(
        jst, jax.random.key(0))
    tout = tsearch.make_host_search(tenv, make_uniform_eval_fn(N * N), tcfg)(tst)
    want = np.asarray(jout.visit_counts)
    got = tout.visit_counts.numpy()
    np.testing.assert_array_equal(got, want)
    assert (got.sum(-1) == jcfg.waves * wave).all()
    np.testing.assert_allclose(tout.root_value.numpy(),
                               np.asarray(jout.root_value), atol=1e-6)
    zero = jnp.zeros((), jnp.float32)
    jact = np.asarray(jsearch.select_action(jax.random.key(1),
                                            jout.visit_counts, zero))
    tact = tsearch.select_action(None, tout.visit_counts, 0.0)
    np.testing.assert_array_equal(tact.numpy(), jact)


def test_terminal_value_backprop_matches_jax():
    """A position one move from a win: terminal leaves carry +-1 values
    (still integral), exercising the terminal paths of select/backprop."""
    jenv, tenv = JaxGomoku(board_size=N), GomokuEnv(board_size=N)
    # Black holds four on row 0 and white has three stones on row 1, with
    # white to move: both players have immediate wins or blocks nearby.
    moves = [0, 7, 1, 8, 2, 9, 3]
    jst = jax.vmap(lambda _: jenv.init())(jnp.arange(B))
    tst = tenv.init(B, device="cpu")
    jstep = jax.jit(jax.vmap(jenv.step))
    for m in moves:
        a = np.full(B, m)
        jst = jstep(jst, jnp.asarray(a, jnp.int32))
        tst = tenv.step(tst, torch.from_numpy(a))
    cfg_kw = dict(num_simulations=64, wave_size=8, dirichlet_epsilon=0.0)
    jout = jsearch.make_host_search(jenv, jax_uniform(N * N),
                                    jsearch.MCTSConfig(**cfg_kw))(
        jst, jax.random.key(0))
    tout = tsearch.make_host_search(tenv, make_uniform_eval_fn(N * N),
                                    tsearch.MCTSConfig(**cfg_kw))(tst)
    np.testing.assert_array_equal(tout.visit_counts.numpy(),
                                  np.asarray(jout.visit_counts))


def test_topk_ties_take_lowest_index():
    logits = torch.zeros(2, 10)
    legal = torch.ones(2, 10, dtype=torch.bool)
    legal[1, ::3] = False
    topv, topa = tsearch._topk_masked_prior(logits, legal, 8)
    assert topa[0].tolist() == list(range(8))
    assert topa[1].tolist() == [1, 2, 4, 5, 7, 8, 0, 3]
    assert float(topv[1, 6]) == 0.0 and float(topv[1, 0]) > 0


def test_dirichlet_noise_from_generator():
    env = GomokuEnv(board_size=N)
    st = env.init(2, device="cpu")
    cfg = tsearch.MCTSConfig(num_simulations=8, wave_size=4)
    run = tsearch.make_host_search(env, make_uniform_eval_fn(N * N), cfg)
    a = run(st, torch.Generator().manual_seed(5)).tree.root_prior
    b = run(st, torch.Generator().manual_seed(5)).tree.root_prior
    c = run(st, torch.Generator().manual_seed(6)).tree.root_prior
    assert torch.equal(a, b) and not torch.equal(a, c)
    np.testing.assert_allclose(a.sum(-1).numpy(), 1.0, atol=1e-5)
