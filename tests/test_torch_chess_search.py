"""The port's search on chess against JAX ``make_host_search``: root visit
counts and the transposition table's hits and stores, exactly, at W=1
with value noise (this file) and at W=4 without
(``tests/test_torch_chess_search_wave.py``); and the mate in one of
``tests/test_search_multigame.py`` found by the port.

The settings are those of ``tests/test_torch_search.py`` and
``tests/test_torch_tt.py``: the uniform evaluator, no Dirichlet noise,
K=16 below the 4,672 actions, the value rounded to bf16 on both sides
where a table consumes it (``evaluators(bf16_value=True)``).  Roots:
openings and sparse endgames (kings and a rook or two, where move orders
transpose within a few plies, so the table hits), after numpy-chosen
plies; the JAX roots are the port's states carried across
(``tests/test_torch_chess.py`` holds the two envs equal).  Each file
compiles one JAX search (about a minute on one core: the chess step's
legality graph is inside it).
"""
import contextlib
import functools

import jax
import numpy as np
import torch

from alphazero_tpu.games import chess as jchess
from alphazero_tpu.mcts import search as jsearch
from alphazero_tpu_torch.core.types import cat_states, where_lanes
from alphazero_tpu_torch.games import chess, chess_fen
from alphazero_tpu_torch.mcts import search as tsearch
from alphazero_tpu_torch.models.stub import make_uniform_eval_fn
from test_torch_chess import FAST, one_torch_thread, to_jax  # noqa: F401 (autouse)
from test_torch_search import evaluators

A = 4672
ENDGAMES = ("k7/8/8/8/8/8/8/K6R w - - 0 1", "4k3/8/8/8/8/8/8/R3K2R w KQ - 0 1",
            "8/8/3k4/8/8/3K4/8/7R b - - 10 40", "r3k3/8/8/8/8/8/8/4K3 b q - 0 1")


@contextlib.contextmanager
def fast_jax_jit():
    """JAX's ``jax.jit`` compiling at XLA optimisation level 1 (see
    ``tests/test_torch_chess.py``) while a JAX search is built."""
    real = jax.jit
    jax.jit = functools.partial(real, compiler_options=FAST)
    try:
        yield
    finally:
        jax.jit = real


def chess_roots(seed: int, plies=(4, 9, 16, 23)):
    """(port env, port states, JAX env, JAX states): 4 openings after the
    given numbers of numpy-chosen plies and the 4 ``ENDGAMES`` after 2,
    all live."""
    env = chess.ChessEnv()
    rng = np.random.RandomState(seed)
    st = cat_states([env.init(4, device="cpu"),
                     chess_fen.state_from_fen(env, list(ENDGAMES), device="cpu")])
    todo = np.array(list(plies) + [2] * 4)
    for ply in range(int(todo.max())):
        legal = env.legal_mask(st).numpy()
        acts = np.array([rng.choice(np.flatnonzero(r)) if r.any() else 0 for r in legal])
        live = torch.from_numpy(ply < todo)
        st = where_lanes(live, env.step(st, torch.from_numpy(acts)), st)
    assert not bool(st.terminal.any())
    return env, st, jchess.ChessEnv(), to_jax(st)


def compare(wave: int, value_noise: float, sims: int, tt: int, seed: int):
    env, st, jenv, jst = chess_roots(seed)
    jev, tev = evaluators(A, value_noise, bf16_value=value_noise > 0)
    kw = dict(num_simulations=sims, wave_size=wave, max_children=16,
              dirichlet_epsilon=0.0, tt_size=tt)
    with fast_jax_jit():
        jrun = jsearch.make_host_search(jenv, jev, jsearch.MCTSConfig(**kw))
    jout = jrun(jst, jax.random.key(0))
    tout = tsearch.make_host_search(env, tev, tsearch.MCTSConfig(**kw))(st)
    got = tout.visit_counts.numpy()
    np.testing.assert_array_equal(got, np.asarray(jout.visit_counts))
    assert (got.sum(-1) == -(-sims // wave) * wave).all()
    np.testing.assert_array_equal(tout.tree.tt.hits.numpy(), np.asarray(jout.tree.tt.hits))
    np.testing.assert_array_equal(tout.tree.tt.stores.numpy(),
                                  np.asarray(jout.tree.tt.stores))
    return tout


def test_w1_visit_counts_and_table_match_jax():
    out = compare(wave=1, value_noise=0.1, sims=48, tt=64, seed=1)
    assert int(out.tree.tt.stores.sum()) > 0 and int(out.tree.tt.hits.sum()) > 0


def test_search_finds_mate_in_one():
    """Qh5# (``tests/test_search_multigame.py``), W=1 and W=16, 200
    simulations, uniform evaluator."""
    env = chess.ChessEnv()
    s = chess_fen.state_from_fen(
        env, "rnbqkbnr/ppppp2p/5p2/6p1/4P3/8/PPPP1PPP/RNBQKBNR w KQkq - 0 3",
        device="cpu")
    mate = chess_fen.san_to_action(env, s, "Qh5#")
    for wave in (1, 16):
        cfg = tsearch.MCTSConfig(num_simulations=200, dirichlet_epsilon=0.0,
                                 wave_size=wave)
        out = tsearch.make_host_search(env, make_uniform_eval_fn(A), cfg)(s)
        assert int(out.visit_counts[0].argmax()) == mate
