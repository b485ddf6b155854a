"""The port's sequential search (W=1), TD(lambda) and parity mode against
the JAX package, and ``mcts/inspect.py`` against its JAX twin.

Visit counts must be equal exactly.  The evaluator is the uniform stub
with ``value_noise > 0`` on both sides (the port's stub rounds as XLA
computes the JAX stub inside the search), no Dirichlet noise, at most 64
simulations.  The W=1 descent reads child statistics exactly in both
packages (JAX's two-dimensional one-hot reads are exact on the CPU), so
non-integral values are fine here."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from alphazero_tpu.mcts import inspect as jinspect
from alphazero_tpu.mcts import search as jsearch
from alphazero_tpu_torch.games.gomoku import GomokuEnv
from alphazero_tpu_torch.mcts import inspect as tinspect
from alphazero_tpu_torch.mcts import search as tsearch
from alphazero_tpu_torch.models.stub import make_uniform_eval_fn
from alphazero_tpu_torch.scripts import self_play
from test_torch_search import evaluators, roots
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.join(os.path.dirname(__file__), "..")
DUMP = os.path.join(REPO, "tools", "parity", "reference_dump_gomoku15.json")


def _both(n, B, seed, plies, value_noise=0.1, bf16_value=False, **kw):
    """JAX and port host searches on the same roots; returns the outputs."""
    jenv, jst, tenv, tst = roots(n, B, seed, plies)
    jev, tev = evaluators(n * n, value_noise, bf16_value)
    kw = dict(dirichlet_epsilon=0.0, **kw)
    jout = jsearch.make_host_search(jenv, jev, jsearch.MCTSConfig(**kw))(
        jst, jax.random.key(0))
    tout = tsearch.make_host_search(tenv, tev, tsearch.MCTSConfig(**kw))(tst)
    return jout, tout


@pytest.mark.parametrize("n,B,seed,plies,sims,k,extra", [
    (7, 8, 0, 3, 64, 32, {}),
    (7, 8, 1, 12, 64, 32, {}),
    (7, 8, 4, 36, 48, 8, {}),
    (5, 8, 2, 6, 64, 25, {}),
    (15, 4, 3, 20, 32, 32, {}),
    (7, 8, 0, 3, 64, 32, dict(td_lambda=0.5)),
    (7, 8, 5, 30, 64, 16, dict(td_lambda=0.3)),
    (5, 8, 6, 4, 64, 25, dict(td_lambda=0.8, unvisited_q="parent")),
])
def test_w1_visit_counts_match_jax(n, B, seed, plies, sims, k, extra):
    jout, tout = _both(n, B, seed, plies, num_simulations=sims, wave_size=1,
                       max_children=k, **extra)
    np.testing.assert_array_equal(tout.visit_counts.numpy(),
                                  np.asarray(jout.visit_counts))
    assert (tout.visit_counts.sum(-1) == sims).all()
    # Same values in the same order: the root means agree bit for bit.
    np.testing.assert_array_equal(tout.root_value.numpy(),
                                  np.asarray(jout.root_value))
    # One node a simulation, at slot sim + 1.
    np.testing.assert_array_equal(tout.tree.parent.numpy(),
                                  np.asarray(jout.tree.parent))


@pytest.mark.parametrize("n,seed,plies,extra", [
    (4, 1, 8, dict(tt_size=64)),
    (7, 1, 24, dict(tt_size=16)),
    (4, 1, 8, dict(tt_size=256, td_lambda=0.5)),
    (7, 3, 30, dict(tt_size=32, td_lambda=0.3)),
])
def test_w1_with_table_matches_jax(n, seed, plies, extra):
    """Visit counts, root values and the table's canonical hits and stores
    equal JAX's (values rounded to bf16 on both sides, see
    ``test_torch_search.evaluators``)."""
    jout, tout = _both(n, 8, seed, plies, bf16_value=True, num_simulations=64,
                       wave_size=1, max_children=16, **extra)
    np.testing.assert_array_equal(tout.visit_counts.numpy(),
                                  np.asarray(jout.visit_counts))
    np.testing.assert_array_equal(tout.root_value.numpy(),
                                  np.asarray(jout.root_value))
    np.testing.assert_array_equal(tout.tree.tt.hits.numpy(),
                                  np.asarray(jout.tree.tt.hits))
    np.testing.assert_array_equal(tout.tree.tt.stores.numpy(),
                                  np.asarray(jout.tree.tt.stores))
    assert int(tout.tree.tt.stores.sum()) > 0
    if n == 4:  # deep 4x4 trees reach positions by several move orders
        assert int(tout.tree.tt.hits.sum()) > 10


def _parity_cases():
    with open(DUMP) as f:
        return [json.loads(line) for line in f if line.strip()]


PARITY = _parity_cases()


@pytest.mark.parametrize("case", PARITY, ids=[
    f"pos{len(c['position'])}ply_{c['sims']}sims" for c in PARITY])
def test_parity_mode_matches_reference_engine(case):
    """The reference engine's visit multiset at each dumped position, from
    the port alone (as tests/test_parity_reference.py holds the JAX
    package)."""
    env = GomokuEnv(board_size=15)
    cfg = tsearch.MCTSConfig(num_simulations=case["sims"], c_puct=1.5,
                             dirichlet_epsilon=0.0, parity_mode=True,
                             max_children=env.num_actions)
    st = env.init(1, device="cpu")
    for mv in case["position"]:
        st = env.step(st, torch.tensor([mv]))
    out = tsearch.search(env, make_uniform_eval_fn(env.num_actions), st, cfg)
    ours = out.visit_counts[0].numpy()
    ref = np.asarray(case["visits"])
    assert ours.sum() == ref.sum() == case["sims"]
    assert (ours > 0).sum() == (ref > 0).sum()
    np.testing.assert_array_equal(np.sort(ours), np.sort(ref))


def test_parity_mode_matches_jax_slot_for_slot():
    """Parity mode at K == A takes identity slots: the whole tree equals
    JAX's, action for action."""
    jout, tout = _both(7, 4, 7, 8, value_noise=0.0, num_simulations=64,
                       wave_size=1, max_children=49, parity_mode=True)
    np.testing.assert_array_equal(tout.visit_counts.numpy(),
                                  np.asarray(jout.visit_counts))
    np.testing.assert_array_equal(tout.tree.caction.numpy(),
                                  np.asarray(jout.tree.caction).astype(np.int32))


@pytest.mark.parametrize("kw", [
    dict(tt_size=48), dict(tt_size=3),
    dict(wave_size=4, td_lambda=0.5), dict(wave_size=16, parity_mode=True),
])
def test_config_value_errors_match_jax(kw):
    """The JAX search's ValueErrors, raised by the port's entry points."""
    jenv, jst, tenv, tst = roots(5, 2, 0, 0)
    jev, tev = evaluators(25)
    with pytest.raises(ValueError) as jerr:
        jsearch.search(jenv, jev, jst, jax.random.key(0),
                       jsearch.MCTSConfig(num_simulations=8, **kw))
    with pytest.raises(ValueError) as terr:
        tsearch.search(tenv, tev, tst, tsearch.MCTSConfig(num_simulations=8, **kw))
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError):
        tsearch.make_host_search(tenv, tev, tsearch.MCTSConfig(**kw))


def test_inspect_matches_jax():
    """top_moves, search_info (with the table's block) and to_dot on the
    same search tree."""
    jout, tout = _both(5, 4, 3, 3, bf16_value=True, num_simulations=64,
                       wave_size=1, max_children=16, tt_size=128)
    for g in range(4):
        assert tinspect.top_moves(tout.tree, g, k=8) == jinspect.top_moves(jout.tree, g, k=8)
        assert tinspect.search_info(tout.tree, g) == jinspect.search_info(jout.tree, g)
        assert tinspect.to_dot(tout.tree, g, max_nodes=30) == jinspect.to_dot(
            jout.tree, g, max_nodes=30)
    info = tinspect.search_info(tout.tree, 0)
    assert info["tt_stores"] > 0 and info["root_visits"] == 65


def test_self_play_cli_wave_1(tmp_path, capsys):
    self_play.main(["--device", "cpu", "--board-size", "5", "--num-games", "2",
                    "--simulations", "8", "--wave", "1", "--max-moves", "3",
                    "--output-dir", str(tmp_path)])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["games"] == 2 and stats["moves"] == 6
    assert len(os.listdir(tmp_path)) == 2
