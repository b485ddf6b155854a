"""The scanned actor (``selfplay/actor.play_games``/``move_once``) against
the JAX package's and against the port's host actor.  The pipeline that
runs it is ``tests/test_torch_scan_pipeline.py``'s."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.games import go as jgo
from alphazero_tpu.games import gomoku as jgomoku
from alphazero_tpu.mcts.search import MCTSConfig as JaxMCTS
from alphazero_tpu.models.stub import make_uniform_eval_fn as jax_uniform
from alphazero_tpu.selfplay import actor as jactor
from alphazero_tpu_torch.core.types import where_lanes
from alphazero_tpu_torch.games import go as tgo
from alphazero_tpu_torch.games import gomoku as tgomoku
from alphazero_tpu_torch.mcts.search import MCTSConfig
from alphazero_tpu_torch.models.stub import make_uniform_eval_fn
from alphazero_tpu_torch.selfplay import actor as tactor
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FAST = {"xla_backend_optimization_level": 1}
B, N = 6, 5


def _openings(jenv, tenv, A, seed=0):
    """The same random openings in both envs: lane b plays b + 2
    numpy-chosen board moves (no pass) that do not end its game."""
    rng = np.random.RandomState(seed)
    jst = jax.vmap(lambda _: jenv.init())(jnp.arange(B))
    tst = tenv.init(B, device="cpu")
    jstep = jax.jit(jax.vmap(jenv.step), compiler_options=FAST)
    for ply in range(B + 1):
        rep = tst.map(lambda x: x.repeat_interleave(A, 0))
        ends = tenv.step(rep, torch.arange(A).repeat(B)).terminal.reshape(B, A)
        ok = (tenv.legal_mask(tst)[:, :N * N] & ~ends[:, :N * N]).numpy()
        acts = np.array([rng.choice(np.flatnonzero(ok[b])) for b in range(B)])
        live = np.arange(B) + 2 > ply
        nxt = jstep(jst, jnp.asarray(acts, jnp.int32))
        jst = jax.tree_util.tree_map(
            lambda n_, o: jnp.where(
                jnp.asarray(live).reshape((-1,) + (1,) * (o.ndim - 1)), n_, o),
            nxt, jst)
        tst = where_lanes(torch.from_numpy(live),
                          tenv.step(tst, torch.from_numpy(acts)), tst)
    return jst, tst


GAMES = {
    "gomoku": (lambda: jgomoku.GomokuEnv(board_size=N),
               lambda: tgomoku.GomokuEnv(board_size=N), N * N, 14),
    "go": (lambda: jgo.GoEnv(board_size=N, max_moves=12),
           lambda: tgo.GoEnv(board_size=N, max_moves=12),
           N * N + 1, 10),
}


@pytest.mark.parametrize("recycle", [True, False], ids=["recycle", "no_recycle"])
@pytest.mark.parametrize("game", sorted(GAMES))
def test_play_games_matches_jax(game, recycle):
    """Greedy (T=0) scanned self-play, uniform stub, no noise, from the same
    openings: every recorded field, the results and both value-target
    functions equal JAX's exactly."""
    make_j, make_t, A, moves = GAMES[game]
    jenv, tenv = make_j(), make_t()
    jst, tst = _openings(jenv, tenv, A)
    mcts = dict(num_simulations=8, dirichlet_epsilon=0.0)
    sp = dict(max_moves=moves, temperature=0.0, final_temperature=0.0,
              recycle=recycle)
    jcfg = jactor.SelfPlayConfig(mcts=JaxMCTS(**mcts), **sp)
    jout = jax.jit(lambda s, r: jactor.play_games(
        jenv, jax_uniform(A), r, jcfg, B, initial_states=s),
        compiler_options=FAST)(jst, jax.random.key(0))
    tout = tactor.play_games(
        tenv, make_uniform_eval_fn(A), torch.Generator().manual_seed(0),
        tactor.SelfPlayConfig(mcts=MCTSConfig(**mcts), **sp), B,
        initial_states=tst)
    for field in ("actions", "policies", "root_values", "to_play", "active",
                  "ended_winner", "winner", "length"):
        np.testing.assert_array_equal(getattr(tout, field).numpy(),
                                      np.asarray(getattr(jout, field)), err_msg=field)
    np.testing.assert_array_equal(tout.states.board.numpy(),
                                  np.asarray(jout.states.board))
    assert int((tout.ended_winner != -2).sum()) > 0, "no game ended"
    z, valid = tactor.value_targets_recycled(tout)
    jz, jvalid = jactor.value_targets_recycled(jout)
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(tactor.value_targets(tout).numpy(),
                                  np.asarray(jactor.value_targets(jout)))


def test_play_games_matches_host_actor():
    """At T=1 with root noise and a valued stub, the scanned actor and the
    host actor draw alike from one generator: the same moves, policies and
    records, move by move (the scanned actor does not stop early)."""
    env = tgomoku.GomokuEnv(board_size=N)
    eval_fn = make_uniform_eval_fn(N * N, value_noise=0.1)
    cfg = tactor.SelfPlayConfig(mcts=MCTSConfig(num_simulations=16, wave_size=4),
                                max_moves=12, temperature_drop_move=4,
                                recycle=True)
    out = tactor.play_games(env, eval_fn, torch.Generator().manual_seed(3), cfg,
                            8, record_states=True, device="cpu")
    step, states = tactor.make_host_actor(env, eval_fn, cfg, 8, device="cpu",
                                          record_states=True)
    gen = torch.Generator().manual_seed(3)
    recs = []
    for _ in range(cfg.max_moves):
        states, rec = step(states, gen)
        recs.append(rec)
    host = tactor.stack_records(env, states, recs)
    for field in ("actions", "policies", "root_values", "to_play", "active",
                  "ended_winner", "winner", "length"):
        assert torch.equal(getattr(out, field), getattr(host, field)), field
    assert torch.equal(out.move_states.board, host.move_states.board)
    assert len(set(out.actions[0].tolist())) > 1  # T=1 drew different moves
