"""The slices as a whole: the port's self-play actor against the JAX actor,
the int8 evaluator of both packages under the wave search, and the port's
self-play CLI writing JAX-schema GameRecords."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from alphazero_tpu.games.gomoku import GomokuEnv as JaxGomoku
from alphazero_tpu.mcts.search import MCTSConfig as JaxMCTS
from alphazero_tpu.models.stub import make_uniform_eval_fn as jax_uniform
from alphazero_tpu.selfplay import actor as jactor
from alphazero_tpu.selfplay.game_record import GameRecord as JaxRecord
from alphazero_tpu_torch.core.types import where_lanes
from alphazero_tpu_torch.games.gomoku import GomokuEnv
from alphazero_tpu_torch.mcts.search import MCTSConfig
from alphazero_tpu_torch.models.stub import make_uniform_eval_fn
from alphazero_tpu_torch.scripts import self_play
from alphazero_tpu_torch.selfplay import actor as tactor
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, B, MOVES = 5, 8, 14


def _openings(jenv, tenv, seed=0):
    """The same random openings in both envs: lane b plays 2 * b + 3
    numpy-chosen moves that do not end the game, so lanes differ and the
    late ones end (and recycle) within the test's moves."""
    rng = np.random.RandomState(seed)
    A = N * N
    jst = jax.vmap(lambda _: jenv.init())(jnp.arange(B))
    tst = tenv.init(B, device="cpu")
    jstep = jax.jit(jax.vmap(jenv.step))
    for ply in range(2 * B + 1):
        rep = tst.map(lambda x: x.repeat_interleave(A, 0))
        ends = tenv.step(rep, torch.arange(A).repeat(B)).terminal.reshape(B, A)
        ok = (tenv.legal_mask(tst) & ~ends).numpy()
        acts = np.array([rng.choice(np.flatnonzero(ok[b])) for b in range(B)])
        live = np.arange(B) * 2 + 3 > ply
        nxt = jstep(jst, jnp.asarray(acts, jnp.int32))
        jst = jax.tree_util.tree_map(
            lambda n_, o: jnp.where(
                jnp.asarray(live).reshape((-1,) + (1,) * (o.ndim - 1)), n_, o),
            nxt, jst)
        tst = where_lanes(torch.from_numpy(live),
                          tenv.step(tst, torch.from_numpy(acts)), tst)
    return jst, tst


def _stack(recs, field, mod):
    return mod.stack([getattr(r, field) for r in recs])


def test_actor_matches_jax_with_recycling():
    """Greedy (T=0) self-play with the zero-value uniform evaluator and no
    noise: every move, policy and segment end must agree exactly, and so
    must the recycled value targets."""
    mcts_kw = dict(num_simulations=16, wave_size=4, dirichlet_epsilon=0.0)
    sp_kw = dict(max_moves=MOVES, temperature=0.0, final_temperature=0.0,
                 recycle=True)
    jenv, tenv = JaxGomoku(board_size=N), GomokuEnv(board_size=N)
    jstep, _ = jactor.make_host_actor(
        jenv, jax_uniform(N * N),
        jactor.SelfPlayConfig(mcts=JaxMCTS(**mcts_kw), **sp_kw), B)
    tstep, _ = tactor.make_host_actor(
        tenv, make_uniform_eval_fn(N * N),
        tactor.SelfPlayConfig(mcts=MCTSConfig(**mcts_kw), **sp_kw), B,
        device="cpu")
    jst, tst = _openings(jenv, tenv)
    rng = jax.random.key(0)
    jrecs, trecs = [], []
    for _ in range(MOVES):
        rng, sub = jax.random.split(rng)
        jst, jr = jstep(jst, sub)
        tst, tr = tstep(tst)
        jrecs.append(jr)
        trecs.append(tr)
        np.testing.assert_array_equal(tr.action.numpy(), np.asarray(jr.action))
        np.testing.assert_array_equal(tr.policy.numpy(), np.asarray(jr.policy))
        np.testing.assert_array_equal(tr.ended_winner.numpy(),
                                      np.asarray(jr.ended_winner))
        np.testing.assert_array_equal(tst.board.numpy(), np.asarray(jst.board))
    ended = _stack(trecs, "ended_winner", torch)
    assert int((ended != -2).sum()) > 0, "no game ended: recycling untested"

    def output(recs, mod, states, env_winner):
        return (jactor if mod is jnp else tactor).SelfPlayOutput(
            states=states,
            actions=_stack(recs, "action", mod),
            policies=_stack(recs, "policy", mod),
            root_values=_stack(recs, "root_value", mod),
            to_play=_stack(recs, "to_play", mod),
            active=_stack(recs, "active", mod),
            ended_winner=_stack(recs, "ended_winner", mod),
            winner=env_winner,
            length=None,
            move_states=None,
        )

    jz, jvalid = jactor.value_targets_recycled(
        output(jrecs, jnp, jst, jst.winner))
    tz, tvalid = tactor.value_targets_recycled(
        output(trecs, torch, tst, tst.winner))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(
        tactor.value_targets(output(trecs, torch, tst, tst.winner)).numpy(),
        np.asarray(jactor.value_targets(output(jrecs, jnp, jst, jst.winner))))


def test_cli_writes_jax_schema_records(tmp_path, capsys):
    out_dir = str(tmp_path / "games")
    self_play.main(["--device", "cpu", "--board-size", "7", "--num-games",
                    "3", "--simulations", "8", "--wave", "4", "--max-moves",
                    "5", "--output-dir", out_dir])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(stats) == {"games", "moves", "elapsed_s", "games_per_min",
                          "moves_per_s"}
    assert stats["games"] == 3 and stats["moves"] == 15
    files = sorted(os.listdir(out_dir))
    assert files == [f"game_0_{i}.json" for i in range(3)]
    for name in files:
        path = os.path.join(out_dir, name)
        rec = JaxRecord.load(path)  # the JAX package reads it back
        assert rec.board_size == 7 and len(rec.moves) == 5
        with open(path) as f:
            raw = json.load(f)
        assert set(raw) == set(rec.to_json())
        assert set(raw["moves"][0]) == set(rec.moves[0].to_json())
        assert len(raw["moves"][0]["policy"]) == 49
        np.testing.assert_allclose(sum(raw["moves"][0]["policy"]), 1.0,
                                   rtol=1e-6)


def test_int8_search_matches_jax():
    """Slice 2 as a whole: both packages build the int8 evaluator (int8
    residual, bf16 heads, 99-percentile calibration, chunked) from the same
    weights and the same injected calibration observations, and drive it
    through ``make_host_search`` from the same roots."""
    from alphazero_tpu.mcts.search import make_host_search as jax_host_search
    from alphazero_tpu.mcts.search import select_action as jax_select
    from alphazero_tpu.models import quant as jq
    from alphazero_tpu.models.resnet import AZResNet as JaxResNet
    from alphazero_tpu.models.resnet import ResNetConfig as JaxConfig
    from alphazero_tpu_torch.mcts.search import make_host_search, select_action
    from alphazero_tpu_torch.models import quant as tq
    from alphazero_tpu_torch.models.convert import state_dict_from_flax
    from alphazero_tpu_torch.models.resnet import AZResNet, ResNetConfig

    small = dict(num_blocks=2, channels=16, se_ratio=4, policy_channels=8,
                 value_channels=8, value_hidden=32)
    jmodel = JaxResNet(num_actions=N * N, cfg=JaxConfig(**small))
    variables = jmodel.init(jax.random.key(0), jnp.zeros((1, 11, N, N)))
    rng = np.random.RandomState(3)

    def rand(path, x):
        if "var" in jax.tree_util.keystr(path):
            return jnp.asarray(rng.uniform(0.5, 2.0, x.shape), jnp.float32)
        return jnp.asarray(rng.normal(0, 0.3, x.shape), jnp.float32)

    variables = jax.tree_util.tree_map_with_path(rand, variables)
    tmodel = AZResNet(N * N, ResNetConfig(**small), obs_shape=(11, N, N))
    tmodel.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables), small["num_blocks"]))
    tmodel.eval()

    jenv, tenv = JaxGomoku(board_size=N), GomokuEnv(board_size=N)
    jst, tst = _openings(jenv, tenv, seed=1)
    live = ~tst.terminal.numpy()
    assert live.sum() >= B - 2
    # calibration observations: the roots themselves plus random stones
    calib = np.concatenate([
        tenv.observation(tst).float().numpy(),
        rng.randint(0, 2, size=(24, 11, N, N)).astype(np.float32)])
    kw = dict(chunk=4, residual="int8", heads="bf16", calib_percentile=99.0)
    jeval = jq.make_int8_eval_fn(jmodel, variables, calib_obs=jnp.asarray(calib), **kw)
    teval = tq.make_int8_eval_fn(tmodel, calib_obs=torch.from_numpy(calib), **kw)

    cfg = dict(num_simulations=32, wave_size=4, dirichlet_epsilon=0.0)
    jout = jax_host_search(jenv, jeval, JaxMCTS(**cfg))(jst, jax.random.key(0))
    tout = make_host_search(tenv, teval, MCTSConfig(**cfg))(tst)
    jv = np.asarray(jout.visit_counts, np.float64)[live]
    tv = tout.visit_counts.numpy().astype(np.float64)[live]
    assert (tv.sum(-1) == 32).all()
    jact = np.asarray(jax_select(jax.random.key(1), jout.visit_counts,
                                 jnp.zeros((), jnp.float32)))[live]
    tact = select_action(None, tout.visit_counts, 0.0).numpy()[live]
    # Not exact: the two int8 nets differ by s8 rounding steps (JAX's bf16
    # sigmoid, bf16 rounding points), and JAX reads child value sums through
    # bf16.  Still far inside the JAX package's own int8-vs-bf16 bars
    # (argmax agreement 0.9, correlation 0.99): every lane but one picks
    # the same move, and the visit counts correlate above 0.995.
    assert (jact == tact).sum() >= live.sum() - 1
    assert np.corrcoef(jv.ravel(), tv.ravel())[0, 1] >= 0.995
    np.testing.assert_allclose(tout.root_value.numpy()[live],
                               np.asarray(jout.root_value)[live], atol=0.05)


def test_cli_int8_inference_on_cpu(tmp_path, capsys, monkeypatch):
    """``--inference int8`` builds the production executor (here with a
    smaller calibration rollout) and plays with it."""
    from alphazero_tpu_torch import production

    monkeypatch.setattr(production, "CALIB_GAMES", 8)
    out_dir = str(tmp_path / "games")
    self_play.main(["--device", "cpu", "--model", "models_zoo/flagship_gomoku15",
                    "--inference", "int8", "--num-games", "2", "--simulations",
                    "8", "--wave", "4", "--max-moves", "2", "--output-dir", out_dir])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["games"] == 2 and stats["moves"] == 4
    assert len(os.listdir(out_dir)) == 2
