"""Go through the port's other paths against the JAX package: the go9
bundle's folded forward and the int8 executor on Go observations, game
records with passes and two-pass ends replayed into training arrays, the
replay ring's dihedral augmentation with the pass column fixed, and the
CLIs (``train --game go``, ``train --config config/go_9x9.json`` cut to
seconds, ``evaluate --game go`` equal to the JAX CLI, ``self_play --game
go`` with its 2 N**2 move default)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.models import quant as jq
from alphazero_tpu.models.io import load_model as jax_load
from alphazero_tpu.models.resnet import make_inference_eval_fn as jax_eval_fn
from alphazero_tpu.selfplay import game_record as jrecord
from alphazero_tpu.training import replay as jreplay
from alphazero_tpu_torch.core.types import where_lanes
from alphazero_tpu_torch.games.go import GoEnv
from alphazero_tpu_torch.mcts.search import MCTSConfig
from alphazero_tpu_torch.models import quant as tq
from alphazero_tpu_torch.models.convert import quant_params_from_jax
from alphazero_tpu_torch.models.io import load_model
from alphazero_tpu_torch.models.resnet import make_inference_eval_fn
from alphazero_tpu_torch.models.stub import make_uniform_eval_fn
from alphazero_tpu_torch.scripts import evaluate as evaluate_cli
from alphazero_tpu_torch.scripts import self_play as self_play_cli
from alphazero_tpu_torch.scripts import train as train_cli
from alphazero_tpu_torch.selfplay import game_record as trecord
from alphazero_tpu_torch.selfplay.actor import (
    SelfPlayConfig, make_host_actor, stack_records,
)
from alphazero_tpu_torch.training import replay as treplay
from test_torch_go import assert_state_equal, envs
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GO9 = os.path.join(REPO, "models_zoo", "go9")
OBS9 = (8, 9, 9)


def _go_obs(B, seed, plies=40):
    """Observations of 9x9 positions after numpy-chosen random plies (lane
    b plays ``b % plies``), as float32 numpy."""
    env = GoEnv(board_size=9)
    rng = np.random.RandomState(seed)
    st = env.init(B, device="cpu")
    for ply in range(plies):
        legal = env.legal_mask(st).numpy()
        acts = np.array([rng.choice(np.flatnonzero(row[:-1])) if row[:-1].any()
                         else 81 for row in legal])
        live = torch.from_numpy(np.arange(B) % plies > ply)
        st = where_lanes(live, env.step(st, torch.from_numpy(acts)), st)
    return env.observation(st).float().numpy()


@pytest.fixture(scope="module")
def go9():
    jmodel, jvars = jax_load(GO9, OBS9)
    model, meta = load_model(GO9, OBS9, device="cpu")
    assert meta["num_actions"] == 82 and meta["config"]["num_blocks"] == 6
    return jmodel, jvars, model


def test_go9_folded_forward_matches_jax(go9):
    jmodel, jvars, model = go9
    obs = _go_obs(16, seed=1)
    jl, jv = jax.jit(jax_eval_fn(jmodel, jvars))(jnp.asarray(obs))
    tl, tv = make_inference_eval_fn(model)(torch.from_numpy(obs))
    assert tl.shape == (16, 82)
    # Both run the trained net in bf16: the Gomoku bundle's stated
    # tolerance (tests/test_torch_resnet.py).
    scale = float(np.abs(np.asarray(jl)).max())
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                               atol=0.05 * scale)
    np.testing.assert_allclose(tv.float().numpy(), np.asarray(jv, np.float32),
                               atol=0.05)


def test_go9_int8_executor_matches_jax(go9):
    """The production executor's modes (99.99-percentile calibration, int8
    residual, bf16 heads) on quantised parameters carried across from JAX,
    on Go observations; the stem's K is 8 x 9 = 72 (an 80-byte pitch
    through ``_im2col``'s wide buffer).

    Each quantisation point of the port is fed JAX's activations of the
    points before it, so each is held to ``test_forward_int8_matches_jax``'s
    limits on its own.  Run free, a flipped rounding (XLA:CPU's bf16
    sigmoid is one ulp off for about half its inputs) propagates through
    the six trained blocks: a fifth of the last blocks' s8 values then
    differ by up to 5 steps, for the Gomoku flagship as for go9."""
    jmodel, jvars, _ = go9
    jfp = jq.extract_folded(jmodel, jvars)
    calib = _go_obs(48, seed=2)
    jqp = jq.quantize(jfp, jq.calibrate(jfp, [jnp.asarray(calib)], 99.99))
    qp = quant_params_from_jax(jax.tree_util.tree_map(np.asarray, jqp), device="cpu")
    assert tq._im2col(torch.zeros((1, 9, 9, 8), dtype=torch.int8), 3, 3).stride(0) == 80
    obs = _go_obs(16, seed=3)
    jacts, orig = [], jq._quant_act

    def record(*args, **kw):
        jacts.append(orig(*args, **kw))
        return jacts[-1]

    jq._quant_act = record
    try:
        jl, jv = jq.forward_int8(jqp, jnp.asarray(obs), "int8", "bf16")
    finally:
        jq._quant_act = orig
    tacts, torig = [], tq._quant_act

    def forced(*args, **kw):
        tacts.append(torig(*args, **kw))
        return torch.from_numpy(np.array(jacts[len(tacts) - 1]))

    tq._quant_act = forced
    try:
        with torch.no_grad():
            tl, tv = tq.forward_int8(qp, torch.from_numpy(obs), "int8", "bf16")
    finally:
        tq._quant_act = torig
    assert len(jacts) == len(tacts) == 2 + 2 * 6
    worst, differing, total = 0, 0, 0
    for ja, ta in zip(jacts, tacts):
        d = np.abs(np.asarray(ja, np.int32) - ta.numpy().astype(np.int32))
        worst = max(worst, int(d.max()))
        differing, total = differing + int((d > 0).sum()), total + d.size
    # test_forward_int8_matches_jax's limits: at most 2 steps with the int8
    # residual, on under 2 % of the values.
    assert worst <= 2 and differing / total < 0.02
    scale = float(np.abs(np.asarray(jl)).max())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=0.05 * scale)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=0.05)


@pytest.fixture(scope="module")
def go_records():
    """Records of a short uniform self-play on 5x5 Go (passes, captures and
    two-pass ends among them), replayed by both packages: (env, records,
    the port's training arrays, JAX's)."""
    env = GoEnv(board_size=5, komi=0.5)
    cfg = SelfPlayConfig(mcts=MCTSConfig(num_simulations=8, wave_size=4,
                                         max_children=16),
                         max_moves=50, temperature_drop_move=50)
    step, states = make_host_actor(env, make_uniform_eval_fn(26), cfg, 6,
                                   device="cpu")
    gen = torch.Generator().manual_seed(0)
    recs = []
    for _ in range(cfg.max_moves):
        states, rec = step(states, gen)
        recs.append(rec)
    records = trecord.records_from_selfplay(env, stack_records(env, states, recs))
    jenv, _ = envs(5, komi=0.5)
    jrecs = [jrecord.GameRecord.from_json(r.to_json()) for r in records]
    return (env, records,
            trecord.records_to_training_arrays(env, records, device="cpu"),
            jrecord.records_to_training_arrays(jenv, jrecs))


def _flat(tree, T, G):
    return jax.tree_util.tree_map(lambda x: x.reshape((T * G,) + x.shape[2:]), tree)


def test_go_records_replay_into_training_arrays_as_jax(go_records):
    env, records, (tst, tpol, tz, tmask), (jst, jpol, jz, jmask) = go_records
    actions = [m.action for r in records for m in r.moves]
    assert 25 in actions and any(len(r.moves) < 50 for r in records)
    np.testing.assert_array_equal(tpol.numpy(), np.asarray(jpol))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    T, G = tz.shape
    assert_state_equal(tst.map(lambda x: x.reshape((T * G,) + x.shape[2:])),
                       _flat(jst, T, G), "records")
    assert bool((tz[tmask] != 0).any())


def test_go_replay_sample_matches_jax_with_pass_column_fixed(go_records):
    """Record states into both rings (one add, fewer rows than the
    capacity: test_jax_replay_add_past_capacity_loses_rows), then one sample
    with injected draws: observations and policies of every symmetry equal,
    pass column kept."""
    env, _, (tst, tpol, tz, tmask), (jst, *_) = go_records
    jenv, _ = envs(5, komi=0.5)
    T, G = tz.shape
    flat = tst.map(lambda x: x.reshape((T * G,) + x.shape[2:]))
    pol, z, mask = tpol.reshape(T * G, 26), tz.reshape(-1), tmask.reshape(-1)
    tbuf = treplay.create(env, 512, 26, device="cpu")
    treplay.add(tbuf, flat, pol, z, mask)
    jbuf = jax.jit(jreplay.add)(jreplay.create(jenv, 512, 26), _flat(jst, T, G),
                                jnp.asarray(pol.numpy()), jnp.asarray(z.numpy()),
                                jnp.asarray(mask.numpy()))
    assert T * G <= 512 and tbuf.size == int(jbuf.size) > 32
    assert_state_equal(tbuf.states, jbuf.states, "ring")
    rng = np.random.RandomState(3)
    idx = rng.randint(0, tbuf.size, 32).astype(np.int32)
    syms = np.tile(np.arange(8), 4).astype(np.int32)

    @jax.jit
    def jax_sample(buf, idx, syms):  # the JAX sampler with the draws given
        states = jax.tree_util.tree_map(lambda x: x[idx], buf.states)
        return jax.vmap(lambda o, p, s: jreplay.augment(o, p, s, 5))(
            jax.vmap(jenv.observation)(states), buf.policy[idx], syms)

    jobs, jpol = jax_sample(jbuf, jnp.asarray(idx), jnp.asarray(syms))
    got = treplay.sample(tbuf, env, None, 32, idx=torch.from_numpy(idx),
                         syms=torch.from_numpy(syms))
    np.testing.assert_array_equal(got.obs.float().numpy(), np.asarray(jobs, np.float32))
    np.testing.assert_array_equal(got.policy.numpy(), np.asarray(jpol))
    assert torch.equal(got.policy[:, 25], tbuf.policy[torch.from_numpy(idx).long(), 25])


def test_jax_replay_add_past_capacity_loses_rows():
    """A JAX fault the port does not copy: an ``add`` of more rows than the
    ring holds writes each masked-out row's slot back with the slot's old
    content, and those writes land on slots that valid rows took, so valid
    rows are lost.  The port keeps the last ``capacity`` valid rows, as
    writing them one after another would."""
    jenv, env = envs(5)
    rows, cap = 10, 4
    mask = np.array([1, 1, 1, 1, 1, 1, 0, 0, 1, 0], bool)
    value = np.arange(rows, dtype=np.float32)
    pol = np.repeat(value[:, None], 26, 1)
    jst = jax.vmap(lambda _: jenv.init())(jnp.arange(rows))
    jbuf = jax.jit(jreplay.add)(jreplay.create(jenv, cap, 26), jst, jnp.asarray(pol),
                                jnp.asarray(value), jnp.asarray(mask))
    tbuf = treplay.add(treplay.create(env, cap, 26, device="cpu"),
                       env.init(rows, device="cpu"), torch.from_numpy(pol),
                       torch.from_numpy(value), torch.from_numpy(mask))
    # Valid rows 0-5 and 8 fill slots 0, 1, 2, 3, 0, 1, 2 in turn.
    assert tbuf.value.tolist() == [4.0, 5.0, 8.0, 3.0]
    assert np.asarray(jbuf.value).tolist() == [0.0, 0.0, 8.0, 0.0]
    assert tbuf.position == int(jbuf.position) == 3


def test_train_cli_go_runs_on_cpu(tmp_path):
    ckpt = tmp_path / "run"
    train_cli.main(["--device", "cpu", "--game", "go", "--board-size", "5",
                    "--komi", "5.5", "--blocks", "1", "--channels", "16",
                    "--iterations", "1", "--games-per-iteration", "4",
                    "--simulations", "8", "--wave", "4", "--max-moves", "12",
                    "--train-steps", "2", "--train-batch-size", "16",
                    "--min-replay", "1", "--inference", "folded",
                    "--checkpoint-every", "1", "--checkpoint-dir", str(ckpt)])
    with open(ckpt / "history.json") as f:
        (entry,) = json.load(f)
    assert entry["moves"] == 4 * 12 and np.isfinite(entry["loss"])
    assert sorted(os.listdir(ckpt)) == ["ckpt_0.pt", "history.json"]


def test_train_cli_runs_go_config_cut_to_depth(tmp_path):
    """``config/go_9x9.json`` through ``--config``: its 8x96 GroupNorm net
    at W=1 on the raw inference path, cut in depth (iterations, moves,
    simulations, steps) and, for the CPU, in games and train batch."""
    with open(os.path.join(REPO, "config", "go_9x9.json")) as f:
        cfg = json.load(f)
    cfg.update(iterations=1, games_per_iteration=2, train_steps_per_iteration=1,
               train_batch_size=8, replay_capacity=256,
               min_replay_before_training=1, checkpoint_every=1,
               checkpoint_dir=str(tmp_path / "run"))
    cfg["selfplay"]["max_moves"] = 2
    cfg["selfplay"]["mcts"]["num_simulations"] = 2
    path = tmp_path / "go_9x9_cut.json"
    path.write_text(json.dumps(cfg))
    train_cli.main(["--config", str(path), "--device", "cpu"])
    with open(tmp_path / "run" / "history.json") as f:
        (entry,) = json.load(f)
    assert entry["moves"] == 4 and np.isfinite(entry["loss"])


def test_evaluate_cli_go_equals_jax_cli(capsys):
    """The same flags through both CLIs (W=1, temperature 0, no openings,
    7x7 so that K=32 lies below the 50 actions): the same printed line."""
    from alphazero_tpu.scripts import evaluate as jax_evaluate

    argv = ["--game", "go", "--board-size", "7", "--num-games", "4",
            "--simulations", "8", "--opening-moves", "0", "--temperature", "0",
            "--wave", "1", "--max-moves", "16"]
    evaluate_cli.main(argv + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jax_evaluate.main(argv)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want and got["wins_a"] + got["wins_b"] + got["draws"] == 4


@pytest.mark.parametrize("game,want", [("go", 50), ("gomoku", 26)])
def test_self_play_cli_default_max_moves(game, want, tmp_path, capsys, monkeypatch):
    """2 N**2 plies for Go by default, as the JAX CLI (N**2 + 1 for Gomoku,
    512 for chess); pinned through the actor's config at 5x5."""
    from alphazero_tpu_torch.selfplay import actor

    seen, real = [], actor.make_host_actor

    def spy(env, eval_fn, config, *a, **kw):
        seen.append(config.max_moves)
        return real(env, eval_fn, config, *a, **kw)

    monkeypatch.setattr(actor, "make_host_actor", spy)
    self_play_cli.main(["--device", "cpu", "--game", game, "--board-size", "5",
                        "--num-games", "2", "--simulations", "8", "--wave", "2",
                        "--output-dir", str(tmp_path)])
    assert seen == [want]
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["games"] == 2 and stats["moves"] > 0
    assert [evaluate_cli.default_max_moves(g, n) for g, n in
            (("go", 19), ("go", 9), ("chess", 8))] == [722, 162, 512]


def test_self_play_cli_go9_int8_on_cpu(tmp_path, capsys, monkeypatch):
    """``--model models_zoo/go9 --inference int8``: the production executor
    at Go's shapes (a smaller calibration rollout on the CPU)."""
    from alphazero_tpu_torch import production

    monkeypatch.setattr(production, "CALIB_GAMES", 8)
    self_play_cli.main(["--device", "cpu", "--game", "go", "--board-size", "9",
                        "--model", GO9, "--inference", "int8", "--num-games", "2",
                        "--simulations", "8", "--wave", "4", "--max-moves", "2",
                        "--output-dir", str(tmp_path)])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["games"] == 2 and stats["moves"] == 4
    rec = json.load(open(tmp_path / "game_0_0.json"))
    assert rec["game_type"] == 3 and len(rec["moves"][0]["policy"]) == 82
