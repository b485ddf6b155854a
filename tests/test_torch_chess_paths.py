"""Chess through the port's other paths against the JAX package: the
``models_zoo/chess_dev`` bundle's folded forward and the int8 executor on
chess observations (the stem's K = 18 x 9 = 162 through a 176-byte
pitch), game records replayed into training arrays, the replay ring
(JAX's dihedral augmentation corrupts chess samples; the port leaves them
as stored), and the CLIs: ``train --config config/chess.json`` cut to
seconds, ``train --game chess``, ``self_play --game chess`` (uniform and
the int8 executor on chess_dev), ``evaluate`` and ``tournament --game
chess`` with the JAX CLIs' JSON keys."""
import ast
import functools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.games import chess as jchess
from alphazero_tpu.models import quant as jq
from alphazero_tpu.models.io import load_model as jax_load
from alphazero_tpu.models.resnet import make_inference_eval_fn as jax_eval_fn
from alphazero_tpu.selfplay import game_record as jrecord
from alphazero_tpu.training import replay as jreplay
from alphazero_tpu_torch.core.types import where_lanes
from alphazero_tpu_torch.games.chess import ChessEnv
from alphazero_tpu_torch.mcts.search import MCTSConfig
from alphazero_tpu_torch.models import quant as tq
from alphazero_tpu_torch.models.convert import quant_params_from_jax
from alphazero_tpu_torch.models.io import load_model
from alphazero_tpu_torch.models.resnet import make_inference_eval_fn
from alphazero_tpu_torch.models.stub import make_uniform_eval_fn
from alphazero_tpu_torch.scripts import evaluate as evaluate_cli
from alphazero_tpu_torch.scripts import self_play as self_play_cli
from alphazero_tpu_torch.scripts import tournament as tournament_cli
from alphazero_tpu_torch.scripts import train as train_cli
from alphazero_tpu_torch.selfplay import game_record as trecord
from alphazero_tpu_torch.selfplay.actor import (
    SelfPlayConfig, make_host_actor, stack_records,
)
from alphazero_tpu_torch.training import replay as treplay
from test_torch_chess import (  # noqa: F401 (one_torch_thread: autouse)
    FAST, FIELDS, assert_state_equal, one_torch_thread, to_jax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHESS_DEV = os.path.join(REPO, "models_zoo", "chess_dev")
OBS = (18, 8, 8)
A = 4672


def _chess_states(B, seed, plies=60):
    """Positions after numpy-chosen random plies (lane b plays ``b %
    plies``), on the CPU."""
    env = ChessEnv()
    rng = np.random.RandomState(seed)
    st = env.init(B, device="cpu")
    for ply in range(plies):
        legal = env.legal_mask(st).numpy()
        acts = np.array([rng.choice(np.flatnonzero(r)) if r.any() else 0 for r in legal])
        live = torch.from_numpy(np.arange(B) % plies > ply)
        st = where_lanes(live, env.step(st, torch.from_numpy(acts)), st)
    return st


def _chess_obs(B, seed):
    return ChessEnv().observation(_chess_states(B, seed)).float().numpy()


@pytest.fixture(scope="module")
def chess_dev():
    jmodel, jvars = jax_load(CHESS_DEV, OBS)
    model, meta = load_model(CHESS_DEV, OBS, device="cpu")
    assert meta["num_actions"] == A and meta["config"]["num_blocks"] == 6
    assert meta["config"]["norm"] == "batch"
    return jmodel, jvars, model


def test_chess_dev_folded_forward_matches_jax(chess_dev):
    jmodel, jvars, model = chess_dev
    obs = _chess_obs(16, seed=1)
    jl, jv = jax.jit(jax_eval_fn(jmodel, jvars))(jnp.asarray(obs))
    tl, tv = make_inference_eval_fn(model)(torch.from_numpy(obs))
    assert tl.shape == (16, A)
    # Both run the BN-folded net in bf16: the resnet tests' tolerance
    # (tests/test_torch_resnet.py).
    scale = float(np.abs(np.asarray(jl)).max())
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                               atol=0.05 * scale)
    np.testing.assert_allclose(tv.float().numpy(), np.asarray(jv, np.float32),
                               atol=0.05)


def test_chess_dev_int8_executor_matches_jax(chess_dev):
    """The production executor's modes (99.99-percentile calibration, int8
    residual, bf16 heads) on quantised parameters carried across from JAX,
    on chess observations; each quantisation point of the port is fed
    JAX's activations of the points before it and held to
    ``test_go9_int8_executor_matches_jax``'s limits."""
    jmodel, jvars, _ = chess_dev
    jfp = jq.extract_folded(jmodel, jvars)
    calib = _chess_obs(48, seed=2)
    jqp = jq.quantize(jfp, jq.calibrate(jfp, [jnp.asarray(calib)], 99.99))
    qp = quant_params_from_jax(jax.tree_util.tree_map(np.asarray, jqp), device="cpu")
    stem = tq._im2col(torch.zeros((1, 8, 8, 18), dtype=torch.int8), 3, 3)
    assert stem.shape == (64, 162) and stem.stride(0) == 176
    obs = _chess_obs(16, seed=3)
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
    assert worst <= 2 and differing / total < 0.02
    scale = float(np.abs(np.asarray(jl)).max())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=0.05 * scale)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=0.05)


@pytest.fixture(scope="module")
def chess_records():
    """A short uniform self-play (6 games, 24 plies): (env, records, the
    actor's output, the port's training arrays from the records)."""
    env = ChessEnv()
    cfg = SelfPlayConfig(mcts=MCTSConfig(num_simulations=8, wave_size=4,
                                         max_children=16),
                         max_moves=24, temperature_drop_move=24)
    step, states = make_host_actor(env, make_uniform_eval_fn(A), cfg, 6, device="cpu",
                                   record_states=True)
    gen = torch.Generator().manual_seed(0)
    recs = []
    for _ in range(cfg.max_moves):
        states, rec = step(states, gen)
        recs.append(rec)
    out = stack_records(env, states, recs)
    records = trecord.records_from_selfplay(env, out)
    return env, records, out, trecord.records_to_training_arrays(env, records, device="cpu")


def test_chess_records_replay_into_training_arrays(chess_records):
    """The records (the JAX package's JSON, read back by its own
    ``GameRecord``) replay into the states the actor played, field for
    field, with the recorded policies and outcomes."""
    env, records, out, (tst, tpol, tz, tmask) = chess_records
    for r in records:
        d = r.to_json()  # stamped now: read back with its timestamp
        again = jrecord.GameRecord.from_json(d)
        assert again.to_json() == d
        assert again.game_type == 2 and again.board_size == 8
        assert len(again.moves[0].policy) == A
    T, G = tz.shape
    assert (T, G) == (24, 6) and bool(tmask.all())
    for f in FIELDS:
        assert torch.equal(getattr(tst, f), getattr(out.move_states, f)), f
    np.testing.assert_allclose(tpol.numpy(), out.policies.numpy(), atol=1e-6)
    acts = np.array([[m.action for m in r.moves] for r in records]).T
    assert (acts == out.actions.numpy()).all()


def test_chess_records_match_jax_records_to_training_arrays(chess_records):
    """The port's chess records replayed by the JAX package's
    ``records_to_training_arrays`` (its chess step compiled at XLA
    optimisation level 1): the same states field for field, policies,
    value targets and mask as the port's replay of the same records."""
    env, records, _, (tst, tpol, tz, tmask) = chess_records
    jrecs = [jrecord.GameRecord.from_json(r.to_json()) for r in records]
    real = jax.jit
    jax.jit = functools.partial(real, compiler_options=FAST)
    try:
        jst, jpol, jz, jmask = jrecord.records_to_training_arrays(
            jchess.ChessEnv(), jrecs)
    finally:
        jax.jit = real
    T, G = tz.shape
    np.testing.assert_array_equal(tpol.numpy(), np.asarray(jpol))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert_state_equal(tst.map(lambda x: x.reshape((T * G,) + x.shape[2:])),
                       jax.tree_util.tree_map(
                           lambda x: x.reshape((T * G,) + x.shape[2:]), jst))


def test_jax_replay_augment_corrupts_chess_samples():
    """A JAX fault the port does not copy: ``replay.augment`` applies the 8
    board symmetries to chess too.  Its planes turn, but only policy
    entries 0-63 (the 64 move types of square a1 ... not squares) are
    permuted; the other 4,608 stay where they were, so the move targets
    no longer follow the pieces."""
    jenv = jchess.ChessEnv()
    js = jax.tree_util.tree_map(lambda x: x[0], to_jax(ChessEnv().init(1, device="cpu")))
    obs = jax.jit(jenv.observation)(js)
    policy = jnp.arange(A, dtype=jnp.float32) / A
    aug_obs, aug_pol = jax.jit(lambda o, p: jreplay.augment(o, p, 2, 8))(obs, policy)
    np.testing.assert_array_equal(np.asarray(aug_obs), np.rot90(np.asarray(obs), 1, (1, 2)))
    assert not np.array_equal(np.asarray(aug_pol[:64]), np.asarray(policy[:64]))
    np.testing.assert_array_equal(np.asarray(aug_pol[64:]), np.asarray(policy[64:]))


def test_port_replay_leaves_chess_samples_as_stored(chess_records):
    """The port's sampler never augments chess: observations regenerate
    from the stored states, policies come back as stored."""
    env, _, out, (tst, tpol, tz, tmask) = chess_records
    T, G = tz.shape
    buf = treplay.create(env, 256, A, device="cpu")
    flat = tst.map(lambda x: x.reshape((T * G,) + x.shape[2:]))
    treplay.add(buf, flat, tpol.reshape(T * G, A), tz.reshape(-1), tmask.reshape(-1))
    idx = torch.arange(0, T * G, 5)
    batch = treplay.sample(buf, env, torch.Generator().manual_seed(0), len(idx), idx=idx)
    assert not treplay.has_dihedral(env)
    assert torch.equal(batch.policy, buf.policy[idx])
    assert torch.equal(batch.obs, env.observation(buf.states.map(lambda x: x[idx])))
    drawn = treplay.sample(buf, env, torch.Generator().manual_seed(1), 32)
    assert bool((drawn.policy.sum(-1) > 0.99).all())


def test_train_cli_runs_chess_config_cut_to_depth(tmp_path):
    """``config/chess.json`` through ``--config``: its 10x128 GroupNorm net
    at W=1 on the raw inference path, cut in depth (iterations, moves,
    simulations, steps) and, for the CPU, in games and train batch."""
    with open(os.path.join(REPO, "config", "chess.json")) as f:
        cfg = json.load(f)
    assert cfg["model"]["num_blocks"] == 10 and cfg["model"]["norm"] == "group"
    cfg.update(iterations=1, games_per_iteration=2, train_steps_per_iteration=1,
               train_batch_size=8, replay_capacity=256,
               min_replay_before_training=1, checkpoint_every=1,
               checkpoint_dir=str(tmp_path / "run"))
    cfg["selfplay"]["max_moves"] = 2
    cfg["selfplay"]["mcts"]["num_simulations"] = 2
    path = tmp_path / "chess_cut.json"
    path.write_text(json.dumps(cfg))
    train_cli.main(["--config", str(path), "--device", "cpu"])
    with open(tmp_path / "run" / "history.json") as f:
        (entry,) = json.load(f)
    assert entry["moves"] == 4 and np.isfinite(entry["loss"])
    assert sorted(os.listdir(tmp_path / "run")) == ["ckpt_0.pt", "history.json"]


def test_train_cli_chess_runs_on_cpu(tmp_path):
    ckpt = tmp_path / "run"
    train_cli.main(["--device", "cpu", "--game", "chess", "--board-size", "8",
                    "--blocks", "1", "--channels", "16", "--iterations", "1",
                    "--games-per-iteration", "4", "--simulations", "8",
                    "--wave", "4", "--max-moves", "6", "--train-steps", "2",
                    "--train-batch-size", "16", "--min-replay", "1",
                    "--inference", "folded", "--checkpoint-every", "1",
                    "--no-recycle", "--checkpoint-dir", str(ckpt)])
    with open(ckpt / "history.json") as f:
        (entry,) = json.load(f)
    assert entry["moves"] == 4 * 6 and np.isfinite(entry["loss"])


def test_self_play_cli_chess_on_cpu(tmp_path, capsys):
    """Uniform, 512 plies by default (cut here by --max-moves)."""
    self_play_cli.main(["--device", "cpu", "--game", "chess", "--board-size", "8",
                        "--num-games", "4", "--simulations", "16", "--wave", "4",
                        "--max-moves", "6", "--output-dir", str(tmp_path)])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["games"] == 4 and stats["moves"] == 24
    rec = json.load(open(tmp_path / "game_0_0.json"))
    assert rec["game_type"] == 2 and len(rec["moves"][0]["policy"]) == A


def test_self_play_cli_chess_dev_int8_on_cpu(tmp_path, capsys, monkeypatch):
    """``--model models_zoo/chess_dev --inference int8``: the production
    executor at chess's shapes (a smaller calibration rollout on the
    CPU)."""
    from alphazero_tpu_torch import production

    monkeypatch.setattr(production, "CALIB_GAMES", 8)
    self_play_cli.main(["--device", "cpu", "--game", "chess", "--board-size", "8",
                        "--model", CHESS_DEV, "--inference", "int8", "--num-games", "2",
                        "--simulations", "8", "--wave", "4", "--max-moves", "2",
                        "--output-dir", str(tmp_path)])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["games"] == 2 and stats["moves"] == 4


def _jax_cli_keys(name: str) -> list:
    """The keys of the JSON line the JAX CLI ``name`` prints, read from its
    source (running the JAX chess arena would compile its search)."""
    src = open(os.path.join(REPO, "alphazero_tpu", "scripts", f"{name}.py")).read()
    for node in ast.walk(ast.parse(src)):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError(f"no json.dumps of a dict in {name}.py")


def test_evaluate_cli_chess_prints_jax_keys(capsys):
    """chess_dev against the uniform stub, a few games cut to 12 plies: the
    JAX CLI's keys, and chess_dev scores at least as well."""
    evaluate_cli.main(["--device", "cpu", "--game", "chess", "--board-size", "8",
                       "--model-a", CHESS_DEV, "--num-games", "4", "--simulations", "8",
                       "--wave", "4", "--max-moves", "12", "--opening-moves", "2"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(got) == _jax_cli_keys("evaluate")
    assert got["wins_a"] + got["wins_b"] + got["draws"] == 4


def test_tournament_cli_chess(capsys, tmp_path):
    """chess_dev and the uniform player, 2 games a pair: the JAX CLI's
    top-level keys and both players rated."""
    zoo = tmp_path / "zoo"
    zoo.mkdir()
    shutil.copy(CHESS_DEV, zoo / "chess_dev.msgpack")
    shutil.copy(CHESS_DEV + ".json", zoo / "chess_dev.msgpack.json")
    out = tmp_path / "t.json"
    tournament_cli.main(["--device", "cpu", "--game", "chess", "--board-size", "8",
                         "--models-dir", str(zoo), "--include-random",
                         "--games-per-pair", "2", "--simulations", "2",
                         "--output", str(out)])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed) == {"elo", "bt"}
    assert sorted(r["player"] for r in printed["elo"]) == ["chess_dev.msgpack", "random"]
    assert printed.keys() <= json.loads(out.read_text()).keys()
