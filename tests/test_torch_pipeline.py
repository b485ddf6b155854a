"""The port's training pipeline on the CPU at a tiny size (5x5 Gomoku,
1 block, 16 channels), mirroring tests/test_pipeline.py: two iterations
train, each inference mode runs, checkpoints round-trip bit for bit,
history.json is written, records feed offline training; plus
``records_to_training_arrays`` against the JAX package, the config files
and the training CLI."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from alphazero_tpu.games.gomoku import GomokuEnv as JaxGomoku
from alphazero_tpu.selfplay import game_record as jrecord
from alphazero_tpu_torch import production
from alphazero_tpu_torch.games.gomoku import GomokuEnv
from alphazero_tpu_torch.mcts.search import MCTSConfig
from alphazero_tpu_torch.models.resnet import ResNetConfig
from alphazero_tpu_torch.models.stub import make_uniform_eval_fn
from alphazero_tpu_torch.scripts import train as train_cli
from alphazero_tpu_torch.selfplay import game_record as trecord
from alphazero_tpu_torch.selfplay.actor import SelfPlayConfig
from alphazero_tpu_torch.training.learner import LearnerConfig
from alphazero_tpu_torch.training.pipeline import Pipeline, PipelineConfig
from alphazero_tpu_torch.utils import config as tconfig
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_config(tmp_path, **kw):
    defaults = dict(
        game="gomoku",
        board_size=5,
        model=ResNetConfig(num_blocks=1, channels=16),
        selfplay=SelfPlayConfig(
            mcts=MCTSConfig(num_simulations=8, wave_size=4, dirichlet_alpha=0.5),
            max_moves=25, temperature_drop_move=4),
        learner=LearnerConfig(learning_rate=1e-3, scheduler="constant",
                              total_steps=100),
        iterations=2,
        games_per_iteration=8,
        train_steps_per_iteration=4,
        train_batch_size=32,
        replay_capacity=4096,
        min_replay_before_training=32,
        checkpoint_dir=str(tmp_path / "ckpt"),
        checkpoint_every=1,
        inference="folded",
    )
    defaults.update(kw)
    return PipelineConfig(**defaults)


def _state_equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _optimizer_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    if sa["param_groups"] != sb["param_groups"] or sa["state"].keys() != sb["state"].keys():
        return False
    return all(_state_equal(sa["state"][k], sb["state"][k]) for k in sa["state"])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two iterations with checkpoints (replay included) after each."""
    tmp = tmp_path_factory.mktemp("pipe")
    cfg = tiny_config(tmp, checkpoint_replay=True)
    pipe = Pipeline(cfg, device="cpu")
    init = {k: v.clone() for k, v in pipe.state.module.state_dict().items()}
    history = pipe.run()
    return cfg, pipe, init, history


def test_two_iterations_train(trained):
    cfg, pipe, init, history = trained
    assert len(history) == 2
    for entry in history:
        assert entry["replay_size"] > 0 and entry["moves"] > 0
        assert np.isfinite(entry["loss"]) and np.isfinite(entry["grad_norm"])
        assert entry["loss"] > 0
    assert pipe.state.step == 2 * cfg.train_steps_per_iteration
    assert not _state_equal(init, pipe.state.module.state_dict())
    assert pipe.inference_mode == "folded"


def test_history_json_written(trained):
    cfg, pipe, _, history = trained
    with open(os.path.join(cfg.checkpoint_dir, "history.json")) as f:
        assert json.load(f) == history


def test_checkpoint_round_trips_bit_for_bit(trained):
    cfg, pipe, _, _ = trained
    assert pipe.checkpoints() == [0, 1]
    fresh = Pipeline(cfg, device="cpu")
    assert fresh.restore_checkpoint() == 1
    assert _state_equal(fresh.state.module.state_dict(), pipe.state.module.state_dict())
    assert _optimizer_equal(fresh.state.optimizer, pipe.state.optimizer)
    assert fresh.state.step == pipe.state.step
    assert torch.equal(fresh.generator.get_state(), pipe.generator.get_state())
    assert (fresh.buffer.position, fresh.buffer.size) == (pipe.buffer.position,
                                                          pipe.buffer.size)
    assert torch.equal(fresh.buffer.policy, pipe.buffer.policy)
    assert torch.equal(fresh.buffer.states.board, pipe.buffer.states.board)
    # the restored run goes on as the original would
    a, b = fresh.train(), pipe.train()
    assert a == b


def test_keeps_the_last_three_checkpoints(tmp_path):
    pipe = Pipeline(tiny_config(tmp_path), device="cpu")
    for it in range(5):
        pipe.save_checkpoint(it)
    assert pipe.checkpoints() == [2, 3, 4]
    with pytest.raises(FileNotFoundError):
        Pipeline(tiny_config(tmp_path / "empty"), device="cpu").restore_checkpoint()


@pytest.mark.parametrize("mode", ["int8", "raw"])
def test_inference_mode_runs(tmp_path, monkeypatch, mode):
    """One iteration in each other mode; int8 re-calibrates on every refresh
    (a 16-game calibration rollout here), so its quantised parameters
    change once the learner has moved."""
    monkeypatch.setattr(production, "CALIB_GAMES", 16)
    pipe = Pipeline(tiny_config(tmp_path, inference=mode), device="cpu")
    assert pipe.inference_mode == mode
    entry = pipe.run_iteration(0)
    assert np.isfinite(entry["loss"]) and entry["replay_size"] > 0
    if mode == "int8":
        first = pipe.eval_tree
        pipe.run_iteration(1)
        assert not torch.equal(first["stem"]["wq"], pipe.eval_tree["stem"]["wq"])


def test_group_norm_model_falls_back_to_raw(tmp_path, caplog):
    cfg = tiny_config(tmp_path, model=ResNetConfig(num_blocks=1, channels=16,
                                                   norm="group", group_size=8))
    pipe = Pipeline(cfg, device="cpu")
    assert pipe.inference_mode == "raw"
    assert "falling back to raw" in caplog.text
    assert np.isfinite(pipe.run_iteration(0)["loss"])


def _selfplay_records(n_games=6, seed=0):
    """Records of a short uniform-evaluator self-play with the port."""
    from alphazero_tpu_torch.selfplay.actor import make_host_actor, stack_records

    env = GomokuEnv(board_size=5)
    cfg = SelfPlayConfig(mcts=MCTSConfig(num_simulations=8, wave_size=4),
                         max_moves=26, temperature_drop_move=6)
    step, states = make_host_actor(env, make_uniform_eval_fn(25), cfg, n_games,
                                   device="cpu")
    gen = torch.Generator().manual_seed(seed)
    recs = []
    for _ in range(cfg.max_moves):
        states, rec = step(states, gen)
        recs.append(rec)
    out = stack_records(env, states, recs)
    return env, trecord.records_from_selfplay(env, out)


def test_records_to_training_arrays_matches_jax():
    env, records = _selfplay_records()
    jrecs = [jrecord.GameRecord.from_json(r.to_json()) for r in records]
    jst, jpol, jz, jmask = jrecord.records_to_training_arrays(
        JaxGomoku(board_size=5), jrecs)
    tst, tpol, tz, tmask = trecord.records_to_training_arrays(env, records,
                                                              device="cpu")
    np.testing.assert_array_equal(tpol.numpy(), np.asarray(jpol))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    for name in ("board", "to_play", "last_moves", "move_count", "terminal",
                 "winner"):
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jst, name)), err_msg=name)
    h = tst.hash
    pair = torch.stack([(h >> 32) & 0xFFFFFFFF, h & 0xFFFFFFFF], -1).numpy()
    np.testing.assert_array_equal(pair.astype(np.uint32), np.asarray(jst.hash))
    assert bool(tmask.any()) and bool((tz[tmask] != 0).any())


def test_ingest_record_files_then_train_only(tmp_path):
    env, records = _selfplay_records(seed=1)
    games = tmp_path / "games"
    for i, rec in enumerate(records):
        rec.save(str(games / f"game_{i}.json"))
    pipe = Pipeline(tiny_config(tmp_path), device="cpu")
    n = pipe.ingest_record_files(str(games))
    assert n == sum(len(r.moves) for r in records) == pipe.buffer.size
    out = pipe.run_training_only(2)
    assert len(out) == 2 and all(np.isfinite(e["loss"]) for e in out)
    assert pipe.checkpoints() == [0, 1]
    with pytest.raises(ValueError):
        pipe.ingest_record_files(str(tmp_path / "none"))


def test_config_round_trip(tmp_path):
    cfg = dataclasses.replace(
        tconfig.default_pipeline_config("gomoku", 9),
        model=ResNetConfig(dtype=torch.float32), game_options=(("use_renju", False),))
    path = str(tmp_path / "cfg.json")
    tconfig.save_config(cfg, path)
    assert tconfig.load_config(PipelineConfig, path) == cfg


def test_shipped_configs_load():
    """The JAX package's JSON files (jax dtype strings keep the default)."""
    cfg = tconfig.load_config(PipelineConfig,
                              os.path.join(REPO, "config", "gomoku_15x15.json"))
    assert cfg.model.norm == "group" and cfg.model.dtype == torch.bfloat16
    assert cfg.selfplay.mcts.wave_size == 1 and cfg.games_per_iteration == 256
    for name in ("go_9x9", "go_19x19", "chess"):
        assert tconfig.load_config(
            PipelineConfig, os.path.join(REPO, "config", f"{name}.json")).game in (
            "go", "chess")


def test_train_cli_runs_shipped_config_cut_to_depth(tmp_path):
    """``--config config/gomoku_15x15.json`` (W=1, GroupNorm 6x64 net) for
    one iteration.  Cut: iterations, moves, simulations, train steps and
    the replay threshold (depth), and for the CPU's sake the games, the
    train batch and the replay capacity; the net's width is the file's."""
    with open(os.path.join(REPO, "config", "gomoku_15x15.json")) as f:
        cfg = json.load(f)
    cfg.update(iterations=1, games_per_iteration=4, train_steps_per_iteration=1,
               train_batch_size=16, replay_capacity=1000,
               min_replay_before_training=1, checkpoint_every=1,
               checkpoint_dir=str(tmp_path / "run"))
    cfg["selfplay"]["max_moves"] = 2
    cfg["selfplay"]["mcts"]["num_simulations"] = 4
    path = tmp_path / "gomoku_15x15_cut.json"
    path.write_text(json.dumps(cfg))
    train_cli.main(["--config", str(path), "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "run")) == ["ckpt_0.pt", "history.json"]
    with open(tmp_path / "run" / "history.json") as f:
        (entry,) = json.load(f)
    assert entry["moves"] == 8 and np.isfinite(entry["loss"])


@pytest.mark.parametrize("argv", [["--model", "randwire", "--board-size", "5"],
                                  ["--game", "chess", "--model", "randwire",
                                   "--board-size", "8"]])
def test_train_cli_refuses_unported_paths(argv, tmp_path):
    """Once refused, ``--model randwire`` now trains a ``DDWRandWireResNet``
    for Gomoku and chess (a tiny 1 x 2 x 16 net, 2 moves), its actor on
    the raw module."""
    ckpt = tmp_path / "run"
    train_cli.main(argv + ["--device", "cpu", "--blocks", "1", "--channels", "16",
                           "--iterations", "1", "--games-per-iteration", "2",
                           "--simulations", "4", "--wave", "4", "--max-moves", "2",
                           "--train-steps", "1", "--train-batch-size", "8",
                           "--min-replay", "1", "--no-recycle",
                           "--checkpoint-every", "1", "--checkpoint-dir", str(ckpt)])
    with open(ckpt / "history.json") as f:
        (entry,) = json.load(f)
    assert entry["moves"] == 4 and np.isfinite(entry["loss"])
    payload = torch.load(ckpt / "ckpt_0.pt", weights_only=True)
    assert "blocks.0.nodes.0.conv1.weight" in payload["model"]


def test_train_cli_runs_on_cpu(tmp_path):
    ckpt = tmp_path / "run"
    train_cli.main(["--device", "cpu", "--board-size", "5", "--blocks", "1",
                    "--channels", "16", "--iterations", "2",
                    "--games-per-iteration", "4", "--simulations", "8",
                    "--wave", "4", "--train-steps", "2", "--train-batch-size", "16",
                    "--min-replay", "1", "--inference", "folded",
                    "--checkpoint-every", "1", "--checkpoint-dir", str(ckpt)])
    with open(ckpt / "history.json") as f:
        history = json.load(f)
    assert len(history) == 2 and "loss" in history[0]
    assert sorted(os.listdir(ckpt)) == ["ckpt_0.pt", "ckpt_1.pt", "history.json"]


def test_pipeline_reuse_actor_starts_each_iteration_fresh(tmp_path):
    """With tree reuse, each actor run drops the kept tree before its first
    move: the last run's tree belongs to other games."""
    cfg = tiny_config(tmp_path, selfplay=SelfPlayConfig(
        mcts=MCTSConfig(num_simulations=8, tree_reuse=True, reuse_cap=8),
        max_moves=3), games_per_iteration=4, min_replay_before_training=1)
    pipe = Pipeline(cfg, device="cpu")
    step, kept = pipe._host_step, []
    reset = step.reset

    def recording_reset():
        kept.append(step.search._tree is not None)
        reset()
        assert step.search._tree is None

    step.reset = recording_reset
    pipe.run(2)
    assert kept == [False, True]
    assert step.search.last_fresh_sims <= 8


def test_train_cli_wave_1_on_cpu(tmp_path):
    ckpt = tmp_path / "run"
    train_cli.main(["--device", "cpu", "--board-size", "5", "--blocks", "1",
                    "--channels", "16", "--iterations", "1",
                    "--games-per-iteration", "4", "--simulations", "6",
                    "--wave", "1", "--max-moves", "4", "--train-steps", "1",
                    "--train-batch-size", "16", "--min-replay", "1",
                    "--inference", "folded", "--checkpoint-every", "1",
                    "--checkpoint-dir", str(ckpt)])
    assert sorted(os.listdir(ckpt)) == ["ckpt_0.pt", "history.json"]


def test_jax_and_port_default_configs_agree():
    """The port's per-game defaults are the JAX package's values, field for
    field, the int8 executor's fields included (the model's dtypes
    aside)."""
    from alphazero_tpu.utils import config as jconfig

    def without_dtypes(d):
        return {k: (without_dtypes(v) if isinstance(v, dict) else v)
                for k, v in d.items() if "dtype" not in k}

    for game in ("gomoku", "go", "chess"):
        j = without_dtypes(jconfig.to_dict(jconfig.default_pipeline_config(game)))
        assert all(k in j for k in ("int8_chunk", "int8_residual",
                                    "int8_calib_percentile"))
        t = without_dtypes(tconfig.to_dict(tconfig.default_pipeline_config(game)))
        assert t == j


def test_jax_int8_fields_reach_the_executor(tmp_path, monkeypatch):
    """A JAX-written config that sets the int8 executor's chunk (0: one
    piece), residual and percentile loads with those values, and the
    pipeline's executor is built with them."""
    from alphazero_tpu.training.pipeline import PipelineConfig as JaxConfig
    from alphazero_tpu.utils import config as jconfig
    from alphazero_tpu_torch.models import quant

    path = str(tmp_path / "jax.json")
    jconfig.save_config(JaxConfig(int8_chunk=0, int8_residual="bf16",
                                  int8_calib_percentile=99.9), path)
    loaded = tconfig.load_config(PipelineConfig, path)
    assert (loaded.int8_chunk, loaded.int8_residual,
            loaded.int8_calib_percentile) == (0, "bf16", 99.9)
    monkeypatch.setattr(production, "CALIB_GAMES", 4)
    seen = {}
    orig = quant.make_int8_eval_params

    def spy(model, **kw):
        seen.update(kw)
        return orig(model, **kw)

    monkeypatch.setattr(quant, "make_int8_eval_params", spy)
    pipe = Pipeline(tiny_config(tmp_path, inference="int8", int8_chunk=0,
                                int8_residual="bf16", int8_calib_percentile=99.9),
                    device="cpu")
    pipe.eval_tree = pipe._eval_transform(pipe.state.module)
    assert (seen["chunk"], seen["residual"], seen["calib_percentile"]) == (
        0, "bf16", 99.9)
    logits, value = pipe.evaluate(torch.zeros((3, 11, 5, 5)))
    assert logits.shape == (3, 25) and bool(torch.isfinite(value).all())
