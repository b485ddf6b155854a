"""Data parallelism over ranks (``parallel/mesh.py``, ``parallel/
distributed.py``, BatchNorm's moments, the learner's gradients and
``Pipeline(mesh=)``): the mesh functions against the JAX package's, and two
CPU processes joined by ``gloo`` against one process, as
``tests/test_multihost.py`` and ``__graft_entry__.dryrun_multichip`` run
the JAX package.

The module is also the two-process test's worker:
``python tests/test_torch_parallel.py <rank> <port> <out dir>``."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAMES = (("gomoku", 9), ("go", 19), ("chess", 8))


# ---------------------------------------------------------------------------
# What one process computes, with or without a process group.


def learner_case():
    """One ``train_step`` of a 1x16 BatchNorm net on this rank's share of a
    global batch of 16 (random observations and targets from a seed).  The
    net computes in float32: in bf16 each rank's half-batch gradient is
    rounded to bf16 before the ranks' sum, one bf16 step (4e-3 relative)
    away from the whole batch's rounded sum."""
    from alphazero_tpu_torch.models.resnet import AZResNet, ResNetConfig
    from alphazero_tpu_torch.parallel import mesh as meshlib
    from alphazero_tpu_torch.training import learner, replay

    rng = np.random.RandomState(5)
    obs = rng.normal(size=(16, 11, 7, 7)).astype(np.float32)
    logits = rng.normal(size=(16, 49))
    policy = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    value = np.tanh(rng.normal(size=16))
    batch = replay.Batch(torch.from_numpy(obs), torch.from_numpy(policy).float(),
                         torch.from_numpy(value).float())
    batch = replay.Batch(*meshlib.shard_batch(meshlib.make_mesh(), tuple(batch)))
    model = AZResNet(49, ResNetConfig(num_blocks=1, channels=16, dtype=torch.float32),
                     obs_shape=(11, 7, 7), generator=torch.Generator().manual_seed(0))
    state = learner.create_train_state(
        model, learner.LearnerConfig(scheduler="constant", total_steps=10))
    state, m = learner.train_step(state, batch, learner.LearnerConfig(
        scheduler="constant", total_steps=10))
    return {"loss": [float(x) for x in m],
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
            "params": {k: p.detach().clone() for k, p in model.named_parameters()},
            "stats": {k: b.clone() for k, b in model.named_buffers()
                      if "running" in k}}


def move_case():
    """``move_once`` on this rank's lanes of 8 Gomoku 9x9 openings (uniform
    stub with value noise, W=2, no root noise, T=0), every rank's records
    gathered."""
    from alphazero_tpu_torch.core.types import where_lanes
    from alphazero_tpu_torch.games.gomoku import GomokuEnv
    from alphazero_tpu_torch.mcts.search import MCTSConfig
    from alphazero_tpu_torch.models.stub import make_uniform_eval_fn
    from alphazero_tpu_torch.parallel import mesh as meshlib
    from alphazero_tpu_torch.selfplay.actor import SelfPlayConfig, move_once

    env, rng = GomokuEnv(board_size=9), np.random.RandomState(2)
    st = env.init(8, device="cpu")
    for ply in range(9):
        acts = [rng.choice(np.flatnonzero(r)) for r in env.legal_mask(st).numpy()]
        live = torch.arange(8) + 2 > ply
        st = where_lanes(live, env.step(st, torch.tensor(acts)), st)
    mesh = meshlib.make_mesh()
    cfg = SelfPlayConfig(mcts=MCTSConfig(num_simulations=8, wave_size=2,
                                         dirichlet_epsilon=0.0),
                         temperature=0.0, final_temperature=0.0)
    gen = torch.Generator().manual_seed(11 + meshlib.distributed.rank())
    new, rec = move_once(env, make_uniform_eval_fn(81, value_noise=0.1),
                         meshlib.shard_batch(mesh, st), gen, cfg)
    return {k: mesh.gather(getattr(rec, k)) for k in
            ("action", "policy", "root_value", "active", "ended_winner")} | {
        "board": mesh.gather(new.board)}


def pipeline_case(game, size, ckpt_dir):
    """One ``Pipeline(mesh=)`` iteration at dryrun shapes (a 1x16 net, 4
    games of 4 moves, 8 simulations in waves of 2, no root noise, T=0), one
    train step of a global batch of 8; then a checkpoint and its restore."""
    from alphazero_tpu_torch.mcts.search import MCTSConfig
    from alphazero_tpu_torch.models.resnet import ResNetConfig
    from alphazero_tpu_torch.selfplay.actor import SelfPlayConfig
    from alphazero_tpu_torch.training.learner import LearnerConfig
    from alphazero_tpu_torch.training.pipeline import Pipeline, PipelineConfig

    cfg = PipelineConfig(
        game=game, board_size=size, model=ResNetConfig(num_blocks=1, channels=16),
        selfplay=SelfPlayConfig(
            mcts=MCTSConfig(num_simulations=8, wave_size=2, dirichlet_epsilon=0.0),
            max_moves=4, temperature=0.0, final_temperature=0.0),
        learner=LearnerConfig(scheduler="constant", total_steps=10),
        games_per_iteration=4, train_steps_per_iteration=1, train_batch_size=8,
        replay_capacity=64, min_replay_before_training=1, inference="folded",
        checkpoint_dir=ckpt_dir, checkpoint_every=1)
    pipe = Pipeline(cfg, device="cpu")
    entry = pipe.run_iteration(0)
    pipe.save_checkpoint(0)
    actor_state = pipe.actor_generator.get_state()
    again = Pipeline(cfg, device="cpu")
    restored = again.restore_checkpoint()
    buf = pipe.buffer
    return {"loss": entry["loss"], "moves": entry["moves"], "size": buf.size,
            "policy": buf.policy.clone(), "value": buf.value.clone(),
            "board": buf.states.board.clone(), "restored": restored,
            "actor_generator_restored": torch.equal(
                again.actor_generator.get_state(), actor_state),
            "files": sorted(os.listdir(ckpt_dir))}


def ingest_case(games_dir, ckpt_dir):
    """Each rank's own shard of 2 GameRecords of 4 moves on 5x5 into the
    ring, then one learner-only iteration."""
    from alphazero_tpu_torch.core.types import GameResult, GameType
    from alphazero_tpu_torch.models.resnet import ResNetConfig
    from alphazero_tpu_torch.parallel import distributed
    from alphazero_tpu_torch.selfplay.game_record import GameRecord
    from alphazero_tpu_torch.training.learner import LearnerConfig
    from alphazero_tpu_torch.training.pipeline import Pipeline, PipelineConfig

    rank = distributed.rank()
    rng = np.random.default_rng(rank)
    for g in range(2):
        rec = GameRecord(GameType.GOMOKU, 5)
        for a in rng.choice(25, size=4, replace=False):
            pol = np.zeros(25)
            pol[a] = 1.0
            rec.add_move(int(a), pol, 0.1)
        rec.set_result(GameResult.WIN_PLAYER1)
        rec.save(os.path.join(games_dir, f"g{g}.json"))
    pipe = Pipeline(PipelineConfig(
        game="gomoku", board_size=5, model=ResNetConfig(num_blocks=1, channels=16),
        learner=LearnerConfig(scheduler="constant", total_steps=10),
        games_per_iteration=4, train_steps_per_iteration=1, train_batch_size=8,
        inference="folded", checkpoint_dir=ckpt_dir, checkpoint_every=10),
        device="cpu")
    n = pipe.ingest_record_files(games_dir)
    (entry,) = pipe.run_training_only(1)
    return {"ingested": n, "size": pipe.buffer.size, "loss": entry["loss"]}


def worker(rank: int, port: str, out: str) -> None:
    sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    from alphazero_tpu_torch.parallel import distributed

    distributed.initialize(f"127.0.0.1:{port}", 2, rank, device="cpu")
    assert distributed.world_size() == 2 and distributed.rank() == rank
    res = {"learner": learner_case(), "move": move_case()}
    for game, size in GAMES:
        res[game] = pipeline_case(game, size, os.path.join(out, f"ckpt_{game}"))
    games_dir = os.path.join(out, f"games{rank}")
    os.makedirs(games_dir, exist_ok=True)
    res["ingest"] = ingest_case(games_dir, os.path.join(out, "ckpt_ingest"))
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# The two-process run against one process.


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ranks"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r),
                               port, tmp], env=env, cwd=tmp,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(2)]


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("one")
    res = {"learner": learner_case(), "move": move_case()}
    for game, size in GAMES:
        res[game] = pipeline_case(game, size, str(tmp / f"ckpt_{game}"))
    return res


def test_learner_step_two_ranks_equal_one(two_ranks, one_rank):
    """Loss rtol 1e-5; the global gradients rtol 1e-4, atol 1e-7; running
    statistics rtol 1e-4, atol 1e-6; parameters after the step within 1e-6
    except where the global gradient is under 1e-6 in magnitude (AdamW
    moves such an entry by about the learning rate whatever its sign)."""
    ref = one_rank["learner"]
    for res in two_ranks:
        got = res["learner"]
        np.testing.assert_allclose(got["loss"][:3], ref["loss"][:3], rtol=1e-5)
        np.testing.assert_allclose(got["loss"][3], ref["loss"][3], rtol=1e-4)
        for k, g in ref["grads"].items():
            np.testing.assert_allclose(got["grads"][k], g, rtol=1e-4, atol=1e-7,
                                       err_msg=k)
        for k, s in ref["stats"].items():
            np.testing.assert_allclose(got["stats"][k], s, rtol=1e-4, atol=1e-6,
                                       err_msg=k)
        tiny = 0
        for k, p in ref["params"].items():
            small = ref["grads"][k].abs() < 1e-6
            tiny += int(small.sum())
            diff = (got["params"][k] - p).abs()
            assert float(torch.cat([diff[~small], diff.new_zeros(1)]).max()) <= 1e-6, k
        print(f"parameters with a global gradient under 1e-6: {tiny}")
    for k in ref["params"]:  # the ranks hold one set of weights
        assert torch.equal(two_ranks[0]["learner"]["params"][k],
                           two_ranks[1]["learner"]["params"][k])


def test_move_once_on_sharded_lanes_equals_one_rank(two_ranks, one_rank):
    for res in two_ranks:
        for k, v in one_rank["move"].items():
            assert torch.equal(res["move"][k], v), k


@pytest.mark.parametrize("game", [g for g, _ in GAMES])
def test_pipeline_iteration_two_ranks_equal_one(two_ranks, one_rank, game):
    """Each rank plays 2 of the 4 games: every rank's ring is one rank's,
    both ranks train to the same loss, and rank 0's checkpoint restores on
    both ranks.  (One rank's actor draws from the generator the ranks
    sample the ring with, so its training batch is another draw.)"""
    ref = one_rank[game]
    assert ref["size"] > 0
    for res in two_ranks:
        got = res[game]
        assert (got["moves"], got["size"]) == (ref["moves"], ref["size"])
        for k in ("policy", "value", "board"):
            assert torch.equal(got[k], ref[k]), k
        assert np.isfinite(got["loss"])
        assert got["restored"] == 0 and got["actor_generator_restored"]
        assert got["files"] == ["ckpt_0.pt", "history.json"]
    assert two_ranks[0][game]["loss"] == two_ranks[1][game]["loss"]


def test_ingest_record_shards(two_ranks):
    """Each rank ingests its own 2 records of 4 moves: a global ring of 16
    on both ranks, and the same loss."""
    a, b = (r["ingest"] for r in two_ranks)
    assert a["ingested"] == b["ingested"] == 16
    assert a["size"] == b["size"] == 16
    assert a["loss"] == b["loss"]


# ---------------------------------------------------------------------------
# The mesh functions against the JAX package's.


def test_mesh_functions_match_jax():
    import jax
    import jax.numpy as jnp

    from alphazero_tpu.parallel import mesh as jmesh
    from alphazero_tpu_torch.parallel import mesh as tmesh

    assert (tmesh.DATA_AXIS, tmesh.MODEL_AXIS) == (jmesh.DATA_AXIS, jmesh.MODEL_AXIS)
    # make_mesh's divisibility error: one rank here, one JAX device.
    with pytest.raises(ValueError) as terr:
        tmesh.make_mesh(model_parallelism=3)
    with pytest.raises(ValueError) as jerr:
        jmesh.make_mesh(jax.devices()[:1], model_parallelism=3)
    assert str(terr.value) == str(jerr.value)
    one = tmesh.make_mesh()
    assert one.shape == dict(jmesh.make_mesh(jax.devices()[:1]).shape)
    # A two-wide data axis (this process is rank 0 of it).
    t2, j2 = tmesh.Mesh((0, 1)), jmesh.make_mesh(jax.devices()[:2])
    assert t2.shape == dict(j2.shape)
    assert tmesh.local_batch_size(8, t2) == jmesh.local_batch_size(8, j2) == 4
    with pytest.raises(ValueError) as terr:
        tmesh.local_batch_size(7, t2)
    with pytest.raises(ValueError) as jerr:
        jmesh.local_batch_size(7, j2)
    assert str(terr.value) == str(jerr.value)
    tree = {"rows": np.arange(24.0).reshape(8, 3), "odd": np.arange(7.0),
            "scalar": np.float32(2.0)}
    tout = tmesh.shard_batch(t2, {k: torch.as_tensor(v) for k, v in tree.items()})
    jout = jmesh.shard_batch(j2, {k: jnp.asarray(v) for k, v in tree.items()})
    for k in ("rows", "odd"):
        shard = jout[k].addressable_shards[0]  # device 0's piece
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(shard.data))
    assert tout["rows"].shape[0] == 4 and tout["odd"].shape[0] == 7
    assert float(tout["scalar"]) == float(jout["scalar"]) == 2.0


def test_pipeline_refuses_games_the_ranks_do_not_divide(tmp_path):
    """Each rank plays an equal share of the games: 5 games over a two-wide
    data axis raise JAX's ``local_batch_size`` error."""
    from alphazero_tpu_torch.parallel.mesh import Mesh
    from alphazero_tpu_torch.training.pipeline import Pipeline, PipelineConfig

    with pytest.raises(ValueError, match="batch 5 not divisible by 2 devices"):
        Pipeline(PipelineConfig(board_size=5, games_per_iteration=5,
                                checkpoint_dir=str(tmp_path)),
                 device="cpu", mesh=Mesh((0, 1)))


def test_one_process_is_a_group_of_one(monkeypatch):
    from alphazero_tpu_torch.parallel import distributed, mesh

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    distributed.initialize()
    distributed.initialize(num_processes=1, device="cpu")
    assert not torch.distributed.is_initialized()
    assert distributed.world_size() == 1 and distributed.rank() == 0
    assert distributed.host_local_batch(6) == 6
    x = torch.arange(6).reshape(3, 2)
    m = mesh.make_mesh()
    assert mesh.shard_batch(m, x) is x and mesh.replicate(m, x) is x
    assert distributed.make_global_array(x, m) is x
    assert distributed.all_true(True, "cpu") and not distributed.all_true(False, "cpu")


if __name__ == "__main__":
    worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
