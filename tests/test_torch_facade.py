"""The port's facade (``alphazero_tpu_torch/facade.py``): the four cases of
``tests/test_facade.py`` on the CPU at a tiny config, and
``get_best_action`` against the JAX facade's on a shared bundle (no root
noise, the most visited action)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from alphazero_tpu_torch.facade import AlphaZero
from alphazero_tpu_torch.mcts.search import MCTSConfig
from alphazero_tpu_torch.models.io import load_model
from alphazero_tpu_torch.models.resnet import ResNetConfig
from alphazero_tpu_torch.selfplay.actor import SelfPlayConfig
from alphazero_tpu_torch.training.learner import LearnerConfig
from alphazero_tpu_torch.training.pipeline import PipelineConfig
from alphazero_tpu_torch.utils.config import save_config
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def tiny(tmp_path, **kw):
    base = dict(
        game="gomoku",
        board_size=5,
        model=ResNetConfig(num_blocks=1, channels=16),
        selfplay=SelfPlayConfig(
            mcts=MCTSConfig(num_simulations=8, dirichlet_alpha=0.5),
            max_moves=25, temperature_drop_move=4,
        ),
        learner=LearnerConfig(scheduler="constant", total_steps=10),
        iterations=1,
        games_per_iteration=4,
        train_steps_per_iteration=2,
        train_batch_size=16,
        min_replay_before_training=16,
        checkpoint_dir=str(tmp_path / "ckpt"),
        inference="folded",
    )
    base.update(kw)
    return PipelineConfig(**base)


def test_selfplay_train_best_action(tmp_path):
    az = AlphaZero(tiny(tmp_path), device="cpu")
    entry = az.run_self_play()
    assert entry["moves"] > 0
    history = az.train_network(1)
    assert len(history) == 2 and "loss" in history[-1]
    state = az.env.init(1, device="cpu")
    action = az.get_best_action(state, simulations=8)
    assert 0 <= action < az.env.num_actions


def test_run_self_play_honors_num_games(tmp_path):
    az = AlphaZero(tiny(tmp_path), device="cpu")
    # games_per_iteration=4; asking for 6 games runs 2 iterations.
    entry = az.run_self_play(num_games=6)
    assert entry["total_games"] == 8
    assert entry["iteration"] == 1


def test_evaluate_and_save(tmp_path):
    """The match tallies 4 games, and the saved bundle reloads with the
    net's weights, for the ResNet and for RandWire (``model_kind``)."""
    for kw in ({}, dict(model_kind="randwire",
                        model_options=(("num_blocks", 1), ("nodes_per_block", 3),
                                       ("channels", 16)))):
        az = AlphaZero(tiny(tmp_path, **kw), device="cpu")
        res = az.evaluate_model(num_games=4, simulations=4)
        assert res["wins"] + res["losses"] + res["draws"] == 4
        path = tmp_path / f"model_{az.config.model_kind}.msgpack"
        az.save(str(path))
        assert path.exists() and (tmp_path / f"{path.name}.json").exists()
        back, meta = load_model(str(path), az.env.observation_shape, device="cpu")
        assert meta["kind"] == az.config.model_kind
        for k, v in az.model.state_dict().items():
            assert torch.equal(back.state_dict()[k], v), k
    other = az.model.state_dict()
    res = az.evaluate_model(other_params=other, num_games=2, simulations=4)
    assert res["wins"] + res["losses"] + res["draws"] == 2


def test_from_config_file(tmp_path):
    path = str(tmp_path / "cfg.json")
    save_config(tiny(tmp_path), path)
    az = AlphaZero.from_config_file(path, device="cpu")
    assert az.env.board_size == 5 and az.config == tiny(tmp_path)


def test_best_action_matches_jax_facade(tmp_path):
    """A bundle written by the JAX package, loaded by both facades; the
    most visited action of a 96-simulation search (no root noise) from
    three positions.  The visit counts themselves may differ by a visit or
    two (bf16 logits round apart in the two frameworks)."""
    from alphazero_tpu.facade import AlphaZero as JaxAlphaZero
    from alphazero_tpu.games.gomoku import GomokuEnv as JaxGomoku
    from alphazero_tpu.models import io as jio
    from alphazero_tpu.models.resnet import ResNetConfig as JaxResNet
    from alphazero_tpu.training.pipeline import PipelineConfig as JaxConfig

    cfg = JaxResNet(num_blocks=1, channels=16)
    jmodel, _ = jio.build_model("resnet", 25, dict(num_blocks=1, channels=16))
    variables = jmodel.init(jax.random.key(0), jnp.zeros((1, 11, 5, 5)))
    rng = np.random.RandomState(4)

    def rand(path, x):
        """JAX's init, with BN statistics and affines and the two
        zero-initialised head kernels drawn from the seed."""
        k = jax.tree_util.keystr(path)
        if "var" in k:
            return jnp.asarray(rng.uniform(0.5, 2.0, x.shape), jnp.float32)
        if "mean" in k or "bias" in k or "scale" in k:
            return (jnp.asarray(rng.normal(0, 0.2, x.shape), jnp.float32)
                    + (1.0 if "scale" in k else 0.0))
        if "'Dense_0'" in k and "SEBlock" not in k or "'Dense_2'" in k:
            return jnp.asarray(rng.normal(0, 0.05, x.shape), jnp.float32)
        return x

    variables = jax.tree_util.tree_map_with_path(rand, variables)
    path = str(tmp_path / "shared.msgpack")
    jio.save_model(path, variables, "resnet", 25, cfg)

    jaz = JaxAlphaZero(JaxConfig(game="gomoku", board_size=5, model=cfg,
                                 games_per_iteration=8, replay_capacity=64,
                                 checkpoint_dir=str(tmp_path / "jax")))
    _, jvars = jio.load_model(path, (11, 5, 5))
    jaz.pipeline.state = jaz.pipeline.state.replace(params=jvars)
    az = AlphaZero(tiny(tmp_path), device="cpu")
    az.model.load_state_dict(load_model(path, (11, 5, 5), device="cpu")[0].state_dict())

    jenv, env = JaxGomoku(board_size=5), az.env
    jstate, state = jenv.init(), env.init(1, device="cpu")
    for moves in ((), (12,), (12, 6)):
        js, ts = jstate, state
        for a in moves:
            js = jenv.step(js, jnp.asarray(a))
            ts = env.step(ts, torch.tensor([a], dtype=torch.int32))
        assert az.get_best_action(ts, simulations=96) == \
            jaz.get_best_action(js, simulations=96), moves
