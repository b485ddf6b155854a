"""The port's DDW-RandWire net (``alphazero_tpu_torch/models/randwire.py``)
against ``alphazero_tpu/models/randwire.py``: the Watts-Strogatz edge
lists, forward passes from carried-over weights on the three games, one
AdamW step, and the pipeline with ``model_kind="randwire"``.  Every
tolerance is stated where it is used."""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax  # noqa: F401 (the JAX learner's optimizer)
import pytest
import torch

from alphazero_tpu.models import randwire as jrw
from alphazero_tpu.training import replay as jreplay
from alphazero_tpu.training.learner import LearnerConfig as JaxLearner
from alphazero_tpu.training.learner import create_train_state as jcreate
from alphazero_tpu.training.learner import train_step as jtrain_step
from alphazero_tpu_torch.core import registry
from alphazero_tpu_torch.mcts.search import MCTSConfig
from alphazero_tpu_torch.models import randwire as trw
from alphazero_tpu_torch.models.convert import (
    flax_from_randwire_state_dict, randwire_state_dict_from_flax,
)
from alphazero_tpu_torch.selfplay.actor import SelfPlayConfig
from alphazero_tpu_torch.training import learner as tlearner
from alphazero_tpu_torch.training import replay as treplay
from alphazero_tpu_torch.training.learner import LearnerConfig
from alphazero_tpu_torch.training.pipeline import Pipeline, PipelineConfig
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SMALL = dict(num_blocks=2, nodes_per_block=4, channels=16)
GAMES = {"gomoku": 7, "go": 9, "chess": 8}


def _nets(game, jdtype, tdtype, seed=0, live_heads=False):
    """(JAX model, its variables randomised from a numpy seed, the port's
    model with the same weights, observation shape, action count).  Every
    variable is JAX's init plus N(0, 0.1); with ``live_heads`` only the two
    zero-initialised kernels are replaced (N(0, 0.05)), so the value's tanh
    stays off saturation and the first step's gradient reaches the
    trunk."""
    env = registry.create_game(game, GAMES[game])
    obs_shape, A = env.observation_shape, env.num_actions
    jmodel = jrw.DDWRandWireResNet(num_actions=A,
                                   cfg=jrw.RandWireConfig(dtype=jdtype, **SMALL))
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.key(seed), jnp.zeros((1,) + obs_shape)))
    rng = np.random.RandomState(seed + 1)
    if live_heads:
        params = variables["params"]
        for name in ("Dense_0", "Dense_2"):
            k = params[name]["kernel"]
            params[name]["kernel"] = rng.normal(0, 0.05, k.shape).astype(np.float32)
    else:
        variables = jax.tree_util.tree_map(
            lambda x: x + rng.normal(0, 0.1, x.shape).astype(np.float32), variables)
    model = trw.DDWRandWireResNet(A, trw.RandWireConfig(dtype=tdtype, **SMALL),
                                  obs_shape)
    model.load_state_dict(randwire_state_dict_from_flax(variables))
    return jmodel, variables, model, obs_shape, A


def _obs(obs_shape, B=8, seed=0):
    return np.random.RandomState(seed).randint(0, 2, (B,) + obs_shape).astype(np.float32)


@pytest.mark.parametrize("p", [0.0, 0.25, 0.75, 1.0])
@pytest.mark.parametrize("k", [2, 4, 6])
def test_edge_lists_equal_jax(k, p):
    """n in 3..32 and seeds 0..40 for each (k, p): the same edges in the
    same order."""
    for n in range(3, 33):
        for seed in range(41):
            assert trw.watts_strogatz_dag(n, k, p, seed) == \
                jrw.watts_strogatz_dag(n, k, p, seed), (n, k, p, seed)


def test_blocks_wire_as_jax_and_carry_weights_both_ways():
    """Each block's graph is seeded ``seed * 1000 + b``; the flax tree has a
    router exactly where a node has several predecessors, and the
    conversion round-trips bit for bit."""
    jmodel, variables, model, _, _ = _nets("gomoku", jnp.float32, torch.float32)
    for b, blk in enumerate(model.blocks):
        assert blk.edges == jrw.watts_strogatz_dag(4, 4, 0.75, b)
        routers = {k for k in variables["params"][f"block_{b}"] if k.startswith("router")}
        assert routers == {f"router_{i}" for i in blk.routers}
    back = flax_from_randwire_state_dict(model.state_dict())
    flat_j = jax.tree_util.tree_leaves_with_path(variables)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_t)
    for path, x in flat_j:
        np.testing.assert_array_equal(flat_t[path], x)


@pytest.mark.parametrize("game", sorted(GAMES))
def test_forward_f32_matches_jax(game):
    """f32 on both sides (``RandWireConfig(dtype=float32)``): within 1e-4
    absolute (summation order of the convs and GroupNorm statistics)."""
    jmodel, variables, model, obs_shape, A = _nets(game, jnp.float32, torch.float32)
    obs = _obs(obs_shape, seed=1)
    jl, jv = jax.jit(jmodel.apply)(variables, jnp.asarray(obs))
    with torch.no_grad():
        tl, tv = model(torch.from_numpy(obs))
    assert tl.dtype == tv.dtype == torch.float32 and tl.shape == (8, A)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)


@pytest.mark.parametrize("game", sorted(GAMES))
def test_forward_bf16_matches_jax(game):
    """The production dtype policy (bf16 compute, f32 parameters): bf16
    activations rounded at different places in the two frameworks, so the
    bound of the ResNet's bf16 test, 5 % of the logit scale (and 0.05 for
    the value)."""
    jmodel, variables, model, obs_shape, _ = _nets(game, jnp.bfloat16, torch.bfloat16)
    obs = _obs(obs_shape, seed=2)
    jl, jv = jax.jit(jmodel.apply)(variables, jnp.asarray(obs))
    with torch.no_grad():
        tl, tv = model(torch.from_numpy(obs))
    assert tl.dtype == tv.dtype == torch.float32
    scale = float(np.abs(np.asarray(jl)).max())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=0.05 * scale)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=0.05)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def test_train_step_matches_jax():
    """One AdamW step in f32 on a 7x7 Gomoku batch: loss and grad norm
    within 1e-5 relative (``tests/test_torch_training.py``'s f32 bound),
    every parameter within 2 * lr, the most two Adam updates can differ by,
    and all but 5e-4 of them within 1e-5 relative + 1e-6.  Adam divides
    each gradient by its own root mean square, so an element whose gradient
    is a near-cancelling sum close to Adam's eps (1e-8) moves by a visible
    part of a step when the summation order changes.  The ResNet's test
    sees 1e-4 of such elements; here 130 of 521,090 (2.5e-4): 127 in the
    value head's 1,568 x 256 dense kernel, whose gradients at this batch
    mostly lie near eps (their updates are a tenth of a full step), the
    largest difference 4.0e-5 in the policy kernel."""
    jmodel, variables, model, obs_shape, A = _nets("gomoku", jnp.float32,
                                                   torch.float32, live_heads=True)
    rng = np.random.RandomState(3)
    obs = rng.normal(size=(32,) + obs_shape).astype(np.float32)
    logits = rng.normal(size=(32, A))
    pol = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    val = np.tanh(rng.normal(size=(32,))).astype(np.float32)
    lr = 1e-3
    base = dict(learning_rate=lr, scheduler="constant", warmup_steps=0,
                total_steps=100)
    jcfg, tcfg = JaxLearner(**base), LearnerConfig(**base)
    jstate, tx = jcreate(jmodel, jax.random.key(0), obs_shape, jcfg,
                         params=jax.tree_util.tree_map(jnp.asarray, variables))
    jstate, jm = jax.jit(lambda s, b: jtrain_step(s, b, jmodel, tx, jcfg))(
        jstate, jreplay.Batch(jnp.asarray(obs), jnp.asarray(pol), jnp.asarray(val)))
    tstate, tm = tlearner.train_step(
        tlearner.create_train_state(model, tcfg),
        treplay.Batch(torch.from_numpy(obs), torch.from_numpy(pol),
                      torch.from_numpy(val)), tcfg)
    for g, w in zip(tm, jm):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    got = _leaves(flax_from_randwire_state_dict(tstate.module.state_dict()))
    want = _leaves(jstate.params)
    assert got.keys() == want.keys()
    off = 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2 * lr, err_msg=k)
        off += int((np.abs(got[k] - want[k]) > 1e-6 + 1e-5 * np.abs(want[k])).sum())
    assert off <= 5e-4 * sum(v.size for v in want.values()), off


def _pipeline_config(tmp_path, **kw):
    base = dict(
        game="gomoku", board_size=5, model_kind="randwire",
        model_options=(("num_blocks", 1), ("nodes_per_block", 3),
                       ("channels", 16)),
        selfplay=SelfPlayConfig(mcts=MCTSConfig(num_simulations=8, wave_size=4),
                                max_moves=25, temperature_drop_move=4),
        learner=LearnerConfig(scheduler="constant", total_steps=10),
        iterations=1, games_per_iteration=8, train_steps_per_iteration=2,
        train_batch_size=16, replay_capacity=4096,
        min_replay_before_training=16, checkpoint_dir=str(tmp_path / "ckpt"),
        checkpoint_every=1)
    base.update(kw)
    return PipelineConfig(**base)


def test_pipeline_trains_randwire_on_raw_inference(tmp_path, caplog):
    """The default int8 inference falls back to the raw module, as in the
    JAX pipeline (whose fallback reads the built model's config too); one
    iteration trains, and its checkpoint restores bit for bit."""
    from alphazero_tpu.training.pipeline import Pipeline as JaxPipeline
    from alphazero_tpu.training.pipeline import PipelineConfig as JaxConfig

    jpipe = JaxPipeline(JaxConfig(
        game="gomoku", board_size=5, model_kind="randwire",
        model_options=(("num_blocks", 1), ("nodes_per_block", 3), ("channels", 16)),
        games_per_iteration=8, replay_capacity=64,
        checkpoint_dir=str(tmp_path / "jax")))
    caplog.set_level(logging.WARNING)
    pipe = Pipeline(_pipeline_config(tmp_path), device="cpu")
    assert jpipe.inference_mode == pipe.inference_mode == "raw"
    assert "falling back to raw for DDWRandWireResNet" in caplog.text
    assert isinstance(pipe.state.module, trw.DDWRandWireResNet)
    history = pipe.run()
    assert history[0]["moves"] > 0 and np.isfinite(history[0]["loss"])
    fresh = Pipeline(_pipeline_config(tmp_path), device="cpu")
    assert fresh.restore_checkpoint() == 0
    a, b = pipe.state.module.state_dict(), fresh.state.module.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    sa, sb = pipe.state.optimizer.state_dict(), fresh.state.optimizer.state_dict()
    assert all(torch.equal(sa["state"][i]["exp_avg"], sb["state"][i]["exp_avg"])
               for i in sa["state"])
    assert fresh.state.step == pipe.state.step == 2
    assert torch.equal(fresh.generator.get_state(), pipe.generator.get_state())
