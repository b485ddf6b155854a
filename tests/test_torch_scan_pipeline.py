"""``Pipeline(host_actor=False)``, the pipeline on the scanned actor,
against the JAX package's: one iteration, the same replay ring."""
import dataclasses

import jax
import numpy as np
import torch

from alphazero_tpu.mcts.search import MCTSConfig as JaxMCTS
from alphazero_tpu.selfplay import actor as jactor
from alphazero_tpu_torch.mcts.search import MCTSConfig
from alphazero_tpu_torch.selfplay import actor as tactor
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FAST = {"xla_backend_optimization_level": 1}
N = 5


def test_scanned_pipeline_ring_matches_jax(tmp_path):
    """One ``Pipeline(host_actor=False)`` iteration on 5x5 from the JAX
    pipeline's initial weights (``models/convert.py``), no noise, T=0,
    folded inference: the replay ring equals the JAX scanned pipeline's."""
    from alphazero_tpu.models.resnet import ResNetConfig as JaxResNetConfig
    from alphazero_tpu.training import pipeline as jpipe
    from alphazero_tpu_torch.models.convert import state_dict_from_flax
    from alphazero_tpu_torch.models.resnet import ResNetConfig
    from alphazero_tpu_torch.training import pipeline as tpipe

    net = dict(num_blocks=1, channels=8, policy_channels=4, value_channels=4,
               value_hidden=16)
    mcts = dict(num_simulations=8, dirichlet_epsilon=0.0)
    sp = dict(max_moves=N * N + 1, temperature=0.0, final_temperature=0.0)
    common = dict(game="gomoku", board_size=N, games_per_iteration=4,
                  train_steps_per_iteration=1, replay_capacity=256,
                  min_replay_before_training=10 ** 6, inference="folded",
                  host_actor=False, checkpoint_every=10 ** 6)
    jp = jpipe.Pipeline(jpipe.PipelineConfig(
        model=JaxResNetConfig(**net),
        selfplay=jactor.SelfPlayConfig(mcts=JaxMCTS(**mcts), **sp),
        checkpoint_dir=str(tmp_path / "jax"), **common))
    tp = tpipe.Pipeline(tpipe.PipelineConfig(
        model=ResNetConfig(**net),
        selfplay=tactor.SelfPlayConfig(mcts=MCTSConfig(**mcts), **sp),
        checkpoint_dir=str(tmp_path / "port"), **common), device="cpu")
    variables = jax.tree_util.tree_map(np.asarray, jp.state.params)
    tp.state.module.load_state_dict(state_dict_from_flax(variables, 1))
    # The JAX pipeline's compiles at XLA level 1.
    real = jax.jit
    jax.jit = lambda *a, **k: real(*a, **{"compiler_options": FAST, **k})
    try:
        jp._build_jits()
        jentry = jp.run_iteration(0)
    finally:
        jax.jit = real
    tentry = tp.run_iteration(0)
    assert jentry["moves"] == tentry["moves"] > 0
    assert jentry["games_finished"] == tentry["games_finished"]
    jb, tb = jp.buffer, tp.buffer
    assert int(jb.size) == tb.size == jentry["replay_size"]
    assert int(jb.position) == tb.position
    n = tb.size
    assert n > 0 and bool((tb.value[:n] != 0).any())
    np.testing.assert_array_equal(tb.policy[:n].numpy(), np.asarray(jb.policy)[:n])
    np.testing.assert_array_equal(tb.value[:n].numpy(), np.asarray(jb.value)[:n])
    for f in dataclasses.fields(tb.states):
        got, want = getattr(tb.states, f.name)[:n], np.asarray(getattr(jb.states, f.name))[:n]
        if f.name == "hash":  # the port's int64 hash is JAX's (hi, lo) u32 pair
            got = torch.stack([(got >> 32) & 0xFFFFFFFF, got & 0xFFFFFFFF], -1)
            got = got.numpy().astype(np.uint32)
        else:
            got = got.numpy()
        np.testing.assert_array_equal(got, want, err_msg=f.name)
