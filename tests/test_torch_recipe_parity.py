"""The flagship recipe's training loop, the port's ``Pipeline`` against the
JAX package's over several iterations on the CPU, at a small size: Gomoku
7x7, a BatchNorm SE-ResNet of 2 blocks and 16 channels, the host actor at
W>1, folded actors (the setting of JAX's flagship record) and the recipe's
learner schedule (``total_steps = max(iters * steps, 256)``, the 500-step
warm-up).

* Exact: float32 on both sides, both started from JAX's initial weights
  (carried with ``models/convert.py``), root noise off (epsilon 0) and
  temperature 0 from move 0, the replay-sample and augmentation draws
  injected into both (numpy, the same stream; JAX's sampler is replaced
  inside the test only, by its body with the draws given, as
  ``tests/test_torch_training.py`` does).  Three iterations: records ->
  ring -> samples -> learner steps -> the next iteration's self-play on the
  updated net.
* Statistical: the recipe's stochastic settings, which the exact run
  cannot reach: temperature 1 until ply 7 (the recipe's 30 of 225 plies
  scaled to the 49 of a 7x7 board: 30 * 49 / 225 = 6.5, rounded up), root
  noise epsilon 0.25 and W=16, on the fresh (uniform) net of iteration 0;
  64 games of each package.

The JAX side compiles at XLA optimisation level 1 (as
``tests/test_torch_scan_pipeline.py`` does), which holds the file under a
minute on one core."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from alphazero_tpu.mcts.search import MCTSConfig as JaxMCTS
from alphazero_tpu.models.resnet import ResNetConfig as JaxNet
from alphazero_tpu.parallel import mesh as jmesh
from alphazero_tpu.selfplay.actor import SelfPlayConfig as JaxSelfPlay
from alphazero_tpu.training import pipeline as jpipeline
from alphazero_tpu.training import replay as jreplay
from alphazero_tpu.training.learner import LearnerConfig as JaxLearner
from alphazero_tpu.training.learner import create_train_state as jcreate_train_state
from alphazero_tpu.training.learner import train_step as jtrain_step
from alphazero_tpu_torch.mcts.search import MCTSConfig
from alphazero_tpu_torch.models.convert import (
    flax_from_state_dict, state_dict_from_flax,
)
from alphazero_tpu_torch.models.resnet import ResNetConfig
from alphazero_tpu_torch.selfplay.actor import SelfPlayConfig
from alphazero_tpu_torch.training import pipeline as tpipeline
from alphazero_tpu_torch.training import replay as treplay
from alphazero_tpu_torch.training.learner import LearnerConfig
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N = 7
NET = dict(num_blocks=2, channels=16)
ITERS, STEPS, BATCH = 3, 8, 64
# The recipe's temperature drop (ply 30 of 225) scaled to 7x7.
DROP = -(-30 * N * N // 225)
FAST = {"xla_backend_optimization_level": 1}


@contextlib.contextmanager
def _fast_jax():
    real = jax.jit
    jax.jit = lambda *a, **k: real(*a, **{"compiler_options": FAST, **k})
    try:
        yield
    finally:
        jax.jit = real


def _jitted_init(model, rng, obs_shape, config):
    """JAX's ``create_train_state`` with ``model.init`` compiled whole (the
    same draws; eagerly, flax's init compiles each of its ops apart)."""
    params = jax.jit(model.init)(rng, jnp.zeros((1,) + tuple(obs_shape)))
    return jcreate_train_state(model, rng, obs_shape, config, params=params)


def _pair(games, sims, wave, drop, epsilon, min_replay):
    """(JAX pipeline, port pipeline) of one recipe structure; the port
    starts from JAX's initial weights."""
    common = dict(game="gomoku", board_size=N, iterations=ITERS,
                  games_per_iteration=games, train_steps_per_iteration=STEPS,
                  train_batch_size=BATCH, replay_capacity=4096,
                  min_replay_before_training=min_replay, checkpoint_every=10**9,
                  inference="folded")
    steps = max(ITERS * STEPS, 256)
    jcfg = jpipeline.PipelineConfig(
        model=JaxNet(dtype=jnp.float32, **NET), learner=JaxLearner(total_steps=steps),
        selfplay=JaxSelfPlay(mcts=JaxMCTS(num_simulations=sims, wave_size=wave,
                                          dirichlet_epsilon=epsilon),
                             max_moves=N * N, temperature_drop_move=drop),
        checkpoint_dir="unused", **common)
    tcfg = tpipeline.PipelineConfig(
        model=ResNetConfig(dtype=torch.float32, **NET), learner=LearnerConfig(total_steps=steps),
        selfplay=SelfPlayConfig(mcts=MCTSConfig(num_simulations=sims, wave_size=wave,
                                                dirichlet_epsilon=epsilon),
                                max_moves=N * N, temperature_drop_move=drop),
        checkpoint_dir="unused", **common)
    real = jpipeline.create_train_state
    jpipeline.create_train_state = _jitted_init
    try:
        jp = jpipeline.Pipeline(jcfg, mesh=jmesh.make_mesh(jax.devices()[:1]))
    finally:
        jpipeline.create_train_state = real
    tp = tpipeline.Pipeline(tcfg, device="cpu")
    tp.state.module.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jp.state.params), NET["num_blocks"]))
    return jp, tp


def _inject_draws(jp, tp, seed):
    """Both learners sample from one numpy stream (each side its own copy):
    a step's ring indices in [0, size) and its dihedral symmetries."""
    jrs, trs = np.random.RandomState(seed), np.random.RandomState(seed)

    def draw(rs, size):
        return (rs.randint(0, size, BATCH).astype(np.int32),
                rs.randint(0, 8, BATCH).astype(np.int32))

    env = jp.env
    step = jax.jit(lambda st, b: jtrain_step(st, b, jp.model, jp.tx, jp.config.learner))

    @jax.jit
    def sample(buf, idx, syms):  # replay.sample's body, the draws given
        states = jax.tree_util.tree_map(lambda x: x[idx], buf.states)
        obs = jax.vmap(env.observation)(states)
        obs, policy = jax.vmap(lambda o, p, s: jreplay.augment(o, p, s, N))(
            obs, buf.policy[idx], syms)
        return jreplay.Batch(obs=obs, policy=policy, value=buf.value[idx])

    def jax_train(state, buf, rng):
        metrics = []
        for _ in range(STEPS):
            idx, syms = draw(jrs, int(buf.size))
            state, m = step(state, sample(buf, jnp.asarray(idx), jnp.asarray(syms)))
            metrics.append(m)
        return state, jax.tree_util.tree_map(lambda *x: jnp.stack(x).mean(), *metrics)

    def port_sample():
        idx, syms = draw(trs, tp.buffer.size)
        return treplay.sample(tp.buffer, tp.env, None, BATCH, True,
                              idx=torch.from_numpy(idx).long(),
                              syms=torch.from_numpy(syms).long())

    jp._train = jax_train
    tp._sample = port_sample


def _capture_actors(jp, tp):
    """Each iteration's self-play output of both pipelines, as numpy."""
    seen = {"jax": [], "port": []}
    jax_actor, port_actor = jp._actor, tp._run_actor

    def jax_run(params, rng):
        out = jax_actor(params, rng)
        seen["jax"].append(jax.tree_util.tree_map(np.asarray, out))
        return out

    def port_run():
        out = port_actor()
        seen["port"].append(out)
        return out

    jp._actor, tp._run_actor = jax_run, port_run
    return seen


def _ring(buf):
    """The ring as numpy; a Zobrist hash as its two 32-bit keys (the port
    packs them into one int64 as ``k0 << 32 | k1``)."""
    st = buf.states
    out = {"size": int(buf.size), "policy": np.asarray(buf.policy),
           "value": np.asarray(buf.value)}
    for f in dataclasses.fields(st):
        x = np.asarray(getattr(st, f.name))
        if f.name == "hash":
            x = x.astype(np.int64)
            if x.ndim == 1:
                x = np.stack([x >> 32, x], -1)
            x = x & 0xFFFFFFFF
        out[f.name] = x
    return out


def test_pipeline_iterations_match_jax_exactly():
    """Three iterations, float32, epsilon 0, T=0, the draws injected.

    Exact: every iteration's self-play (actions, visit policies, lengths,
    winners) and the replay ring after it (states, policies, value targets,
    size); ``moves``, ``replay_size`` and ``games_finished``.  Within 1e-5
    relative: ``loss``, ``policy_loss``, ``value_loss`` and ``grad_norm``
    (measured: 4e-7 and 2e-6).  Within 1e-5 absolute: the final weights and
    BatchNorm statistics (measured: 7e-7).  Iteration 0 already trains
    (200 positions >= the 64-row minimum), so iterations 1 and 2 play on
    updated nets."""
    with _fast_jax():
        jp, tp = _pair(games=8, sims=16, wave=4, drop=0, epsilon=0.0, min_replay=64)
        _inject_draws(jp, tp, seed=5)
    seen = _capture_actors(jp, tp)
    for it in range(ITERS):
        with _fast_jax():
            want = jp.run_iteration(it)
        got = tp.run_iteration(it)
        for key in ("moves", "replay_size", "games_finished"):
            assert got[key] == want[key], (it, key)
        for key in ("loss", "policy_loss", "value_loss", "grad_norm"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=f"{it} {key}")
        j, t = seen["jax"][it], seen["port"][it]
        for name in ("actions", "policies", "active", "winner", "length"):
            np.testing.assert_array_equal(getattr(t, name).numpy(),
                                          np.asarray(getattr(j, name)),
                                          err_msg=f"{it} {name}")
        rj, rt = _ring(jp.buffer), _ring(tp.buffer)
        assert sorted(rj) == sorted(rt)
        for name in rj:
            np.testing.assert_array_equal(rt[name], rj[name], err_msg=f"{it} ring {name}")
    assert tp.state.step == int(jp.state.step) == ITERS * STEPS
    got = flax_from_state_dict(tp.state.module.state_dict(), NET["num_blocks"])
    want = jax.tree_util.tree_map(np.asarray, jp.state.params)
    paths = jax.tree_util.tree_leaves_with_path(want)
    mine = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(paths) == len(mine)
    for path, w in paths:
        np.testing.assert_allclose(np.asarray(mine[path]), w, rtol=0, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def _game_stats(out):
    """Per game: plies played and the mean entropy (nats) of its root
    visit targets over the moves it played."""
    active = np.asarray(out.active, bool)  # [T, B]
    p = np.asarray(out.policies, np.float64)  # [T, B, A]
    ent = -(p * np.log(np.where(p > 0, p, 1.0))).sum(-1)
    plies = active.sum(0)
    return plies.astype(np.float64), (ent * active).sum(0) / np.maximum(plies, 1)


def test_stochastic_selfplay_matches_jax_statistically():
    """Iteration 0's self-play at the recipe's stochastic settings (T=1
    until ply 7, epsilon 0.25, W=16, 16 simulations) on the fresh net,
    whose logits and value are exactly 0 in both packages: 64 games each.
    Mean game length and mean root-target entropy agree within 3 standard
    errors of their difference (each package's games independent)."""
    with _fast_jax():
        jp, tp = _pair(games=64, sims=16, wave=16, drop=DROP, epsilon=0.25,
                       min_replay=10**9)
        # The first half of ``run_iteration``: the refreshed actor's games.
        jout = jp._actor(jp._eval_transform(jp.state.params, jp._next_rng()),
                         jp._next_rng())
        jout = jax.tree_util.tree_map(np.asarray, jout)
    tp.eval_tree = tp._eval_transform(tp.state.module)
    tout = tp._run_actor()
    (jl, je), (tl, te) = _game_stats(jout), _game_stats(tout)
    assert tout.winner.shape == jout.winner.shape == (64,)
    for name, a, b in (("plies", jl, tl), ("entropy", je, te)):
        se = np.sqrt(a.var(ddof=1) / a.size + b.var(ddof=1) / b.size)
        assert abs(a.mean() - b.mean()) <= 3 * se, (name, a.mean(), b.mean(), se)
        assert se > 0, name
