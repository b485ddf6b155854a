"""The port's training slice against the JAX package on the same numpy
inputs: root noise, flax's initialisation, train-mode BatchNorm and
GroupNorm, the loss, the schedules, the replay ring and its augmentation,
the optimizer chain and ``train_step``, and the slice as a whole
(replay -> sample -> three steps).  Every tolerance is stated where it is
used."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from alphazero_tpu.games.gomoku import GomokuEnv as JaxGomoku
from alphazero_tpu.games.gomoku import GomokuState as JaxState
from alphazero_tpu.models.resnet import AZResNet as JaxResNet
from alphazero_tpu.models.resnet import ResNetConfig as JaxConfig
from alphazero_tpu.training import replay as jreplay
from alphazero_tpu.training import schedulers as jsched
from alphazero_tpu.training.learner import LearnerConfig as JaxLearner
from alphazero_tpu.training.learner import create_train_state as jcreate
from alphazero_tpu.training.learner import train_step as jtrain_step
from alphazero_tpu.training.loss import alphazero_loss as jloss
from alphazero_tpu_torch.core.types import where_lanes
from alphazero_tpu_torch.games.gomoku import GomokuEnv
from alphazero_tpu_torch.mcts import search as tsearch
from alphazero_tpu_torch.models.convert import (
    flax_from_state_dict, state_dict_from_flax,
)
from alphazero_tpu_torch.models.resnet import (
    AZResNet, GroupNorm, ResNetConfig,
)
from alphazero_tpu_torch.models.stub import make_uniform_eval_fn
from alphazero_tpu_torch.training import learner as tlearner
from alphazero_tpu_torch.training import replay as treplay
from alphazero_tpu_torch.training import schedulers as tsched
from alphazero_tpu_torch.training.loss import alphazero_loss
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N = 5
A = N * N
OBS = (11, N, N)
SMALL = dict(num_blocks=1, channels=16)


# ---- helpers ---------------------------------------------------------------

def _jax_net(dtype=jnp.float32, norm="batch", seed=0, live_heads=False):
    """A small JAX net from its own init.  ``live_heads`` replaces the two
    zero-initialised kernels with small random ones, so the first step's
    gradient reaches the trunk."""
    model = JaxResNet(num_actions=A, cfg=JaxConfig(dtype=dtype, norm=norm, **SMALL))
    variables = model.init(jax.random.key(seed), jnp.zeros((1,) + OBS))
    if live_heads:
        rng = np.random.RandomState(seed + 100)
        params = dict(variables["params"])
        for name in ("Dense_0", "Dense_2"):
            k = params[name]["kernel"]
            params[name] = dict(params[name], kernel=jnp.asarray(
                rng.normal(0, 0.05, k.shape), jnp.float32))
        variables = dict(variables, params=params)
    return model, variables


def _port_net(variables, dtype=torch.float32, norm="batch"):
    model = AZResNet(A, ResNetConfig(dtype=dtype, norm=norm, **SMALL),
                     obs_shape=OBS)
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables), SMALL["num_blocks"]))
    return model


def _batch_np(B=32, seed=0):
    rng = np.random.RandomState(seed)
    obs = rng.normal(size=(B,) + OBS).astype(np.float32)
    logits = rng.normal(size=(B, A))
    pol = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    val = np.tanh(rng.normal(size=(B,))).astype(np.float32)
    return obs, pol, val


def _tbatch(obs, pol, val):
    return treplay.Batch(torch.from_numpy(obs), torch.from_numpy(pol),
                         torch.from_numpy(val))


def _jbatch(obs, pol, val):
    return jreplay.Batch(jnp.asarray(obs), jnp.asarray(pol), jnp.asarray(val))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_trees_close(got, want, rtol, atol):
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol, err_msg=k)


def _to_jax_states(st):
    """The port's batched GomokuState as the JAX pytree (leading axis B)."""
    h = st.hash
    pair = torch.stack([(h >> 32) & 0xFFFFFFFF, h & 0xFFFFFFFF], -1)
    return JaxState(
        board=jnp.asarray(st.board.numpy()),
        to_play=jnp.asarray(st.to_play.numpy()),
        last_moves=jnp.asarray(st.last_moves.numpy()),
        move_count=jnp.asarray(st.move_count.numpy()),
        terminal=jnp.asarray(st.terminal.numpy()),
        winner=jnp.asarray(st.winner.numpy()),
        hash=jnp.asarray(pair.numpy().astype(np.uint32)),
    )


def _random_states(env, B, seed):
    """Lane b plays b % 9 random moves on the port's env (numpy-chosen)."""
    rng = np.random.RandomState(seed)
    st = env.init(B, device="cpu")
    for ply in range(8):
        legal = env.legal_mask(st).numpy()
        acts = np.array([rng.choice(np.flatnonzero(legal[b])) if legal[b].any()
                         else 0 for b in range(B)])
        live = torch.from_numpy(np.arange(B) % 9 > ply)
        st = where_lanes(live, env.step(st, torch.from_numpy(acts)), st)
    return st


# ---- 0. the two repaired faults ---------------------------------------------

def test_root_noise_without_generator_keeps_its_invariants():
    """ε = 0.25 and no generator: the root is noised from the default
    generator.  Over 4000 draws of one root: exact zeros on illegal moves,
    rows summing to 1 within 1e-6, and the mean prior within 2.5e-3 of
    (1 - ε) p + ε / n_legal (Dirichlet(0.3) over 17 legal moves: a
    component's std is 0.07, ε times it over 4000 draws is 2.8e-4, so the
    bound is about 9 standard errors)."""
    env = GomokuEnv(board_size=N)
    st = env.init(1, device="cpu")
    for a in (0, 6, 12, 18, 24, 3, 21, 9):
        st = env.step(st, torch.tensor([a]))
    draws = 4000
    roots = st.map(lambda x: x.expand((draws,) + x.shape[1:]).clone())
    logits = torch.from_numpy(np.random.RandomState(3).normal(size=(1, A))
                              .astype(np.float32)).expand(draws, A)
    cfg = tsearch.MCTSConfig(num_simulations=8, wave_size=4)
    torch.manual_seed(11)
    tree = tsearch.instantiate_tree(env, roots, logits, torch.zeros(draws), cfg)
    prior = tree.root_prior.double()
    legal = env.legal_mask(roots)
    n_legal = int(legal[0].sum())
    assert n_legal == A - 8
    assert bool((prior[~legal] == 0).all())
    np.testing.assert_allclose(prior.sum(-1).numpy(), 1.0, atol=1e-6)
    p = tsearch.masked_softmax(logits[:1].float(), legal[:1]).double()
    eps = cfg.dirichlet_epsilon
    want = torch.where(legal[0], (1 - eps) * p[0] + eps / n_legal, 0.0)
    np.testing.assert_allclose(prior.mean(0).numpy(), want.numpy(), atol=2.5e-3)
    assert float(prior.std(0).max()) > 0.01  # really noised


def test_search_without_generator_noises_the_root():
    env = GomokuEnv(board_size=N)
    st = env.init(2, device="cpu")
    run = tsearch.make_host_search(env, make_uniform_eval_fn(A),
                                   tsearch.MCTSConfig(num_simulations=8, wave_size=4))
    prior = run(st).tree.root_prior
    assert not torch.allclose(prior, torch.full_like(prior, 1.0 / A), atol=1e-3)
    quiet = tsearch.make_host_search(
        env, make_uniform_eval_fn(A),
        tsearch.MCTSConfig(num_simulations=8, wave_size=4, dirichlet_epsilon=0.0))
    torch.testing.assert_close(quiet(st).tree.root_prior,
                               torch.full_like(prior, 1.0 / A))


@pytest.mark.parametrize("norm", ["batch", "group", "none"])
def test_fresh_net_gives_uniform_logits_and_zero_value(norm):
    """Both packages: the zero policy and last value kernels (and zero
    biases) give logits exactly 0 and value exactly 0 on any input."""
    obs = np.random.RandomState(1).normal(size=(6,) + OBS).astype(np.float32)
    jmodel, jvars = _jax_net(jnp.bfloat16, norm)
    jl, jv = jmodel.apply(jvars, jnp.asarray(obs))
    assert float(jnp.abs(jl).max()) == 0.0 and float(jnp.abs(jv).max()) == 0.0
    model = AZResNet(A, ResNetConfig(norm=norm, **SMALL), obs_shape=OBS)
    for train in (False, True):
        with torch.no_grad():
            tl, tv = model(torch.from_numpy(obs), train=train)
        assert float(tl.abs().max()) == 0.0 and float(tv.abs().max()) == 0.0


def test_init_draws_flax_distributions():
    """lecun-normal kernels: variance 1/fan_in within 5 % (std), truncated at
    two standard deviations; biases 0, BN scale 1, running stats 0/1."""
    model = AZResNet(225, ResNetConfig(), generator=torch.Generator().manual_seed(0))
    w = model.value_fc1.weight  # fan_in 32 * 225 = 7200, 1.8 M draws
    want = (1.0 / 7200) ** 0.5
    assert abs(float(w.std()) / want - 1) < 0.05
    assert float(w.abs().max()) <= 2 * want / 0.87962566103423978 + 1e-9
    conv = model.blocks[0].conv1.weight  # fan_in 64 * 9 = 576
    assert abs(float(conv.std()) / (1 / 576) ** 0.5 - 1) < 0.05
    assert float(model.policy_fc.weight.abs().max()) == 0.0
    assert float(model.value_fc2.weight.abs().max()) == 0.0
    assert all(float(m.bias.abs().max()) == 0.0 for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)) and m.bias is not None)
    bn = model.blocks[0].bn1
    assert bool((bn.weight == 1).all() and (bn.bias == 0).all())
    assert bool((bn.running_mean == 0).all() and (bn.running_var == 1).all())
    again = AZResNet(225, ResNetConfig(), generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.stem.weight, model.stem.weight)


# ---- 1. model: train mode, BN statistics, GroupNorm, conversion --------------

def test_bn_running_stats_follow_flax_biased_variance():
    """One train-mode forward in f32: the running means and variances equal
    flax's within 1e-6.  torch's BatchNorm2d (unbiased variance) is off by
    var / (n - 1) * (1 - momentum), about 2.5e-4 here at n = 8 * 25."""
    jmodel, jvars = _jax_net()
    model = _port_net(jvars)
    obs = np.random.RandomState(2).normal(size=(8,) + OBS).astype(np.float32)
    (jl, jv), upd = jmodel.apply(jvars, jnp.asarray(obs), train=True,
                                 mutable=["batch_stats"])
    tl, tv = model(torch.from_numpy(obs), train=True)
    got = flax_from_state_dict(model.state_dict(), 1)["batch_stats"]
    _assert_trees_close(got, upd["batch_stats"], rtol=0, atol=1e-6)
    # the train-mode forward itself, f32 on both sides: summation order only
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), atol=1e-4)
    # torch's own update is measurably different:
    bn = torch.nn.BatchNorm2d(11, momentum=0.1)
    x = torch.from_numpy(obs * 3)
    bn.train()(x)
    biased = 0.9 + 0.1 * x.var((0, 2, 3), unbiased=False)
    assert float((bn.running_var - biased).abs().max()) > 1e-4


def test_group_norm_layer_matches_flax_with_eps_1e6():
    """flax GroupNorm (eps 1e-6) on inputs of variance 1e-4: equal within
    1e-5 relative.  torch's GroupNorm (eps 1e-5) is about 4 % off here."""
    rng = np.random.RandomState(4)
    x = (rng.normal(size=(4, 16, N, N)) * 1e-2).astype(np.float32)
    scale = rng.normal(1, 0.2, 16).astype(np.float32)
    bias = rng.normal(0, 0.2, 16).astype(np.float32)
    gn = fnn.GroupNorm(num_groups=2)
    want = gn.apply({"params": {"scale": scale, "bias": bias}},
                    jnp.asarray(x.transpose(0, 2, 3, 1)))
    want = np.asarray(want).transpose(0, 3, 1, 2)
    layer = GroupNorm(16, 2)
    layer.weight.data = torch.from_numpy(scale)
    layer.bias.data = torch.from_numpy(bias)
    got = layer(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    torch_gn = torch.nn.functional.group_norm(
        torch.from_numpy(x), 2, torch.from_numpy(scale), torch.from_numpy(bias))
    assert np.abs(torch_gn.numpy() - want).max() > 1e-2


@pytest.mark.parametrize("train", [False, True])
def test_group_norm_net_matches_jax(train):
    """A norm="group" net (group_size 32 > channels: one group), f32 both
    sides: within 1e-4 absolute (summation order)."""
    jmodel, jvars = _jax_net(norm="group")
    rng = np.random.RandomState(5)
    jvars = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.normal(0, 0.3, x.shape), jnp.float32), jvars)
    model = _port_net(jvars, norm="group")
    obs = rng.normal(size=(6,) + OBS).astype(np.float32)
    jl, jv = jmodel.apply(jvars, jnp.asarray(obs), train=train)
    tl, tv = model(torch.from_numpy(obs), train=train)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), atol=1e-4)


@pytest.mark.parametrize("norm", ["batch", "group", "none"])
def test_flax_tree_round_trip(norm):
    """state_dict -> flax tree has JAX init's structure and shapes, and
    maps back to the same state_dict."""
    _, jvars = _jax_net(norm=norm)
    model = AZResNet(A, ResNetConfig(norm=norm, **SMALL), obs_shape=OBS)
    tree = flax_from_state_dict(model.state_dict(), 1, norm)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, jvars))
    for k, v in _leaves(jvars).items():
        assert _leaves(tree)[k].shape == v.shape, k
    back = state_dict_from_flax(tree, 1)
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], v), k


# ---- 2. loss and schedules --------------------------------------------------

def test_loss_matches_jax():
    rng = np.random.RandomState(6)
    logits = rng.normal(size=(16, A)).astype(np.float32) * 3
    value = np.tanh(rng.normal(size=16)).astype(np.float32)
    _, pol, val = _batch_np(16, seed=7)
    want = jloss(jnp.asarray(logits), jnp.asarray(value), jnp.asarray(pol),
                 jnp.asarray(val), 1.0, 0.5)
    got = alphazero_loss(torch.from_numpy(logits), torch.from_numpy(value),
                         torch.from_numpy(pol), torch.from_numpy(val), 1.0, 0.5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6, atol=1e-6)


SCHEDULES = [
    ("warmup_cosine", dict(warmup_steps=40, total_steps=250)),
    ("warmup_cosine", dict(warmup_steps=0, total_steps=120, final_lr_frac=0.1)),
    ("linear_warmup", dict(warmup_steps=70, total_steps=300)),
    ("cyclic_cosine", dict(warmup_steps=0, total_steps=300, cycle_steps=64)),
    ("step", dict(warmup_steps=0, total_steps=300, step_size=50, gamma=0.5)),
    ("constant", dict(warmup_steps=0, total_steps=300)),
]


@pytest.mark.parametrize("name,kw", SCHEDULES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(SCHEDULES)])
def test_schedule_matches_optax(name, kw):
    """Every step 0..300 within float32 rounding: the JAX schedules are
    evaluated in f32, the port's in f64, so rtol 1e-6 and, where a cosine
    reaches 0, atol 2^-21 of the base rate (an f32 ulp of the cosine term).
    warmup_cosine starts at lr 0, as optax's does."""
    kw = dict(kw)
    total, warm = kw.pop("total_steps"), kw.pop("warmup_steps")
    js = jsched.make(name, 2e-3, total, warm, **kw)
    ts = tsched.make(name, 2e-3, total, warm, **kw)
    steps = np.arange(301)
    want = np.array([float(js(jnp.int32(s))) for s in steps])
    got = np.array([ts(int(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=2e-3 * 2.0 ** -21)
    if name == "warmup_cosine":
        assert ts(0) == 0.0


# ---- 3. replay ---------------------------------------------------------------

@pytest.mark.parametrize("n,extra", [(5, 0), (7, 0), (7, 1), (15, 0)])
def test_dihedral_perms_identical(n, extra):
    np.testing.assert_array_equal(treplay._dihedral_policy_perms(n, extra),
                                  jreplay._dihedral_policy_perms(n, extra))


@pytest.mark.parametrize("extra", [0, 1])
def test_augment_matches_jax_for_all_symmetries(extra):
    """All 8 symmetries, twice each, on distinct planes; with a trailing
    pass action (extra=1) that must stay fixed.  Exact."""
    rng = np.random.RandomState(8)
    B = 16
    obs = rng.normal(size=(B, 3, N, N)).astype(np.float32)
    pol = rng.uniform(size=(B, A + extra)).astype(np.float32)
    syms = np.tile(np.arange(8), 2).astype(np.int32)
    rng.shuffle(syms)
    jo, jp = jax.vmap(lambda o, p, s: jreplay.augment(o, p, s, N))(
        jnp.asarray(obs), jnp.asarray(pol), jnp.asarray(syms))
    to, tp = treplay.augment(torch.from_numpy(obs), torch.from_numpy(pol),
                             torch.from_numpy(syms), N)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    if extra:
        np.testing.assert_array_equal(tp[:, -1].numpy(), pol[:, -1])


def _fill(rounds, seed=9):
    """The same adds into a capacity-24 ring in both packages: masked rows
    and wrap-around.  Returns (jax buffer, port buffer)."""
    env, jenv = GomokuEnv(board_size=N), JaxGomoku(board_size=N)
    rng = np.random.RandomState(seed)
    jbuf = jreplay.create(jenv, 24, A)
    tbuf = treplay.create(env, 24, A, device="cpu")
    for r in range(rounds):
        n = 10
        st = _random_states(env, n, seed + r)
        pol = rng.uniform(size=(n, A)).astype(np.float32)
        val = rng.choice([-1.0, 0.0, 1.0], n).astype(np.float32)
        mask = rng.uniform(size=n) < 0.7
        jbuf = jreplay.add(jbuf, _to_jax_states(st), jnp.asarray(pol),
                           jnp.asarray(val), jnp.asarray(mask))
        treplay.add(tbuf, st, torch.from_numpy(pol), torch.from_numpy(val),
                    torch.from_numpy(mask))
    return jbuf, tbuf


def test_replay_add_matches_jax_with_masks_and_wraparound():
    jbuf, tbuf = _fill(rounds=5)
    assert int(jbuf.size) == 24 and tbuf.size == 24  # filled and wrapped
    assert tbuf.position == int(jbuf.position)
    np.testing.assert_array_equal(tbuf.policy.numpy(), np.asarray(jbuf.policy))
    np.testing.assert_array_equal(tbuf.value.numpy(), np.asarray(jbuf.value))
    jst = _to_jax_states(tbuf.states)
    for f in dataclasses.fields(JaxState):
        np.testing.assert_array_equal(np.asarray(getattr(jst, f.name)),
                                      np.asarray(getattr(jbuf.states, f.name)),
                                      err_msg=f.name)


def _jax_sample(jbuf, jenv, idx, syms):
    """The JAX sampler's body with the draws injected."""
    states = jax.tree_util.tree_map(lambda x: x[idx], jbuf.states)
    obs = jax.vmap(jenv.observation)(states)
    obs, policy = jax.vmap(lambda o, p, s: jreplay.augment(o, p, s, N))(
        obs, jbuf.policy[idx], syms)
    return jreplay.Batch(obs=obs, policy=policy, value=jbuf.value[idx])


def test_replay_sample_matches_jax_with_injected_draws():
    jbuf, tbuf = _fill(rounds=2)
    rng = np.random.RandomState(10)
    idx = rng.randint(0, tbuf.size, 32).astype(np.int32)
    syms = rng.randint(0, 8, 32).astype(np.int32)
    want = _jax_sample(jbuf, JaxGomoku(board_size=N), jnp.asarray(idx),
                       jnp.asarray(syms))
    got = treplay.sample(tbuf, GomokuEnv(board_size=N), None, 32,
                         idx=torch.from_numpy(idx), syms=torch.from_numpy(syms))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
    # drawn indices stay within the filled part
    drawn = treplay.sample(tbuf, GomokuEnv(board_size=N),
                           torch.Generator().manual_seed(0), 64)
    assert drawn.obs.shape == (64,) + OBS and drawn.policy.shape == (64, A)


# ---- 4. optimizer and train step ---------------------------------------------

@pytest.mark.parametrize("max_norm", [1e-3, 1e3])
def test_clip_by_global_norm_is_optax_formula(max_norm):
    """Engaged (norm 0.002 >= 0.001) and not engaged: equal to optax within
    1e-6 relative.  torch's clip_grad_norm_ scales by max / (norm + 1e-6),
    5e-4 relative off here."""
    rng = np.random.RandomState(12)
    leaves = [(rng.normal(size=s) * 4e-4).astype(np.float32)
              for s in ((3, 4), (7,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(x) for x in leaves], None)
    grads = [torch.from_numpy(x.copy()) for x in leaves]
    norm = tlearner.global_norm(grads)
    want_norm = optax.global_norm([jnp.asarray(x) for x in leaves])
    np.testing.assert_allclose(float(norm), float(want_norm), rtol=1e-6)
    tlearner.clip_by_global_norm(grads, max_norm)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)
    if max_norm < 1:
        ref = [torch.from_numpy(x.copy()).requires_grad_() for x in leaves]
        for r in ref:
            r.grad = r.detach().clone()
        torch.nn.utils.clip_grad_norm_(ref, max_norm)
        assert max(float((r.grad - g).abs().max() / g.abs().max())
                   for r, g in zip(ref, grads)) > 1e-4


def _jax_steps(jmodel, jvars, cfg, batches):
    state, tx = jcreate(jmodel, jax.random.key(0), OBS, cfg, params=jvars)
    step = jax.jit(lambda s, b: jtrain_step(s, b, jmodel, tx, cfg))
    metrics = []
    for b in batches:
        state, m = step(state, b)
        metrics.append(m)
    return state, metrics


def _port_steps(model, cfg, batches):
    state = tlearner.create_train_state(model, cfg)
    metrics = []
    for b in batches:
        state, m = tlearner.train_step(state, b, cfg)
        metrics.append(m)
    return state, metrics


# Adam divides each gradient by its own root mean square: where a gradient
# is near Adam's eps (1e-8), the last bits of its f32 summation order move
# the update by a few % of a step of lr 1e-3 (one element in 10^5 seen at
# 1.6e-5).  So every element within 1e-5 relative + ADAM_ATOL, and all but
# 1e-4 of them within 1e-5 relative + 1e-6.
ADAM_ATOL = 3e-5


def _assert_params_close(got, want):
    _assert_trees_close(got, want, 1e-5, ADAM_ATOL)
    g, w = _leaves(got), _leaves(want)
    off = sum(int((np.abs(g[k] - w[k]) > 1e-6 + 1e-5 * np.abs(w[k])).sum())
              for k in w)
    assert off <= 1e-4 * sum(v.size for v in w.values()), off


def _learner_pair(**kw):
    base = dict(learning_rate=1e-3, scheduler="constant", warmup_steps=0,
                total_steps=100)
    base.update(kw)
    return JaxLearner(**base), tlearner.LearnerConfig(**base)


@pytest.mark.parametrize("clip", [1e-3, 100.0], ids=["clipped", "unclipped"])
def test_train_step_f32_matches_jax(clip):
    """Two steps in f32 (ResNetConfig dtype float32 on both sides), with the
    clip engaged (max 1e-3) and not: loss and grad norm within 1e-5
    relative; params as ``_assert_params_close``, batch stats within 1e-5
    relative + 1e-6."""
    jmodel, jvars = _jax_net(live_heads=True)
    model = _port_net(jvars)
    jcfg, tcfg = _learner_pair(grad_clip_norm=clip)
    data = [_batch_np(32, seed=20 + i) for i in range(2)]
    jstate, jm = _jax_steps(jmodel, jvars, jcfg, [_jbatch(*d) for d in data])
    tstate, tm = _port_steps(model, tcfg, [_tbatch(*d) for d in data])
    for a, b in zip(tm, jm):
        for g, w in zip(a, b):
            np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    assert (float(jm[0].grad_norm) > clip) == (clip < 1)
    got = flax_from_state_dict(tstate.module.state_dict(), 1)
    _assert_params_close(got["params"], jstate.params["params"])
    _assert_trees_close(got["batch_stats"], jstate.params["batch_stats"], 1e-5, 1e-6)
    assert tstate.step == 2 and int(jstate.step) == 2


def test_train_step_bf16_matches_jax():
    """One step in the production dtype policy (bf16 compute, f32 master
    weights): loss and grad norm within 2 % relative, and 99.9 % of the
    params within 1e-5 (measured 99.98 %).  No bound on the largest
    difference: the first Adam update is about lr * sign(g), so an element
    whose bf16 gradient near 0 flips sign lands 2 lr = 2e-3 away, the most
    two runs can differ by; those flips are what the share allows for."""
    jmodel, jvars = _jax_net(jnp.bfloat16)
    model = _port_net(jvars, torch.bfloat16)
    jcfg, tcfg = _learner_pair()
    data = _batch_np(32, seed=30)
    jstate, (jm,) = _jax_steps(jmodel, jvars, jcfg, [_jbatch(*data)])
    tstate, (tm,) = _port_steps(model, tcfg, [_tbatch(*data)])
    for g, w in zip(tm, jm):
        np.testing.assert_allclose(float(g), float(w), rtol=2e-2)
    got = _leaves(flax_from_state_dict(tstate.module.state_dict(), 1)["params"])
    want = _leaves(jstate.params["params"])
    diffs = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert np.mean(diffs <= 1e-5) >= 0.999


def test_train_step_sgd_matches_jax():
    """The sgd branch (weight decay added to the gradient, momentum 0.9),
    two steps in f32 with the clip engaged: within 1e-5 relative + 1e-6
    absolute (no per-element division here)."""
    jmodel, jvars = _jax_net(live_heads=True)
    model = _port_net(jvars)
    jcfg, tcfg = _learner_pair(optimizer="sgd", learning_rate=0.05,
                               weight_decay=1e-2, grad_clip_norm=0.5)
    data = [_batch_np(32, seed=40 + i) for i in range(2)]
    jstate, jm = _jax_steps(jmodel, jvars, jcfg, [_jbatch(*d) for d in data])
    tstate, tm = _port_steps(model, tcfg, [_tbatch(*d) for d in data])
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(float(a.loss), float(b.loss), rtol=1e-5)
    got = flax_from_state_dict(tstate.module.state_dict(), 1)
    _assert_trees_close(got["params"], jstate.params["params"], 1e-5, 1e-6)


def test_first_warmup_cosine_update_has_lr_zero():
    """optax counts from 0, so a fresh warmup_cosine run's first update has
    lr 0: the weights stay bit-equal (the BN statistics still move), and
    the second update changes them (the zero policy kernel first: no
    gradient reaches the trunk through it yet)."""
    model = AZResNet(A, ResNetConfig(**SMALL), obs_shape=OBS)
    before = {k: v.clone() for k, v in model.named_parameters()}
    cfg = tlearner.LearnerConfig(warmup_steps=10, total_steps=100)
    state = tlearner.create_train_state(model, cfg)
    batch = _tbatch(*_batch_np(16, seed=50))
    state, _ = tlearner.train_step(state, batch, cfg)
    assert all(torch.equal(v, before[k]) for k, v in model.named_parameters())
    assert not torch.equal(model.blocks[0].bn1.running_mean,
                           torch.zeros_like(model.blocks[0].bn1.running_mean))
    state, _ = tlearner.train_step(state, batch, cfg)
    assert not torch.equal(model.policy_fc.weight, before["policy_fc.weight"])


def test_loss_decreases_over_30_steps():
    """The port alone, as tests/test_training.py does for JAX: 1 block, 16
    channels, 7x7, lr 3e-3 constant, one fixed batch of 16."""
    a = 49
    model = AZResNet(a, ResNetConfig(**SMALL), obs_shape=(11, 7, 7),
                     generator=torch.Generator().manual_seed(0))
    cfg = tlearner.LearnerConfig(learning_rate=3e-3, scheduler="constant",
                                 total_steps=50, warmup_steps=0)
    state = tlearner.create_train_state(model, cfg)
    g = torch.Generator().manual_seed(1)
    batch = treplay.Batch(torch.randn(16, 11, 7, 7, generator=g),
                          torch.softmax(torch.randn(16, a, generator=g), -1),
                          torch.tanh(torch.randn(16, generator=g)))
    state, m0 = tlearner.train_step(state, batch, cfg)
    for _ in range(30):
        state, m = tlearner.train_step(state, batch, cfg)
    assert float(m.loss) < float(m0.loss) and state.step == 31


# ---- 5. the slice as a whole -------------------------------------------------

def test_replay_sample_three_steps_matches_jax():
    """replay.add -> sample (injected draws) -> three train steps in f32
    gives the JAX composition's params (``_assert_params_close``) and its
    batch stats within 1e-5 relative + 1e-6."""
    jbuf, tbuf = _fill(rounds=3, seed=60)
    jenv, env = JaxGomoku(board_size=N), GomokuEnv(board_size=N)
    jmodel, jvars = _jax_net(seed=3, live_heads=True)
    model = _port_net(jvars)
    jcfg, tcfg = _learner_pair(grad_clip_norm=5.0)
    rng = np.random.RandomState(61)
    draws = [(rng.randint(0, tbuf.size, 24).astype(np.int32),
              rng.randint(0, 8, 24).astype(np.int32)) for _ in range(3)]
    jbatches = [_jax_sample(jbuf, jenv, jnp.asarray(i), jnp.asarray(s))
                for i, s in draws]
    tbatches = [treplay.sample(tbuf, env, None, 24, idx=torch.from_numpy(i),
                               syms=torch.from_numpy(s)) for i, s in draws]
    jstate, jm = _jax_steps(jmodel, jvars, jcfg, jbatches)
    tstate, tm = _port_steps(model, tcfg, tbatches)
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(float(a.loss), float(b.loss), rtol=1e-5)
    got = flax_from_state_dict(tstate.module.state_dict(), 1)
    _assert_params_close(got["params"], jstate.params["params"])
    _assert_trees_close(got["batch_stats"], jstate.params["batch_stats"], 1e-5, 1e-6)


@pytest.mark.cuda
def test_train_steps_on_card_match_cpu():
    """Card only: three f32 steps (TF32 off) of the small net on the card
    against the CPU within 1e-5 relative in the losses and as
    ``_assert_params_close`` in the weights.  chip_smoke.py [train] runs the
    same check at the flagship width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, jvars = _jax_net(live_heads=True)
    _, tcfg = _learner_pair()
    data = [_tbatch(*_batch_np(32, seed=70 + i)) for i in range(3)]
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        cpu, mc = _port_steps(_port_net(jvars), tcfg, data)
        card, mg = _port_steps(_port_net(jvars).cuda(), tcfg,
                               [treplay.Batch(*(x.cuda() for x in b)) for b in data])
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    for a, b in zip(mg, mc):
        np.testing.assert_allclose(float(a.loss), float(b.loss), rtol=1e-5)
    _assert_params_close(flax_from_state_dict(card.module.state_dict(), 1)["params"],
                         flax_from_state_dict(cpu.module.state_dict(), 1)["params"])
