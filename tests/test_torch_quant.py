"""The port's int8 executor (``alphazero_tpu_torch/models/quant.py``)
against ``alphazero_tpu/models/quant.py``, function by function, on the
same numpy-seeded inputs and on quantised parameters carried across
unchanged.  The port runs on the CPU here, so its s8 products take their
plain versions; JAX runs its XLA:CPU integer conv."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.games.gomoku import GomokuEnv as JaxGomoku
from alphazero_tpu.models import quant as jq
from alphazero_tpu.models.resnet import AZResNet as JaxResNet
from alphazero_tpu.models.resnet import ResNetConfig as JaxConfig
from alphazero_tpu.models.resnet import make_inference_eval_fn as jax_eval_fn
from alphazero_tpu_torch.games.gomoku import GomokuEnv
from alphazero_tpu_torch.models import quant as tq
from alphazero_tpu_torch.models.convert import (
    folded_from_jax, quant_params_from_jax, state_dict_from_flax,
)
from alphazero_tpu_torch.models.resnet import (
    AZResNet, ResNetConfig, make_inference_eval_fn,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N = 7
OBS = (11, N, N)
SMALL = dict(num_blocks=2, channels=16, se_ratio=4, policy_channels=8,
             value_channels=8, value_hidden=32)
BF16_ULP = 2.0 ** -8  # relative spacing of bf16 values


def _jax_model():
    """A small JAX model with every parameter and BN statistic randomised
    from a numpy seed."""
    model = JaxResNet(num_actions=N * N, cfg=JaxConfig(**SMALL))
    variables = model.init(jax.random.key(0), jnp.zeros((1,) + OBS))
    rng = np.random.RandomState(7)

    def rand(path, x):
        if "var" in jax.tree_util.keystr(path):
            return jnp.asarray(rng.uniform(0.5, 2.0, x.shape), jnp.float32)
        return jnp.asarray(rng.normal(0, 0.3, x.shape), jnp.float32)

    return model, jax.tree_util.tree_map_with_path(rand, variables)


def _port_model(variables):
    model = AZResNet(N * N, ResNetConfig(**SMALL), obs_shape=OBS)
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables), SMALL["num_blocks"]))
    return model.eval()


def _obs(B=16, seed=0):
    """Board-like planes: binary stones plus two coordinate planes."""
    rng = np.random.RandomState(seed)
    obs = rng.randint(0, 2, size=(B,) + OBS).astype(np.float32)
    obs[:, -2:] = rng.uniform(0, 1, size=(B, 2, N, N))
    return obs


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def nets():
    jmodel, variables = _jax_model()
    jfp = jq.extract_folded(jmodel, variables)
    calib = _obs(32, seed=11)
    jqp = jq.quantize(jfp, jq.calibrate(jfp, [jnp.asarray(calib)]))
    return dict(jmodel=jmodel, variables=variables, model=_port_model(variables),
                jfp=jfp, fp=folded_from_jax(_numpy_tree(jfp), device="cpu"),
                jqp=jqp, qp=quant_params_from_jax(_numpy_tree(jqp), device="cpu"),
                calib=calib)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def test_extract_folded_matches_jax(nets):
    got = tq.extract_folded(nets["model"])
    want = _numpy_tree(nets["jfp"])
    flat_got = dict(_leaves(jax.tree_util.tree_map(
        lambda t: t.numpy() if isinstance(t, torch.Tensor) else t, got,
        is_leaf=lambda t: isinstance(t, torch.Tensor))))
    assert got["num_blocks"] == want["num_blocks"] == 2
    for path, leaf in _leaves(want):
        g = flat_got[path]
        assert np.shape(g) == np.shape(leaf), path
        # BN folding multiplies and subtracts f32 values in both packages;
        # only the rsqrt/divide formulation differs.
        np.testing.assert_allclose(g, leaf, atol=1e-6, rtol=1e-6)


def test_carried_params_keep_layout_and_dtype(nets):
    qp = nets["qp"]
    assert qp["stem"]["wq"].dtype == torch.int8
    assert tuple(qp["stem"]["wq"].shape) == (3, 3, 11, 16)  # HWIO
    assert qp["blocks"][0]["m1"].dtype == torch.float32
    assert qp["in_scale"].dim() == 0
    assert len(qp["blocks"]) == 2 and "policy_conv_q" in qp


def test_quantize_matches_jax_on_identical_inputs(nets):
    rng = np.random.RandomState(3)
    scales = rng.uniform(0.5, 6.0, size=6).astype(np.float32)
    want = _numpy_tree(jq.quantize(nets["jfp"], jnp.asarray(scales)))
    got = tq.quantize(nets["fp"], torch.from_numpy(scales))
    flat_got = dict(_leaves(jax.tree_util.tree_map(
        lambda t: t.numpy(), got, is_leaf=lambda t: isinstance(t, torch.Tensor))))
    n_int8 = 0
    for path, leaf in _leaves(want):
        g = flat_got[path]
        assert g.dtype == leaf.dtype and g.shape == leaf.shape, path
        if leaf.dtype == np.int8:
            np.testing.assert_array_equal(g, leaf)  # weights bit-equal
            n_int8 += 1
        else:
            # multipliers to 1 ulp: XLA may divide by multiplying with a
            # reciprocal
            np.testing.assert_allclose(g, leaf, rtol=1.2e-7, atol=0)
    assert n_int8 == 1 + 2 * 2 + 2


@pytest.mark.parametrize("pct", [50.0, 99.0, 99.99])
def test_abs_percentile_matches_jnp(pct):
    rng = np.random.RandomState(int(pct))
    a = np.abs(rng.normal(size=(8, 7, 7, 16))).astype(np.float32)
    want = float(jnp.percentile(jnp.asarray(a), pct))
    got = float(tq._abs_percentile(torch.from_numpy(a), pct))
    # same f32 index arithmetic and interpolation weights; one f32 rounding
    np.testing.assert_allclose(got, want, rtol=2e-7)


@pytest.mark.parametrize("pct", [0.0, 99.0])
def test_calibrate_matches_jax(nets, pct):
    batches = [_obs(16, seed=s) for s in (1, 2)]
    want = np.asarray(jq.calibrate(nets["jfp"], [jnp.asarray(b) for b in batches],
                                   percentile=pct))
    got = tq.calibrate(nets["fp"], [torch.from_numpy(b) for b in batches],
                       percentile=pct).numpy()
    assert got.shape == want.shape == (2 + 2 * 2,)
    # The statistics are taken from bf16 activations, which the two
    # frameworks round at different places: a few bf16 ulps.
    np.testing.assert_allclose(got, want, rtol=4 * BF16_ULP)
    single = tq.calibrate(nets["fp"], [torch.from_numpy(batches[0])],
                          percentile=pct).numpy()
    assert (got >= single).all()  # max across batches
    zeros = tq.calibrate(nets["fp"], [torch.zeros((2,) + OBS)]).numpy()
    assert zeros[0] == np.float32(1e-6)  # floor



@pytest.mark.parametrize("C,k", [(11, 3), (4, 3), (64, 3), (6, 1)])
def test_im2col_rows_lie_16_bytes_apart(C, k):
    """The patch matrix equals the unfolded input, and its row pitch is a
    multiple of 16 bytes whatever ``k*k*C`` is (the stem's 99 included), so
    that the product kernel reads it in place."""
    rng = np.random.default_rng(C)
    x = rng.integers(-127, 128, (3, 7, 7, C)).astype(np.int8)
    got = tq._im2col(torch.from_numpy(x), k, k)
    assert got.shape == (3 * 7 * 7, k * k * C) and got.dtype == torch.int8
    assert got.stride(1) == 1 and got.stride(0) % 16 == 0
    xp = np.pad(x, ((0, 0), (k // 2, k // 2), (k // 2, k // 2), (0, 0)))
    want = np.stack([xp[:, ky:ky + 7, kx:kx + 7] for ky in range(k)
                     for kx in range(k)], axis=3).reshape(3 * 7 * 7, -1)
    np.testing.assert_array_equal(got.numpy(), want)

@pytest.mark.parametrize("cin,cout,k", [(16, 16, 3), (11, 16, 3), (16, 8, 1)])
def test_conv_i8_exact(cin, cout, k):
    rng = np.random.default_rng(cin + k)
    x = rng.integers(-127, 128, (4, 7, 9, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    want = np.asarray(jq._conv_i8(jnp.asarray(x), jnp.asarray(w)))
    got = tq._conv_i8(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_tap_sums_exact():
    rng = np.random.default_rng(3)
    x = rng.integers(-127, 128, (4, 7, 9, 16)).astype(np.int8)
    want = np.asarray(jq._tap_sums(jnp.asarray(x)))
    got = tq._tap_sums(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == (4, 9, 16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_se_gate_precomputed_matches_jax(nets):
    rng = np.random.default_rng(5)
    hq = rng.integers(0, 128, (8, N, N, 16)).astype(np.int8)
    want = np.asarray(jq._se_gate_precomputed(
        jnp.asarray(hq), nets["jqp"]["blocks"][0]).astype(jnp.float32))
    got = tq._se_gate_precomputed(torch.from_numpy(hq), nets["qp"]["blocks"][0])
    assert got.dtype == torch.bfloat16 and got.shape == (8, 1, 1, 16)
    # a bf16 sigmoid output in (0, 1): two bf16 ulps of 1
    np.testing.assert_allclose(got.float().numpy(), want, atol=2 * BF16_ULP)


def test_se_gate_differs_only_in_the_sigmoid_rounding(nets):
    """Where the port's s8 activations leave JAX's: the gate's inputs agree
    bit for bit, torch's bf16 sigmoid is the correctly rounded one, and
    XLA:CPU's is within one bf16 ulp of it."""
    rng = np.random.default_rng(5)
    hq = rng.integers(0, 128, (8, N, N, 16)).astype(np.int8)
    jblk, tblk = nets["jqp"]["blocks"][0], nets["qp"]["blocks"][0]

    def pre_sigmoid(mod, x, blk, bf16, relu, f32):
        taps = f32(mod._tap_sums(x)).reshape(8, -1)
        mean = (taps @ f32(blk["wq2"]).reshape(9 * 16, 16) * blk["m2"]) / (N * N) + blk["b2"]
        s = relu(bf16(mean) @ bf16(blk["se1"]["kernel"]) + bf16(blk["se1"]["bias"]))
        return s @ bf16(blk["se2"]["kernel"]) + bf16(blk["se2"]["bias"])

    jz = pre_sigmoid(jq, jnp.asarray(hq), jblk, lambda t: t.astype(jnp.bfloat16),
                     jax.nn.relu, lambda t: t.astype(jnp.float32))
    tz = pre_sigmoid(tq, torch.from_numpy(hq), tblk, lambda t: t.to(torch.bfloat16),
                     torch.relu, lambda t: t.float())
    np.testing.assert_array_equal(tz.float().numpy(), np.asarray(jz, np.float32))
    exact = 1.0 / (1.0 + np.exp(-tz.double().numpy()))
    rounded = torch.from_numpy(exact).to(torch.bfloat16).float().numpy()
    tg = tq._se_gate_precomputed(torch.from_numpy(hq), tblk).float().numpy()
    jg = np.asarray(jq._se_gate_precomputed(jnp.asarray(hq), jblk), np.float32)
    np.testing.assert_array_equal(tg.reshape(8, 16), rounded)
    np.testing.assert_allclose(jg.reshape(8, 16), rounded, atol=BF16_ULP, rtol=0)


def test_quant_act_folds_relu_into_the_clip():
    rng = np.random.RandomState(2)
    a = torch.from_numpy(rng.normal(0, 3, size=(4, 5, 5, 8)).astype(np.float32))
    a.view(-1)[:3] = torch.tensor([-0.0, 0.0, -1e-9])
    scale = torch.tensor(2.5)
    for x in (a, a.to(torch.bfloat16)):
        assert torch.equal(tq._quant_act(torch.relu(x), scale),
                           tq._quant_act(x, scale, lo=0.0))
    want = np.asarray(jq._quant_act(jnp.asarray(a.numpy()), jnp.float32(2.5)))
    np.testing.assert_array_equal(tq._quant_act(a, scale).numpy(), want)


def test_executor_params_change_no_output(nets):
    obs = torch.from_numpy(_obs(8, seed=12))
    prepared = tq._executor_params(nets["qp"])
    assert prepared["blocks"][0]["se1"]["kernel"].dtype == torch.bfloat16
    assert nets["qp"]["blocks"][0]["se1"]["kernel"].dtype == torch.float32
    for residual, heads in (("int8", "bf16"), ("bf16", "int8")):
        with torch.no_grad():
            a = tq.forward_int8(nets["qp"], obs, residual, heads)
            b = tq.forward_int8(prepared, obs, residual, heads)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_forward_bf16_matches_jax(nets):
    obs = _obs(16, seed=4)
    jl, jv = jq.forward_bf16(nets["jfp"], jnp.asarray(obs))
    tl, tv = tq.forward_bf16(nets["fp"], torch.from_numpy(obs))
    assert tl.dtype == torch.float32 and tv.shape == (16,)
    # bf16 activations rounded at different places in the two frameworks: a
    # few bf16 ulps of the logit scale, as for the folded net.
    scale = float(np.abs(np.asarray(jl)).max())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=0.05 * scale)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=0.05)


def _trace(module, fn):
    """Run ``fn()`` recording every activation ``module._quant_act``
    quantises."""
    acts, orig = [], module._quant_act

    def record(*args, **kw):
        acts.append(orig(*args, **kw))
        return acts[-1]

    module._quant_act = record
    try:
        out = fn()
    finally:
        module._quant_act = orig
    return out, acts


@pytest.mark.parametrize("residual", ["bf16", "int8"])
@pytest.mark.parametrize("heads", ["bf16", "int8"])
def test_forward_int8_matches_jax(nets, residual, heads):
    obs = _obs(16, seed=6)
    (jl, jv), jacts = _trace(jq, lambda: jq.forward_int8(
        nets["jqp"], jnp.asarray(obs), residual, heads))
    with torch.no_grad():
        (tl, tv), tacts = _trace(tq, lambda: tq.forward_int8(
            nets["qp"], torch.from_numpy(obs), residual, heads))
    assert len(jacts) == len(tacts) == 2 + 2 * 2
    worst, differing, total = 0, 0, 0
    for ja, ta in zip(jacts, tacts):
        d = np.abs(np.asarray(ja, np.int32) - ta.numpy().astype(np.int32))
        worst, differing, total = max(worst, int(d.max())), differing + int((d > 0).sum()), total + d.size
    # Everything up to the SE gate's sigmoid is equal bit for bit (see
    # test_se_gate_differs_only_in_the_sigmoid_rounding); XLA:CPU's bf16
    # sigmoid is one bf16 ulp (2**-8 relative) off the correctly rounded
    # value for about half its inputs.  ``h2 * g`` then moves by one bf16
    # ulp of h2, which is one s8 step while |h2| stays within the block's
    # output scale (the bf16 master stream keeps it so here) and two steps
    # where the int8 residual stream meets an |h2| above it.
    assert worst <= (2 if residual == "int8" else 1), f"s8 differ by {worst}"
    assert differing / total < 0.02
    scale = float(np.abs(np.asarray(jl)).max())
    # heads: bf16 products over 8 * 49 features; one-step trunk differences
    # and bf16 rounding points: 5 % of the logit scale, as for the bf16 net.
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=0.05 * scale)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=0.05)


@pytest.mark.parametrize("residual,heads", [("bf16", "bf16"), ("int8", "bf16"),
                                            ("int8", "int8")])
def test_chunked_equals_unchunked(nets, residual, heads):
    obs = torch.from_numpy(_obs(16, seed=8)).to(torch.bfloat16)
    whole = tq._chunked_int8_eval(nets["qp"], obs, None, "unroll", residual, heads)
    chunks = tq._chunked_int8_eval(nets["qp"], obs, 4, "unroll", residual, heads)
    odd = tq._chunked_int8_eval(nets["qp"], obs[:14], 4, "unroll", residual, heads)
    assert torch.equal(whole[0], chunks[0]) and torch.equal(whole[1], chunks[1])
    # 14 is no multiple of 4: evaluated whole, as the JAX package does
    assert torch.equal(odd[0], whole[0][:14])
    # JAX's "map" loop form runs the same chunks in eager PyTorch
    mapped = tq._chunked_int8_eval(nets["qp"], obs, 4, "map", residual, heads)
    assert torch.equal(mapped[0], chunks[0]) and torch.equal(mapped[1], chunks[1])
    with pytest.raises(ValueError):
        tq._chunked_int8_eval(nets["qp"], obs, 4, "scan")


@pytest.mark.parametrize("residual", ["bf16", "int8"])
def test_chunked_map_matches_jax(nets, residual):
    """``chunk_mode="map"`` against the JAX package's ``lax.map`` form on
    the same quantised parameters: 4 chunks of 4."""
    obs = _obs(16, seed=12)
    jl, jv = jq._chunked_int8_eval(nets["jqp"], jnp.asarray(obs), 4, "map",
                                   residual=residual)
    with torch.no_grad():
        tl, tv = tq._chunked_int8_eval(nets["qp"], torch.from_numpy(obs), 4,
                                       "map", residual=residual)
    assert tl.shape == jl.shape and tv.shape == jv.shape
    # The bounds of test_forward_int8_matches_jax: XLA:CPU's bf16 sigmoid
    # moves s8 activations by a step or two, the heads by a few bf16 ulps.
    scale = float(np.abs(np.asarray(jl)).max())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=0.05 * scale)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=0.05)


def test_eval_fns_agree_and_default_calibration(nets):
    model, calib = nets["model"], torch.from_numpy(nets["calib"])
    obs = torch.from_numpy(_obs(8, seed=9))
    closure = tq.make_int8_eval_fn(model, calib_obs=calib, chunk=4,
                                   residual="int8", calib_percentile=99.0)
    fn, qp = tq.make_int8_eval_params(model, calib_obs=calib, chunk=4,
                                      residual="int8", calib_percentile=99.0)
    l1, v1 = closure(obs)
    l2, v2 = fn(qp, obs)
    assert torch.equal(l1, l2) and torch.equal(v1, v2)
    logits, value = tq.make_int8_eval_fn(model)(torch.zeros((4,) + OBS))
    assert logits.shape == (4, N * N) and value.shape == (4,)
    assert bool(torch.isfinite(logits).all())
    assert tq._infer_obs_shape(model) == OBS


def test_int8_eval_fn_matches_jax_from_same_calibration(nets):
    """Both packages calibrate (99-percentile) and quantise on their own
    from the same observations, then evaluate the same positions."""
    calib, obs = nets["calib"], _obs(32, seed=10)
    jev = jq.make_int8_eval_fn(nets["jmodel"], nets["variables"],
                               calib_obs=jnp.asarray(calib), chunk=8,
                               residual="int8", calib_percentile=99.0)
    tev = tq.make_int8_eval_fn(nets["model"], calib_obs=torch.from_numpy(calib),
                               chunk=8, residual="int8", calib_percentile=99.0)
    jl, jv = jev(jnp.asarray(obs))
    tl, tv = tev(torch.from_numpy(obs))
    # Scales differ by bf16 ulps between the packages here, so rounding
    # flips are more frequent than on identical qp; tighter than the
    # int8-vs-bf16 bars of the JAX package's own test (0.9 / 0.99 / 0.02).
    jl, jv = np.asarray(jl), np.asarray(jv)
    agree = (tl.numpy().argmax(-1) == jl.argmax(-1)).mean()
    corr = np.corrcoef(tl.numpy().ravel(), jl.ravel())[0, 1]
    assert agree >= 0.95 and corr >= 0.999
    assert np.abs(tv.numpy() - jv).mean() < 0.01


def test_rollout_calibration_shapes_and_legality(nets):
    n, plies, every = 6, 6, 2
    tenv, jenv = GomokuEnv(board_size=N), JaxGomoku(board_size=N)
    calib = tq.make_rollout_calib_fn(
        tenv, make_inference_eval_fn(nets["model"]), n=n, plies=plies,
        every=every, device="cpu")(None, torch.Generator().manual_seed(0))
    jcalib = jq.make_rollout_calib_fn(
        jenv, jax_eval_fn(nets["jmodel"], nets["variables"]), n=n, plies=plies,
        every=every)(None, jax.random.key(0))
    assert tuple(calib.shape) == tuple(jcalib.shape) == ((1 + plies // every) * n,) + OBS
    snaps = calib.float().reshape(1 + plies // every, n, *OBS)
    for i, snap in enumerate(snaps):
        me, opp = snap[:, 0], snap[:, 1]
        assert float((me * opp).sum()) == 0  # no cell holds two stones
        # every sampled move was legal: one new stone per ply (no game can
        # end within 6 plies)
        stones = (me + opp).sum((1, 2))
        assert stones.tolist() == [float(i * every)] * n
    # same snapshot schedule as JAX: first observation, then every `every`
    jsnaps = np.asarray(jcalib, np.float32).reshape(snaps.shape)
    np.testing.assert_array_equal(jsnaps[:, :, :2].sum((2, 3, 4)),
                                  snaps[:, :, :2].sum((2, 3, 4)).numpy())
    again = tq.make_rollout_calib_fn(
        tenv, make_inference_eval_fn(nets["model"]), n=n, plies=plies,
        every=every, device="cpu")(None, torch.Generator().manual_seed(0))
    assert torch.equal(calib, again)  # the generator decides the rollout


def test_production_eval_fn_uses_pinned_config(nets, monkeypatch):
    from alphazero_tpu_torch import production

    monkeypatch.setattr(production, "CALIB_GAMES", 4)
    monkeypatch.setattr(production, "INT8_CHUNK", 4)
    seen = {}
    orig = tq.make_int8_eval_params

    def spy(model, **kw):
        seen.update(kw)
        return orig(model, **kw)

    monkeypatch.setattr(tq, "make_int8_eval_params", spy)
    env = GomokuEnv(board_size=N)
    ev, calib = tq.make_production_eval_fn(
        env, nets["model"], device="cpu", generator=torch.Generator().manual_seed(1))
    assert calib.shape[0] == 4 * (1 + production.CALIB_PLIES // production.CALIB_EVERY)
    assert seen["residual"] == "int8" and seen["heads"] == "bf16"
    assert seen["calib_percentile"] == 99.99 and seen["chunk"] == 4
    logits, value = ev(calib[:8])
    assert logits.shape == (8, N * N) and bool(torch.isfinite(value).all())
