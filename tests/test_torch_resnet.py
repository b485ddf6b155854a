"""The port's SE-ResNet against the JAX AZResNet: weight carry-over, BN
folding, the folded forward in f32 and bf16, and the msgpack reader."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from alphazero_tpu.models.resnet import AZResNet as JaxResNet
from alphazero_tpu.models.resnet import ResNetConfig as JaxConfig
from alphazero_tpu.models.resnet import make_inference_eval_fn as jax_eval_fn
from alphazero_tpu_torch.models.convert import state_dict_from_flax
from alphazero_tpu_torch.models.io import load_model, read_msgpack
from alphazero_tpu_torch.models.resnet import (
    AZResNet, ResNetConfig, fold_batch_norm, make_inference_eval_fn,
)

N = 7
OBS = (11, N, N)
SMALL = dict(num_blocks=2, channels=16, se_ratio=4, policy_channels=8,
             value_channels=8, value_hidden=32)


def _jax_variables(dtype):
    """A small JAX model with every parameter and BN statistic randomised
    (flax zero-inits the final dense layers, which would hide their
    mapping)."""
    model = JaxResNet(num_actions=N * N, cfg=JaxConfig(dtype=dtype, **SMALL))
    variables = model.init(jax.random.key(0), jnp.zeros((1,) + OBS))
    rng = np.random.RandomState(7)

    def rand(path, x):
        name = jax.tree_util.keystr(path)
        if "var" in name:
            return jnp.asarray(rng.uniform(0.5, 2.0, x.shape), jnp.float32)
        return jnp.asarray(rng.normal(0, 0.3, x.shape), jnp.float32)

    return model, jax.tree_util.tree_map_with_path(rand, variables)


def _obs(B=16, seed=0):
    rng = np.random.RandomState(seed)
    obs = rng.randint(0, 2, size=(B,) + OBS).astype(np.float32)
    return obs


def _port(variables, dtype):
    model = AZResNet(N * N, ResNetConfig(dtype=dtype, **SMALL), obs_shape=OBS)
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables), SMALL["num_blocks"]))
    return model.eval()


def test_weight_carry_over_unfolded_forward():
    jmodel, variables = _jax_variables(jnp.float32)
    model = _port(variables, torch.float32)
    obs = _obs()
    jl, jv = jmodel.apply(variables, jnp.asarray(obs))
    with torch.no_grad():
        tl, tv = model(torch.from_numpy(obs))
    # f32 on both sides: only the summation order of convs/dots differs.
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)


def test_folded_forward_f32_matches_jax():
    jmodel, variables = _jax_variables(jnp.float32)
    model = _port(variables, torch.float32)
    obs = _obs(seed=1)
    jl, jv = jax.jit(jax_eval_fn(jmodel, variables))(jnp.asarray(obs))
    tl, tv = make_inference_eval_fn(model)(torch.from_numpy(obs))
    # f32 on both sides: only the summation order of convs/dots differs.
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)
    folded = fold_batch_norm(model)
    assert folded.cfg.norm == "none"
    assert all(isinstance(b.bn1, torch.nn.Identity) for b in folded.blocks)


def test_folded_forward_bf16_matches_jax():
    jmodel, variables = _jax_variables(jnp.bfloat16)
    model = _port(variables, torch.bfloat16)
    obs = _obs(seed=2)
    jl, jv = jax.jit(jax_eval_fn(jmodel, variables))(jnp.asarray(obs))
    tl, tv = make_inference_eval_fn(model)(torch.from_numpy(obs))
    assert tl.dtype == torch.float32 and tv.dtype == torch.float32
    # bf16 activations (8-bit mantissa) rounded at different places in the
    # two frameworks: a few bf16 ulps of the logit scale (~3).
    scale = float(np.abs(np.asarray(jl)).max())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=0.05 * scale)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=0.05)


def test_msgpack_reader_matches_flax_on_flagship():
    path = "models_zoo/flagship_gomoku15"
    with open(path, "rb") as f:
        data = f.read()
    want = serialization.msgpack_restore(data)
    got = read_msgpack(data)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat_w) == len(flat_g)
    for path_, leaf in flat_w:
        g = flat_g[path_]
        assert g.dtype == leaf.dtype and g.shape == leaf.shape
        np.testing.assert_array_equal(g, leaf)


def test_read_msgpack_scalars_and_rejects_truncation():
    import msgpack

    blob = msgpack.packb({"a": [1, -3, 2.5, None, True], "b": "x" * 40,
                          "c": 70000, "d": -200})
    assert read_msgpack(blob) == {"a": [1, -3, 2.5, None, True],
                                  "b": "x" * 40, "c": 70000, "d": -200}
    with pytest.raises(ValueError):
        read_msgpack(blob[:-3])


def test_load_model_flagship_matches_jax():
    from alphazero_tpu.models.io import load_model as jax_load

    obs_shape = (11, 15, 15)
    jmodel, jvars = jax_load("models_zoo/flagship_gomoku15", obs_shape)
    model, meta = load_model("models_zoo/flagship_gomoku15", obs_shape,
                             device="cpu")
    assert meta["config"]["num_blocks"] == 6 and meta["num_actions"] == 225
    rng = np.random.RandomState(4)
    obs = rng.randint(0, 2, size=(4,) + obs_shape).astype(np.float32)
    jl, jv = jax.jit(jax_eval_fn(jmodel, jvars))(jnp.asarray(obs))
    tl, tv = make_inference_eval_fn(model)(torch.from_numpy(obs))
    # Both run the trained net in bf16: stated tolerance as in the bf16 test.
    scale = float(np.abs(np.asarray(jl)).max())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=0.05 * scale)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=0.05)


def test_raw_eval_matches_jax_model_apply():
    """``make_raw_eval_fn`` against JAX's ``model.apply(variables, obs)``
    (bf16 compute from float32 master weights, BatchNorm's statistics and
    affine in float32) on the same carried weights and running statistics,
    256 positions.

    Against ``model.apply`` run op by op, flax's dtype policy as written:
    the stem's conv -> BatchNorm output, in bf16, is equal on at least
    99.9 % of its elements (measured 99.995 %; BatchNorm's float32 formula
    rounds apart on a few), where the BN-folded bf16 stem is equal on under
    90 % (measured 54 %); and the whole net's mean logit error is below the
    folded net's (measured 0.0073 against 0.0105).  The whole net is not
    bit-equal: the SE gate's bf16 ``sigmoid`` rounds differently in XLA and
    torch (``ROADMAP.md`` §3).  Against ``model.apply`` under ``jax.jit``,
    as JAX's tools run it: XLA may keep a conv's output in float32 into
    BatchNorm (excess precision), so every form agrees only to bf16 noise:
    logits within 0.1 (measured 0.057 at a mean |logit| of 1.6), value within
    0.02 (measured 0.0079), policy argmax equal on at least 98 % (measured
    98.8 %)."""
    from alphazero_tpu_torch.models.resnet import fold_batch_norm, make_raw_eval_fn

    jmodel, variables = _jax_variables(jnp.bfloat16)
    model = _port(variables, torch.bfloat16)
    assert model.stem.weight.dtype == torch.float32  # the master weights
    obs = _obs(B=256, seed=3)

    def apply(v, o):
        return jmodel.apply(v, o, capture_intermediates=True, mutable=["intermediates"])

    (el, _), state = apply(variables, jnp.asarray(obs))
    jstem = np.asarray(state["intermediates"]["BatchNorm_0"]["__call__"][0]
                       .astype(jnp.bfloat16).astype(jnp.float32))
    (jl, jv), _ = jax.jit(apply)(variables, jnp.asarray(obs))
    el, jl, jv = np.asarray(el), np.asarray(jl), np.asarray(jv)
    stems = {}

    def keep(name):
        def hook(module, inputs, out):
            stems[name] = out.float().permute(0, 2, 3, 1).numpy()
        return hook

    hook = model.stem_bn.register_forward_hook(keep("raw"))
    tl, tv = make_raw_eval_fn(model)(torch.from_numpy(obs))
    hook.remove()
    folded = fold_batch_norm(model).to(torch.bfloat16)
    folded.stem_bn.register_forward_hook(keep("folded"))
    with torch.no_grad():
        fl, _ = folded(torch.from_numpy(obs))
    assert np.mean(stems["raw"] == jstem) >= 0.999
    assert np.mean(stems["folded"] == jstem) < 0.9
    tl, tv, fl = tl.numpy(), tv.numpy(), fl.numpy()
    assert np.abs(tl - el).mean() < np.abs(fl - el).mean()
    np.testing.assert_allclose(tl, jl, atol=0.1)
    np.testing.assert_allclose(tv, jv, atol=0.02)
    assert np.mean(tl.argmax(1) == jl.argmax(1)) >= 0.98
