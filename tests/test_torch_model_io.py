"""The port's model bundles (``alphazero_tpu_torch/models/io.py``) against
``alphazero_tpu/models/io.py``: a bundle written by either package loads in
the other bit for bit, for both model kinds; the two writers give the same
bytes; and the ``models_zoo/`` bundles re-write to their own bytes."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphazero_tpu.models import io as jio
from alphazero_tpu.models.randwire import RandWireConfig as JaxRandWire
from alphazero_tpu.models.resnet import ResNetConfig as JaxResNet
from alphazero_tpu_torch.core import registry
from alphazero_tpu_torch.models import io as tio
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBS = (11, 7, 7)
A = 49
KINDS = {
    "resnet_batch": ("resnet", dict(num_blocks=1, channels=16)),
    "resnet_group": ("resnet", dict(num_blocks=2, channels=16, norm="group",
                                    group_size=8)),
    "randwire": ("randwire", dict(num_blocks=2, nodes_per_block=4, channels=16,
                                  seed=3)),
}


def _jax_bundle(kind, config, path, seed=0):
    """A JAX model with every variable randomised from a numpy seed,
    saved by the JAX package; returns (model, variables)."""
    model, cfg = jio.build_model(kind, A, config)
    variables = model.init(jax.random.key(seed), jnp.zeros((1,) + OBS))
    rng = np.random.RandomState(seed)
    variables = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.normal(0, 0.3, x.shape), jnp.float32), variables)
    jio.save_model(path, variables, kind, A, cfg)
    return model, variables


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("name", sorted(KINDS))
def test_jax_bundle_loads_in_port_bit_for_bit(name, tmp_path):
    kind, config = KINDS[name]
    path = str(tmp_path / "jax.msgpack")
    _, variables = _jax_bundle(kind, config, path)
    model, meta = tio.load_model(path, OBS, device="cpu")
    assert meta["kind"] == kind and meta["num_actions"] == A
    got, want = _flat(tio.model_variables(model)), _flat(variables)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(KINDS))
def test_port_bundle_loads_in_jax_bit_for_bit(name, tmp_path):
    """The port's bundle reads back in JAX's ``load_model`` with the same
    arrays, in the port with the same outputs, and its bytes (msgpack and
    JSON) are the JAX writer's for the same weights."""
    kind, config = KINDS[name]
    model, _ = tio.build_model(kind, A, config, OBS,
                               torch.Generator().manual_seed(1))
    with torch.no_grad():
        for p in model.parameters():  # live heads: no zero kernels
            p.add_(0.01)
    path = str(tmp_path / "port.msgpack")
    cfg = model.cfg
    tio.save_model(path, model, kind, A, cfg)
    jmodel, jvars = jio.load_model(path, OBS)
    want = _flat(tio.model_variables(model))
    got = _flat(jvars)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # The JAX writer keeps each dict's order; a trained state, as jit returns
    # it, has its keys sorted (the order of the models_zoo bundles).
    jcfg = (JaxResNet if kind == "resnet" else JaxRandWire)(**config)
    jio.save_model(str(tmp_path / "jax.msgpack"),
                   jax.tree_util.tree_map(jnp.asarray, jvars), kind, A, jcfg)
    for suffix in ("", ".json"):
        with open(path + suffix, "rb") as a, open(str(tmp_path / "jax.msgpack") + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    obs = np.random.RandomState(2).randint(0, 2, (4,) + OBS).astype(np.float32)
    jl, _ = jmodel.apply(jvars, jnp.asarray(obs))
    back, _ = tio.load_model(path, OBS, device="cpu")
    with torch.no_grad():
        assert torch.equal(back(torch.from_numpy(obs))[0], model.eval()(torch.from_numpy(obs))[0])
    assert np.isfinite(np.asarray(jl)).all()


@pytest.mark.parametrize("name,game,size", [("flagship_gomoku15", "gomoku", 15),
                                            ("go9", "go", 9),
                                            ("chess_dev", "chess", 8)])
def test_zoo_bundles_rewrite_to_their_own_bytes(name, game, size, tmp_path):
    """Read and written again, each bundle keeps its bytes: through the
    msgpack codec alone, and through ``load_model`` -> ``save_model``."""
    path = os.path.join(REPO, "models_zoo", name)
    with open(path, "rb") as f:
        data = f.read()
    with open(path + ".json") as f:
        meta_text = f.read()
    assert tio.write_msgpack(tio.read_msgpack(data)) == data
    env = registry.create_game(game, size)
    model, meta = tio.load_model(path, env.observation_shape, device="cpu")
    out = str(tmp_path / name)
    tio.save_model(out, model, meta["kind"], meta["num_actions"], model.cfg)
    with open(out, "rb") as f:
        assert f.read() == data
    with open(out + ".json") as f:
        assert f.read() == meta_text
    assert json.loads(meta_text)["num_actions"] == env.num_actions


def test_msgpack_writer_forms():
    """Each value in the smallest msgpack form, as the ``msgpack`` package
    writes it (the forms flax's files use, and the wider ones)."""
    import msgpack

    values = [0, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -128,
              -129, -32768, -32769, -2**31 - 1, 1.5, True, False, None, "a",
              "x" * 40, "y" * 300, b"\x00" * 5, b"\x01" * 300, list(range(20)),
              {f"k{i}": i for i in range(20)}]
    for v in values:
        assert tio.write_msgpack(v) == msgpack.packb(v, use_bin_type=True), v
    arr = np.arange(6, dtype=np.int32).reshape(2, 3)
    back = tio.read_msgpack(tio.write_msgpack({"a": arr, "s": np.float32(2.5)}))
    np.testing.assert_array_equal(back["a"], arr)
    assert back["s"] == np.float32(2.5) and back["s"].dtype == np.float32
    with pytest.raises(TypeError):
        tio.write_msgpack(object())
