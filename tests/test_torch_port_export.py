"""The port's exports (``alphazero_tpu_torch/models/export_torch.py``,
``export_onnx.py`` and ``scripts/export_model.py``) against the JAX
package's on the same bundles: TorchScript outputs, the ONNX graph node for
node with its initialisers, both ONNX files replayed by the numpy executor,
a dynamic batch, a ``.pt`` that loads without the port, and the export CLI,
whose ``--bundle`` takes the game from the bundle where JAX's takes
Gomoku.  Every tolerance is stated where it is used."""
import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

from alphazero_tpu.models import export_onnx as jonnx
from alphazero_tpu.models import export_torch as jts
from alphazero_tpu.models.io import load_model as jax_load
from alphazero_tpu_torch.core import registry
from alphazero_tpu_torch.models import export_onnx as tonnx
from alphazero_tpu_torch.models import export_torch as tts
from alphazero_tpu_torch.models.io import load_model
from alphazero_tpu_torch.models.resnet import AZResNet, ResNetConfig
from alphazero_tpu_torch.scripts import export_model as export_cli
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "models_zoo", "flagship_gomoku15")
CHESS = os.path.join(REPO, "models_zoo", "chess_dev")
OBS = (11, 15, 15)


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """The flagship exported by both packages: (port model, paths)."""
    tmp = tmp_path_factory.mktemp("export")
    jmodel, jvars = jax_load(FLAGSHIP, OBS)
    model, _ = load_model(FLAGSHIP, OBS, device="cpu")
    paths = {k: str(tmp / k) for k in ("j.pt", "t.pt", "j.onnx", "t.onnx")}
    jts.export_torchscript(jmodel, jvars, OBS, paths["j.pt"])
    tts.export_torchscript(model, OBS, paths["t.pt"])
    jonnx.export_onnx(jmodel, jvars, OBS, paths["j.onnx"])
    tonnx.export_onnx(model, OBS, paths["t.onnx"])
    return model, paths


def _obs(B, seed=0):
    return np.random.RandomState(seed).randint(0, 2, (B,) + OBS).astype(np.float32)


@pytest.mark.parametrize("B", [1, 5])
def test_torchscript_matches_jax_export(exports, B):
    """Both ``.pt`` files on the same observations (traced at batch 1, run
    at 1 and 5): within 1e-4 absolute (both are the folded f32 net; the
    folds round their products apart by an ulp)."""
    _, paths = exports
    x = torch.from_numpy(_obs(B))
    with torch.no_grad():
        jl, jv = torch.jit.load(paths["j.pt"])(x)
        tl, tv = torch.jit.load(paths["t.pt"])(x)
    assert tl.shape == (B, 225) and tv.shape == (B,)
    np.testing.assert_allclose(tl.numpy(), jl.numpy(), atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), jv.numpy(), atol=1e-4)


def test_torchscript_verifies_and_loads_without_the_port(exports, tmp_path):
    """``verify_export`` holds the ``.pt`` against the folded f32 eval, and a
    Python that cannot import ``alphazero_tpu_torch`` runs it."""
    model, paths = exports
    dev = tts.verify_export(model, _obs(4, seed=1), paths["t.pt"], atol=1e-4)
    assert dev["max_logit_dev"] <= 1e-4
    code = ("import importlib.util, sys, torch\n"
            "assert importlib.util.find_spec('alphazero_tpu_torch') is None\n"
            f"m = torch.jit.load({paths['t.pt']!r})\n"
            "l, v = m(torch.zeros(3, 11, 15, 15))\n"
            "print(tuple(l.shape), tuple(v.shape))\n")
    out = subprocess.run([sys.executable, "-I", "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "(3, 225) (3,)"


def _graph(path):
    """(nodes as (op, name, inputs, outputs, attrs), initialisers, the
    graph's inputs, outputs and name, the model's other top-level fields)
    of an ONNX file, read by the port's parser."""
    with open(path, "rb") as f:
        model = tonnx._parse_msg(f.read())
    graph = tonnx._parse_msg(tonnx._fields(model, 7)[0])
    nodes = []
    for buf in tonnx._fields(graph, 1):
        msg = tonnx._parse_msg(buf)
        nodes.append((tonnx._fields(msg, 4)[0], tonnx._fields(msg, 3)[0],
                      tonnx._fields(msg, 1), tonnx._fields(msg, 2),
                      tonnx._parse_attrs(tonnx._fields(msg, 5))))
    inits = dict(tonnx._parse_tensor(t) for t in tonnx._fields(graph, 5))
    io = (tonnx._fields(graph, 11), tonnx._fields(graph, 12), tonnx._fields(graph, 2))
    head = [(f, v) for f, _, v in model if f != 7]
    return nodes, inits, io, head


def test_onnx_graph_matches_jax_node_for_node(exports):
    """The same nodes in the same order, with the same names, inputs,
    outputs and attributes; the same graph inputs/outputs (a ``batch``
    dimension), opset and IR version; initialisers of the same names and
    shapes within 1e-6 relative (the two BN folds round apart)."""
    _, paths = exports
    jn, ji, jio_, jhead = _graph(paths["j.onnx"])
    tn, ti, tio_, thead = _graph(paths["t.onnx"])
    assert tn == jn and len(tn) == 2 + 6 * 13 + 5 + 9  # stem, blocks, heads
    assert tio_ == jio_ and thead == jhead
    assert b"batch" in jio_[0][0]
    assert ti.keys() == ji.keys()
    for k in ji:
        assert ti[k].shape == ji[k].shape and ti[k].dtype == ji[k].dtype, k
        np.testing.assert_allclose(ti[k], ji[k], rtol=1e-6,
                                   atol=1e-6 * float(np.abs(ji[k]).max()), err_msg=k)


@pytest.mark.parametrize("B", [1, 6])
def test_onnx_files_replay_alike(exports, B):
    """Both files replayed by the numpy executor (dynamic batch: 1 and 6),
    within 1e-4 absolute; the port's also against its folded f32 eval."""
    model, paths = exports
    obs = _obs(B, seed=2)
    jl, jv = jonnx.load_and_run_onnx(paths["j.onnx"], obs)
    tl, tv = tonnx.load_and_run_onnx(paths["t.onnx"], obs)
    assert tl.shape == (B, 225) and tv.shape == (B,)
    np.testing.assert_allclose(tl, jl, atol=1e-4)
    np.testing.assert_allclose(tv, jv, atol=1e-4)
    dev = tonnx.verify_onnx_export(model, obs, paths["t.onnx"], atol=1e-4)
    assert dev["max_value_dev"] <= 1e-4


def test_export_cli_bundle_takes_its_game_from_the_bundle(tmp_path, capsys):
    """``--bundle models_zoo/chess_dev`` with no ``--game``: the port builds
    the chess env (its TorchScript and ONNX checks run on chess
    observations) and packages chess 8x8; the JAX CLI packages the default
    Gomoku 15x15 (and would check the exports on Gomoku observations)."""
    from alphazero_tpu.scripts import export_model as jax_cli

    jax_cli.main(["--bundle", CHESS, "--package", str(tmp_path / "jax.zip")])
    capsys.readouterr()
    with zipfile.ZipFile(tmp_path / "jax.zip") as z:
        jmeta = json.loads(z.read("metadata.json"))
    assert (jmeta["game"], jmeta["board_size"]) == ("gomoku", 15)

    export_cli.main(["--bundle", CHESS, "--torchscript", str(tmp_path / "c.pt"),
                     "--onnx", str(tmp_path / "c.onnx"),
                     "--package", str(tmp_path / "port.zip"), "--device", "cpu"])
    out = json.loads(capsys.readouterr().out)
    assert out["bundle"] == CHESS and out["checkpoint_step"] is None
    assert out["torchscript_parity"]["max_logit_dev"] <= 2e-2
    assert out["onnx_parity"]["max_logit_dev"] <= 2e-2
    with zipfile.ZipFile(tmp_path / "port.zip") as z:
        meta = json.loads(z.read("metadata.json"))
        assert sorted(z.namelist()) == ["chess_dev", "chess_dev.json", "metadata.json"]
    assert meta.keys() == jmeta.keys()
    assert (meta["game"], meta["board_size"]) == ("chess", 8)
    with torch.no_grad():
        l, v = torch.jit.load(str(tmp_path / "c.pt"))(torch.zeros(2, 18, 8, 8))
    assert l.shape == (2, 4672)
    with pytest.raises(ValueError):
        export_cli.main(["--bundle", CHESS, "--game", "gomoku", "--device", "cpu"])


def test_export_cli_converts_a_checkpoint(tmp_path, capsys):
    """``--checkpoint-dir``: the latest ``ckpt_N.pt`` of a run becomes a
    bundle with the checkpoint's weights."""
    env = registry.create_game("gomoku", 5)
    model = AZResNet(env.num_actions, ResNetConfig(num_blocks=1, channels=16),
                     env.observation_shape, torch.Generator().manual_seed(0))
    run = tmp_path / "run"
    run.mkdir()
    for step in (2, 7):
        torch.save({"model": model.state_dict()}, run / f"ckpt_{step}.pt")
    out_path = str(tmp_path / "model.msgpack")
    export_cli.main(["--checkpoint-dir", str(run), "--game", "gomoku",
                     "--board-size", "5", "--blocks", "1", "--channels", "16",
                     "--output", out_path, "--device", "cpu"])
    assert json.loads(capsys.readouterr().out)["checkpoint_step"] == 7
    back, meta = load_model(out_path, env.observation_shape, device="cpu")
    assert meta["kind"] == "resnet"
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
