"""KataGo's nested-bottleneck trunk (``ResNetConfig(block="nbt")``) in the
port: ``AZResNet`` against the plain float32 reference written from the
layer equations (``tests/nbt_reference.py``), the fold, the folded bf16
form, the global pooling, a learner step, the published widths, the spans
and counters, and the entry points that carry the block or refuse it."""
import json
import os

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import nbt_reference as ref
from alphazero_tpu_torch.models import convert, export_onnx, export_torch, quant
from alphazero_tpu_torch.models import io as tio
from alphazero_tpu_torch.models.resnet import (
    NBT_KEYS, AZResNet, ResNetConfig, fold_batch_norm, global_pool,
    make_inference_eval_fn,
)
from alphazero_tpu_torch.utils import config as tconfig
from alphazero_tpu_torch.utils import telemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBS = (8, 9, 9)  # the port's Go planes at 9x9
A = 82
# 2 nested blocks, the second pooling; 32 / 16 / 8 channels.
SMALL = dict(block="nbt", num_blocks=2, channels=32,
             gpool_channels=8, gpool_every=2,
             policy_channels=8, value_channels=8, value_hidden=32)
# The published b18c384nbt trunk (KataGo's modelconfigs.py).
PUBLISHED = dict(block="nbt", num_blocks=18, channels=384,
                 gpool_channels=64, gpool_every=3)


def _seeded(model, seed):
    """Every float parameter and statistic of ``model`` drawn as the
    benchmark draws them: kernels LeCun-normal, shifts and running means
    normal(0.1), norm scales 1 + normal(0.1), running variances
    exp(normal(0.2)).  Returns the weights by name."""
    gen = torch.Generator().manual_seed(seed)
    w = {}
    for name, v in model.state_dict().items():
        if not v.is_floating_point():
            continue
        x = torch.randn(v.shape, generator=gen)
        last = name.rsplit(".", 1)[-1]
        if last == "running_var":
            x = torch.exp(0.2 * x)
        elif last in ("running_mean", "bias"):
            x = 0.1 * x
        elif "bn" in name:
            x = 1.0 + 0.1 * x
        else:
            x = x / torch.Size(v.shape[1:]).numel() ** 0.5
        w[name] = x
    model.load_state_dict(w, strict=False)
    return w


def _net(seed=0, **kw):
    cfg = ResNetConfig(dtype=torch.float32, **dict(SMALL, **kw))
    model = AZResNet(A, cfg, obs_shape=OBS).eval()
    return model, _seeded(model, seed)


def _obs(B=32, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand((B,) + OBS, generator=gen) < 0.3).float()


def _rel(a, b):
    """The widest gap over the widest reference value."""
    return float((a - b).abs().max() / b.abs().max())


def test_net_matches_the_reference_in_f32():
    """The same float32 operations in another order: 1e-5 of the widest
    value."""
    model, w = _net()
    obs = _obs()
    with torch.no_grad():
        logits, value = model(obs)
    rl, rv = ref.forward(w, obs, SMALL["num_blocks"])
    assert _rel(logits, rl) < 1e-5 and _rel(value, rv) < 1e-5
    assert float(rl.std()) > 0.1 and float(rv.abs().max()) > 0.1  # live heads


def test_fold_matches_the_unfolded_net_in_f32():
    """``bn_b`` and ``bn_g`` fold into the convs before them (and ``bn_b``
    into the pooling's dense kernel); the norms on residual sums become
    ``Affine``.  The folded state loads into a ``norm="none"`` net."""
    model, _ = _net(seed=3)
    folded = fold_batch_norm(model)
    obs = _obs(seed=4)
    with torch.no_grad():
        l0, v0 = model(obs)
        l1, v1 = folded(obs)
    assert _rel(l1, l0) < 1e-5 and _rel(v1, v0) < 1e-5
    blk = folded.blocks[1]
    assert blk.inner[0].conv_r.bias is not None and blk.inner[0].conv_g.bias is not None
    assert blk.inner[1].conv_a.bias is not None and blk.inner[0].conv_b.bias is None
    assert type(blk.pre_bn).__name__ == "Affine"
    plain = AZResNet(A, folded.cfg, obs_shape=OBS)
    plain.load_state_dict(folded.state_dict())


def test_folded_bf16_within_a_tolerance_that_8_bit_fails():
    """The folded net in bf16 against the float32 reference, by the mean
    logit gap over the mean logit: every bf16 op rounds to 2**-9 of its
    value, and about a dozen roundings lie between input and logits, so
    the gap stays under 0.012 (0.0056-0.0096 over eight seeds); the
    reference with its trunk convs in 8-bit fake quantisation (per-position
    input scale, per-channel weight scale) reads 0.014-0.022 and fails."""
    model, w = _net(seed=5)
    obs = _obs(B=64, seed=6)
    eval_fn = make_inference_eval_fn(model, torch.bfloat16)
    logits, value = eval_fn(obs)
    rl, rv = ref.forward(w, obs, SMALL["num_blocks"])
    ql, _ = ref.forward(w, obs, SMALL["num_blocks"], bits=8)

    def gap(a):
        return float((a - rl).abs().mean() / rl.abs().mean())

    assert gap(logits) < 0.012 < gap(ql)
    assert float((value - rv).abs().max()) < 0.02


@pytest.mark.parametrize("n,scale", [(19, 0.5), (9, -0.5)])
def test_global_pool_on_a_hand_made_board(n, scale):
    """[mean, mean * (sqrt(N * N) - 14) / 10, max] a channel: at 19x19 the
    scaled mean is half the mean; the port's and the reference's."""
    g = torch.zeros(2, 3, n, n)
    g[0, 0, 0, 0] = n * n  # mean 1, max n * n
    g[0, 1] = -2.0  # mean -2, max -2
    g[1, 2, 3, 4] = -5.0  # mean -5 / (n * n), max 0
    mean = torch.tensor([[1.0, -2.0, 0.0], [0.0, 0.0, -5.0 / (n * n)]])
    top = torch.tensor([[n * n, -2.0, 0.0], [0.0, 0.0, 0.0]])
    want = torch.cat([mean, mean * scale, top], dim=1)
    torch.testing.assert_close(global_pool(g), want)
    torch.testing.assert_close(ref._pool(g), want)


def test_a_learner_step_reaches_every_parameter():
    """A train-mode step: every parameter gets a finite gradient that is not
    zero everywhere, and every BatchNorm's running statistics move."""
    from alphazero_tpu_torch.training.learner import (
        LearnerConfig, create_train_state, train_step,
    )
    from alphazero_tpu_torch.training.replay import Batch

    model, _ = _net(seed=7)
    cfg = LearnerConfig(total_steps=10)
    state = create_train_state(model, cfg)
    obs = _obs(B=16, seed=8)
    gen = torch.Generator().manual_seed(9)
    policy = torch.softmax(torch.randn(16, A, generator=gen), -1)
    value = torch.rand(16, generator=gen) * 2 - 1
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state, metrics = train_step(state, Batch(obs, policy, value), cfg)
    assert state.step == 1 and np.isfinite(float(metrics.loss))
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert p.grad.abs().sum() > 0, name
    moved = [k for k in before if k.endswith("running_mean")
             and not torch.equal(before[k], model.state_dict()[k])]
    assert len(moved) == sum(k.endswith("running_mean") for k in before)


def test_published_widths_on_the_meta_device():
    """b18c384nbt at its published widths, built without memory: the
    parameter count the shapes give."""
    cfg = ResNetConfig(**PUBLISHED)
    with torch.device("meta"):
        model = AZResNet(362, cfg, obs_shape=(8, 19, 19))
    c, m, g = 384, 192, 64

    def bn(n):
        return 2 * n

    plain = 2 * (bn(m) + m * m * 9 + bn(m) + m * m * 9)
    pool = (bn(m) + m * (m - g) * 9 + m * g * 9 + bn(g) + 3 * g * (m - g)
            + bn(m - g) + (m - g) * m * 9)
    block = bn(c) + c * m + bn(m) + m * c
    trunk = 8 * c * 9 + 18 * block + 12 * plain + 6 * (pool + plain // 2) + bn(c)
    heads = (c * 32 + 32 + 32 * 361 * 362 + 362
             + c * 32 + 32 + 32 * 361 * 256 + 256 + 256 + 1)
    assert sum(p.numel() for p in model.parameters()) == trunk + heads
    convs = [mod for mod in model.blocks.modules() if isinstance(mod, torch.nn.Conv2d)]
    assert len(convs) + 1 == 115  # with the stem
    pooled = [k + 1 for k, b in enumerate(model.blocks) if b.inner[0].gpool]
    assert pooled == [3, 6, 9, 12, 15, 18]
    assert all(p.device.type == "meta" for p in model.parameters())


def test_spans_and_counters_of_one_call():
    """Each call counts 4 unfoldable pre-activations a block and the trunk's
    last, and one pooling a pooling block; every trunk conv has its span."""
    model, _ = _net()
    eval_fn = make_inference_eval_fn(model, torch.float32)
    with telemetry.recording() as rec:
        eval_fn(_obs(B=4))
        eval_fn(_obs(B=4))
    counters = rec.counters
    assert counters["eval.nbt.preact"] == 2 * (4 * 2 + 1)
    assert counters["eval.nbt.gpool"] == 2 * 1
    names = [s.name for s in rec.spans]
    assert names.count("eval.nbt.conv") == 2 * (1 + 6 + 7)
    assert names.count("eval.nbt.gpool") == 2
    assert names.count("eval.nbt.preact") == 2 * (9 + 2 + 3)  # with folded convs' Mish


def test_bundle_saves_and_loads(tmp_path):
    model, _ = _net(seed=11)
    path = str(tmp_path / "nbt.msgpack")
    tio.save_model(path, model, "resnet", A, model.cfg)
    with open(path + ".json") as f:
        meta = json.load(f)
    assert meta["config"]["block"] == "nbt" and meta["config"]["gpool_channels"] == 8
    back, _ = tio.load_model(path, OBS, device="cpu")
    obs = _obs(B=4)
    with torch.no_grad():
        assert torch.equal(back.float()(obs)[0], model(obs)[0])


def test_se_configs_keep_jax_keys(tmp_path):
    """An SE-ResNet's bundle JSON and config dict hold JAX's keys alone."""
    cfg = ResNetConfig(num_blocks=1, channels=16)
    model = AZResNet(A, cfg, obs_shape=OBS)
    path = str(tmp_path / "se.msgpack")
    tio.save_model(path, model, "resnet", A, cfg)
    with open(path + ".json") as f:
        keys = set(json.load(f)["config"])
    assert not keys & set(NBT_KEYS)
    assert "se_ratio" in keys
    assert "block" not in tconfig.to_dict(cfg)
    assert tconfig.to_dict(ResNetConfig(**PUBLISHED))["block"] == "nbt"


def test_self_play_cli_runs_an_nbt_bundle(tmp_path, capsys):
    from alphazero_tpu_torch.scripts import self_play

    model, _ = _net(seed=12)
    path = str(tmp_path / "nbt")
    tio.save_model(path, model, "resnet", A, model.cfg)
    self_play.main(["--device", "cpu", "--game", "go", "--board-size", "9",
                    "--model", path, "--num-games", "2", "--simulations", "8",
                    "--wave", "4", "--max-moves", "3",
                    "--output-dir", str(tmp_path / "games")])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["games"] == 2 and stats["moves"] == 6


def test_train_cli_trains_an_nbt_net(tmp_path):
    from alphazero_tpu_torch.scripts import train as train_cli

    ckpt = tmp_path / "run"
    train_cli.main(["--device", "cpu", "--game", "go", "--board-size", "5",
                    "--block", "nbt", "--blocks", "2", "--channels", "16",
                    "--gpool-channels", "4", "--gpool-every", "2",
                    "--iterations", "1", "--games-per-iteration", "2",
                    "--simulations", "4", "--wave", "4", "--max-moves", "2",
                    "--train-steps", "1", "--train-batch-size", "8",
                    "--min-replay", "1", "--no-recycle", "--inference", "folded",
                    "--checkpoint-every", "1", "--checkpoint-dir", str(ckpt)])
    with open(ckpt / "history.json") as f:
        (entry,) = json.load(f)
    assert np.isfinite(entry["loss"])
    payload = torch.load(ckpt / "ckpt_0.pt", weights_only=True)
    assert "blocks.1.inner.0.gpool_fc.weight" in payload["model"]


def test_int8_executor_refuses_the_block():
    model, _ = _net()
    with pytest.raises(ValueError, match="block 'nbt'"):
        quant.make_int8_eval_fn(model, calib_obs=_obs(B=4))


def test_convert_refuses_the_block():
    model, _ = _net()
    with pytest.raises(ValueError, match="block 'nbt'"):
        convert.flax_from_state_dict(model.state_dict(), 2)


@pytest.mark.parametrize("kind", ["onnx", "torchscript"])
def test_exports_refuse_the_block(kind, tmp_path):
    model, _ = _net()
    with pytest.raises(ValueError, match="block 'nbt'"):
        if kind == "onnx":
            export_onnx.export_onnx(model, OBS, str(tmp_path / "m.onnx"))
        else:
            export_torch.export_torchscript(model, OBS, str(tmp_path / "m.pt"))


def test_the_benchmark_reference_is_this_one():
    """``perfbench/reference/nbt.py`` is this reference, byte for byte."""
    with open(os.path.join(REPO, "tests", "nbt_reference.py"), "rb") as a, \
            open(os.path.join(REPO, "perfbench", "reference", "nbt.py"), "rb") as b:
        assert a.read() == b.read()
