"""The int8 executor's trunk epilogues (``models/quant.py``
``_epilogue_*_plain``) and their one-pass kernel (``ops/int8_epilogue.py``,
``csrc/int8_epilogue.cu``).

On the CPU: the plain epilogues against the passes the executor ran inline
before they were gathered into functions (transcribed here), the channels
the wrapper takes, the constants ``_executor_params`` stores, and the
counters.  On the card (``-m cuda``): each kernel form against its plain
version bit for bit, and the whole forward with the kernel against it
without."""
import pytest
import torch

from alphazero_tpu_torch.core import registry
from alphazero_tpu_torch.models import quant as tq
from alphazero_tpu_torch.models.resnet import AZResNet, ResNetConfig
from alphazero_tpu_torch.ops import int8_epilogue as ep
from alphazero_tpu_torch.utils import telemetry
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BF16 = torch.bfloat16


def _inputs(B, H, W, O, seed, device="cpu", ties=False):
    """An s32 accumulator whose requant spans the output scale (clipping
    included), per-channel multipliers and biases, the scales of the three
    quantisers, an SE gate and both residual carries.  ``ties`` makes every
    requantised value a multiple of 0.5 at a quantiser multiplier of 1, so
    round-half-to-even decides half of them."""
    g = torch.Generator().manual_seed(seed)
    scale = torch.tensor(3.0) * (1 + torch.rand((), generator=g))
    if ties:
        m = torch.full((O,), 0.5)
        bias = torch.zeros(O)
        acc = torch.randint(-300, 301, (B, H, W, O), generator=g, dtype=torch.int32)
        scales = [torch.tensor(127.0)] * 3
    else:
        m = (1 + torch.rand(O, generator=g)) * 1e-6
        bias = torch.randn(O, generator=g) * 0.3 * scale
        y = torch.randn((B, H, W, O), generator=g) * 1.5 * scale
        acc = torch.round(y / m).to(torch.int32)
        scales = [scale * (0.5 + torch.rand((), generator=g)) for _ in range(3)]
    st = {"m": m, "bias": bias, "out_scale": scales[0]}
    blk = {"m1": m, "b1": bias, "mid_scale": scales[1],
           "m2": m.flip(0), "b2": bias.flip(0), "out_scale": scales[2]}
    gate = torch.sigmoid(torch.randn((B, O), generator=g)).to(BF16)
    a = (torch.randn((B, H, W, O), generator=g) * scales[0]).relu().to(BF16)
    aq = torch.randint(-127, 128, (B, H, W, O), generator=g, dtype=torch.int8)
    out = dict(acc=acc, st=st, blk=blk, gate=gate, a=a, aq=aq, s_prev=scales[0])
    return {k: _to(v, device) for k, v in out.items()}


def _to(x, device):
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    return x.to(device)


# ------------------------------------------------------------------ the CPU

def _inline_stem(acc, st):
    """The stem's passes as ``forward_int8_from_q`` ran them inline."""
    y = tq._requant(acc, st["m"], st["bias"])
    a = torch.relu_(y).to(BF16)
    return tq._quant_act(a, st["out_scale"]), a


def _inline_conv1(acc, blk):
    h = tq._requant(acc, blk["m1"], blk["b1"])
    hq = tq._quant_act(h, blk["mid_scale"], lo=0.0)
    return hq, tq._tap_sums(hq)


def _inline_conv2(acc, blk, g, a, aq, s_prev, residual):
    h2 = tq._requant(acc, blk["m2"], blk["b2"]).to(BF16)
    if residual == "int8":
        a = aq.to(BF16) * (s_prev.float() / 127.0).to(BF16)
    a = torch.relu(a + h2 * g[:, None, None, :])
    return tq._quant_act(a, blk["out_scale"]), a


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", [(5, 7, 7, 16), (3, 15, 15, 64), (2, 8, 8, 12)])
def test_plain_epilogues_equal_the_inline_passes(shape, ties):
    x = _inputs(*shape, seed=sum(shape), ties=ties)
    for got, want in (
            (tq._epilogue_stem_plain(x["acc"], x["st"]), _inline_stem(x["acc"], x["st"])),
            (tq._epilogue_conv1_plain(x["acc"], x["blk"]),
             _inline_conv1(x["acc"], x["blk"]))):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    hq, _ = tq._epilogue_conv1_plain(x["acc"], x["blk"])
    assert hq.min() >= 0 and hq.max() == 127  # the ReLU in the clip, and the clip
    for residual in ("bf16", "int8"):
        args = (x["acc"], x["blk"], x["gate"], x["a"], x["aq"], x["s_prev"], residual)
        got, want = tq._epilogue_conv2_plain(*args), _inline_conv2(*args)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_plain_tap_sums_feed_the_gate_as_before():
    x = _inputs(4, 9, 9, 16, seed=3)
    blk = dict(x["blk"], wq2=torch.randint(-127, 128, (3, 3, 16, 16), dtype=torch.int8),
               se1={"kernel": torch.randn(16, 4), "bias": torch.randn(4)},
               se2={"kernel": torch.randn(4, 16), "bias": torch.randn(16)})
    hq, taps = tq._epilogue_conv1_plain(x["acc"], blk)
    assert taps.dtype == torch.int32 and taps.shape == (4, 9, 16)
    assert torch.equal(tq._se_gate_from_taps(taps, 81, blk)[:, None, None, :],
                       tq._se_gate_precomputed(hq, blk))


@pytest.mark.parametrize("O,taken", [(4, True), (16, True), (64, True), (96, True),
                                     (128, True), (1024, True), (2, False),
                                     (6, False), (66, False), (1028, False)])
def test_the_wrapper_takes_channels_a_multiple_of_4_up_to_1024(O, taken):
    """The channels are checked before the device: a CPU accumulator of a
    width the kernel takes gets as far as the device check."""
    acc = torch.zeros((1, 2, 2, O), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA" if taken else "channels"):
        ep.int8_epilogue("stem", acc, torch.zeros(O), torch.zeros(O),
                         torch.tensor(1.0))


def test_the_wrapper_takes_only_the_card():
    x = _inputs(2, 7, 7, 16, seed=1)
    with pytest.raises(ValueError, match="CUDA"):
        ep.int8_epilogue("stem", x["acc"], x["st"]["m"], x["st"]["bias"],
                         127.0 / x["st"]["out_scale"])
    with pytest.raises(ValueError, match="form"):
        ep.int8_epilogue("conv3", x["acc"], x["st"]["m"], x["st"]["bias"],
                         127.0 / x["st"]["out_scale"])


def _net(game, size, blocks=2, channels=16, seed=0):
    env = registry.create_game(game, size)
    cfg = ResNetConfig(num_blocks=blocks, channels=channels, policy_channels=8,
                       value_channels=8, value_hidden=32)
    model = AZResNet(env.num_actions, cfg, obs_shape=env.observation_shape,
                     generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_var"):
                buf.copy_(0.5 + 1.5 * torch.rand(buf.shape, generator=g))
            elif name.endswith("running_mean"):
                buf.copy_(0.3 * torch.randn(buf.shape, generator=g))
    return model.eval(), env.observation_shape


def _obs(shape, B, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 2, (B,) + tuple(shape), generator=g).float()


def test_executor_params_store_the_constants_the_plain_passes_compute():
    model, shape = _net("gomoku", 7)
    qp = tq.build_quantized_params(model, _obs(shape, 16, 0))
    ex = tq._executor_params(qp)
    assert torch.equal(ex["stem"]["out_qmul"], 127.0 / qp["stem"]["out_scale"])
    s_prev = qp["stem"]["out_scale"]
    for b, e in zip(qp["blocks"], ex["blocks"]):
        assert torch.equal(e["mid_qmul"], 127.0 / b["mid_scale"])
        assert torch.equal(e["out_qmul"], 127.0 / b["out_scale"])
        assert e["res_scale"].dtype == BF16
        assert torch.equal(e["res_scale"], (s_prev.float() / 127.0).to(BF16))
        s_prev = b["out_scale"]


@pytest.mark.parametrize("blocks", [0, 1, 2])
def test_every_trunk_conv_counts_its_epilogue(blocks):
    model, shape = _net("gomoku", 7, blocks=blocks)
    qp = tq._executor_params(tq.build_quantized_params(model, _obs(shape, 8, 0)))
    with telemetry.recording() as rec, torch.no_grad():
        tq.forward_int8(qp, _obs(shape, 4, 1), "int8", "bf16")
    counts = rec.counters
    assert counts["eval.epilogue_plain"] == 1 + 2 * blocks  # the CPU: plain
    assert counts["eval.epilogue_fused"] == 0


# ----------------------------------------------------------------- the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _form_cases():
    for side in (7, 8, 9, 15, 19):
        for O in (64, 96, 128):
            for B in (512, 37):
                yield side, O, B


@pytest.mark.cuda
def test_each_form_equals_its_plain_version_on_card():
    _card()
    n = 0
    for side, O, B in _form_cases():
        for ties in (False, True):
            x = _inputs(B, side, side, O, seed=side * O + B, device="cuda", ties=ties)
            acc, st, blk = x["acc"], x["st"], x["blk"]
            where = f"{side}x{side} O={O} B={B} ties={ties}"
            for want_a in (True, False):
                q, a = ep.int8_epilogue("stem", acc, st["m"], st["bias"],
                                        127.0 / st["out_scale"], want_a=want_a)
                pq, pa = tq._epilogue_stem_plain(acc, st)
                assert torch.equal(q, pq), f"stem s8 at {where}"
                assert (a is None) if not want_a else torch.equal(a, pa), where
            q, taps = ep.int8_epilogue("conv1", acc, blk["m1"], blk["b1"],
                                       127.0 / blk["mid_scale"])
            pq, ptaps = tq._epilogue_conv1_plain(acc, blk)
            assert torch.equal(q, pq), f"conv1 s8 at {where}"
            assert torch.equal(taps, ptaps), f"conv1 taps at {where}"
            for residual in ("bf16", "int8"):
                rs = (x["s_prev"].float() / 127.0).to(BF16)
                q, a = ep.int8_epilogue(
                    "conv2", acc, blk["m2"], blk["b2"], 127.0 / blk["out_scale"],
                    want_a=True, gate=x["gate"],
                    residual=x["aq"] if residual == "int8" else x["a"], res_scale=rs)
                pq, pa = tq._epilogue_conv2_plain(acc, blk, x["gate"], x["a"], x["aq"],
                                                  x["s_prev"], residual)
                assert torch.equal(q, pq), f"conv2 s8 at {where}, {residual}"
                assert torch.equal(a, pa), f"conv2 bf16 at {where}, {residual}"
            n += 1
    torch.cuda.synchronize()
    assert n == 60


@pytest.mark.cuda
def test_the_wrapper_counts_launches_and_refuses_other_channels_on_card():
    _card()
    x = _inputs(1, 7, 7, 16, seed=0, device="cuda")
    before = ep.int8_epilogue.launches
    ep.int8_epilogue("stem", x["acc"], x["st"]["m"], x["st"]["bias"],
                     127.0 / x["st"]["out_scale"])
    assert ep.int8_epilogue.launches == before + 1
    y = _inputs(1, 7, 7, 6, seed=0, device="cuda")
    with pytest.raises(ValueError, match="channels"):
        ep.int8_epilogue("stem", y["acc"], y["st"]["m"], y["st"]["bias"],
                         127.0 / y["st"]["out_scale"])
    assert ep.int8_epilogue.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("game,size,blocks,channels", [
    ("gomoku", 15, 6, 64), ("go", 9, 6, 64), ("chess", 8, 6, 64), ("go", 19, 2, 96)])
def test_forward_with_the_kernel_equals_it_without_on_card(game, size, blocks,
                                                          channels, monkeypatch):
    _card()
    model, shape = _net(game, size, blocks, channels, seed=size)
    model = model.cuda()
    qp = tq._executor_params(tq.build_quantized_params(
        model, _obs(shape, 64, 0).cuda(), calib_percentile=99.99))
    obs = _obs(shape, 512, 1).cuda()
    for residual in ("int8", "bf16"):
        for heads in ("bf16", "int8"):
            before = ep.int8_epilogue.launches
            with telemetry.recording() as rec, torch.no_grad():
                fused = tq.forward_int8(qp, obs, residual, heads)
            assert rec.counters["eval.epilogue_fused"] == 1 + 2 * blocks
            assert ep.int8_epilogue.launches == before + 1 + 2 * blocks
            with monkeypatch.context() as mp, torch.no_grad():
                mp.setattr(tq, "_fused", lambda acc: False)
                plain = tq.forward_int8(qp, obs, residual, heads)
            assert ep.int8_epilogue.launches == before + 1 + 2 * blocks
            assert torch.equal(fused[0], plain[0]), (game, residual, heads)
            assert torch.equal(fused[1], plain[1]), (game, residual, heads)


@pytest.mark.cuda
def test_the_card_takes_the_executors_params_alone():
    """The kernel reads the constants ``_executor_params`` stores, so the
    raw ``qp`` is refused on the card (the CPU's plain passes take both)."""
    _card()
    model, shape = _net("gomoku", 7, blocks=1, channels=16)
    qp = tq.build_quantized_params(model.cuda(), _obs(shape, 16, 0).cuda())
    with torch.no_grad(), pytest.raises(ValueError, match="_executor_params"):
        tq.forward_int8(qp, _obs(shape, 8, 1).cuda(), "int8", "bf16")
