"""The int8 executor's SE gate (``models/quant.py`` ``_se_gate_from_taps``,
the plain chain) and its one-launch kernel (``ops/se_gate.py``,
``csrc/se_gate.cu``).

On the CPU: the widths and devices the wrapper takes, the constants
``gate_weights`` lays out, and the counters of the gate's route.  On the
card (``-m cuda``): the kernel within a bf16 ulp of the plain gate, and the
whole forward with the kernel's gate against the plain gate's."""
import copy
import ctypes

import pytest
import torch

from alphazero_tpu_torch.models import quant as tq
from alphazero_tpu_torch.ops import se_gate as sg
from alphazero_tpu_torch.utils import telemetry
from test_torch_int8_epilogue import _card, _form_cases, _net, _obs
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BF16 = torch.bfloat16


def _block(C, O, hidden, seed, device="cpu"):
    """One block's constants of the gate as the executor holds them
    (``_executor_params``): conv2's s8 weight (and its f32 copy), a requant
    that maps a board's conv sum to a mean of a few units, and an SE MLP
    initialised as ``nn.Linear`` is, in bf16."""
    g = torch.Generator().manual_seed(seed)
    wq2 = torch.randint(-127, 128, (3, 3, C, O), generator=g, dtype=torch.int8)
    m2 = (1 + torch.rand(O, generator=g)) * 1e-5
    b2 = torch.randn(O, generator=g) * 0.5

    def dense(n_in, n_out):
        bound = n_in ** -0.5
        return {"kernel": ((torch.rand((n_in, n_out), generator=g) * 2 - 1) * bound).to(BF16),
                "bias": ((torch.rand(n_out, generator=g) * 2 - 1) * bound).to(BF16)}

    blk = {"wq2": wq2, "wq2_f32": wq2.float(), "m2": m2, "b2": b2,
           "se1": dense(O, hidden), "se2": dense(hidden, O)}
    blk = {k: ({n: t.to(device) for n, t in v.items()} if isinstance(v, dict)
               else v.to(device)) for k, v in blk.items()}
    blk["gate"] = sg.gate_weights(blk["wq2"], blk["m2"], blk["b2"], blk["se1"],
                                  blk["se2"])
    return blk


def _taps(B, side, C, seed, device="cpu", full=False):
    """Tap sums of conv2's input: s8 activations after a ReLU in the clip
    (0 to 127, a third of them 0), or with ``full`` every cell at 127, the
    largest tap sums a board allows."""
    if full:
        hq = torch.full((B, side, side, C), 127, dtype=torch.int8)
    else:
        g = torch.Generator().manual_seed(seed)
        x = torch.randn((B, side, side, C), generator=g) * 50 + 20
        hq = x.round().clamp(0, 127).to(torch.int8)
    return tq._tap_sums(hq.to(device))


# ------------------------------------------------------------------ the CPU

@pytest.mark.parametrize("C,O,hidden,taken", [
    (64, 64, 16, True), (96, 96, 24, True), (128, 128, 32, True),
    (16, 16, 4, True), (256, 256, 64, True), (3, 4, 1, True),
    (64, 66, 16, False), (64, 6, 2, False), (64, 260, 65, False),
    (300, 64, 16, False), (64, 64, 130, False)])
def test_the_wrapper_takes_the_widths_its_kernel_takes(C, O, hidden, taken):
    """Widths are checked before the device: a CPU call at a width the
    kernel takes gets as far as the device check, which refuses it."""
    blk = _block(C, O, hidden, seed=C + O)
    taps = torch.zeros((2, 9, C), dtype=torch.int32)
    with pytest.raises(ValueError, match="takes CUDA tap sums" if taken else "se_gate takes C"):
        sg.se_gate(taps, 49, blk["gate"])


def test_gate_weights_lay_out_the_plain_gates_constants_without_copies():
    blk = _block(16, 32, 8, seed=2)
    gw = blk["gate"]
    assert (gw.C, gw.O, gw.hidden) == (16, 32, 8)
    assert torch.equal(gw.w, blk["wq2"].reshape(9 * 16, 32))
    ts = (gw.w, gw.m, gw.bias, gw.w1, gw.b1, gw.w2, gw.b2)
    pairs = zip(ts[1:], (blk["m2"], blk["b2"], blk["se1"]["kernel"], blk["se1"]["bias"],
                         blk["se2"]["kernel"], blk["se2"]["bias"]))
    for got, want in pairs:  # the executor's own tensors, not copies
        assert got.data_ptr() == want.data_ptr() and got.dtype == want.dtype
    assert all(t.is_contiguous() for t in ts)
    # The kernel's argument block: the addresses, then C, O and hidden.
    block = list((ctypes.c_longlong * 10).from_address(gw.args))
    assert block == [t.data_ptr() for t in ts] + [16, 32, 8]
    copied = copy.deepcopy(gw)
    assert torch.equal(copied.w1, gw.w1) and copied.w1.data_ptr() != gw.w1.data_ptr()
    block = list((ctypes.c_longlong * 10).from_address(copied.args))
    assert block[3] == copied.w1.data_ptr()
    with pytest.raises(ValueError, match="GateWeights takes"):
        sg.gate_weights(blk["wq2"], blk["m2"], blk["b2"], blk["se2"], blk["se1"])


def test_executor_params_hold_each_blocks_gate_weights():
    model, shape = _net("gomoku", 7)
    ex = tq._executor_params(tq.build_quantized_params(model, _obs(shape, 16, 0)))
    for b in ex["blocks"]:
        gw = b["gate"]
        assert torch.equal(gw.w, b["wq2"].reshape(-1, gw.O))
        assert gw.w1.data_ptr() == b["se1"]["kernel"].data_ptr()
        assert gw.w2.dtype == BF16 and gw.w2.data_ptr() == b["se2"]["kernel"].data_ptr()


@pytest.mark.parametrize("blocks", [0, 1, 2])
def test_every_block_counts_its_gate(blocks):
    model, shape = _net("gomoku", 7, blocks=blocks)
    qp = tq._executor_params(tq.build_quantized_params(model, _obs(shape, 8, 0)))
    with telemetry.recording() as rec, torch.no_grad():
        tq.forward_int8(qp, _obs(shape, 4, 1), "int8", "bf16")
    counts = rec.counters
    assert counts["eval.se_gate_plain"] == blocks  # the CPU: plain
    assert counts["eval.se_gate_fused"] == 0


# ----------------------------------------------------------------- the card

def _ulps(got, want):
    """The distance of two bf16 tensors of non-negative values in units in
    the last place: the difference of their bit patterns."""
    return (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()


@pytest.mark.cuda
def test_the_kernel_is_within_a_bf16_ulp_of_the_plain_gate_on_card():
    _card()
    cases = [(side, O, B, False) for side, O, B in _form_cases()]
    cases += [(15, 64, 1024, False), (9, 96, 1, False)]
    cases += [(side, O, 64, True) for side in (7, 15, 19) for O in (64, 96, 128)]
    n = equal = 0
    worst = []
    for side, O, B, full in cases:
        blk = _block(O, O, O // 4, seed=side * O + B, device="cuda")
        taps = _taps(B, side, O, seed=side + O + B, device="cuda", full=full)
        got = sg.se_gate(taps, side * side, blk["gate"])
        want = tq._se_gate_from_taps(taps, side * side, blk)
        assert got.dtype == BF16 and got.shape == want.shape == (B, O)
        d = _ulps(got, want)
        worst.append((int(d.max()), side, O, B, full))
        n += d.numel()
        equal += int((d == 0).sum())
    torch.cuda.synchronize()
    assert max(worst)[0] <= 1, f"more than a bf16 ulp apart: {max(worst)}"
    assert equal >= 0.99 * n, f"{equal} of {n} gate values equal"


@pytest.mark.cuda
def test_the_wrapper_counts_launches_and_refuses_other_widths_on_card():
    _card()
    blk = _block(16, 16, 4, seed=0, device="cuda")
    before = sg.se_gate.launches
    sg.se_gate(_taps(3, 7, 16, seed=0, device="cuda"), 49, blk["gate"])
    assert sg.se_gate.launches == before + 1
    odd = _block(6, 6, 2, seed=0, device="cuda")
    with pytest.raises(ValueError, match="se_gate takes C"):
        sg.se_gate(_taps(3, 7, 6, seed=0, device="cuda"), 49, odd["gate"])
    with pytest.raises(ValueError, match="i32 tap sums"):
        sg.se_gate(_taps(3, 7, 16, seed=0, device="cuda").float(), 49, blk["gate"])
    assert sg.se_gate.launches == before + 1


def _tv_and_value_gap(a, b):
    """The widest total-variation distance of the two forwards' policies
    (softmax of the logits) over the rows, and their widest value gap."""
    tv = 0.5 * (torch.softmax(a[0], -1) - torch.softmax(b[0], -1)).abs().sum(-1)
    return float(tv.max()), float((a[1] - b[1]).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("game,size,blocks,channels", [
    ("gomoku", 15, 6, 64), ("go", 9, 6, 64), ("chess", 8, 6, 64), ("go", 19, 2, 96)])
def test_forward_with_the_kernels_gate_against_the_plain_gate_on_card(
        game, size, blocks, channels, monkeypatch):
    """The whole forward with each block's gate from the kernel, against the
    same forward with the plain gate (the epilogues fused in both), well
    inside the Gomoku cell's limits of ``correct`` (``policy_tv_max``
    0.017, ``value_gap_max`` 0.06): a gate a bf16 ulp off moves a few s8
    activations a step."""
    _card()
    model, shape = _net(game, size, blocks, channels, seed=size)
    model = model.cuda()
    qp = tq._executor_params(tq.build_quantized_params(
        model, _obs(shape, 64, 0).cuda(), calib_percentile=99.99))
    obs = _obs(shape, 512, 1).cuda()
    for residual in ("int8", "bf16"):
        for heads in ("bf16", "int8"):
            before = sg.se_gate.launches
            with telemetry.recording() as rec, torch.no_grad():
                fused = tq.forward_int8(qp, obs, residual, heads)
            assert rec.counters["eval.se_gate_fused"] == blocks
            assert rec.counters["eval.se_gate_plain"] == 0
            assert sg.se_gate.launches == before + blocks
            with monkeypatch.context() as mp, torch.no_grad():
                mp.setattr(tq, "_gate_fused", lambda taps: False)
                plain = tq.forward_int8(qp, obs, residual, heads)
            assert sg.se_gate.launches == before + blocks
            tv, gap = _tv_and_value_gap(fused, plain)
            assert tv <= 0.004 and gap <= 0.015, (game, residual, heads, tv, gap)
