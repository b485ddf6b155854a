"""The nested-bottleneck cell: its traffic (``traffic/selfplay_nbt.py``)
run tiny on the CPU, the modules the other cells load left as they were,
its join of spans and trace, its operation counts and its readers."""
import json
import time
from pathlib import Path

import torch

from perfbench import compare, harness, yardstick, yardstick_nbt
from perfbench.reference import net as ref_net
from perfbench.tests import tiny
from perfbench.trace import MARKER
from alphazero_tpu_torch.utils import telemetry
from alphazero_tpu_torch.utils.telemetry import Span

ROOT = Path(__file__).resolve().parents[2]
CELL = "go19-b18c384nbt.selfplay"
CONFIG = json.loads((ROOT / "perfbench" / "configs" / "go19-b18c384nbt.json").read_text())

# The cell cut to seconds on the CPU: 5x5, 2 nested blocks (the second
# pooling) of 32 / 16 / 8 channels, 32 sims, 8 lanes.  The bf16 net reads
# gaps under 0.01 here; the limits sit well above.
OVERRIDES = {
    "cell": {"limits": {"policy_tv_max": 0.05, "value_gap_max": 0.05}},
    "config": {"game": {"board_size": 5},
               "net": {"num_blocks": 2, "channels": 32,
                       "gpool_channels": 8, "gpool_every": 2, "policy_channels": 4,
                       "value_channels": 4, "value_hidden": 16},
               "search": {"num_simulations": 32, "wave_size": 4}},
    "mix": {"lanes": 8, "opening_plies": 4, "search_lanes": 3, "env_lanes": 8}}


def _run(cell, seed):
    return harness.run(cell, seed, 0.3, False, torch.device("cpu"),
                       time.perf_counter(), log=lambda m: None)


def test_the_cut_cell_runs_and_reads_correct():
    cell = harness.find_cell(CELL, overrides=OVERRIDES)
    assert cell.kind.__name__ == "perfbench_selfplay_nbt"
    assert [m["name"] for m in cell.per_layer] == [
        "nbt.conv_bf16_peak_pct", "nbt.preact_device_us_per_position",
        "nbt.gpool_device_us_per_position"]
    r = _run(cell, 2 ** 40 + 17)
    assert r["correct"] and r["failed"] == 0
    assert r["info"]["rows_compared"] > 0
    assert set(r["metrics"]) == {"selfplay_moves_per_s", "setup_s"}


def test_the_other_cells_modules_stay_as_they_were():
    """A go9 run after an nbt run in one process reads what it read before:
    the nbt traffic rebinds names in fresh copies only."""
    seed = 2 ** 33 + 5
    # Step 0 alone is checked: every window runs it, whatever the host's pace.
    go = harness.merge(tiny.overrides("go"), {"mix": {"check_steps": [0]}})

    def go_checks():
        return _run(harness.find_cell(tiny.CELLS["go"], overrides=go), seed)["checks"]

    before = go_checks()
    _run(harness.find_cell(CELL, overrides=OVERRIDES), seed)
    assert compare.ref_net is ref_net
    assert yardstick.resnet_macs.__module__ == "perfbench.yardstick"
    assert go_checks() == before


def test_operation_counts_of_the_published_net():
    """115 trunk convs a call; 532 M multiply-adds a plain block and 492 M a
    pooling block at 19x19, 9.35 G with the stem."""
    net = CONFIG["net"]
    assert len(yardstick_nbt.trunk_convs(net, 8)) == 115
    one = dict(net, num_blocks=1, gpool_every=0)
    pool = dict(net, num_blocks=1, gpool_every=1)
    hw, stem = 361, 8 * 384 * 9 * 361
    plain = hw * (2 * 384 * 192 + 4 * 192 * 192 * 9)
    pooled = hw * (2 * 384 * 192 + 2 * 192 * 192 * 9 + (192 * 128 + 192 * 64 + 128 * 192) * 9)
    assert (plain, pooled) == (532_316_160, 492_392_448)
    assert yardstick_nbt.trunk_conv_macs(one, 8, 19, 19) - stem == plain
    assert yardstick_nbt.trunk_conv_macs(pool, 8, 19, 19) - stem == pooled
    assert yardstick_nbt.trunk_conv_macs(net, 8, 19, 19) == stem + 12 * plain + 6 * pooled
    heads = 384 * 32 * 361 * 2 + 32 * 361 * 362 + 32 * 361 * 256 + 256
    assert yardstick_nbt.net_macs(net, 8, 19, 19, 362) == (
        yardstick_nbt.trunk_conv_macs(net, 8, 19, 19) + 6 * 3 * 64 * 128 + heads)


def test_the_counts_follow_the_module():
    """The convs ``trunk_convs`` lists are the module's, in order."""
    from alphazero_tpu_torch.models.resnet import AZResNet, ResNetConfig

    net = dict(CONFIG["net"], num_blocks=6)
    with torch.device("meta"):
        model = AZResNet(362, ResNetConfig(**net), obs_shape=(8, 19, 19))
    convs = [m for name, m in model.named_modules()
             if isinstance(m, torch.nn.Conv2d) and not name.endswith("_conv")]
    shapes = [(m.in_channels, m.out_channels, m.kernel_size[0]) for m in convs]
    assert shapes == yardstick_nbt.trunk_convs(net, 8)


def _recording():
    """One step [0, 1000] (ns) with one evaluator call [100, 900]: a conv
    [110, 200], a pre-activation [200, 300], a pooling [300, 400] and a
    second conv [400, 500]; counters of one call."""
    rec = telemetry.Recording()
    rec.spans = [
        Span(0, None, "actor.step", 0, 1000, 0),
        Span(1, 0, "eval", 100, 900, 0),
        Span(2, 1, "eval.nbt.conv", 110, 200, 0),
        Span(3, 1, "eval.nbt.preact", 200, 300, 0),
        Span(4, 1, "eval.nbt.gpool", 300, 400, 0),
        Span(5, 1, "eval.nbt.conv", 400, 500, 0),
        Span(6, 0, "search.select", 920, 990, 0),
    ]
    rec.step_counters[0].update({"eval.nbt.preact": 73, "eval.nbt.gpool": 6})
    return rec


def _acts():
    from perfbench.spans import Activity

    rows = [(2000, 2400, "conv_kernel", 1, 150),  # in the first conv
            (2400, 2500, "mish", 2, 250),  # in the pre-activation
            (2500, 2530, "mean", 3, 350),  # in the pooling
            (2530, 2560, MARKER, 4, 360),  # a marker: left out
            (2600, 3000, "conv_kernel", 5, 450),  # the second conv
            (3000, 3100, "select", 6, 950)]  # outside the evaluator
    return ([Activity(s, e, n, c) for s, e, n, c, _ in rows],
            {c: t for *_, c, t in rows})


def test_the_join_charges_each_activity_to_its_span():
    kind = harness.find_cell(CELL).kind
    acts, launch_at = _acts()
    j = kind.join(_recording(), acts, launch_at, 0, 1000)
    assert j["eval_calls"] == 1 and j["conv_spans"] == 2
    assert abs(j["conv_s"] - 800e-9) < 1e-15
    assert abs(j["preact_s"] - 100e-9) < 1e-15
    assert abs(j["gpool_s"] - 30e-9) < 1e-15
    assert j["preact_count_per_call"] == 73 and j["gpool_count_per_call"] == 6
    out = kind.join(_recording(), acts, launch_at, 1000, 2000)  # no span inside
    assert out["eval_calls"] == 0 and out["preact_count_per_call"] is None


def _reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py").read


def test_the_readers():
    kind = harness.find_cell(CELL).kind
    acts, launch_at = _acts()
    j = kind.join(_recording(), acts, launch_at, 0, 1000)
    j.update(conv_flops_per_position=1e6, convs_per_call=2)
    s = {"positions": 100, "nbt": j}
    want = 100.0 * 1e6 * 100 / 800e-9 / yardstick.PEAK_OPS["bf16"]
    assert abs(_reader("nbt.conv_bf16_peak_pct")(s) - want) < 1e-9
    assert abs(_reader("nbt.preact_device_us_per_position")(s) - 1e-3) < 1e-12
    assert abs(_reader("nbt.gpool_device_us_per_position")(s) - 3e-4) < 1e-12
    j2 = dict(j, convs_per_call=3)  # the conv spans do not pair up
    assert _reader("nbt.conv_bf16_peak_pct")({"positions": 100, "nbt": j2}) is None
    for name in ("nbt.conv_bf16_peak_pct", "nbt.preact_device_us_per_position",
                 "nbt.gpool_device_us_per_position"):
        assert _reader(name)({"positions": 100}) is None  # no nbt spans
