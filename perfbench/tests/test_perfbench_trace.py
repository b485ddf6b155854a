"""The interval arithmetic of the device trace and the readers on it."""
import collections

import pytest

from perfbench import harness, trace


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0, 1)], 1.0),
    ([(0, 1), (2, 3)], 2.0),
    ([(0, 2), (1, 3)], 3.0),  # overlap counted once
    ([(0, 10), (1, 2), (3, 4)], 10.0),  # nested
    ([(5, 6), (0, 1), (0.5, 5.5)], 6.0),  # unsorted, chained
    ([(0, 1), (1, 2)], 2.0),  # touching
])
def test_union_length(intervals, want):
    assert trace.union_length(intervals) == pytest.approx(want)


def test_gaps_name_the_activity_that_ends_them():
    iv = [(0, 1), (0.5, 2), (3, 4), (7, 8)]
    assert trace.gaps(iv) == [(1, 2), (3, 3)]
    assert trace.gaps([(3, 4), (0, 1)]) == [(2, 0)]


def _summary(**kw):
    s = {"window_s": 2.0, "busy_s": 1.5, "range_busy_s": 1.0, "steps": 2,
         "positions": 1000, "kernel_s": {}, "kernel_count": collections.Counter(),
         "launches": trace.LaunchLog()}
    s.update(kw)
    return s


def _read(name, s):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py").read(s)


def test_layer_readers_by_hand():
    s = _summary()
    assert _read("device_idle_pct.selfplay", s) == pytest.approx(25.0)
    assert _read("eval.device_us_per_position", s) == pytest.approx(1000.0)
    assert _read("search_env.device_ms_per_step", s) == pytest.approx(250.0)
    assert _read("s8_mm_roofline", s) is None  # no launch: nothing
    assert _read("gather_rows_roofline", s) is None


def test_roofline_readers_pair_launches_with_kernels():
    from perfbench import yardstick

    log = trace.LaunchLog()
    log.s8_mm = [(115200, 576, 64, "resident")] * 3
    log.gather = [(16384, [225, 48], 8)] * 2
    name_s8 = "void s8_resident_kernel<64>(CUtensorMap, ...)"
    name_g = "void gather_rows_kernel<long>(Table, ...)"
    least_s8 = yardstick.least_time(*yardstick.s8_mm_cost(115200, 576, 64), "int8")
    least_g = yardstick.least_time(*yardstick.gather_cost(16384, [225, 48], 8), "int8")
    s = _summary(launches=log,
                 kernel_s={name_s8: 3 * least_s8 / 0.8, name_g: 2 * least_g / 0.1},
                 kernel_count=collections.Counter({name_s8: 3, name_g: 2}))
    assert _read("s8_mm_roofline", s) == pytest.approx(80.0)
    assert _read("gather_rows_roofline", s) == pytest.approx(10.0)
    s["kernel_count"][name_s8] = 4  # a launch the log missed
    assert _read("s8_mm_roofline", s) is None


def test_the_traced_window_is_paced_by_the_untraced_steps():
    from perfbench.traffic import selfplay

    # Two untraced steps of 10 s and 12 s, one traced step stretched to
    # 22 s by the profiler, one more untraced of 11 s: 1 x 11 s.
    assert selfplay.paced_window([10.0, 12.0, 22.0, 11.0],
                                 [False, False, True, False]) == 11.0
    assert selfplay.paced_window([1.0, 3.0, 9.0, 9.0],
                                 [False, False, True, True]) == 4.0
