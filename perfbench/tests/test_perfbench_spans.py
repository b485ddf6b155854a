"""The join of the program's spans with the device trace, its readers, and
the spans run of a tiny cell on the CPU."""
import time

import pytest
import torch

from perfbench import harness, spans
from perfbench.trace import MARKER
from alphazero_tpu_torch.utils import telemetry
from alphazero_tpu_torch.utils.telemetry import Span


def _recording():
    """Two steps by hand (ns).  Step 0 [0, 1000]: eval [100, 300] holding
    a chunk [150, 250]; select [400, 600] holding a sync [500, 550].  Step 5
    [2000, 3000]: eval [2100, 2500] holding a sync [2200, 2300]."""
    rec = telemetry.Recording()
    rec.spans = [
        Span(0, None, "actor.step", 0, 1000, 0),
        Span(1, 0, "eval", 100, 300, 0),
        Span(2, 1, "eval.chunk", 150, 250, 0),
        Span(3, 0, "search.select", 400, 600, 0),
        Span(4, 3, "host_sync", 500, 550, 0),
        Span(5, None, "actor.step", 2000, 3000, 5),
        Span(6, 5, "eval", 2100, 2500, 5),
        Span(7, 6, "host_sync", 2200, 2300, 5),
    ]
    rec.step_counters[0].update({"eval.positions": 10, "search.rows": 8,
                                 "search.new_nodes": 6, "host_sync.search.select": 1})
    rec.step_counters[5].update({"eval.positions": 30, "search.rows": 8,
                                 "search.new_nodes": 2, "host_sync.go.step": 1})
    return rec


# (start, end, name, corr) of each activity, and each launch's host time.
ACTS = [
    (1100, 1200, "chunk_gemm", 1),      # launched in the chunk (160)
    (1300, 1310, MARKER + "(long)", 2),  # a marker launched in eval (120)
    (1400, 1500, "select_kernel", 3),   # launched in select, outside the sync (450)
    (1700, 1800, "sync_kernel", 4),     # launched in the sync (520)
    (1900, 1950, "loose_copy", 5),      # launched between steps (1500)
    (1960, 1970, "orphan", 6),          # no launch event
    (2600, 2700, "eval_kernel", 7),     # step 5's eval (2150)
]
LAUNCH_AT = {1: 160, 2: 120, 3: 450, 4: 520, 5: 1500, 7: 2150}


def _join(traced=frozenset({0}), host=(5,)):
    acts = [spans.Activity(*a) for a in ACTS]
    return spans.join(_recording(), acts, LAUNCH_AT, set(traced), list(host))


def test_innermost_span_of_an_instant():
    index = spans.SpanIndex(_recording().spans)
    assert [getattr(index.at(t), "name", None) for t in
            (-1, 0, 120, 160, 250, 350, 520, 600, 1500, 2250, 2400, 3001)] == [
        None, "actor.step", "eval", "eval.chunk", "eval.chunk", "actor.step",
        "host_sync", "search.select", None, "host_sync", "eval", None]
    assert index.in_eval == {0: False, 1: True, 2: True, 3: False, 4: False,
                             5: False, 6: True, 7: True}


def test_the_join_counts_launches_by_layer_and_names_the_gaps():
    j = _join()
    assert (j["eval_launches"], j["outside_eval_launches"]) == (1, 2)
    assert (j["markers"], j["markers_in_eval"]) == (1, 1)
    assert (j["activities"], j["unattributed"]) == (6, 2)
    # Gaps (the marker is no activity here) end at 1400 (select_kernel,
    # 200 ns), 1700 (the sync, 200 ns), 1900 (no span, 100 ns), 1960 (no
    # launch, 10 ns) and 2600 (eval, 630 ns).
    assert dict(j["idle_gaps"]) == pytest.approx({
        "search.select": 200e-9, "host_sync": 200e-9, spans.NO_SPAN: 110e-9,
        "eval": 630e-9})
    # Host time from step 5 alone; its sync lies inside eval.
    assert (j["host_steps"], j["host_positions"]) == (1, 30)
    assert j["host_step_s"] == pytest.approx(1000e-9)
    assert j["host_eval_s"] == pytest.approx(400e-9)
    assert j["host_sync_s"] == 0
    assert dict(j["host_self_s"]) == pytest.approx(
        {"actor.step": 600e-9, "eval": 300e-9, "host_sync": 100e-9})
    assert (j["traced_steps"], j["traced_positions"]) == (1, 10)
    assert (j["steps"], j["spans"], j["syncs"]) == (2, 8, 2)
    assert (j["rows"], j["new_nodes"]) == (16, 8)
    info = spans.info(j)
    assert info["spans_unattributed_pct"] == pytest.approx(100 * 2 / 6)
    assert info["marker_launches_in_eval"] == 100.0
    assert info["spans_per_step"] == 4.0
    assert info["host_sync_wait_ms_per_step"] == 0.0
    assert info["host_self_ms_per_step"]["actor.step"] == pytest.approx(600e-6)


def test_a_sync_outside_eval_is_the_hosts_wait():
    j = _join(traced=(), host=(0,))
    assert j["host_sync_s"] == pytest.approx(50e-9)
    assert j["eval_launches"] == j["outside_eval_launches"] == 0
    assert spans.info(j)["host_sync_wait_ms_per_step"] == pytest.approx(50e-6)


def _read(name, s):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py").read(s)


def test_span_readers_by_hand():
    s = {"spans": _join()}
    assert _read("eval.host_us_per_position", s) == pytest.approx(400e-9 / 30 * 1e6)
    assert _read("eval.launches_per_position", s) == pytest.approx(1 / 10)
    assert _read("search_env.host_ms_per_step", s) == pytest.approx(600e-9 * 1e3)
    assert _read("search_env.launches_per_step", s) == pytest.approx(2.0)
    assert _read("host_sync.count_per_step", s) == pytest.approx(1.0)
    assert _read("search.useful_rows_pct", s) == pytest.approx(50.0)


@pytest.mark.parametrize("name", [m["name"] for m in spans.METRICS])
def test_span_readers_find_nothing_without_spans(name):
    """A run whose program records no spans reports none of them."""
    assert _read(name, {"window_s": 1.0}) is None
    assert (harness.HERE / "metrics" / f"{name}.py").is_file()


def test_the_span_metrics_keep_the_contract():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    layers = {m["layer"] for m in bench["per_layer"]}
    assert not {m["name"] for m in spans.METRICS} & {m["name"] for m in bench["per_layer"]}
    for m in spans.METRICS:
        assert m["layer"] in layers
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["moves"] == "selfplay_moves_per_s"
        assert m["source"] in ("program_span", "program_counter", "device_trace")
        assert set(m["workloads"]) == {"gomoku15-6x64.selfplay", "go9-6x64.selfplay"}


def test_a_tiny_cell_runs_with_the_spans_on(monkeypatch):
    """The spans run's plumbing on the CPU: a profiler of host ops in place
    of the device trace (no activity, so no launch metric)."""
    import torch.profiler as tp

    from perfbench import spans_run
    from perfbench.tests import tiny

    profile = tp.profile
    monkeypatch.setattr(tp, "profile", lambda activities: profile(
        activities=[tp.ProfilerActivity.CPU]))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    cell = tiny.cell("gomoku")
    monkeypatch.setattr(cell.kind, "mark", lambda: None)
    r = spans_run.run_cell(cell, 9876543210123, 0.5, True, torch.device("cpu"),
                           time.perf_counter(), log=lambda m: None)
    assert r["correct"]
    got = set(r["metrics"])
    assert {"eval.host_us_per_position", "search_env.host_ms_per_step",
            "host_sync.count_per_step", "search.useful_rows_pct"} <= got
    assert not got & {"eval.launches_per_position", "search_env.launches_per_step"}
    j = r["info"]["spans"]
    assert j["steps"] == r["info"]["steps"] and j["syncs"] > 0
    assert j["counters"]["search.rows"] == j["rows"] > 0
    assert telemetry.span("x") is telemetry.span("y")  # the recording ended


def test_a_tiny_cell_alternates_spans_on_and_off():
    from perfbench import spans_run
    from perfbench.tests import tiny

    r = spans_run.run_cell(tiny.cell("go"), 9876543210123, 1.0, False,
                           torch.device("cpu"), time.perf_counter(), log=lambda m: None)
    alt = r["info"]["alternate"]
    steps = r["info"]["steps"]
    assert (len(alt["off_s"]), len(alt["on_s"])) == (steps - steps // 2, steps // 2)
    assert alt["on_s"] + alt["off_s"] and sorted(alt["on_s"] + alt["off_s"]) == sorted(
        r["info"]["step_s"])
    assert r["correct"]
