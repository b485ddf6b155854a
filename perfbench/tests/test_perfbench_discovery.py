"""Cells, configurations, mixes and metrics are found by name, and
BENCHMARK.json keeps to its contract."""
import json
import re
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_by_name(cell):
    c = harness.find_cell(cell)
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert c.spec["config"] == w["config"] and c.spec["traffic"] == w["traffic"]
    assert c.spec["chips"] == w["chips"] == 1
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    assert callable(c.kind.run)
    for m in c.per_layer:
        mod = harness.load_module(harness.HERE / "metrics" / f"{m['name']}.py")
        assert callable(mod.read)
    assert set(c.spec["limits"]) >= {
        "env_mismatch", "search_visit_mismatch", "search_move_mismatch",
        "policy_tv_max"}
    assert all(c.spec["limits"][k] == 0 for k in (
        "env_mismatch", "search_visit_mismatch", "search_move_mismatch"))


def test_s8_mm_only_where_the_int8_executor_runs():
    go = {m["name"] for m in harness.find_cell("go9-6x64.selfplay").per_layer}
    gomoku = {m["name"] for m in harness.find_cell("gomoku15-6x64.selfplay").per_layer}
    assert "s8_mm_roofline" in gomoku and "s8_mm_roofline" not in go
    assert gomoku - go == {"s8_mm_roofline"}


def test_a_cell_added_by_files_alone_is_found(tmp_path, monkeypatch):
    """A new cell, configuration, mix and metric need new files only."""
    here = tmp_path / "perfbench"
    for sub in ("workloads", "configs", "traffic", "metrics"):
        (here / sub).mkdir(parents=True)
    (here / "configs" / "c.json").write_text('{"x": 1}')
    (here / "traffic" / "m.json").write_text('{"kind": "k"}')
    (here / "traffic" / "k.py").write_text("def run(ctx):\n    return 7\n")
    (here / "metrics" / "new.metric.py").write_text("def read(s):\n    return 1.5\n")
    (here / "workloads" / "c.m.json").write_text(
        '{"config": "c", "traffic": "m", "chips": 1, "limits": {}}')
    bench = {"end_to_end": [{"name": "rate", "unit": "1/s"},
                            {"name": "setup_s", "unit": "s"}],
             "per_layer": [{"name": "new.metric", "unit": "%", "moves": "rate",
                            "workloads": ["c.m"]}]}
    monkeypatch.setattr(harness, "HERE", here)
    c = harness.find_cell("c.m", bench=bench)
    assert c.config == {"x": 1} and c.kind.run(None) == 7
    assert [m["name"] for m in c.per_layer] == ["new.metric"]
    assert harness.load_module(here / "metrics" / "new.metric.py").read({}) == 1.5


def test_unknown_cell_exits():
    with pytest.raises(SystemExit):
        harness.find_cell("no-such-cell")


def test_benchmark_json_keeps_its_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51 and (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert entry["name"] not in names
            names.add(entry["name"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["reduced"] == []
    cfg_names = {c["name"] for c in BENCH["configs"]}
    assert {w["config"] for w in BENCH["workloads"]} == cfg_names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    assert len(json.dumps(BENCH)) < 64 * 1024
