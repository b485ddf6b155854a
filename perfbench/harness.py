"""Runs one cell once and builds the result line.

Everything is found by name: the cell ``workloads/<cell>.json`` names its
configuration ``configs/<config>.json`` and its traffic mix
``traffic/<mix>.json``, whose ``kind`` is the generator
``traffic/<kind>.py`` (a module with ``run(ctx) -> dict``); each per-layer
metric ``<name>`` of ``BENCHMARK.json`` is read by ``metrics/<name>.py``
(``read(summary) -> float | None``).  ``BENCHMARK.json`` says which
metrics each cell reports.
"""
from __future__ import annotations

import copy
import dataclasses
import hashlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Callable

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "alphazero_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    name = "perfbench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def merge(base: dict, over: dict | None) -> dict:
    """``base`` with ``over``'s keys, nested dicts merged key by key."""
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def seed_for(seed: int, tag: str) -> int:
    """A 63-bit seed for ``tag`` drawn from the run's seed."""
    digest = hashlib.sha256(f"{seed}/{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


@dataclasses.dataclass
class Cell:
    name: str
    spec: dict  # workloads/<cell>.json
    config: dict
    mix: dict
    kind: object  # the traffic generator module
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list


def find_cell(name: str, bench: dict | None = None, overrides: dict | None = None) -> Cell:
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    path = HERE / "workloads" / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"perfbench: no cell {name!r} ({path})")
    overrides = overrides or {}
    spec = merge(load_json(path), overrides.get("cell"))
    config = merge(load_json(HERE / "configs" / f"{spec['config']}.json"),
                   overrides.get("config"))
    mix = merge(load_json(HERE / "traffic" / f"{spec['traffic']}.json"),
                overrides.get("mix"))
    kind = load_module(HERE / "traffic" / f"{mix['kind']}.py")

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if applies(m) and m["moves"] in e2e_names]
    return Cell(name, spec, config, mix, kind, e2e, layer)


@dataclasses.dataclass
class Context:
    device: object
    seed: int
    seconds: float
    trace: bool
    config: dict
    mix: dict
    t_start: float
    log: Callable = print

    def seed_for(self, tag: str) -> int:
        return seed_for(self.seed, tag)

    def gen(self, tag: str):
        import torch

        return torch.Generator(device=self.device).manual_seed(self.seed_for(tag))


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def verdict(numbers: dict, limits: dict):
    """``(checks, correct)``: each number the cell's ``limits`` name beside
    its limit, and whether every one lies within it."""
    checks = {name: {"value": numbers[name], "limit": limit}
              for name, limit in limits.items()}
    return checks, all(c["value"] <= c["limit"] for c in checks.values())


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, log=print) -> dict:
    """Run the cell once; the result line as a dict (``checks`` last).

    The traffic kind's ``run(ctx)`` returns ``outcome`` (``numbers``,
    ``failed``, ``info``), ``attempted``, ``memory_peak_bytes``, ``e2e``
    (the end-to-end metrics by name) and ``info``; a traced run adds
    ``summary`` (what the per-layer readers read), ``device`` (``busy_s``,
    ``window_s``) and ``breakdown``, copied as they are."""
    import torch

    ctx = Context(device=device, seed=seed, seconds=seconds, trace=trace,
                  config=cell.config, mix=cell.mix, t_start=t_start, log=log)
    out = cell.kind.run(ctx)
    outcome = out["outcome"]
    limits = cell.spec["limits"]
    checks, correct = verdict(outcome.numbers, limits)

    metrics = {}
    if trace:
        for m in cell.per_layer:
            reader = load_module(HERE / "metrics" / f"{m['name']}.py")
            value = reader.read(out["summary"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}

    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": 1, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    else:
        dev = {"platform": device.type, "kind": device.type, "count": 1,
               "memory_peak_bytes": 0}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(outcome.failed), "metrics": metrics, "device": dev}
    if trace:
        dev.update(out["device"])
        result["breakdown"] = out["breakdown"]
    result["info"] = dict(outcome.info, **{k: v for k, v in outcome.numbers.items()
                                           if k not in limits}, **out["info"])
    result["checks"] = checks
    return result
