"""Self-play traffic for KataGo's nested-bottleneck net (``block: "nbt"``):
``traffic/selfplay.py``'s loop, unchanged, run from fresh copies of it and
of ``compare.py`` whose names are rebound: ``compare.ref_net`` to the plain
nbt reference (``reference/nbt.py``), the loop's ``ref_go`` to the plain Go
whose ``legal`` scans the groups once (``reference/go_scan.py``: the same
answers, in time for a 19x19 replay of 800 simulations), its
``yardstick.resnet_macs`` to the nbt count (``yardstick_nbt.net_macs``) and
its ``Tracer`` to one that also records the program's spans.  The modules
that the other cells load stay as they are.  Parameters:
``traffic/selfplay.py``'s.

A traced run records the program's spans and counters
(``alphazero_tpu_torch/utils/telemetry.py``) over the traced steps alone,
or reads the recording that is already on (``spans_run.py``'s), and joins
them to the device trace as ``spans.py`` does: each device activity is
charged to the innermost span that holds its launch.  ``summary["nbt"]``
holds the device time of the activities launched in ``eval.nbt.conv``,
``eval.nbt.preact`` and ``eval.nbt.gpool`` spans (the union of their
intervals, a name at a time), the spans and counters a call of the
evaluator, and the trunk convs' FLOPs a position, which the
``metrics/nbt.*`` readers take; the result line's ``info["nbt"]`` repeats
it.
"""
from __future__ import annotations

import collections
import importlib.util
import sys
import types

from perfbench import harness, spans, yardstick_nbt
from perfbench.reference import go_scan
from perfbench.reference import nbt as ref_nbt
from perfbench.trace import MARKER, Tracer, union_length

CONV, PREACT, GPOOL = "eval.nbt.conv", "eval.nbt.preact", "eval.nbt.gpool"
NAMES = (CONV, PREACT, GPOOL)


def join(rec, acts, launch_at, t_on: int, t_off: int) -> dict:
    """Device time by nbt span, and spans and counters, of the evaluator
    calls that ran between ``t_on`` and ``t_off`` (``telemetry.clock``)."""
    index = spans.SpanIndex(rec.spans)
    inside = [s for s in index.spans if t_on <= s.start and s.end <= t_off]
    steps = [s for s in inside if s.name == spans.STEP]
    counters = collections.Counter()
    for s in steps:
        counters.update(rec.step_counters[s.id])
    intervals = collections.defaultdict(list)
    for a in acts:
        t = launch_at.get(a.corr)
        s = index.at(t) if t is not None else None
        if s is not None and s.name in NAMES and MARKER not in a.name:
            intervals[s.name].append((a.start * 1e-9, a.end * 1e-9))
    by_name = collections.Counter(s.name for s in inside)
    calls = by_name[spans.EVAL]
    return {
        "eval_calls": calls,
        "steps": len(steps),
        "conv_s": union_length(intervals[CONV]),
        "preact_s": union_length(intervals[PREACT]),
        "gpool_s": union_length(intervals[GPOOL]),
        "conv_spans": by_name[CONV],
        "activities": {n: len(intervals[n]) for n in NAMES},
        "preact_count_per_call": counters[PREACT] / calls if calls else None,
        "gpool_count_per_call": counters[GPOOL] / calls if calls else None,
    }


def _tracer(base, conv_flops: float, convs_per_call: int):
    """``base`` (the loop's tracer class) with the program's spans recorded
    while it traces."""
    from alphazero_tpu_torch.utils import telemetry

    class NbtTracer(base):
        def start(self):
            super().start()
            self._own = None
            self.rec = telemetry.active()
            if self.rec is None:
                self._own = telemetry.recording()
                self.rec = self._own.__enter__()
            self.t_on_nbt = telemetry.clock()

        def stop(self):
            self.t_off_nbt = telemetry.clock()
            super().stop()
            if self._own is not None:
                self._own.__exit__(None, None, None)

        def summary(self):
            out = super().summary()
            acts, launch_at = spans.device_events(self._prof)
            j = join(self.rec, acts, launch_at, self.t_on_nbt, self.t_off_nbt)
            j.update(conv_flops_per_position=conv_flops,
                     convs_per_call=convs_per_call)
            out["nbt"] = j
            return out

    return NbtTracer


def fresh_copy(name: str):
    """A fresh module of ``perfbench/<name>.py``, registered in
    ``sys.modules`` under a name of its own (its dataclasses look their
    module up there); ``perfbench.<name>`` is left as it is."""
    key = "perfbench_nbt_" + name.replace("/", "_")
    spec = importlib.util.spec_from_file_location(key, harness.HERE / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def run(ctx) -> dict:
    from alphazero_tpu_torch.core import registry

    game, net = ctx.config["game"], ctx.config["net"]
    env = registry.create_game(game["name"], game["board_size"],
                               **game.get("options", {}))
    c_in, h, w = env.observation_shape
    compare = fresh_copy("compare")
    compare.ref_net = ref_nbt
    loop = fresh_copy("traffic/selfplay")
    loop.compare = compare
    loop.ref_go = go_scan
    loop.yardstick = types.SimpleNamespace(resnet_macs=yardstick_nbt.net_macs)
    loop.Tracer = _tracer(Tracer, 2.0 * yardstick_nbt.trunk_conv_macs(net, c_in, h, w),
                          len(yardstick_nbt.trunk_convs(net, c_in)))
    out = loop.run(ctx)
    if "summary" in out:
        out["info"]["nbt"] = out["summary"]["nbt"]
    return out
