"""The program's spans (``alphazero_tpu_torch/utils/telemetry.py``) joined to
the device trace, read into the sums the span metrics take.

Each device activity pairs with its host launch (the runtime event of the
same correlation id), and the launch with the innermost span whose
interval holds it: spans and the profiler's host events share one clock.
From that:

* launches by layer in the traced steps: inside an ``eval`` span (the
  evaluator) or inside ``actor.step`` and outside ``eval`` (actor, search
  and env), markers (``trace.MARKER``) left out;
* the idle gaps between activities, named by the span that launched the
  activity ending the gap (``(no span)`` where no span holds its launch);
* host time by layer in the untraced steps (no profiler, no stretch):
  ``actor.step`` wall time, its ``eval`` spans, its ``host_sync`` spans,
  and each span name's self time (its spans' time less their children's);
* the counters of every recorded step: ``host_sync.*``,
  ``eval.positions``, ``search.rows``, ``search.new_nodes``.

``METRICS`` are the per-layer metrics that read these sums
(``metrics/<name>.py``, from ``summary["spans"]``).
"""
from __future__ import annotations

import bisect
import collections
from typing import NamedTuple

from perfbench.trace import MARKER, gaps

STEP = "actor.step"
EVAL = "eval"
SYNC = "host_sync"
NO_SPAN = "(no span)"

METRICS = [
    {"name": "eval.host_us_per_position", "unit": "us/position", "better": "lower",
     "source": "program_span", "layer": "executor"},
    {"name": "eval.launches_per_position", "unit": "launches/position",
     "better": "lower", "source": "device_trace", "layer": "executor"},
    {"name": "search_env.host_ms_per_step", "unit": "ms/step", "better": "lower",
     "source": "program_span", "layer": "actor, search and env"},
    {"name": "search_env.launches_per_step", "unit": "launches/step",
     "better": "lower", "source": "device_trace", "layer": "actor, search and env"},
    {"name": "host_sync.count_per_step", "unit": "syncs/step", "better": "lower",
     "source": "program_counter", "layer": "actor, search and env"},
    {"name": "search.useful_rows_pct", "unit": "%", "better": "higher",
     "source": "program_counter", "layer": "actor, search and env"},
]
for _m in METRICS:
    _m.update(moves="selfplay_moves_per_s",
              workloads=["gomoku15-6x64.selfplay", "go9-6x64.selfplay"])


class Activity(NamedTuple):
    start: int  # ns
    end: int
    name: str
    corr: int  # correlation id of its launch


def device_events(prof):
    """``(activities, launch_at)`` of a stopped ``torch.profiler`` run:
    every device activity, and the start of the host runtime call of each
    correlation id (the earliest host event of that id: CUDA's own work
    inside a launch, such as loading a module, carries the launch's id)."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    acts, launch_at = [], {}
    for e in prof.profiler.kineto_results.events():
        corr = e.correlation_id()
        if e.device_type() == cpu:
            if corr:
                t = e.start_ns()
                launch_at[corr] = min(t, launch_at.get(corr, t))
        else:
            s = e.start_ns()
            acts.append(Activity(s, s + e.duration_ns(), e.name(), corr))
    return acts, launch_at


class SpanIndex:
    """The innermost span holding an instant, with its step and whether it
    lies in an ``eval`` span."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s.start, s.id))
        self.starts = [s.start for s in self.spans]
        self.by_id = {s.id: s for s in self.spans}
        self.in_eval = {}
        for s in self.spans:  # parents start first
            p = self.in_eval.get(s.parent, False) if s.parent is not None else False
            self.in_eval[s.id] = s.name == EVAL or p

    def at(self, t: int):
        i = bisect.bisect_right(self.starts, t) - 1
        s = self.spans[i] if i >= 0 else None
        while s is not None and s.end < t:
            s = self.by_id.get(s.parent) if s.parent is not None else None
        return s


def _dur(spans) -> float:
    return sum(s.end - s.start for s in spans) * 1e-9


def join(rec, acts, launch_at, traced_steps, host_steps) -> dict:
    """The sums ``METRICS`` read and the span-named idle gaps.

    ``rec`` is the window's ``telemetry.Recording``; ``acts`` and
    ``launch_at`` the traced steps' device events (``device_events``);
    ``traced_steps`` and ``host_steps`` the step ids of the traced steps
    and of the untraced steps whose host time is read."""
    index = SpanIndex(rec.spans)
    steps = [s for s in index.spans if s.name == STEP]
    per_step = collections.defaultdict(list)
    for s in index.spans:
        per_step[s.step].append(s)

    # --- host time and counters ---
    host = [s for k in host_steps for s in per_step[k]]
    host_sync = [s for s in host if s.name == SYNC and not index.in_eval[s.id]]
    self_s = collections.Counter()
    for s in host:
        self_s[s.name] += (s.end - s.start) * 1e-9
        if s.parent is not None and s.name != STEP:
            p = index.by_id[s.parent]
            self_s[p.name] -= (s.end - s.start) * 1e-9
    positions = {k: rec.step_counters[k]["eval.positions"] for k in per_step}
    counters = collections.Counter()
    for s in steps:
        counters.update(rec.step_counters[s.id])
    syncs = sum(v for k, v in counters.items() if k.startswith(SYNC + "."))

    # --- launches and gaps in the traced steps ---
    launches = collections.Counter()
    markers = markers_in_eval = unattributed = 0
    intervals, where = [], []
    for a in acts:
        t = launch_at.get(a.corr)
        s = index.at(t) if t is not None else None
        if MARKER in a.name:
            markers += 1
            markers_in_eval += s is not None and index.in_eval[s.id]
            continue
        intervals.append((a.start, a.end))
        where.append(s)
        if s is None:
            unattributed += 1
        elif s.step in traced_steps:
            launches["eval" if index.in_eval[s.id] else "outside_eval"] += 1
    gap_by = collections.Counter()
    for g, i in gaps(intervals):
        gap_by[where[i].name if where[i] is not None else NO_SPAN] += g * 1e-9

    return {
        "steps": len(steps),
        "spans": len(index.spans),
        "host_steps": len(host_steps),
        "host_step_s": _dur(s for s in host if s.name == STEP),
        "host_eval_s": _dur(s for s in host if s.name == EVAL),
        "host_sync_s": _dur(host_sync),
        "host_positions": sum(positions[k] for k in host_steps),
        "host_self_s": self_s.most_common(),
        "traced_steps": len(traced_steps),
        "traced_positions": sum(positions[k] for k in traced_steps),
        "eval_launches": launches["eval"],
        "outside_eval_launches": launches["outside_eval"],
        "activities": len(intervals),
        "unattributed": unattributed,
        "markers": markers,
        "markers_in_eval": markers_in_eval,
        "syncs": syncs,
        "counters": dict(counters),
        "rows": counters["search.rows"],
        "new_nodes": counters["search.new_nodes"],
        "idle_gaps": gap_by.most_common(10),
    }


def info(j: dict) -> dict:
    """The ``info`` entries of a traced run: the host's wait in syncs, the
    share of activities no span launched, the markers launched inside
    ``eval`` (100 % when spans and trace share a clock), spans a step, and
    each span name's host self time a step."""
    def pct(a, b):
        return 100.0 * a / b if b else None

    return {
        "host_sync_wait_ms_per_step": (j["host_sync_s"] / j["host_steps"] * 1e3
                                       if j["host_steps"] else None),
        "spans_unattributed_pct": pct(j["unattributed"], j["activities"]),
        "marker_launches_in_eval": pct(j["markers_in_eval"], j["markers"]),
        "spans_per_step": j["spans"] / j["steps"] if j["steps"] else None,
        "host_self_ms_per_step": {n: v / j["host_steps"] * 1e3
                                  for n, v in j["host_self_s"]} if j["host_steps"] else None,
    }
