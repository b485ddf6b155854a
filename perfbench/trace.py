"""A device trace of whole steps, read into the sums the per-layer metrics
take.

``Tracer`` profiles the device with ``torch.profiler`` (CUPTI activity
tracing) between two synchronised points; ``summary()`` reads the raw
events once:

* every device activity (kernels, copies, fills) as an interval, merged
  into their union: ``busy_s``;
* the activities between two marker kernels, which the benchmark enqueues
  around each call of the evaluator (one stream runs in order), and the
  union of their intervals: ``range_busy_s``;
* device time by kernel name, and the idle gaps between activities named
  by the activity that ends the gap and whether it is the evaluator's.

Launch shapes are recorded by ``LaunchLog``, which wraps the program's
kernel wrappers where the program calls them, for the traced steps only.
"""
from __future__ import annotations

import collections
import contextlib
import re
import time

import torch

def union_length(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        elif e > end:
            end = e
    if end is not None:
        total += end - start
    return total


def gaps(intervals):
    """(gap length, index of the interval that ends the gap) between the
    merged ``(start, end)`` intervals, in time order."""
    order = sorted(range(len(intervals)), key=lambda i: intervals[i])
    out, end = [], None
    for i in order:
        s, e = intervals[i]
        if end is not None and s > end:
            out.append((s - end, i))
        end = e if end is None else max(end, e)
    return out


_FUNCTOR = re.compile(r"\w*(Functor|_kernel_cuda|launch_\w+|Ops)\w*(<[\w:, ]*>)?")
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel


def mark():
    """A marker kernel on the current stream: the evaluator's calls are
    bracketed by two, so the kernels between them are the evaluator's."""
    torch.cuda._sleep(0)


class Tracer:
    """CUPTI activity tracing of the device alone (no host ops recorded,
    which would slow the host loop the trace is meant to see)."""

    def __init__(self, device):
        self.device = device
        self.window_s = None
        self._prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self):
        torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self._t0
        self._prof.stop()

    def summary(self) -> dict:
        t0 = time.perf_counter()
        events = self._prof.profiler.kineto_results.events()
        device = sorted((e.start_ns(), e.duration_ns(), e.name()) for e in events
                        if e.device_type() != torch.autograd.DeviceType.CPU)
        intervals, in_eval, names, by_name = [], [], [], collections.Counter()
        count = collections.Counter()
        inside = False
        markers = 0
        for s, d, name in device:
            if MARKER in name:
                inside = not inside
                markers += 1
                continue
            intervals.append((s * 1e-9, (s + d) * 1e-9))
            in_eval.append(inside)
            names.append(name)
            by_name[name] += d * 1e-9
            count[name] += 1
        gap_by = collections.Counter()
        for g, i in gaps(intervals):
            where = "eval" if in_eval[i] else "search_env"
            gap_by[f"before {short(names[i])} ({where})"] += g
        by_label = collections.Counter()
        for name, t in by_name.items():
            by_label[short(name)] += t
        return {
            "busy_s": union_length(intervals),
            "range_busy_s": union_length(
                [iv for iv, ev in zip(intervals, in_eval) if ev]),
            "kernel_s": dict(by_name),
            "kernel_count": count,
            "device_ops": by_label.most_common(10),
            "markers": markers,
            "idle_gaps": gap_by.most_common(10),
            "events": len(events),
            "read_s": time.perf_counter() - t0,
        }


def short(name: str) -> str:
    """A kernel's name without its template and argument lists, and with
    the functor of PyTorch's elementwise and reduce kernels."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    head = name.split("(")[0].split("<")[0].strip()[:80]
    inner = list(dict.fromkeys(m.group(0) for m in _FUNCTOR.finditer(name[len(head):])))
    return f"{head} [{' '.join(inner[:2])}]" if inner else head


class LaunchLog:
    """Shapes of each launch of the wrapped kernel wrappers: ``s8_mm`` as
    ``(M, K, N, route)``, ``gather_rows`` / ``gather_rows_many`` as
    ``(rows, [row bytes of each arena], index bytes)``."""

    def __init__(self):
        self.s8_mm = []
        self.gather = []

    @contextlib.contextmanager
    def patched(self):
        from alphazero_tpu_torch.mcts import search
        from alphazero_tpu_torch.models import quant
        from alphazero_tpu_torch.ops import gather_rows as gr
        from alphazero_tpu_torch.ops import s8_mm as s8

        orig = (quant.s8_mm, search.gather_rows, search.gather_rows_many)

        def s8_mm(a, b):
            n = s8.s8_mm.launches
            out = orig[0](a, b)
            if s8.s8_mm.launches != n:
                M, K = a.shape
                N = b.shape[1]
                self.s8_mm.append((M, K, N, s8.s8_mm_route(N, K)))
            return out

        def log_gather(arrs, idx):
            rows = idx.numel()
            self.gather.append((rows, [a.shape[2] * a.element_size()
                                       for a in arrs],
                                8 if idx.dtype == torch.int64 else 4))

        def gather_rows(arr, idx):
            n = gr.gather_rows.launches
            out = orig[1](arr, idx)
            if gr.gather_rows.launches != n:
                log_gather([arr], idx)
            return out

        def gather_rows_many(arrs, idx):
            n = gr.gather_rows.launches
            out = orig[2](arrs, idx)
            if gr.gather_rows.launches != n:
                log_gather(list(arrs), idx)
            return out

        quant.s8_mm = s8_mm
        search.gather_rows, search.gather_rows_many = gather_rows, gather_rows_many
        try:
            yield self
        finally:
            quant.s8_mm, search.gather_rows, search.gather_rows_many = orig
