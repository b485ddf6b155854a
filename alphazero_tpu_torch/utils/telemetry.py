"""Spans and counters at the port's layer boundaries, off unless a
recording is on.

    with telemetry.recording() as rec:
        step(states, generator)          # the program runs as always
    telemetry.export_chrome(rec, "spans.json")

``span(name)`` marks the interval a layer holds the host thread;
``count(name, n)`` adds a host integer; ``count_device(name, t)`` adds the
sum of a device tensor into an accumulator on the device, read once when
the recording ends; ``host_sync(site)`` is the span and count of one
blocking host read.  A span named ``STEP`` (``actor.step``) opens a step:
it and every span inside it carry its id as their step id, and the
counters are kept per step too.

Off (the default), ``span`` and ``host_sync`` return one shared null
context and the counters return at once: nothing is allocated, launched or
synchronised.  On, a span costs two clock reads and two small objects; only
``count_device`` launches (its sum and its add).

Spans stamp ``time.time_ns()``, the clock of ``torch.profiler``'s host
events: a kernel's runtime launch event (``cudaLaunchKernel``), which pairs
with the kernel by correlation id, falls inside the span that launched it.
``export_chrome`` writes the spans on the time base of the profiler's
``export_chrome_trace``, so the two files line up.

One recording at a time, on the thread that runs the program.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import NamedTuple

STEP = "actor.step"
SYNC = "host_sync"
clock = time.time_ns

_NULL = contextlib.nullcontext()
_active: "Recording | None" = None


class Span(NamedTuple):
    id: int
    parent: int | None
    name: str
    start: int  # ns, ``clock``
    end: int
    step: int | None  # id of the enclosing ``actor.step``


class Recording:
    """What one ``recording()`` kept: ``spans`` in the order they closed,
    ``counters`` (name -> total) and ``step_counters`` (step id -> name ->
    count; counts made outside any step are under ``None``)."""

    def __init__(self):
        self.spans: list[Span] = []
        self.step_counters = collections.defaultdict(collections.Counter)
        self.start = self.end = None
        self.pid = os.getpid()
        self.tid = threading.get_native_id()
        self._stack: list[tuple[int, int | None]] = []  # (span id, step id)
        self._device = {}  # (step id, name) -> int64 accumulator

    @property
    def counters(self) -> collections.Counter:
        total = collections.Counter()
        for c in self.step_counters.values():
            total.update(c)
        return total

    def _step(self):
        return self._stack[-1][1] if self._stack else None

    def _close(self):
        """Read the device accumulators, in one transfer."""
        if self._device:
            import torch

            keys = list(self._device)
            values = torch.stack([self._device[k] for k in keys]).tolist()
            for (step, name), v in zip(keys, values):
                self.step_counters[step][name] += v
            self._device.clear()


class _Span:
    __slots__ = ("rec", "name", "id", "start")

    def __init__(self, rec: Recording, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        stack = rec._stack
        self.id = sid = len(rec.spans) + len(stack)
        step = sid if self.name == STEP else (stack[-1][1] if stack else None)
        stack.append((sid, step))
        self.start = clock()
        return self

    def __exit__(self, *exc):
        end = clock()
        rec = self.rec
        stack = rec._stack
        sid, step = stack.pop()
        rec.spans.append(Span(sid, stack[-1][0] if stack else None, self.name,
                              self.start, end, step))
        return False


def span(name: str):
    """A context marking ``name``'s interval; the shared null context when
    no recording is on."""
    rec = _active
    if rec is None:
        return _NULL
    return _Span(rec, name)


def host_sync(site: str):
    """The ``host_sync`` span and one count of ``host_sync.<site>``: wrap
    the blocking host read, not the launches that feed it where the call
    lets the two apart."""
    rec = _active
    if rec is None:
        return _NULL
    rec.step_counters[rec._step()][f"{SYNC}.{site}"] += 1
    return _Span(rec, SYNC)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the host counter ``name``."""
    rec = _active
    if rec is None:
        return
    rec.step_counters[rec._step()][name] += n


def count_device(name: str, t) -> None:
    """Add ``t.sum()`` into the device counter ``name``, with no sync."""
    rec = _active
    if rec is None:
        return
    key = (rec._step(), name)
    acc = rec._device.get(key)
    if acc is None:
        import torch

        acc = rec._device[key] = torch.zeros((), dtype=torch.int64,
                                             device=t.device)
    acc.add_(t.sum())


def active() -> "Recording | None":
    """The recording that is on, or None."""
    return _active


@contextlib.contextmanager
def recording():
    """Turn spans and counters on; yields the ``Recording``, whose device
    counters are read when the context exits."""
    global _active
    if _active is not None:
        raise RuntimeError("a recording is already on")
    rec = Recording()
    rec.start = clock()
    _active = rec
    try:
        yield rec
    finally:
        _active = None
        rec.end = clock()
        rec._close()


# libkineto's ChromeTraceBaseTime: the epoch time floored to whole spans of
# this many seconds, which torch.profiler's ``export_chrome_trace`` subtracts.
_BASE_SECONDS = 7889238


def _base_ns(t_ns: int) -> int:
    s = _BASE_SECONDS
    return t_ns // 1_000_000_000 // s * s * 1_000_000_000


def _us(t_ns: int) -> str:
    return f"{t_ns // 1000}.{t_ns % 1000:03d}"


def export_chrome(rec: Recording, path) -> None:
    """Write ``rec`` as a Chrome trace: each span an ``"X"`` event (its id,
    parent and step in ``args``), each counter one ``"C"`` event at the
    recording's end, all on ``torch.profiler``'s time base."""
    base = _base_ns(rec.start)
    lines = []
    for s in sorted(rec.spans):
        args = json.dumps({"id": s.id, "parent": s.parent, "step": s.step})
        lines.append(
            f'{{"ph":"X","cat":"span","name":{json.dumps(s.name)},'
            f'"pid":{rec.pid},"tid":{rec.tid},"ts":{_us(s.start - base)},'
            f'"dur":{_us(s.end - s.start)},"args":{args}}}')
    for name, v in sorted(rec.counters.items()):
        lines.append(
            f'{{"ph":"C","cat":"counter","name":{json.dumps(name)},'
            f'"pid":{rec.pid},"tid":{rec.tid},"ts":{_us(rec.end - base)},'
            f'"args":{{"value":{v}}}}}')
    with open(path, "w") as f:
        f.write(f'{{"displayTimeUnit":"ms","baseTimeNanoseconds":{base},'
                '"traceEvents":[\n')
        f.write(",\n".join(lines))
        f.write("\n]}\n")
