"""Run one cell as ``run.py`` does, with the program's spans recorded.

    python3 perfbench/spans_run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace 1 [--sync-check]
    python3 perfbench/spans_run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace 0 --alternate

``--trace 1``: the program's spans and counters (``telemetry.recording()``)
are on for the whole window and joined to the device trace
(``perfbench/spans.py``); the result line is ``run.py``'s with the metrics
of ``spans.METRICS`` added, the idle gaps named by the span that launched
the activity ending each gap, and ``info`` holding the join's sums and
shares.  Host time is read from the untraced window steps other than the
check steps (the check steps where no other is left).  ``--sync-check``
runs the first untraced step after the trace under
``torch.cuda.set_sync_debug_mode("warn")`` and lists every synchronising
call by the source line that made it, the program's apart from the
benchmark's, beside the step's ``host_sync`` spans; that step's host time
is not read.

``--trace 0 --alternate``: the window's steps run with the recording on
and off in turn (off first); ``info.alternate`` holds the median step time
of each: the cost of the spans when on.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


class Shared:
    """What the patched actor and tracer share over one run."""

    def __init__(self, mode: str, sync_check: bool):
        self.mode = mode  # "trace" | "alternate"
        self.sync_check = sync_check
        self.rec = None
        self.ctx = None
        self.tracer = None
        self.calls = 0
        self.step_ids = []  # the recorded steps, in window order
        self.on = []  # alternate: whether each window step recorded
        self.sync_step = None  # window index of the sync-checked step
        self.sync_sites = collections.Counter()
        self.check_steps = []
        self.joined = None  # spans.join's sums, once the trace is read

    def begin(self):
        from alphazero_tpu_torch.utils import telemetry

        self.ctx = telemetry.recording()
        self.rec = self.ctx.__enter__()

    def end(self):
        if self.ctx is not None:
            self.ctx.__exit__(None, None, None)
            self.ctx = None


def _site(stack) -> tuple:
    """(``program`` | ``benchmark`` | ``other``, "file:line") of the
    innermost frame of the repository's code."""
    for f in reversed(stack):
        path = Path(f.filename).resolve()
        for part, kind in (("alphazero_tpu_torch", "program"), ("perfbench", "benchmark")):
            if part in path.parts:
                rel = path.relative_to(ROOT) if ROOT in path.parents else path
                return kind, f"{rel}:{f.lineno}"
    return "other", f"{stack[-1].filename}:{stack[-1].lineno}" if stack else "?"


def _synced(shared: Shared, fn, *args):
    import torch

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" in str(message):
            shared.sync_sites[_site(traceback.extract_stack()[:-1])] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            return fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)


def _patch(shared: Shared, traffic):
    """Wrap the cell's first actor (the window's; the second is the
    warm-up's) and the tracer of ``traffic``, the cell's loaded traffic
    module."""
    from alphazero_tpu_torch.selfplay import actor
    from alphazero_tpu_torch.utils import telemetry
    from perfbench import spans

    make, Tracer = actor.make_host_actor, traffic.Tracer

    def make_host_actor(*args, **kw):
        step, states = make(*args, **kw)
        shared.calls += 1
        if shared.calls != 1:
            return step, states

        def window_step(states, generator=None):
            k = len(shared.step_ids) if shared.mode == "trace" else len(shared.on)
            if shared.mode == "alternate":
                on = k % 2 == 1
                shared.on.append(on)
                if on:
                    shared.begin()
                try:
                    return step(states, generator)
                finally:
                    window_step.last_search = step.last_search
                    shared.end()
            if shared.rec is None:
                shared.begin()
            n = len(shared.rec.spans)
            tracer = shared.tracer
            check = (shared.sync_check and shared.sync_step is None
                     and tracer is not None and tracer.window_s is not None)
            try:
                if check:
                    shared.sync_step = k
                    return _synced(shared, step, states, generator)
                return step(states, generator)
            finally:
                window_step.last_search = step.last_search
                new = shared.rec.spans[n:]
                shared.step_ids.append(next(s.id for s in new if s.name == spans.STEP))

        window_step.last_search = None
        return window_step, states

    class SpanTracer(Tracer):
        def start(self):
            shared.tracer = self
            super().start()
            self.t_on = telemetry.clock()

        def stop(self):
            self.t_off = telemetry.clock()
            super().stop()

        def summary(self):
            out = super().summary()
            shared.end()
            rec = shared.rec
            by_id = {s.id: s for s in rec.spans}
            traced = {i for i in shared.step_ids
                      if self.t_on <= by_id[i].start and by_id[i].end <= self.t_off}
            checks = {shared.step_ids[k] for k in shared.check_steps
                      if k < len(shared.step_ids)}
            skip = {shared.step_ids[shared.sync_step]} if shared.sync_step is not None else set()
            untraced = [i for i in shared.step_ids if i not in traced and i not in skip]
            host = [i for i in untraced if i not in checks] or untraced
            acts, launch_at = spans.device_events(self._prof)
            j = spans.join(rec, acts, launch_at, traced, host)
            j["host_from_check_steps"] = bool(host) and set(host) <= checks
            j["idle_gaps_by_kernel"] = out["idle_gaps"]
            out["spans"] = shared.joined = j
            out["idle_gaps"] = j["idle_gaps"]
            return out

    traffic.Tracer = SpanTracer
    actor.make_host_actor = make_host_actor

    def unpatch():
        traffic.Tracer = Tracer
        actor.make_host_actor = make

    shared.unpatch = unpatch


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start,
             sync_check: bool = False, log=print) -> dict:
    """``harness.run`` of ``cell`` with the spans on: the whole window
    joined to the trace where ``trace``, else steps alternating on and
    off."""
    from perfbench import harness, spans

    shared = Shared("trace" if trace else "alternate", sync_check)
    shared.check_steps = [int(k) for k in cell.mix["check_steps"]]
    _patch(shared, cell.kind)
    names = {m["name"] for m in cell.per_layer}
    cell.per_layer += [m for m in spans.METRICS
                       if m["name"] not in names and cell.name in m["workloads"]]
    try:
        result = harness.run(cell, seed, seconds, trace, device, t_start, log=log)
    finally:
        shared.end()
        shared.unpatch()
    info = result["info"]
    if shared.joined is not None:
        j = dict(shared.joined)
        info.update(spans.info(j))
        info["idle_gaps_by_kernel"] = j.pop("idle_gaps_by_kernel")
        j.pop("idle_gaps")
        info["spans"] = j
    if not trace:
        on = [t for t, o in zip(info["step_s"], shared.on) if o]
        off = [t for t, o in zip(info["step_s"], shared.on) if not o]
        info["alternate"] = {
            "on_s": on, "off_s": off,
            "on_median_s": statistics.median(on) if on else None,
            "off_median_s": statistics.median(off) if off else None}
    if shared.sync_step is not None:
        rec = shared.rec
        sid = shared.step_ids[shared.sync_step]
        sites = shared.sync_sites
        info["sync_check"] = {
            "step": shared.sync_step,
            "program_syncs": sum(n for (kind, _), n in sites.items()
                                 if kind == "program"),
            "other_syncs": sum(n for (kind, _), n in sites.items()
                               if kind != "program"),
            "host_sync_spans": sum(s.step == sid and s.name == spans.SYNC
                                   for s in rec.spans),
            "host_sync_counters": {k: v for k, v in rec.step_counters[sid].items()
                                   if k.startswith(spans.SYNC + ".")},
            "sites": {f"{kind} {where}": n for (kind, where), n
                      in sites.most_common()}}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--sync-check", action="store_true")
    ap.add_argument("--alternate", action="store_true")
    args = ap.parse_args(argv)
    if args.alternate == bool(args.trace):
        ap.error("--alternate runs with --trace 0; --trace 1 without it")

    sys.path.insert(0, str(ROOT))
    from perfbench import harness, run

    run._cache_dirs()
    cell = harness.find_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("perfbench: the spans run needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                      T_START, sync_check=args.sync_check, log=log)
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: JAX or the JAX package is loaded: {found}", file=sys.stderr)
        return 3
    log(f"# info: {json.dumps(result['info'])}")
    for name, c in result["checks"].items():
        log(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
