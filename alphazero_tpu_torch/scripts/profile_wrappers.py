"""Host cost of the kernel wrappers: eager time against CUDA-graph time.

For ``gather_rows`` and ``gather_rows_many`` at the search's shapes and
``s8_mm`` at the int8 trunk's and the probes' shapes, one JSON line each with

  ``ms``        calls issued back to back from Python, by CUDA events: what
                a call costs its caller, the wrapper's host work included;
  ``graph_ms``  the same calls replayed from a CUDA graph: device time alone;
  ``host_us``   Python wall time of one call, the device never the limit
                (synchronised after every batch of 64 calls): the wrapper's
                own cost, as the median and the least of the batches' means,
                since other tenants of the host's cores disturb single
                batches.

    python alphazero_tpu_torch/scripts/profile_wrappers.py [--reps 640] [--pieces]

``--pieces`` adds one line with the least time of each piece of one
``s8_mm`` call (argument check, routing, alignment check, output
allocation, the C call that encodes the tensor map and launches) beside a
bare ``torch.add`` on the same host; it reaches into ``ops/s8_mm.py`` and so
needs a checkout that has those pieces.  It also times the two ways
``gather_rows_many`` could allocate a level's four outputs: one
``torch.empty`` each, or one buffer carved into views.

Run as a file, it measures whichever checkout of the package comes first on
``PYTHONPATH`` (so two trees can be compared in one go on one card);
the first line names that checkout.  It carries its own timers and uses
nothing of the package but the wrappers, so that it also runs against a
checkout older than itself (one without ``gather_rows_many`` skips its
lines).
"""
from __future__ import annotations

import argparse
import json
import time

import torch

import alphazero_tpu_torch
from alphazero_tpu_torch.ops import gather_rows as gather_ops
from alphazero_tpu_torch.ops.gather_rows import gather_rows
from alphazero_tpu_torch.ops.s8_mm import s8_mm

gather_rows_many = getattr(gather_ops, "gather_rows_many", None)

# A level's arenas as the search reads them at one index (K, dtype): the
# terminal flag, slot priors, child pointers, node stats; and a wave's leaf
# rows: board, meta, terminal value.
LEVEL = ((1, torch.bool), (32, torch.bfloat16), (32, torch.int32), (2, torch.float32))
LEAF = ((225, torch.int8), (12, torch.int32), (1, torch.float32))


def cuda_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, 5) / reps


def host_us(fn, reps: int) -> dict:
    fn()
    batches = []
    for _ in range(max(1, reps // 64)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(64):
            fn()
        batches.append((time.perf_counter() - t0) / 64 * 1e6)
    torch.cuda.synchronize()
    batches.sort()
    return {"median": batches[len(batches) // 2], "least": batches[0]}


def least_us(fn, calls: int = 2000, rounds: int = 5) -> float:
    """Least mean Python wall time of one call over ``rounds`` rounds."""
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return best


def pieces() -> dict:
    """Host microseconds of each piece of one resident ``s8_mm`` call at a
    size whose device time is no limit ([256, 128] x [128, 64])."""
    from alphazero_tpu_torch.ops import _build
    from alphazero_tpu_torch.ops import s8_mm as ops

    a = torch.zeros((256, 128), dtype=torch.int8, device="cuda")
    b = torch.zeros((128, 64), dtype=torch.int8, device="cuda")
    out = s8_mm(a, b)
    fns = ops._bind()
    ptrs = (a.data_ptr(), b.data_ptr(), out.data_ptr())
    stream = _build.stream_of(a)
    return {
        "check_pair": least_us(lambda: ops._check_pair("s8_mm", a, b, (torch.int8,))),
        "route": least_us(lambda: ops.s8_mm_route(b.shape[1], a.shape[1])),
        "rows16": least_us(lambda: ops._rows16(a)),
        "empty": least_us(lambda: torch.empty((256, 64), dtype=torch.int32,
                                              device=a.device)),
        "pointers_and_stream": least_us(lambda: (
            a.data_ptr(), b.data_ptr(), out.data_ptr(), _build.stream_of(a))),
        "c_call": least_us(lambda: fns.resident(*ptrs, 256, 64, 128, 128, stream)),
        "whole_s8_mm": least_us(lambda: s8_mm(a, b)),
        "torch_add": least_us(lambda: torch.add(out, 1)),
        **alloc_ways(),
    }


def alloc_ways() -> dict:
    """Host microseconds of the two ways to allocate a level's four
    ``gather_rows_many`` outputs at B=1024, W=16."""
    B, M = 1024, 16
    sizes = [B * M * K * torch.empty((), dtype=dt).element_size() for K, dt in LEVEL]
    offs = [sum(-(-n // 16) * 16 for n in sizes[:k]) for k in range(len(sizes))]
    end = offs[-1] + sizes[-1]

    def per_output():
        return [torch.empty((B, M, K), dtype=dt, device="cuda") for K, dt in LEVEL]

    def carved():
        buf = torch.empty(end, dtype=torch.uint8, device="cuda")
        return [buf[o:o + n].view(dt).view(B, M, K)
                for o, n, (K, dt) in zip(offs, sizes, LEVEL)]

    return {"many_alloc_one_empty_per_output": least_us(per_output),
            "many_alloc_one_buffer_carved": least_us(carved)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--reps", type=int, default=640)
    p.add_argument("--pieces", action="store_true",
                   help="also time the pieces of one s8_mm call")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_wrappers needs a CUDA card")
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "package": alphazero_tpu_torch.__file__}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    # gather_rows at B=1024, N=801 nodes: child stats (f32 pairs, 512 rows a
    # lane) and leaf boards (225-byte rows, 16 a lane).
    for name, K, M, dtype in (("child_stats", 2, 512, torch.float32),
                              ("leaf_boards", 225, 16, torch.int8)):
        arr = torch.randint(-100, 100, (1024, 801, K), generator=gen,
                            device="cuda").to(dtype)
        idx = torch.randint(0, 801, (1024, M), generator=gen, device="cuda",
                            dtype=torch.int32)
        cases.append(("gather_rows", name, lambda arr=arr, idx=idx: gather_rows(arr, idx)))
    # a level's and a wave's arenas: one launch, against one a arena
    for name, arenas in (("level_rows", LEVEL), ("leaf_rows", LEAF)):
        arrs = tuple(torch.randint(0, 100, (1024, 801, K), generator=gen,
                                   device="cuda").to(dt) for K, dt in arenas)
        idx = torch.randint(-1, 801, (1024, 16), generator=gen, device="cuda",
                            dtype=torch.int32)
        if gather_rows_many is not None:
            cases.append(("gather_rows_many", name,
                          lambda arrs=arrs, idx=idx: gather_rows_many(arrs, idx)))
        cases.append(("gather_rows x" + str(len(arrs)), name,
                      lambda arrs=arrs, idx=idx: [gather_rows(a, idx) for a in arrs]))
    for name, M, K, N in (("conv3x3_64", 115200, 576, 64),
                          ("head_1x1", 115200, 64, 32),
                          ("probe_128x64", 14400, 128, 64),
                          ("probe_576x64", 14400, 576, 64)):
        a = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                          dtype=torch.int8)
        cases.append(("s8_mm", name, lambda a=a, b=b: s8_mm(a, b)))
    for kernel, name, fn in cases:
        ms, g = cuda_ms(fn, min(args.reps, 200)), graph_ms(fn, min(args.reps, 50))
        print(json.dumps({"kernel": kernel, "case": name, "ms": ms,
                          "graph_ms": g, "eager_minus_graph_us": (ms - g) * 1e3,
                          "host_us": host_us(fn, args.reps)}), flush=True)
    if args.pieces:
        print(json.dumps({"s8_mm_pieces_us": pieces()}), flush=True)


if __name__ == "__main__":
    main()
