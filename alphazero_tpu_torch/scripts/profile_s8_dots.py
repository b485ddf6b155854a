"""Time the hand-written s8 / bf16 products at the probes' own shapes.

One counterpart of the JAX package's three probe tools
(``tools/profile_fused_shapes.py``, ``tools/profile_inkernel_dot.py``,
``tools/profile_pallas_mm.py``): every case runs its kernel of
``ops/s8_mm.py`` on the card, holds the result against the plain PyTorch
version (s8: bit for bit; bf16: within ``BF16_TOL`` of the largest
reference value; a chained dot at no more than ``CHECK_CHAIN`` steps) and
prints one JSON line with the time by CUDA events (``ms``: eager calls, the
wrapper's host cost included; ``graph_ms``: the same calls replayed from a
CUDA graph, device time alone), the achieved TOP/s, the plain version's time
and the roofline bound (operations at the tensor cores' peak against bytes
at the memory's rate).  Before the timed cases, ``edge_cases()`` are checked
without timing: ragged M, N and K on each side of every tile edge, several
rounds of the persistent grid, both routes of ``s8_mm`` and
``s8_mm_multi``, -128 among the values, inputs that are strided, misaligned
or pitched.  After them, ``multi_prologue_cases()`` time ``s8_mm_multi`` on
one tile of rows, where the launch and the image of ``b`` are all there is.

    python -m alphazero_tpu_torch.scripts.profile_s8_dots [--reps 20] [--chain 64] [--only chained_dot]

To time another checkout's kernels with these cases (an earlier commit
unpacked with ``git archive``), run this file by its path with that
checkout first on ``PYTHONPATH``.

The package calls no library product of the same function, so
``library_ms`` is null here; ``chip_smoke.py`` passes its yardstick calls
in through ``run_case(..., library=...)``.
"""
from __future__ import annotations

import argparse
import json
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from alphazero_tpu_torch.ops import s8_mm as ops

# H100 SXM data sheet: dense tensor-core peaks and HBM3 rate.
PEAK_OPS = {torch.int8: 1979e12, torch.bfloat16: 989e12}
HBM_BYTES_PER_S = 3.35e12
# bf16 -> f32: kernel and plain version both sum in f32 but in another order
# (relative 1e-4 of the largest value covers K = 2048).  chained_dot rounds
# to bf16 between its products, where a differing last f32 bit can flip a
# rounding (2**-8 relative) that the following products carry along.
BF16_TOL = {"tiled_mm": 1e-4, "chained_dot": 2e-2}
CHECK_CHAIN = 8  # chained_dot is checked at R <= 8 and timed at its own R


class Case(NamedTuple):
    kernel: str  # wrapper name in ops/s8_mm.py
    name: str
    dtype: torch.dtype
    a_shape: Tuple[int, int]
    b_shape: Tuple[int, ...]
    R: int = 0  # chained_dot only
    # How the inputs lie in memory: "dense"; "strided" (every other column
    # of a wider `a`, `b` a transposed view: both must be copied);
    # "misaligned" (bases one element past a 16-byte boundary); "pitched"
    # (`a` the first K columns of a wider matrix whose pitch is a multiple
    # of 16 bytes, other data behind them: read in place); "im2col" (the
    # same with the least such pitch, as ``models/quant._im2col`` lays it).
    layout: str = "dense"
    lowest: int = -127  # smallest s8 value drawn; -128 is forced in if asked


def probe_cases(chain: int):
    """The probe tools' shapes.  ``chain``: R of the chained-dot cases."""
    s8, bf = torch.int8, torch.bfloat16
    M = 14400  # 64 boards x 15 x 15
    cases = [Case("s8_mm", f"probe_{K}x{N}", s8, (M, K), (K, N))
             for K, N in ((128, 64), (128, 128), (576, 64), (640, 128))]
    # the probe's taps, the executor's chunk of 512 boards, and the tiled route
    cases += [Case("s8_mm_multi", "probe_5x128x64", s8, (M, 128), (5, 128, 64)),
              Case("s8_mm_multi", "chunk_5x128x64", s8, (512 * 225, 128), (5, 128, 64)),
              Case("s8_mm_multi", "tiled_5x576x128", s8, (M, 576), (5, 576, 128))]
    cases += [Case("chained_dot", f"s8_{m}x{K}x{N}", s8, (m, K), (K, N), chain)
              for m, K, N in ((3600, 128, 64), (3600, 128, 128), (3600, 256, 128),
                              (1800, 640, 128), (3600, 640, 64), (7200, 128, 64),
                              (3600, 576, 64))]
    cases += [Case("chained_dot", f"bf16_{m}x{K}x{N}", bf, (m, K), (K, N), chain)
              for m, K, N in ((3600, 128, 128), (3600, 128, 64))]
    cases += [Case("tiled_mm", "s8_8192x2048x2048", s8, (8192, 2048), (2048, 2048)),
              Case("tiled_mm", "bf16_8192x2048x2048", bf, (8192, 2048), (2048, 2048))]
    return cases


def trunk_cases(boards: int = 512, cells: int = 225):
    """``s8_mm`` at the int8 trunk's shapes for one chunk of ``boards``
    15x15 positions: the 3x3 conv in im2col form, the stem (densely packed,
    which ``s8_mm`` must copy to a 16-byte pitch, and as the executor's
    im2col hands it over, with a 112-byte pitch) and a 1x1 head."""
    M = boards * cells
    return [Case("s8_mm", "conv3x3_64", torch.int8, (M, 576), (576, 64)),
            Case("s8_mm", "stem_11", torch.int8, (M, 99), (99, 64)),
            Case("s8_mm", "stem_11_pitched", torch.int8, (M, 99), (99, 64),
                 layout="pitched"),
            Case("s8_mm", "head_1x1", torch.int8, (M, 64), (64, 32))]


def go_cases():
    """``s8_mm`` at the int8 trunk's shapes on Go: one chunk of 512 boards
    at 9x9 and at 19x19, the 3x3 conv in im2col form and the 8-plane stem
    (K = 72) as the executor's im2col hands it over (``layout="im2col"``:
    an 80-byte pitch)."""
    s8 = torch.int8
    return [Case("s8_mm", f"go{n}_{name}", s8, (512 * n * n, K), (K, 64), layout=layout)
            for n in (9, 19)
            for name, K, layout in (("conv3x3_64", 576, "dense"),
                                    ("stem_8", 72, "im2col"))]


def chess_cases():
    """``s8_mm`` at the int8 trunk's shapes on chess: one chunk of 512
    boards of 8x8, the 3x3 conv in im2col form and the 18-plane stem (K =
    162) as the executor's im2col hands it over (a 176-byte pitch)."""
    s8 = torch.int8
    return [Case("s8_mm", f"chess_{name}", s8, (512 * 64, K), (K, 64), layout=layout)
            for name, K, layout in (("conv3x3_64", 576, "dense"),
                                    ("stem_18", 162, "im2col"))]


def multi_prologue_cases():
    """``s8_mm_multi`` on one tile of 128 rows, 5 taps and 1: the launch,
    the image of ``b`` and one tile's product, against the probe case."""
    s8 = torch.int8
    return [Case("s8_mm_multi", "prologue_5x128x64", s8, (128, 128), (5, 128, 64)),
            Case("s8_mm_multi", "prologue_1x128x64", s8, (128, 128), (1, 128, 64))]


def edge_cases():
    """Shapes and layouts on each side of every edge of the wgmma kernels
    (row tiles of 128, column tiles of 32 / 64 / 128 / 256, K steps of 32 and
    128 bytes, the resident limit of ``s8_mm`` and of ``s8_mm_multi``'s taps
    together; the chained dot's bands of 64 rows, its N, K = N, R = 0, its
    shared-memory limit, both dtypes), checked only."""
    s8, bf = torch.int8, torch.bfloat16
    ragged = [(1, 1, 1), (37, 99, 21), (130, 577, 65), (129, 64, 513),
              (300, 200, 8), (257, 130, 256), (64, 256, 128)]
    cases = []
    for M, K, N in ragged:
        cases.append(Case("s8_mm", f"edge_{M}x{K}x{N}", s8, (M, K), (K, N)))
        cases.append(Case("tiled_mm", f"edge_s8_{M}x{K}x{N}", s8, (M, K), (K, N)))
        cases.append(Case("tiled_mm", f"edge_bf16_{M}x{K}x{N}", bf, (M, K), (K, N)))
    rounds = 132 * 128 * 2 + 77  # over two rounds of 132 blocks, ragged tail
    cases += [
        Case("s8_mm", "edge_rounds", s8, (rounds, 576), (576, 64)),
        Case("s8_mm", "edge_resident_max", s8, (300, 768), (768, 128)),
        Case("s8_mm", "edge_resident_over", s8, (300, 769), (769, 128)),
        Case("s8_mm", "edge_n32_k3072", s8, (300, 3072), (3072, 32)),
        Case("tiled_mm", "edge_s8_tiles", s8, (513, 1024), (1024, 520)),
        Case("tiled_mm", "edge_bf16_tiles", bf, (513, 1024), (1024, 520)),
    ]
    for kernel in ("s8_mm", "tiled_mm"):
        cases += [
            Case(kernel, "edge_minus128", s8, (1000, 576), (576, 64), lowest=-128),
            Case(kernel, "edge_strided", s8, (500, 576), (576, 64), layout="strided"),
            Case(kernel, "edge_misaligned", s8, (500, 99), (99, 64), layout="misaligned"),
            Case(kernel, "edge_pitched", s8, (5000, 99), (99, 64), layout="pitched"),
        ]
    cases += [
        Case("tiled_mm", "edge_bf16_strided", bf, (500, 576), (576, 64), layout="strided"),
        Case("tiled_mm", "edge_bf16_misaligned", bf, (500, 99), (99, 64), layout="misaligned"),
        Case("tiled_mm", "edge_bf16_pitched", bf, (500, 100), (100, 64), layout="pitched"),
    ]
    # chained_dot: M under one band, one band, ragged, over 132 bands, K = N,
    # N = 32 / 64 / 128, R = 0, the largest K that fits, both dtypes
    chains = [(s8, 1, 64, 32, 3), (s8, 37, 128, 64, 3), (s8, 64, 128, 128, 2),
              (s8, 1000, 576, 64, 8), (s8, 130, 96, 32, 2), (s8, 300, 128, 128, 0),
              (s8, 200, 64, 64, 5), (s8, 500, 256, 128, 4), (s8, 8500, 128, 64, 2),
              (s8, 70, 1152, 128, 1), (bf, 37, 128, 64, 3), (bf, 1000, 256, 128, 4),
              (bf, 100, 128, 128, 0), (bf, 300, 64, 64, 2), (bf, 8500, 128, 128, 2),
              (bf, 70, 512, 128, 1)]
    for dt, M, K, N, R in chains:
        tag = "s8" if dt == s8 else "bf16"
        cases.append(Case("chained_dot", f"edge_{tag}_{M}x{K}x{N}_R{R}", dt,
                          (M, K), (K, N), R))
    cases += [
        Case("chained_dot", "edge_s8_minus128", s8, (500, 128), (128, 64), 3,
             lowest=-128),
        Case("chained_dot", "edge_s8_pitched", s8, (500, 96), (96, 32), 2,
             layout="pitched"),
        Case("chained_dot", "edge_bf16_misaligned", bf, (300, 128), (128, 64), 2,
             layout="misaligned"),
    ]
    # s8_mm_multi (M, K, N, taps): ragged, the tiled route (N > 128), each
    # side of the resident limit (6 x 16 KB = 96 KB), over two rounds of the
    # persistent grid, one tap (also held equal to s8_mm), -128, layouts
    multi = [(1, 1, 1, 1), (37, 99, 21, 3), (130, 577, 65, 2), (300, 200, 8, 9),
             (129, 64, 513, 5), (257, 130, 256, 2), (300, 128, 128, 6),
             (300, 128, 128, 7), (132 * 128 * 2 + 77, 128, 64, 5),
             (300, 576, 64, 1), (257, 130, 256, 1), (64, 3072, 32, 1),
             (200, 1024, 32, 3), (100, 256, 48, 4)]
    cases += [Case("s8_mm_multi", f"edge_{M}x{K}x{N}_t{T}", s8, (M, K), (T, K, N))
              for M, K, N, T in multi]
    cases += [
        Case("s8_mm_multi", "edge_minus128", s8, (1000, 128), (5, 128, 64), lowest=-128),
        Case("s8_mm_multi", "edge_strided", s8, (500, 128), (5, 128, 64), layout="strided"),
        Case("s8_mm_multi", "edge_misaligned", s8, (500, 99), (3, 99, 64),
             layout="misaligned"),
        Case("s8_mm_multi", "edge_pitched", s8, (5000, 99), (5, 99, 64), layout="pitched"),
        Case("s8_mm_multi", "edge_tiled_pitched", s8, (300, 99), (2, 99, 200),
             layout="pitched"),
    ]
    return cases


def route(case: Case) -> Optional[str]:
    """The kernel a product case takes on the card (None: chained_dot, and
    s8_mm_multi of a package without ``s8_mm_multi_route``)."""
    N, K = case.b_shape[-1], case.a_shape[1]
    if case.kernel == "s8_mm":
        return ops.s8_mm_route(N, K)
    if case.kernel == "s8_mm_multi":
        rule = getattr(ops, "s8_mm_multi_route", None)
        return rule(case.b_shape[0], N, K) if rule else None
    return "tiled" if case.kernel == "tiled_mm" else None


def cuda_ms(fn: Callable[[], object], reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn: Callable[[], object], reps: int) -> float:
    """Device milliseconds per call: ``reps`` calls captured in one CUDA
    graph and replayed, so the host's launch cost is left out."""
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
    return cuda_ms(graph.replay, reps=5) / reps


def make_inputs(case: Case, gen: torch.Generator):
    def rand(shape):
        if case.dtype == torch.int8:
            x = torch.randint(case.lowest, 128, shape, generator=gen,
                              device="cuda", dtype=torch.int8)
            if case.lowest == -128:
                x.view(-1)[::7] = -128
            return x
        x = torch.randn(shape, generator=gen, device="cuda")
        scale = 0.02 if case.kernel == "tiled_mm" else 1.0
        return (x * scale).to(torch.bfloat16)

    (M, K), (_, N) = case.a_shape, case.b_shape[-2:]
    lead = case.b_shape[:-2]  # (taps,) for s8_mm_multi
    per16 = 16 // (1 if case.dtype == torch.int8 else 2)  # elements in 16 bytes
    if case.layout == "strided":
        return rand((M, 2 * K))[:, ::2], rand((*lead, N, K)).transpose(-1, -2)
    if case.layout == "misaligned":
        size = K * N * (lead[0] if lead else 1)
        return (rand((M * K + 1,))[1:].view(M, K),
                rand((size + 1,))[1:].view(case.b_shape))
    if case.layout in ("pitched", "im2col"):
        pitch = -(-K // per16) * per16 + (per16 if case.layout == "pitched" else 0)
        return rand((M, pitch))[:, :K], rand(case.b_shape)
    return rand(case.a_shape), rand(case.b_shape)


def work(case: Case) -> Tuple[int, int]:
    """(operations, bytes) of one call: 2 per multiply-add; every input read
    once and the output written once."""
    M, K = case.a_shape
    N = case.b_shape[-1]
    taps = case.b_shape[0] if len(case.b_shape) == 3 else 1
    es = 1 if case.dtype == torch.int8 else 2
    ops_ = 2 * M * K * N * taps * (case.R + 1)
    bytes_ = (M * K + taps * K * N) * es + M * N * 4
    return ops_, bytes_


def run_case(case: Case, gen: torch.Generator, reps: int,
             library: Optional[Callable] = None) -> dict:
    """Check one case against its plain version and, unless ``reps`` is 0,
    time it.  ``library``, if given, is called once as ``library(a, b)``
    and returns the call to time as the yardstick (whatever it prepares,
    such as a stacked copy of ``a``, is made before the timing)."""
    a, b = make_inputs(case, gen)
    fn = getattr(ops, case.kernel)
    plain = getattr(ops, case.kernel + "_plain")
    chain = case.kernel == "chained_dot"
    args = (a, b, case.R) if chain else (a, b)
    # A long bf16 chain shrinks to zero (every step scales by 0.001), which
    # would compare nothing: the check stops at CHECK_CHAIN steps.
    checked = (a, b, min(case.R, CHECK_CHAIN)) if chain else args
    out, ref = fn(*checked), plain(*checked)
    torch.cuda.synchronize()
    err = float((out.double() - ref.double()).abs().max())
    if case.dtype == torch.int8:
        ok = torch.equal(out, ref)
        if case.kernel == "s8_mm_multi" and b.shape[0] == 1:
            ok = ok and torch.equal(out, ops.s8_mm(a, b[0]))  # one kernel
    else:
        ok = err <= BF16_TOL[case.kernel] * float(ref.abs().max())
    row = {
        "kernel": case.kernel, "case": case.name,
        "dtype": str(case.dtype).replace("torch.", ""),
        "a": list(case.a_shape), "b": list(case.b_shape), "R": case.R,
        "agrees": bool(ok), "max_abs_err": err,
        "ref_max": float(ref.abs().max()),
    }
    if route(case) is not None:
        row["route"] = route(case)
    if reps == 0:
        return row
    n_ops, n_bytes = work(case)
    t_ops, t_bytes = n_ops / PEAK_OPS[case.dtype], n_bytes / HBM_BYTES_PER_S
    ms = cuda_ms(lambda: fn(*args), reps)
    g_ms = graph_ms(lambda: fn(*args), reps)
    if chain:  # the chain's length apart: R = 0 leaves the loads of `b` and
        # the band, one product and the store
        row["graph_ms_R0"] = graph_ms(lambda: fn(a, b, 0), reps)
        row["step_us"] = (g_ms - row["graph_ms_R0"]) / max(case.R, 1) * 1e3
    return {
        **row,
        "ms": ms, "graph_ms": g_ms,
        "tops": n_ops / (ms * 1e-3) / 1e12,
        "plain_ms": cuda_ms(lambda: plain(*args), max(2, reps // 4)),
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": (cuda_ms(library(a, b), reps)
                       if library is not None else None),
    }


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--chain", type=int, default=64,
                   help="R of the chained-dot cases")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--only", default=None,
                   help="run the cases of this wrapper alone (e.g. chained_dot)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_s8_dots needs a CUDA card")
    print(json.dumps({"card": torch.cuda.get_device_name(0)}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = []
    for case in edge_cases():
        if args.only in (None, case.kernel):
            rows.append(run_case(case, gen, reps=0))
            print(json.dumps(rows[-1]), flush=True)
    for case in trunk_cases() + probe_cases(args.chain) + multi_prologue_cases():
        if args.only not in (None, case.kernel):
            continue
        rows.append(run_case(case, gen, args.reps))
        print(json.dumps(rows[-1]), flush=True)
    bad = [f"{r['kernel']}:{r['case']}" for r in rows if not r["agrees"]]
    if bad:
        raise SystemExit(f"kernels disagree with their plain versions: {bad}")
    return rows


if __name__ == "__main__":
    main()
