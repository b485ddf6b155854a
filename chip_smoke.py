#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``alphazero_tpu_torch``) on one card.

    python3 chip_smoke.py          # from the repository root, one NVIDIA card

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: every CUDA source (gather_rows, wgmma_mm), one nvcc each,
     started together (sm_90a); prints each kernel's registers and shared
     memory, counts the wgmma and TMA instructions in wgmma_mm's machine
     code, the IGMMA (s8) / HGMMA (bf16) instructions of every chained_dot
     kernel, and the IGMMA and UTMALDG instructions of every instance that
     s8_mm_multi launches (the resident kernels and the s8 tiled one; none
     would fail the run; skipped where the toolkit has no cuobjdump), and
     holds the chained dot's shared-memory rule and s8_mm_multi's route
     rule in ops/s8_mm.py against the ones their C entry points apply;
  3. kernels: each kernel against its plain PyTorch version on the card:
     gather_rows at the search's shapes, at odd row lengths (1, 3, 7, 225,
     227 bytes), from misaligned arenas and with int64 indices, and
     gather_rows_many at the arenas the search reads at one index (all bit
     for bit); the wgmma kernels (s8_mm, s8_mm_multi, tiled_mm,
     chained_dot) at scripts/profile_s8_dots.edge_cases(): ragged M, N, K
     around every tile edge, several rounds of the persistent grid, both
     routes of s8_mm and of s8_mm_multi (one tap also held equal to s8_mm),
     both dtypes of chained_dot, -128 among the values, strided, misaligned
     and pitched inputs; then s8_mm at the int8 trunk's shapes (a chunk of
     Gomoku, Go and chess boards) and the probes' shapes, s8_mm_multi at the probe's, a chunk's and a tiled-route
     shape (and on one tile of rows), chained_dot (R=8) and tiled_mm at the
     probes' shapes through scripts/profile_s8_dots.run_case (s8 bit for
     bit, bf16 within its stated tolerance); with CUDA-event times of the
     kernel (eager, and replayed from a CUDA graph), the plain version and
     one PyTorch library call, and the roofline bound;
  4. nets on the card against the port's CPU forwards on 64 mid-game
     positions: bf16/f32 folded net, and the int8 executor on the same qp;
  5. main path at full width with the production executor: the flagship
     6x64 SE-ResNet bundle, rollout calibration on the card, int8 trunk,
     driving make_host_actor at B=1024, 800 simulations, W=16, K=32,
     recycle on, for 2 moves (1 warm-up, 1 timed; cut from 3, printed);
     checks root visit sums, action legality, and that gather_rows and
     s8_mm were launched, s8_mm exactly as often as the chunk count
     predicts; prints gather launches a move;
     [w1_main]: the sequential search (W=1) at the shipped config's width,
     B=256, 200 simulations (cut from 800, then 400), int8
     executor, 2 moves: the same checks, s8_mm exactly 13 x (1 + 200)
     launches a move, eval and search ms a simulation; [reuse_base] and
     [reuse_main]: 2 greedy moves (cut from 3 with the Go phases) at
     B=1024, W=16, 192 simulations (cut from 800)
     without and with tree reuse (topup): fresh simulations a move (192,
     then fewer), every live root at 192 visits or more, moves/s of both
     and [main]'s; every main path records the
     kernel calls of its warm-up move, and [reuse_main] of one more
     untimed move that re-roots, and holds each distinct signature against
     its plain version, bit for bit;
  6. the earlier main path (BN-folded bf16 net), shallower: 192 simulations,
     2 moves, same checks;
  7. the probe entry point scripts/profile_s8_dots.main, whose path runs
     s8_mm_multi, chained_dot and tiled_mm: launch counts;
  8. card vs CPU search: B=64, 256 simulations, W=16, zero-value uniform
     evaluator, no noise, greedy, on 15x15 openings and on crowded 7x7
     positions (deeper trees): visit counts must be equal; [search_options]:
     the same roots, 64 simulations, an evaluator with integer-derived
     values, card against CPU for W=1, parity mode (K = A), TD(lambda 0.5),
     a 256-entry table at W=1 and W=16 (128 simulations), and tree reuse
     over 3 moves at W=1 and W=16 under both budgets (the table and reuse
     cases with a prior on about 6 cells, so that positions recur; each
     table case must hit 64 times or more): equal visit counts, table hits
     and stores and fresh simulations; then parity mode on the card at the
     reference engine's seven dumped positions (sorted visit vectors
     equal); the card's kernel calls of every case held against their
     plain versions;
  9. training at the flagship width (6x64 SE-ResNet, 15x15): the learner
     on one fixed batch of 1024, 2 AdamW steps (cut from 3 with the chess
     phases) on the card against the same on the CPU, in float32 (TF32 off) and in bf16 compute, with the
     limits printed beside the differences; 30 steps on the card (the
     loss must fall; train steps/s); then the Pipeline with the int8
     executor from the flagship weights for 2 iterations at a reduced
     depth (printed): s8_mm and gather_rows launched in each actor run,
     replay filled, finite losses, weights and refreshed quantised
     parameters changed, a checkpoint restored bit for bit, history.json
     written; actor and learner seconds, moves/s, peak device memory;
     [train_config]: scripts/train.py --config on config/gomoku_15x15.json
     cut in depth only (printed): 2 iterations of 256 games and 4 moves
     (cut from 8 with the chess phases), W=1, its
     GroupNorm net; every distinct gather call held against its plain
     version, checkpoints and finite losses;
 10. [variants]: Renju, Omok and pro-long on the card against the CPU,
     exactly, at 4,096 random-playout positions (forbidden_map, legal_mask,
     step); then Renju self-play as [main] (B=1024, W=16, 96 simulations,
     cut from 800, then 192, int8) from 20 policy-sampled
     plies, 2 moves, with the forbidden
     points among the roots, legal_mask ms a wave and moves/s beside
     [main]'s; its kernel calls held against their plain versions;
 11. [arena]: a 7x7 play_match_sides (one side with tree reuse) and
     play_match_host on the card against the CPU (winners and final boards
     equal); scripts/evaluate.py as a subprocess, its JSON keys equal to
     the JAX CLI's; kernel calls held against their plain versions (the
     flagship's anchored ladder moved to [anchor_eval], slice 12);
 12. Go (slice 9): [go_exact] 4,096 random-playout 9x9 positions (0-120
     plies) and 1,024 at 19x19 (0-240), played on the card, against the
     CPU exactly (masks, observations, both rule sets' scores with and
     without dead stones, ownership, hashes, arena rows, one more step);
     [go_search] card vs CPU at 9x9 (B=64, 128 simulations, W=16, W=1 and
     W=1 with a 256-entry table); [go_main] (models_zoo/go9, int8 with
     rollout calibration, 192 simulations, cut from 800) and [go19_main] (a fresh 6x64
     net at 19x19, 192 simulations, cut from 800) as [main] at B=1024,
     W=16, 2 moves, with one wave's env
     ms (step, legal_mask, observation) and host syncs; [go_train_config]:
     config/go_9x9.json cut in depth (2 iterations, 4 moves (cut from 16),
     64 simulations, 4 train steps); [go_arena]: go9 (BN-folded bf16, 32
     simulations, cut from 128, then 64) against uniform_mcts_16 and _64
     (uniform_mcts_256 dropped with the slice-11 phases), 8 games
     each (cut from 16), at least three quarters against uniform_mcts_16, Bradley-Terry
     with the anchors' round-robin of docs/train_zoo_go9.json, and
     scripts/evaluate.py --game go;
 13. chess (slice 10): [chess_exact] 4,096 standard lanes, 1,024 each of
     Chess960 numbers 0, 333 and 959 and 256 king-and-rook endings, 128
     random plies (cut from 256) drawn on the card, card against CPU after every ply
     (every ChessState field; masks, planes, position hash and arena rows
     at intervals), with counts of the rules met (checks, mates,
     stalemates, en passant, castling, promotions, repetition, 50-move and
     material draws), then perft on the card against the published totals
     (start position depth 4, Kiwipete 3, positions 3 to 6); [chess_search]
     card vs CPU (B=64, 128 simulations, W=16 and W=1, each with a
     256-entry table: counts, actions, hits, stores) and the mate in one
     (Qh5#) at W=16 and W=1; [chess_main] models_zoo/chess_dev on the int8
     executor as [main] (B=1024, W=16, 192 simulations, cut from 800, 2 moves; s8_mm
     exactly 13 x 386 a move) and one wave's env ms and host syncs on
     1,024 mid-game roots (40 random plies) x 16; [chess_train_config]
     config/chess.json cut in depth (2 iterations of 4 moves (cut from 16), 64
     simulations, 4 train steps), its last checkpoint reloaded bit for
     bit; [chess_arena] chess_dev (BN-folded bf16, 128 simulations)
     against uniform_mcts_16, 16 games, 4 opening plies, T=0.1, 160 plies
     (at most 2 losses and more wins than losses), and scripts/evaluate.py
     --game chess cut to 40 plies (keys equal to the JAX CLI's);
     [chess_cli] scripts/self_play.py --game chess (chess_dev int8 and
     folded), scripts/train.py --game chess and
     scripts/tournament.py --game chess, in process, cut in depth; every
     path's kernel calls held against their plain versions;
 14. slice 11: [randwire_exact] RandWireConfig() (4 blocks x 8 nodes x 64
     channels, head kernels drawn too) on the card against the CPU on 256
     random-playout 15x15 observations, in f32 (TF32 off) and bf16;
     [randwire_main] a freshly seeded RandWireConfig() net on its raw bf16
     evaluator as [main] (B=1024, W=16, 192 simulations (cut from 800), 2
     moves), with one
     wave's env ms and host syncs on 1,024 mid-game roots; [randwire_train]
     scripts/train.py --model randwire at config/gomoku_15x15.json's shape
     cut in depth (printed), its checkpoint reloaded bit for bit and its
     net through save_model -> load_model with bit-equal outputs on the
     card; [export] the flagship's TorchScript .pt run on the card by a
     Python that cannot import the port, its ONNX file replayed by numpy,
     both against the folded f32 eval, the int8 executor against the
     export, and scripts/export_model.py --bundle models_zoo/chess_dev
     --torchscript --onnx --package; [facade] AlphaZero on for_game
     ("gomoku")'s config cut in depth (printed): run_self_play,
     train_network, evaluate_model (4 games), get_best_action, save;
     [serve] api_server.serve on 127.0.0.1:0 with the flagship, 200
     simulations and an API key: model info, a Gomoku game with a human
     move, two engine moves and the state, a chess game with a click-pair
     move, a bad game (400), a call without the key (401) and the page,
     each request's latency; every path's kernel calls held against their
     plain versions;
 15. slice 12: [scan_main] the scanned actor (selfplay/actor.play_games)
     with the production int8 executor at [main]'s width (B=1024, W=16,
     K=32, recycle, T=1), 2 moves at 192 simulations (the cut), s8_mm
     exactly as the evaluated batches predict, the first move's actions
     equal to the host actor's from the same generator; [scan_pipeline]
     config/gomoku_15x15.json with host_actor false (256 games, W=1, the
     GroupNorm net raw), cut to 2 iterations of 4 moves, 64 simulations, 2
     train steps; [dist_one] a one-rank NCCL group: one learner step of the
     flagship at batch 1024 (f32, deterministic cuDNN) bit-equal to the
     same step with no group, and one Pipeline(mesh=) iteration of the
     6x64 BatchNorm net on the int8 executor (256 games, 4 moves, 32
     simulations) under it; [dist_two] two processes of this script
     (--dist-worker) joined by gloo, both on cuda:0: the learner step at
     batch 1024 (512 a rank) against one process's (loss and running
     statistics within the CPU test's tolerances; gradients and parameters
     no further off than one process's step on the rows in another order),
     and one Pipeline(mesh=) iteration at 256 games (128 a
     rank, no root noise, T=0) whose ring equals one process's; learner
     steps/s of each; [scripts] regression_test.py --device cuda (every
     check ok), benchmark.py at B=1024, 6x64 cut to 64 simulations,
     hyperopt.py cut to 2 trials of 1 iteration (9x9, 32 games, 8
     simulations); [records] 64 of [scan_main]'s games encoded by the
     native encoder and by json: equal bytes, both times; [anchor_eval]
     scripts/anchor_eval.py on the flagship (BN-folded bf16, 64 simulations,
     cut from 800) against the four anchors, 8 games each (cut from 64),
     with the round-robin of docs/anchor_table.json, at least three
     quarters against uniform_mcts_16 (the ladder [arena] ran until slice
     12); [plugins] a plugin game (load_directory of a temporary
     *_plugin.py) searched on the card; every path's kernel calls held
     against their plain versions;
 16. summary: one JSON line of kernels, then the final status line.

gather_rows times are taken with warm L2 (the search re-reads the same
arenas within a wave); its ``bound_ms`` counts the bytes the call must move
(indices, each distinct gathered row once, the output once) at 3.35 TB/s.
The products' ``bound_ms`` is the larger of their operations at the tensor
cores' peak (1,979 TOP/s int8, 989 TFLOP/s bf16) and their bytes (inputs
and output once) at 3.35 TB/s.  ``library_ms`` times ``torch._int_mm``
(s8; on a dense copy of a pitched ``a``) or ``torch.matmul`` (bf16) where
they take the shape, for s8_mm_multi
``torch._int_mm`` on the stacked form ``a.repeat(1, taps) @ b.reshape(taps
K, N)`` (the repeat made before the timing); the port itself calls neither
for these products.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import socket
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
ROOT = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 50) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
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


def phase_device() -> tuple:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} card(s): {name}")
    log(smi)
    return name, smi


def phase_build() -> None:
    from alphazero_tpu_torch.ops import _build

    names = ["gather_rows", "wgmma_mm"]
    t0 = time.perf_counter()
    _build.build(names)
    secs = time.perf_counter() - t0
    for n in names:
        kernel = "?"
        for ln in _build.ptxas_log.get(n, "").splitlines():
            if "Compiling entry function" in ln:
                kernel = _build.demangle(ln.split("'")[1])[:100]
            elif ": Used" in ln or ("spill" in ln and "0 bytes spill" not in ln):
                log(f"[build] {n}: {kernel}: {ln.split(':', 1)[1].strip()}")
    log(f"[build] {names} built in {secs:.2f} s")
    from alphazero_tpu_torch.ops import s8_mm as ops

    log("[build] wgmma_mm dynamic shared memory a block: " + json.dumps({
        "tiled": ops.dynamic_smem_bytes("tiled"),
        "resident_576x64": ops.dynamic_smem_bytes("resident", 64, 576),
        "resident_99x64": ops.dynamic_smem_bytes("resident", 64, 99),
        "multi_resident_5x128x64": ops.dynamic_smem_bytes("resident", 64, 128, 5),
        "chained_576x64": ops.chained_dot_smem(64, 576, torch.int8),
        "chained_bf16_128x128": ops.chained_dot_smem(128, 128, torch.bfloat16)}))
    # The chained dot's shape rule in Python against its C entry point's.
    c_smem = ops._bind().wg.az_chained_smem
    differ = [(N, K, es) for N in (16, 32, 48, 64, 96, 128, 256)
              for K in (32, 64, 96, 128, 512, 576, 640, 768, 1152, 1280, 2048)
              for es, dt in ((1, torch.int8), (2, torch.bfloat16))
              if (ops.chained_dot_smem(N, K, dt) or -1) != c_smem(N, K, es)]
    if differ:
        raise AssertionError(f"chained_dot_smem differs from az_chained_smem at "
                             f"(N, K, elem_size) {differ}")
    # s8_mm_multi's route rule in Python against its C entry point's
    # (1 resident, 0 tiled).
    c_route = ops._bind().wg.az_s8_mm_multi_route
    grid = [(t, N, K) for t in (1, 2, 3, 5, 6, 7, 9, 24, 25)
            for N in (1, 8, 21, 32, 33, 64, 65, 128, 129, 256)
            for K in (1, 64, 99, 128, 129, 200, 576, 768, 769, 1024, 3072, 3073)]
    differ = [(t, N, K) for t, N, K in grid
              if c_route(t, N, K) != int(ops.s8_mm_multi_route(t, N, K) == "resident")]
    if differ:
        raise AssertionError(f"s8_mm_multi_route differs from "
                             f"az_s8_mm_multi_route at (taps, N, K) {differ}")
    log(f"[build] s8_mm_multi route rule: Python and C agree at {len(grid)} shapes")
    # The product kernels must really be wgmma fed by TMA: count both in the
    # machine code of the library just built.
    sass = _build.machine_code("wgmma_mm")
    if sass is None:
        log("[build] no cuobjdump beside nvcc: machine code not inspected")
        return
    counts = {op: sass.count(op) for op in ("HGMMA", "IGMMA", "UTMALDG")}
    log(f"[build] wgmma_mm machine code: {json.dumps(counts)}")
    if not all(counts.values()):
        raise AssertionError(f"wgmma_mm was built without wgmma or TMA: {counts}")
    # Every chained_dot kernel must be wgmma: IGMMA in the s8 ones
    # (chained_dot_kernel<1, ...>), HGMMA in the bf16 ones (<2, ...>).
    chained = {}
    for chunk in sass.split("Function : ")[1:]:
        name = _build.demangle(chunk.split()[0])
        if "chained_dot_kernel<" in name:
            es, n = re.findall(r"\d+", name.split("chained_dot_kernel<")[1])[:2]
            op = "IGMMA" if es == "1" else "HGMMA"
            chained[f"{'s8' if es == '1' else 'bf16'} N={n}"] = {
                op: len(re.findall(op + r"\.", chunk))}
    log(f"[build] chained_dot kernels: {json.dumps(chained)}")
    if len(chained) != 5 or not all(n for c in chained.values() for n in c.values()):
        raise AssertionError(f"chained_dot kernels without wgmma: {chained}")
    # The instances s8_mm_multi launches (the resident kernel at NP = 32, 64
    # and 128, the s8 tiled kernel): wgmma fed by TMA.
    multi = {}
    for chunk in sass.split("Function : ")[1:]:
        # cu++filt may print a template argument as (int)64
        found = re.search(r"(s8_resident_kernel|wgmma_tiled_kernel)<(?:\(int\))?(\d+)>",
                          _build.demangle(chunk.split()[0]))
        if found and (found.group(1) == "s8_resident_kernel" or found.group(2) == "1"):
            multi[f"{found.group(1)}<{found.group(2)}>"] = {
                op: len(re.findall(op + r"\.", chunk)) for op in ("IGMMA", "UTMALDG")}
    log(f"[build] s8_mm_multi kernels: {json.dumps(multi)}")
    if len(multi) != 4 or not all(n for c in multi.values() for n in c.values()):
        raise AssertionError(f"s8_mm_multi kernels without wgmma or TMA: {multi}")


def _arena(B, N, K, dtype, gen, offset=0):
    """A random contiguous arena [B, N, K]; ``offset`` bytes past an
    aligned base."""
    if dtype.is_floating_point:
        arr = torch.randn((B, N, K), generator=gen, device="cuda").to(dtype)
    else:
        arr = torch.randint(-100, 100, (B, N, K), generator=gen,
                            device="cuda").to(dtype)
    if offset:
        raw = torch.empty(arr.numel() * arr.element_size() + offset,
                          dtype=torch.uint8, device="cuda")
        arr = raw[offset:].view(dtype).view(B, N, K).copy_(arr)
    return arr


def _gather_case(name, B, N, K, M, dtype, lo, hi, gen, offset=0,
                 idx_dtype=torch.int32):
    from alphazero_tpu_torch.ops.gather_rows import gather_rows, gather_rows_plain
    from alphazero_tpu_torch.scripts.profile_s8_dots import graph_ms

    arr = _arena(B, N, K, dtype, gen, offset)
    idx = torch.randint(lo, hi, (B, M), generator=gen, device="cuda",
                        dtype=idx_dtype)
    out = gather_rows(arr, idx)
    ref = gather_rows_plain(arr, idx)
    torch.cuda.synchronize()
    equal = torch.equal(out.view(torch.uint8), ref.view(torch.uint8))
    err = float((out.float() - ref.float()).abs().max())
    row_bytes = K * arr.element_size()
    inside = (idx >= 0) & (idx < N)
    flat = (torch.arange(B, device="cuda")[:, None] * N + idx.long())[inside]
    distinct = int(torch.unique(flat).numel())
    bytes_moved = B * M * 4 + B * M * row_bytes + distinct * row_bytes
    row = {"case": name, "shape": [B, N, K], "idx": [B, M],
           "dtype": str(dtype).replace("torch.", ""),
           "idx_dtype": str(idx_dtype).replace("torch.", ""),
           "base_offset": offset, "bit_equal": equal,
           "max_abs_err": err,
           "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3}
    if lo >= 0 and hi <= N:  # torch.gather computes the same function here
        full_idx = idx.long()[:, :, None].expand(B, M, K)
        row["library_ms"] = cuda_ms(lambda: torch.gather(arr, 1, full_idx))
        row["library_graph_ms"] = graph_ms(lambda: torch.gather(arr, 1, full_idx), 50)
    else:
        row["library_ms"] = row["library_graph_ms"] = None
    # *_ms: eager calls back to back (what a call costs the search, host
    # launch included); *_graph_ms: the same calls replayed from a CUDA
    # graph (device time alone).
    row["ms"] = cuda_ms(lambda: gather_rows(arr, idx))
    row["graph_ms"] = graph_ms(lambda: gather_rows(arr, idx), 50)
    row["plain_ms"] = cuda_ms(lambda: gather_rows_plain(arr, idx))
    row["plain_graph_ms"] = graph_ms(lambda: gather_rows_plain(arr, idx), 50)
    return row


def _gather_many_case(name, B, N, M, arenas, gen):
    """gather_rows_many over ``arenas`` ((K, dtype), ...) at one index with
    -1 among its entries, against its plain version and against one
    gather_rows launch per arena."""
    from alphazero_tpu_torch.ops.gather_rows import (
        gather_rows, gather_rows_many, gather_rows_many_plain)
    from alphazero_tpu_torch.scripts.profile_s8_dots import graph_ms

    arrs = tuple(_arena(B, N, K, dt, gen) for K, dt in arenas)
    idx = torch.randint(-1, N, (B, M), generator=gen, device="cuda",
                        dtype=torch.int32)
    before = gather_rows.launches
    outs = gather_rows_many(arrs, idx)
    launches = gather_rows.launches - before
    refs = gather_rows_many_plain(arrs, idx)
    torch.cuda.synchronize()
    equal = all(o.dtype == r.dtype and torch.equal(o.view(torch.uint8), r.view(torch.uint8))
                for o, r in zip(outs, refs))
    inside = (idx >= 0) & (idx < N)
    flat = (torch.arange(B, device="cuda")[:, None] * N + idx.long())[inside]
    distinct = int(torch.unique(flat).numel())
    row_bytes = sum(a.shape[2] * a.element_size() for a in arrs)
    bytes_moved = B * M * 4 + (B * M + distinct) * row_bytes
    row = {"case": name, "arenas": [[K, str(dt).replace("torch.", "")] for K, dt in arenas],
           "N": N, "idx": [B, M], "launches": launches, "bit_equal": equal,
           "max_abs_err": max(float((o.float() - r.float()).abs().max())
                              for o, r in zip(outs, refs)),
           "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3, "library_ms": None}
    row["ms"] = cuda_ms(lambda: gather_rows_many(arrs, idx))
    row["graph_ms"] = graph_ms(lambda: gather_rows_many(arrs, idx), 50)
    row["one_per_arena_ms"] = cuda_ms(lambda: [gather_rows(a, idx) for a in arrs])
    row["one_per_arena_graph_ms"] = graph_ms(
        lambda: [gather_rows(a, idx) for a in arrs], 50)
    row["plain_ms"] = cuda_ms(lambda: gather_rows_many_plain(arrs, idx))
    return row


def phase_kernels() -> list:
    gen = torch.Generator(device="cuda").manual_seed(0)
    i64 = dict(idx_dtype=torch.int64)
    cases = [
        # name, B, N, K, M, dtype, idx range: the search's shapes at B=1024,
        # N=801 nodes (800 simulations), W=16 walkers, K=32 slots.
        ("child_stats", 1024, 801, 2, 512, torch.float32, 0, 801),
        ("slot_priors", 1024, 801, 32, 16, torch.bfloat16, 0, 801),
        ("child_pointers", 1024, 801, 32, 16, torch.int32, 0, 801),
        ("leaf_boards", 1024, 801, 225, 16, torch.int8, 0, 801),
        ("leaf_meta", 1024, 801, 12, 16, torch.int32, 0, 801),
        ("node_scalar", 1024, 801, 1, 16, torch.bool, 0, 801),
        ("b3", 3, 50, 7, 5, torch.int32, 0, 50),
        ("out_of_range", 64, 100, 32, 40, torch.float32, -5, 105),
        # odd row lengths: bytes (1, 3), 4-byte words (7) and 16-byte chunks
        # (225, 227) with shifts, words and chunks across rows
        ("odd_1", 1024, 801, 1, 16, torch.int8, -1, 801),
        ("odd_3", 1024, 801, 3, 16, torch.int8, -1, 801),
        ("odd_225", 1024, 801, 225, 16, torch.int8, -1, 801),
        ("odd_227", 1024, 801, 227, 16, torch.int8, -1, 801),
        ("odd_227_b5", 5, 33, 227, 7, torch.int8, -3, 36),
        ("odd_7", 1024, 801, 7, 16, torch.int8, -1, 801),
        # a source base 1 to 3 bytes past alignment; int64 indices as the
        # search's root and link reads pass them
        ("misaligned_128", 256, 801, 128, 16, torch.int8, -1, 801, 1),
        ("misaligned_225", 256, 801, 225, 16, torch.int8, -1, 801, 2),
        ("misaligned_meta", 256, 801, 12, 16, torch.int8, -1, 801, 3),
        ("root_child_i64", 1024, 225, 1, 16, torch.int32, 0, 225, 0, i64),
        ("link_i64", 1024, 801 * 32, 1, 16, torch.int32, -1, 801 * 32, 0, i64),
    ]
    rows = []
    for c in cases:  # name, B, N, K, M, dtype, lo, hi[, offset[, idx dtype]]
        offset = c[8] if len(c) > 8 else 0
        extra = c[9] if len(c) > 9 else {}
        rows.append(_gather_case(*c[:8], gen=gen, offset=offset, **extra))
        log("[kernel] " + json.dumps(rows[-1]))
    # gather_rows_many at the arenas the search reads at one index: a
    # level's node rows (terminal flag, slot priors, child pointers, node
    # stats) and a wave's leaf rows (board, meta, terminal value).
    many = [_gather_many_case("level_rows", 1024, 801, 16,
                              [(1, torch.bool), (32, torch.bfloat16),
                               (32, torch.int32), (2, torch.float32)], gen),
            _gather_many_case("leaf_rows", 1024, 801, 16,
                              [(225, torch.int8), (12, torch.int32),
                               (1, torch.float32)], gen),
            _gather_many_case("eight_arenas", 7, 40, 9,
                              [(k, dt) for k, dt in zip(
                                  (1, 3, 5, 225, 2, 7, 16, 1),
                                  (torch.bool, torch.int8, torch.bfloat16, torch.int8,
                                   torch.float32, torch.int32, torch.int8, torch.float32))],
                              gen)]
    for r in many:
        log("[kernel] gather_rows_many " + json.dumps(r))
    bad = [r["case"] for r in rows + many if not r["bit_equal"]]
    bad += [r["case"] for r in many if r["launches"] != 1]
    if bad:
        raise AssertionError(f"gather_rows differs from its plain version: {bad}")
    return rows + many


def _library_for(case):
    """The PyTorch call that computes the same function, where one does, as
    ``run_case`` takes it: ``library(a, b)`` returns the call to time."""
    if case.kernel not in ("s8_mm", "s8_mm_multi", "tiled_mm"):
        return None
    if case.dtype == torch.bfloat16:
        return lambda a, b: lambda: torch.matmul(a, b)  # f32 accumulation
    M, K = case.a_shape
    N = case.b_shape[-1]
    taps = case.b_shape[0] if case.kernel == "s8_mm_multi" else 1
    if not (M > 16 and taps * K % 8 == 0 and N % 8 == 0):  # what _int_mm takes
        return None
    if case.kernel == "s8_mm_multi":
        # stacked: sum_t a @ b[t] == [a .. a] @ vstack(b), the repeat made once
        def stacked(a, b):
            a_rep, b_cat = a.repeat(1, taps), b.reshape(taps * K, N)
            return lambda: torch._int_mm(a_rep, b_cat)
        return stacked
    # A dense copy of a pitched `a`, made before the timing.
    return lambda a, b: (lambda a: lambda: torch._int_mm(a, b))(a.contiguous())


def phase_products() -> list:
    """Every s8 / bf16 product kernel against its plain version: the two
    wgmma kernels at their edge cases (checked only), then all at the int8
    trunk's shapes and the probes' shapes (checked and timed)."""
    from alphazero_tpu_torch.scripts import profile_s8_dots as probe

    gen = torch.Generator(device="cuda").manual_seed(0)
    edges = [probe.run_case(case, gen, reps=0) for case in probe.edge_cases()]
    log("[kernel] edge cases: " + json.dumps(
        [[r["kernel"], r["case"], r.get("route"), r["agrees"],
          r["max_abs_err"]] for r in edges]))
    for kernel in ("s8_mm", "s8_mm_multi"):
        routes = {r["route"] for r in edges if r["kernel"] == kernel}
        if routes != {"resident", "tiled"}:
            raise AssertionError(f"the {kernel} edge cases took only the routes {routes}")
    rows = []
    for case in (probe.trunk_cases() + probe.go_cases() + probe.chess_cases()
                 + probe.probe_cases(chain=8) + probe.multi_prologue_cases()):
        row = probe.run_case(case, gen, reps=20, library=_library_for(case))
        log("[kernel] " + json.dumps(row))
        rows.append(row)
    bad = [f"{r['kernel']}:{r['case']}" for r in edges + rows if not r["agrees"]]
    if bad:
        raise AssertionError(f"kernels differ from their plain versions: {bad}")
    return edges + rows


def _random_states(env, B, plies, seed, device):
    """Numpy-chosen random openings; lane b plays ``b % plies`` moves that do
    not end the game.  Built on the CPU, then moved to ``device``."""
    from alphazero_tpu_torch.core.types import where_lanes

    rng = np.random.RandomState(seed)
    A = env.num_actions
    st = env.init(B, device="cpu")
    for ply in range(plies):
        rep = st.map(lambda x: x.repeat_interleave(A, 0))
        ends = env.step(rep, torch.arange(A).repeat(B)).terminal.reshape(B, A)
        ok = (env.legal_mask(st) & ~ends).numpy()
        acts = np.array([rng.choice(np.flatnonzero(ok[b])) for b in range(B)])
        live = torch.from_numpy(np.arange(B) % plies > ply)
        st = where_lanes(live, env.step(st, torch.from_numpy(acts)), st)
    return st.map(lambda x: x.to(device))


def phase_net(env, model_path) -> dict:
    """The flagship net on the card (bf16, and f32 with TF32 off) against
    the port's f32 forward on the CPU, on 64 positions."""
    from alphazero_tpu_torch.models.io import load_model
    from alphazero_tpu_torch.models.resnet import make_inference_eval_fn

    obs = env.observation(_random_states(env, 64, 40, seed=1, device="cpu"))
    cpu_model, _ = load_model(model_path, env.observation_shape, device="cpu")
    ref_l, ref_v = make_inference_eval_fn(cpu_model, torch.float32)(obs)
    gpu_model, _ = load_model(model_path, env.observation_shape, device="cuda")
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        l32, v32 = make_inference_eval_fn(gpu_model, torch.float32)(obs.cuda())
        l16, v16 = make_inference_eval_fn(gpu_model)(obs.cuda())
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    res = {
        "f32_logit_err": float((l32.cpu() - ref_l).abs().max()),
        "f32_value_err": float((v32.cpu() - ref_v).abs().max()),
        "bf16_logit_err": float((l16.cpu() - ref_l).abs().max()),
        "bf16_value_err": float((v16.cpu() - ref_v).abs().max()),
        "logit_scale": float(ref_l.abs().max()),
    }
    log("[net] " + json.dumps(res))
    # f32 on both sides: summation order only (TF32 off), 1e-3 absolute.
    # bf16 on the card: 8-bit mantissas through 13 conv layers; the CPU's
    # own bf16 forward is 0.17 (logits, scale ~24) and 0.05 (value) off f32.
    if not (res["f32_logit_err"] < 1e-3 and res["f32_value_err"] < 1e-3):
        raise AssertionError(f"f32 net on the card disagrees with the CPU: {res}")
    if not (res["bf16_logit_err"] < 0.5 and res["bf16_value_err"] < 0.1):
        raise AssertionError(f"bf16 net on the card disagrees with the CPU: {res}")
    return res


def phase_net_int8(env, model, calib) -> dict:
    """The int8 executor on the card (s8_mm kernel) against the port's own
    int8 forward on the CPU (plain s8 product), same quantised parameters,
    in the production modes, on 64 mid-game positions."""
    from alphazero_tpu_torch import production
    from alphazero_tpu_torch.models import quant

    qp = quant.build_quantized_params(
        model, calib, calib_percentile=production.INT8_CALIB_PERCENTILE)

    def to_cpu(x):
        if isinstance(x, dict):
            return {k: to_cpu(v) for k, v in x.items()}
        if isinstance(x, list):
            return [to_cpu(v) for v in x]
        return x.cpu() if isinstance(x, torch.Tensor) else x

    def traced(params, obs):
        """forward_int8 plus every s8 activation it quantised."""
        acts, orig = [], quant._quant_act

        def record(*args, **kw):
            acts.append(orig(*args, **kw))
            return acts[-1]

        quant._quant_act = record
        try:
            with torch.no_grad():
                out = quant.forward_int8(params, obs, production.INT8_RESIDUAL,
                                         production.INT8_HEADS)
        finally:
            quant._quant_act = orig
        return out, acts

    obs = env.observation(_random_states(env, 64, 40, seed=1, device="cpu"))
    (ref_l, ref_v), ref_acts = traced(to_cpu(qp), obs)
    (l, v), acts = traced(qp, obs.cuda())
    torch.cuda.synchronize()
    diffs = [(a.cpu().int() - r.int()).abs() for a, r in zip(acts, ref_acts)]
    total = sum(d.numel() for d in diffs)
    res = {
        "quant_points": len(diffs),
        "s8_differing_share": sum(int((d > 0).sum()) for d in diffs) / total,
        "s8_max_diff": max(int(d.max()) for d in diffs),
        "logit_err": float((l.cpu() - ref_l).abs().max()),
        "value_err": float((v.cpu() - ref_v).abs().max()),
        "logit_scale": float(ref_l.abs().max()),
    }
    log("[net_int8] " + json.dumps(res))
    # The s8 products are exact on both sides.  What differs is the order of
    # the f32 sums in the SE gate's contraction and of the bf16 head
    # products, and the sigmoid.  A gate off by one bf16 ulp (2**-8
    # relative) moves ``h2 * g``, which percentile clipping lets reach
    # several times the next scale, by more than one s8 step there, and
    # later layers carry a flipped rounding on.  Limits: under 1 % of s8
    # activations differ, none by more than 4 steps; heads as for the bf16
    # net.
    if not (res["s8_differing_share"] < 0.01 and res["s8_max_diff"] <= 4):
        raise AssertionError(f"int8 trunk on the card disagrees with the CPU: {res}")
    if not (res["logit_err"] < 0.5 and res["value_err"] < 0.1):
        raise AssertionError(f"int8 net on the card disagrees with the CPU: {res}")
    return res


def _s8_launches_expected(batches, convs: int, chunk: int) -> int:
    """s8_mm launches of the evaluator for the batch sizes it was given:
    one per conv per chunk (a batch of at most one chunk is one chunk, as
    the W=1 path's 256-position evaluations are)."""
    return sum(convs * (n // chunk if n > chunk and n % chunk == 0 else 1)
               for n in batches)


def phase_main_path(env, eval_fn, label: str, sims: int, moves: int,
                    s8_convs: int = 0, B: int = 1024, W: int = 16,
                    reuse: bool = False, greedy: bool = False,
                    tag: str = "main", start_states=None) -> dict:
    """Self-play moves at full width (K=32) with ``eval_fn``: B lanes, W
    walkers a wave; recycling and moves sampled at temperature 1, or with
    ``greedy`` greedy moves and no recycling; with ``reuse`` tree reuse
    (topup budget), always greedy.  The first move is the warm-up.
    ``s8_convs``: s8_mm launches the evaluator makes per chunk (0: none
    expected).  ``start_states``: the B root states of the first move
    (default: empty boards).

    The warm-up move runs with its kernel calls recorded, and with ``reuse``
    one untimed move after the timed ones too (a move that re-roots); every
    recorded signature is then held against its plain version.

    Reuse plays greedily, as self-play does after ``temperature_drop_move``
    and the arena always: the topup budget is set by the least-visited
    played child of all B lanes, and at temperature 1 some lane of 1024
    nearly always samples a child of a few visits, so no move would save a
    simulation."""
    from alphazero_tpu_torch import production
    from alphazero_tpu_torch.mcts.search import MCTSConfig
    from alphazero_tpu_torch.ops.gather_rows import gather_rows
    from alphazero_tpu_torch.ops.s8_mm import s8_mm
    from alphazero_tpu_torch.selfplay.actor import SelfPlayConfig, make_host_actor

    greedy = greedy or reuse
    batches = []

    def counted_eval(obs, to_play=None):
        batches.append(obs.shape[0])
        return eval_fn(obs, to_play)

    config = SelfPlayConfig(
        mcts=MCTSConfig(num_simulations=sims, wave_size=W, max_children=32,
                        tree_reuse=reuse, reuse_budget="topup"),
        recycle=not greedy, temperature=0.0 if greedy else 1.0)
    step, states = make_host_actor(env, counted_eval, config, B, device="cuda")
    if start_states is not None:
        states = start_states
    gen = torch.Generator(device="cuda").manual_seed(0)
    rec = _KernelCalls()

    def play(states, move):
        legal = env.legal_mask(states)
        new_states, out = step(states, gen)
        if reuse:
            roots = step.last_search.tree.visits[:, 0]
            if not bool((roots[out.active] >= sims).all()):
                raise AssertionError(f"move {move}: root visits below {sims}: "
                                     f"{int(roots[out.active].min())}")
        else:
            visits = step.last_search.visit_counts.sum(-1)
            if not bool((visits[out.active] == sims).all()):
                raise AssertionError(f"move {move}: root visits "
                                     f"{visits.unique().tolist()}")
        chosen_legal = legal.gather(1, out.action.long()[:, None])[:, 0]
        if not bool(chosen_legal[out.active].all()):
            raise AssertionError(f"move {move}: an illegal action was chosen")
        return new_states

    gather_rows.launches = 0
    s8_mm.launches = 0
    times, fresh, per_move = [], [], []
    for move in range(moves):
        before = (gather_rows.launches, s8_mm.launches, len(batches))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with rec if move == 0 else contextlib.nullcontext():
            new_states = play(states, move)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_move.append({"gather_rows": gather_rows.launches - before[0],
                         "s8_mm": s8_mm.launches - before[1],
                         "evaluations": len(batches) - before[2]})
        if reuse:
            fresh.append(step.search.last_fresh_sims)
        states = new_states
    launches = {"gather_rows": gather_rows.launches, "s8_mm": s8_mm.launches}
    gather_per_move = gather_rows.launches / moves
    if launches["gather_rows"] <= 0:
        raise AssertionError(f"the {tag} path launched no gather_rows kernel")
    expected = _s8_launches_expected(batches, s8_convs, production.INT8_CHUNK)
    if launches["s8_mm"] != expected or (s8_convs and expected <= 0):
        raise AssertionError(f"s8_mm launches {launches['s8_mm']}, but the "
                             f"evaluated batches predict {expected}")
    if reuse and not (fresh[0] == sims and max(fresh[1:]) < sims):
        raise AssertionError(f"tree reuse saved no simulations: {fresh}")
    if reuse:
        with rec:
            play(states, moves)
        log(f"[{tag}] untimed move {moves + 1}, recorded: "
            f"{step.search.last_fresh_sims} fresh simulations after a reroot")
    _check_recorded(tag, rec)

    # One wave's evaluation alone, to split the move time.
    obs = env.observation(env.init(B * W, device="cuda"))
    eval_ms = cuda_ms(lambda: eval_fn(obs, None), reps=5)
    timed = times[1:]
    move_s = sum(timed) / len(timed)
    # Evaluations of B * W positions a timed move (the roots' one counted
    # as a wave).
    waves = 1 + (sum(fresh[1:]) / W / len(timed) if reuse else config.mcts.waves)
    res = {
        "inference": label, "B": B, "simulations": sims, "wave": W,
        "tree_reuse": reuse, "greedy": greedy, "moves": moves, "move_s": times,
        "timed_moves_per_s": len(timed) * B / sum(timed),
        "launches": launches, "launches_per_move": per_move,
        "gather_launches_per_move": gather_per_move,
        "s8_mm_launches_expected": expected,
        "eval_calls": len(batches),
        "eval_ms_per_wave": eval_ms,
        "eval_share_est": eval_ms * waves / 1e3 / move_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    if reuse:
        res["fresh_sims_per_move"] = fresh
    if W == 1:
        # A simulation is one evaluation of B positions plus one descent,
        # install and backprop: what is left of its share of the move.
        sim_ms = move_s * 1e3 / (sims + 1)
        res["ms_per_simulation"] = sim_ms
        res["eval_ms_per_simulation"] = eval_ms
        res["search_ms_per_simulation"] = sim_ms - eval_ms
    log(f"[{tag}] " + json.dumps(res))
    return res


def phase_probe_path() -> dict:
    """The probe entry point as a user runs it; its path launches
    s8_mm_multi, chained_dot and tiled_mm (and s8_mm)."""
    from alphazero_tpu_torch.ops import s8_mm as ops
    from alphazero_tpu_torch.scripts import profile_s8_dots as probe

    names = ("s8_mm", "s8_mm_multi", "chained_dot", "tiled_mm")
    for n in names:
        getattr(ops, n).launches = 0
    probe.main(["--reps", "3", "--chain", "8"])
    launches = {n: getattr(ops, n).launches for n in names}
    log("[probe_path] " + json.dumps(launches))
    missing = [n for n, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f"the probe path launched no kernel of {missing}")
    return launches


def phase_card_vs_cpu() -> list:
    from alphazero_tpu_torch.core import registry
    from alphazero_tpu_torch.mcts.search import MCTSConfig, make_host_search, select_action
    from alphazero_tpu_torch.models.stub import make_uniform_eval_fn

    cfg = MCTSConfig(num_simulations=256, wave_size=16, max_children=32,
                     dirichlet_epsilon=0.0)
    out = []
    # 15x15 as specified; 7x7 late positions (few legal moves) grow deeper
    # trees, so the deep levels of the descent are compared too.
    for board, plies in ((15, 24), (7, 40)):
        env = registry.create_game("gomoku", board)
        run = make_host_search(env, make_uniform_eval_fn(env.num_actions), cfg)
        roots_cpu = _random_states(env, 64, plies, seed=2, device="cpu")
        roots_gpu = roots_cpu.map(lambda x: x.cuda())
        rec = _KernelCalls()
        with rec:
            gpu = run(roots_gpu)
        cpu = run(roots_cpu)
        diff = int((gpu.visit_counts.cpu() != cpu.visit_counts).sum())
        same_action = bool(torch.equal(
            select_action(None, gpu.visit_counts, 0.0).cpu(),
            select_action(None, cpu.visit_counts, 0.0)))
        res = {"board": board, "differing_counts": diff,
               "same_actions": same_action,
               "max_depth": int(cpu.tree.depth.max())}
        log("[card_vs_cpu] " + json.dumps(res))
        if diff or not same_action:
            raise AssertionError(f"card and CPU searches differ: {res}")
        _check_recorded(f"card_vs_cpu {board}x{board}", rec, each=False)
        out.append(res)
    return out


def _integer_value_eval(env, hot: int = 0):
    """An evaluator whose value does not depend on the order of any sum: a
    value from integer arithmetic on the stone planes (a multiple of 2**-13
    in [-0.13, 0.13], so the search's f32 value sums are exact too), and
    uniform logits.  The stub's value is a float sum that can round
    otherwise on the card.  With ``hot`` > 0 only every ``hot``-th cell has
    a nonzero prior while one is legal (logit 0 against -1e4, whose
    exponent is exactly 0): the trees stay on a few cells and grow deep, so
    positions recur by transposition."""
    A = env.num_actions
    weights, cold = {}, {}

    def eval_fn(obs, to_play=None):
        B, dev = obs.shape[0], obs.device
        if dev not in weights:
            cells = torch.arange(2 * A, device=dev, dtype=torch.int64)
            weights[dev] = (cells * 2654435761 + 12345) % 1021
            cold[dev] = (torch.arange(A, device=dev) % max(hot, 1) != 0) * -1e4
        stones = obs[:, :2].reshape(B, 2 * A).to(torch.int64)
        h = (stones * weights[dev]).sum(-1)
        value = ((h * 40503) % 2001 - 1000).float() / 8192
        logits = torch.zeros((B, A), device=dev) + (cold[dev] if hot else 0.0)
        return logits, value

    return eval_fn


def phase_search_options() -> list:
    """The search options of slice 7 on the card against the CPU, inside
    the port, bit for bit: 64 lanes of 15x15 and of crowded 7x7 positions
    (as [card_vs_cpu]), no noise; equal visit counts, table hits and
    stores, and fresh simulations a move.  The table and reuse cases
    evaluate with a prior on about 6 cells, so transpositions hit on most
    lanes (each table case must hit at least 64 times, on at least half the
    lanes) and reuse keeps deep subtrees.  Every kernel call of each case's
    card run is recorded and held against its plain version."""
    from alphazero_tpu_torch.core import registry
    from alphazero_tpu_torch.mcts.search import HostReuseSearch, MCTSConfig, search

    base = dict(num_simulations=64, max_children=32, dirichlet_epsilon=0.0)
    cases = [
        ("w1", dict(wave_size=1)),
        ("parity", dict(wave_size=1, parity_mode=True)),  # K = A below
        ("td_lambda_0.5", dict(wave_size=1, td_lambda=0.5)),
        ("tt256_w1", dict(wave_size=1, tt_size=256, num_simulations=128)),
        ("tt256_w16", dict(wave_size=16, tt_size=256, num_simulations=128)),
    ]
    reuse = [(f"reuse_{budget}_w{w}", dict(wave_size=w, tree_reuse=True,
                                            reuse_cap=64, reuse_budget=budget))
             for w in (1, 16) for budget in ("topup", "fixed")]
    out = []
    for board, plies in ((15, 24), (7, 40)):
        env = registry.create_game("gomoku", board)
        uniform = _integer_value_eval(env)
        focused = _integer_value_eval(env, hot=env.num_actions // 6)
        roots = {"cpu": _random_states(env, 64, plies, seed=3, device="cpu")}
        roots["cuda"] = roots["cpu"].map(lambda x: x.cuda())
        for name, kw in cases + reuse:
            kw = dict(base, **kw)
            if kw.get("parity_mode"):
                kw["max_children"] = env.num_actions
            cfg = MCTSConfig(**kw)
            eval_fn = focused if cfg.tt_size or cfg.tree_reuse else uniform
            runs, rec = {}, _KernelCalls()
            t0 = time.perf_counter()
            for dev in ("cuda", "cpu"):
                with rec if dev == "cuda" else contextlib.nullcontext():
                    if not cfg.tree_reuse:
                        res = search(env, eval_fn, roots[dev], cfg)
                        tt = res.tree.tt
                        runs[dev] = [(res.visit_counts.cpu(),
                                      None if tt is None else (tt.hits.cpu(), tt.stores.cpu()),
                                      None)]
                        continue
                    hs, st, moves = HostReuseSearch(env, eval_fn, cfg), roots[dev], []
                    for _ in range(3):
                        res = hs(st)
                        moves.append((res.visit_counts.cpu(), None, hs.last_fresh_sims))
                        action = res.visit_counts.argmax(-1).int()
                        hs.notify_action(action)
                        st = env.step(st, action)
                    runs[dev] = moves
            equal = all(torch.equal(a[0], b[0]) and a[2] == b[2]
                        and (a[1] is None or all(torch.equal(x, y)
                                                 for x, y in zip(a[1], b[1])))
                        for a, b in zip(runs["cuda"], runs["cpu"]))
            row = {"board": board, "case": name, "equal": equal,
                   "visits": int(runs["cpu"][-1][0].sum()),
                   "s": round(time.perf_counter() - t0, 2)}
            if runs["cpu"][0][1] is not None:
                hits, stores = runs["cpu"][0][1]
                row["tt_hits"], row["tt_stores"] = int(hits.sum()), int(stores.sum())
                row["lanes_hit"] = int((hits > 0).sum())
            if cfg.tree_reuse:
                row["fresh_sims"] = [m[2] for m in runs["cpu"]]
            log("[search_options] " + json.dumps(row))
            if not equal:
                raise AssertionError(f"card and CPU differ: {row}")
            if cfg.tt_size and not (row["tt_hits"] >= 64 and row["lanes_hit"] >= 32):
                raise AssertionError(f"too few table hits to test the hit path: {row}")
            _check_recorded(f"search_options {board}x{board} {name}", rec, each=False)
            out.append(row)
    return out


def phase_parity() -> list:
    """Parity mode on the card at the seven positions of the reference
    engine's dump: sorted visit vectors equal to the reference's."""
    from alphazero_tpu_torch.core import registry
    from alphazero_tpu_torch.mcts.search import MCTSConfig, search
    from alphazero_tpu_torch.models.stub import make_uniform_eval_fn

    env = registry.create_game("gomoku", 15)
    path = os.path.join(ROOT, "tools", "parity", "reference_dump_gomoku15.json")
    with open(path) as f:
        cases = [json.loads(line) for line in f if line.strip()]
    rows, rec = [], _KernelCalls()
    for case in cases:
        cfg = MCTSConfig(num_simulations=case["sims"], c_puct=1.5,
                         dirichlet_epsilon=0.0, parity_mode=True,
                         max_children=env.num_actions)
        st = env.init(1, device="cuda")
        for mv in case["position"]:
            st = env.step(st, torch.tensor([mv], device="cuda"))
        t0 = time.perf_counter()
        with rec:
            ours = search(env, make_uniform_eval_fn(env.num_actions), st,
                          cfg).visit_counts[0].cpu().numpy()
        ref = np.asarray(case["visits"])
        rows.append({"plies": len(case["position"]), "sims": case["sims"],
                     "equal": bool(np.array_equal(np.sort(ours), np.sort(ref))),
                     "s": round(time.perf_counter() - t0, 2)})
    log("[search_options] parity vs the reference engine: " + json.dumps(rows))
    if not all(r["equal"] for r in rows):
        raise AssertionError(f"parity mode differs from the reference engine: {rows}")
    _check_recorded("search_options parity", rec, each=False)
    return rows


def phase_train_config(name: str = "gomoku_15x15.json", tag: str = "train_config",
                       cuts: dict | None = None, reload: bool = False) -> dict:
    """``scripts/train.py --config`` on a copy of ``config/<name>`` cut in
    depth only (printed): the shipped width (its games, its GroupNorm net on
    the raw inference path, W=1), 2 iterations of 8 moves (``cuts``
    overrides), 64 simulations, 4 train steps.  Every distinct gather and
    s8_mm call of the run is held against its plain version.  With
    ``reload``, a fresh ``Pipeline`` of the same config restores the last
    checkpoint: its weights, optimizer state, step and generator must equal
    the file's bit for bit."""
    import tempfile

    from alphazero_tpu_torch.ops.gather_rows import gather_rows
    from alphazero_tpu_torch.ops.s8_mm import s8_mm
    from alphazero_tpu_torch.scripts import train as train_cli

    with open(os.path.join(ROOT, "config", name)) as f:
        cfg = json.load(f)
    cuts = {"iterations": 2, "selfplay.max_moves": 8,
            "selfplay.mcts.num_simulations": 64,
            "train_steps_per_iteration": 4, "min_replay_before_training": 1,
            "checkpoint_every": 1, **(cuts or {})}
    with tempfile.TemporaryDirectory() as tmp:
        cuts["checkpoint_dir"] = os.path.join(tmp, "run")
        for key, v in cuts.items():
            *path, last = key.split(".")
            node = cfg
            for k in path:
                node = node[k]
            node[last] = v
        log(f"[{tag}] cuts of config/{name}: " + json.dumps(
            {k: v for k, v in cuts.items() if k != "checkpoint_dir"}))
        cfg_path = os.path.join(tmp, name)
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        gather_rows.launches = 0
        s8_mm.launches = 0
        t0 = time.perf_counter()
        with _KernelCalls() as recorded:
            train_cli.main(["--config", cfg_path])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"gather_rows": gather_rows.launches, "s8_mm": s8_mm.launches}
        with open(os.path.join(cuts["checkpoint_dir"], "history.json")) as f:
            history = json.load(f)
        files = sorted(os.listdir(cuts["checkpoint_dir"]))
        if reload:
            from alphazero_tpu_torch.training.pipeline import PipelineConfig
            from alphazero_tpu_torch.utils.config import load_config

            reloaded = _reload_checkpoint(load_config(PipelineConfig, cfg_path))
    held = _check_recorded(tag, recorded)
    for e in history:
        log(f"[{tag}] iteration: " + json.dumps(e))
    res = {"wall_s": wall, "launches": launches, "files": files,
           "signatures": len(held)}
    if reload:
        res["checkpoint_reload_bit_equal"] = reloaded
    log(f"[{tag}] " + json.dumps(res))
    if reload and not reloaded:
        raise AssertionError(f"config/{name}'s last checkpoint did not reload bit for bit")
    if launches["gather_rows"] <= 0:
        raise AssertionError(f"config/{name}'s actor launched no gather_rows")
    if not (len(history) == 2 and all(np.isfinite(e["loss"]) for e in history)
            and "ckpt_1.pt" in files):
        raise AssertionError(f"config/{name} did not train: {history}, {files}")
    return res


def _reload_checkpoint(config, keep: list | None = None) -> bool:
    """A fresh ``Pipeline`` of ``config`` restores its last checkpoint:
    weights, optimizer state, step and generator equal the file's, bit for
    bit.  ``keep`` (a list) receives the fresh pipeline."""
    from alphazero_tpu_torch.training.pipeline import Pipeline

    fresh = Pipeline(config)
    if keep is not None:
        keep.append(fresh)
    it = fresh.restore_checkpoint()
    saved = torch.load(fresh._checkpoint_path(it), map_location="cpu", weights_only=True)
    sd = fresh.state.module.state_dict()
    opt = fresh.state.optimizer.state_dict()["state"]
    return (fresh.state.step == saved["step"]
            and all(torch.equal(sd[k].cpu(), v) for k, v in saved["model"].items())
            and all(torch.equal(opt[i][n].cpu(), v)
                    for i, st in saved["optimizer"]["state"].items() for n, v in st.items())
            and torch.equal(fresh.generator.get_state(), saved["generator"])
            and torch.equal(fresh.actor_generator.get_state(),
                            saved["actor_generators"][0]))


def _playout_states(env, B: int, max_plies: int, gen) -> object:
    """Seeded random playouts on the CPU: lane b plays ``b % (max_plies +
    1)`` uniform legal moves (odd lanes inside the 7x7 center while they
    can, so threats and fives come early); games that end stop there.
    ``_random_states`` draws lane by lane and steps every action to keep
    games alive; this draws for all lanes at once, which 4,096 lanes
    need."""
    from alphazero_tpu_torch.core.types import where_lanes

    n = env.board_size
    cells = torch.arange(n * n)
    near = ((cells // n - n // 2).abs() <= 3) & ((cells % n - n // 2).abs() <= 3)
    odd = (torch.arange(B) % 2 == 1)[:, None]
    plies = torch.arange(B) % (max_plies + 1)
    st = env.init(B, device="cpu")
    for ply in range(max_plies):
        legal = env.legal_mask(st)
        pref = legal & near & odd
        w = torch.where(pref.any(-1, keepdim=True), pref, legal)
        w = w | ~w.any(-1, keepdim=True)
        acts = torch.multinomial(w.float(), 1, generator=gen)[:, 0]
        st = where_lanes(plies > ply, env.step(st, acts), st)
    return st


_STATE_FIELDS = ("board", "to_play", "last_moves", "move_count", "terminal",
                 "winner", "hash")


def phase_variants_exact() -> list:
    """Renju, Omok and pro-long on the card against the CPU, exactly: 4,096
    seeded random-playout positions at 15x15 with 0 to 60 plies;
    ``forbidden_map`` (both maps), ``legal_mask``, and ``step`` (every
    field) on one more move a lane drawn from the variant's legal cells."""
    from alphazero_tpu_torch.games.gomoku import GomokuEnv

    gen = torch.Generator().manual_seed(11)
    cpu = _playout_states(GomokuEnv(board_size=15), 4096, 60, gen)
    gpu = cpu.map(lambda x: x.cuda())
    rows = []
    for name, kw in (("renju", dict(use_renju=True)), ("omok", dict(use_omok=True)),
                     ("pro_long", dict(use_pro_long_opening=True))):
        env = GomokuEnv(board_size=15, **kw)
        eq, row = {}, {"variant": name, "positions": cpu.batch_size}
        if name != "pro_long":
            fc, vc = env.forbidden_map(cpu.board == 0, cpu.board == 1)
            fg, vg = env.forbidden_map(gpu.board == 0, gpu.board == 1)
            eq["forbidden"] = torch.equal(fc, fg.cpu())
            eq["exact_five"] = torch.equal(vc, vg.cpu())
            row["forbidden_points"] = int((fc & ~vc).sum())
            row["boards_with_forbidden"] = int((fc & ~vc).flatten(1).any(1).sum())
        lc = env.legal_mask(cpu)
        eq["legal_mask"] = torch.equal(lc, env.legal_mask(gpu).cpu())
        w = lc | ~lc.any(-1, keepdim=True)
        acts = torch.multinomial(w.float(), 1, generator=gen)[:, 0]
        sc, sg = env.step(cpu, acts), env.step(gpu, acts.cuda())
        for f in _STATE_FIELDS:
            eq[f"step.{f}"] = torch.equal(getattr(sc, f), getattr(sg, f).cpu())
        row["wins_after_step"] = int(((sc.winner >= 0) & ~cpu.terminal).sum())
        row["equal"] = eq
        log("[variants] card vs CPU: " + json.dumps(row))
        if not all(eq.values()):
            raise AssertionError(f"{name} differs between the card and the CPU: {eq}")
        rows.append(row)
    return rows


def _policy_plies(env, eval_fn, B: int, plies: int, seed: int):
    """B games from the empty board after ``plies`` moves sampled from the
    net's masked policy, on the card.  A move that would end its game is
    taken back (the lane draws again on the next ply), so the roots are
    live."""
    from alphazero_tpu_torch.core.types import where_lanes
    from alphazero_tpu_torch.mcts.search import masked_softmax

    gen = torch.Generator(device="cuda").manual_seed(seed)
    st = env.init(B, device="cuda")
    with torch.no_grad():
        for _ in range(plies):
            logits, _ = eval_fn(env.observation(st), env.to_play(st))
            probs = masked_softmax(logits.float(), env.legal_mask(st))
            nxt = env.step(st, torch.multinomial(probs, 1, generator=gen)[:, 0])
            st = where_lanes(nxt.terminal, st, nxt)
    return st


def phase_variants(int8_eval, convs: int, main_res: dict, sims: int = 800) -> dict:
    """Renju self-play at the main path's full width: B=1024, W=16, ``sims``
    simulations, K=32, the flagship's int8 executor, from positions after
    20 policy-sampled plies (so forbidden points exist), 2 moves (the
    second timed), through ``phase_main_path`` (its checks, launch counts
    and recorded kernel calls held against their plain versions).  Prints
    moves/s beside [main]'s, the forbidden points among the roots' cells,
    and ``legal_mask``'s time a wave (B*W leaves) under Renju and
    freestyle."""
    from alphazero_tpu_torch.core import registry

    exact = phase_variants_exact()
    renju = registry.create_game("gomoku", 15, use_renju=True)
    free = registry.create_game("gomoku", 15)
    B, W = 1024, 16
    starts = _policy_plies(renju, int8_eval, B, 20, seed=12)
    black = (starts.to_play == 0) & ~starts.terminal
    lost = (free.legal_mask(starts) & ~renju.legal_mask(starts))[black]
    roots = {"roots": B, "black_to_move": int(black.sum()),
             "terminal": int(starts.terminal.sum()),
             "forbidden_points": int(lost.sum()),
             "roots_with_forbidden": int(lost.any(-1).sum())}
    log("[variants] Renju roots after 20 policy plies: " + json.dumps(roots))
    if roots["forbidden_points"] <= 0:
        raise AssertionError(f"no forbidden point among the Renju roots: {roots}")
    # legal_mask over one wave's leaves: each root and one legal move, W times.
    gen = torch.Generator(device="cuda").manual_seed(13)
    rep = starts.map(lambda x: x.repeat_interleave(W, 0))
    legal = free.legal_mask(rep)
    w = legal | ~legal.any(-1, keepdim=True)
    leaves = free.step(rep, torch.multinomial(w.float(), 1, generator=gen)[:, 0])
    mask_ms = {"renju": cuda_ms(lambda: renju.legal_mask(leaves), reps=10),
               "freestyle": cuda_ms(lambda: free.legal_mask(leaves), reps=10)}
    res = phase_main_path(renju, int8_eval, "int8", sims=sims, moves=2,
                          s8_convs=convs, B=B, W=W, tag="variants",
                          start_states=starts)
    waves = sims // W + 1
    summary = {
        "renju_moves_per_s": res["timed_moves_per_s"],
        "main_moves_per_s": main_res["timed_moves_per_s"],
        "legal_mask_ms_per_wave": mask_ms,
        "legal_mask_leaves": leaves.batch_size,
        "renju_legal_mask_s_per_move_est": mask_ms["renju"] * waves / 1e3,
        "gather_launches_per_move": res["gather_launches_per_move"],
        "s8_mm_launches": res["launches"]["s8_mm"],
    }
    log("[variants] " + json.dumps(summary))
    return {"exact": exact, "roots": roots, "main": res, **summary}


def _jax_cli_keys(path: str) -> list:
    """The keys of the dict the JAX CLI at ``path`` prints with
    ``json.dumps`` (read from its source; nothing of it is imported)."""
    import ast

    with open(os.path.join(ROOT, path)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "print"
                and node.args and isinstance(node.args[0], ast.Call)
                and getattr(node.args[0].func, "attr", "") == "dumps"
                and isinstance(node.args[0].args[0], ast.Dict)):
            return [k.value for k in node.args[0].args[0].keys]
    raise AssertionError(f"no printed JSON dict in {path}")


def phase_arena() -> dict:
    """Evaluation on the card.

    1. Card against CPU at 7x7, temperature 0, no openings: play_match_sides
       (the uniform stub, value 0, at 32 simulations with tree reuse against
       ``_integer_value_eval`` at 16) and play_match_host (24 simulations,
       the same two nets); every lane's winner and final board equal.
    2. ``scripts/evaluate.py`` as a subprocess: its JSON keys equal the
       JAX CLI's.
    The kernel calls of the card runs of 1 are held against their plain
    versions.  The anchored ladder is [anchor_eval]'s (slice 12): the
    anchor evaluation script on the flagship, with the gate this phase had."""
    from alphazero_tpu_torch.core import registry
    from alphazero_tpu_torch.eval.arena import (
        ArenaConfig, play_match_host, play_match_sides)
    from alphazero_tpu_torch.mcts.search import MCTSConfig
    from alphazero_tpu_torch.models.stub import make_uniform_eval_fn

    out = {}
    env7 = registry.create_game("gomoku", 7)
    uni, ival = make_uniform_eval_fn(env7.num_actions), _integer_value_eval(env7)
    side_a = (uni, MCTSConfig(num_simulations=32, wave_size=8, dirichlet_epsilon=0.0,
                              tree_reuse=True, reuse_cap=64))
    side_b = (ival, MCTSConfig(num_simulations=16, wave_size=4, dirichlet_epsilon=0.0))
    host_cfg = ArenaConfig(mcts=MCTSConfig(num_simulations=24, wave_size=8,
                                           dirichlet_epsilon=0.0),
                           max_moves=49, temperature=0.0)
    runs, rec = {}, _KernelCalls()
    for dev in ("cuda", "cpu"):
        with rec if dev == "cuda" else contextlib.nullcontext():
            runs[dev] = (play_match_sides(env7, side_a, side_b, None, 16, max_moves=49,
                                          temperature=0.0, device=dev),
                         play_match_host(env7, uni, ival, None, host_cfg, 16, device=dev))
    for i, kind in enumerate(("sides", "host")):
        g, c = runs["cuda"][i], runs["cpu"][i]
        row = {"match": kind, "lanes": c.winner.shape[0],
               "winners": c.winner.tolist(),
               "moves": c.states.move_count.tolist(),
               "winner_equal": torch.equal(g.winner.cpu(), c.winner),
               "board_equal": torch.equal(g.states.board.cpu(), c.states.board)}
        log("[arena] card vs CPU 7x7: " + json.dumps(row))
        if not (row["winner_equal"] and row["board_equal"]):
            raise AssertionError(f"arena card and CPU differ: {row}")
        out[f"card_vs_cpu_{kind}"] = row
    _check_recorded("arena card_vs_cpu", rec, each=False)

    cmd = [sys.executable, "-m", "alphazero_tpu_torch.scripts.evaluate",
           "--model-a", os.path.join("models_zoo", "flagship_gomoku15"),
           "--num-games", "2", "--simulations", "16"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd)} failed: {proc.stderr[-2000:]}")
    printed = json.loads(proc.stdout.strip().splitlines()[-1])
    want = _jax_cli_keys(os.path.join("alphazero_tpu", "scripts", "evaluate.py"))
    out["cli"] = {"printed": printed, "wall_s": time.perf_counter() - t0,
                  "keys_equal_jax": list(printed) == want}
    log("[arena] scripts/evaluate.py: " + json.dumps(out["cli"]))
    if list(printed) != want:
        raise AssertionError(f"evaluate.py printed keys {list(printed)}, the JAX CLI {want}")
    return out


# ---- Go (slice 9) ---------------------------------------------------------

_GO_FIELDS = ("board", "to_play", "ko_point", "consecutive_passes", "move_count",
              "prisoners", "terminal", "winner", "board_hash", "history",
              "last_move")
GO9_PATH = os.path.join(ROOT, "models_zoo", "go9")


def phase_go_exact(sizes=((9, 4096, 120), (19, 1024, 240))) -> dict:
    """Go on the card against the CPU, exactly: 4,096 random-playout 9x9
    positions (0 to 120 plies) and 1,024 at 19x19 (0 to 240 plies), played
    on the card (the CPU takes minutes for them):
    ``legal_mask``, ``observation`` (bit for bit), area and territory
    scores with and without dead stones, ``territory_ownership``,
    ``position_hash``, the arena-row round trip, and ``step`` (every field,
    then the mask and observation from the stats it kept) on one more
    legal move a lane.  Prints the ko points, the moves the superko ring
    refuses (with the ko point set aside, and where nothing else refuses
    them), and the captures among the positions.  Returns the positions,
    for the env timings of the main paths."""
    from alphazero_tpu_torch.games.go import GoEnv
    from alphazero_tpu_torch.scripts.profile_go_env import random_playouts

    gen = torch.Generator().manual_seed(31)
    card_gen = torch.Generator(device="cuda").manual_seed(31)
    out = {}
    for n, B, plies in sizes:
        env = GoEnv(board_size=n)
        t0 = time.perf_counter()
        gpu = random_playouts(env, B, plies, card_gen, device="cuda")
        cpu = gpu.map(lambda x: x.cpu())
        made_s = time.perf_counter() - t0
        eq = {}
        lc = env.legal_mask(cpu)
        eq["legal_mask"] = torch.equal(lc, env.legal_mask(gpu).cpu())
        eq["observation"] = torch.equal(env.observation(cpu).view(torch.int16),
                                        env.observation(gpu).view(torch.int16).cpu())
        dead = torch.rand((B, n, n), generator=gen) < 0.05
        for rules in (True, False):
            e = dataclasses.replace(env, chinese_rules=rules)
            name = "area" if rules else "territory"
            for tag, args in (("", ()), ("_dead", (dead,))):
                sc = e.score(cpu, *args)
                sg = e.score(gpu, *[a.cuda() for a in args])
                eq[f"score_{name}{tag}"] = all(torch.equal(c, g.cpu())
                                               for c, g in zip(sc, sg))
        eq["territory_ownership"] = torch.equal(env.territory_ownership(cpu),
                                                env.territory_ownership(gpu).cpu())
        eq["position_hash"] = torch.equal(env.position_hash(cpu),
                                          env.position_hash(gpu).cpu())
        rows = [r.cuda() for r in env.arena_rows(cpu)]
        back = env.from_arena_rows(*rows)
        eq["arena_rows"] = all(torch.equal(getattr(back, f).cpu(), getattr(cpu, f))
                               for f in _GO_FIELDS)
        w = lc.float()
        w = torch.where(w.sum(1, keepdim=True) > 0, w, torch.ones_like(w))
        acts = torch.multinomial(w, 1, generator=gen)[:, 0]
        sc, sg = env.step(cpu, acts), env.step(gpu, acts.cuda())
        for f in _GO_FIELDS:
            eq[f"step.{f}"] = torch.equal(getattr(sc, f), getattr(sg, f).cpu())
        eq["step.legal_mask"] = torch.equal(env.legal_mask(sc), env.legal_mask(sg).cpu())
        eq["step.observation"] = torch.equal(
            env.observation(sc).view(torch.int16), env.observation(sg).view(torch.int16).cpu())
        # The ring against a sentinel hash no board takes, with and without
        # the ko point.
        no_ko = dataclasses.replace(cpu, ko_point=torch.full_like(cpu.ko_point, -1))
        sentinel = torch.full_like(cpu.history, 0xFFFFFFFF)
        ring = (env.legal_mask(dataclasses.replace(no_ko, history=sentinel))
                & ~env.legal_mask(no_ko))
        ring_only = env.legal_mask(dataclasses.replace(cpu, history=sentinel)) & ~lc
        row = {"board": n, "positions": B, "plies": f"0-{plies}",
               "made_on_card_s": made_s,
               "ko_points": int((cpu.ko_point >= 0).sum()),
               "superko_refusals": int(ring.sum()),
               "superko_refusals_ring_alone": int(ring_only.sum()),
               "captured_stones": int(cpu.prisoners.sum()),
               "terminal": int(cpu.terminal.sum()),
               "captures_on_the_step": int((sc.prisoners.sum(1) - cpu.prisoners.sum(1)).sum()),
               "equal": eq}
        log("[go_exact] card vs CPU: " + json.dumps(row))
        if not all(eq.values()):
            raise AssertionError(f"Go {n}x{n} differs between the card and the CPU: {eq}")
        out[n] = gpu
    return out


def phase_go_search() -> list:
    """The search on Go, card against CPU, at 9x9: B=64 live random-playout
    roots (0 to 40 plies, on the CPU), 128 simulations, the uniform evaluator with
    value 0, no noise, greedy, at W=16, at W=1, and at W=1 with a 256-entry
    table: equal visit counts, actions, table hits and stores.  The card's
    kernel calls are held against their plain versions."""
    from alphazero_tpu_torch.games.go import GoEnv
    from alphazero_tpu_torch.mcts.search import MCTSConfig, make_host_search, select_action
    from alphazero_tpu_torch.models.stub import make_uniform_eval_fn
    from alphazero_tpu_torch.scripts.profile_go_env import random_playouts

    env = GoEnv(board_size=9)
    roots = random_playouts(env, 96, 40, torch.Generator().manual_seed(32), device="cpu")
    live = torch.nonzero(~roots.terminal)[:64, 0]
    if live.numel() < 64:
        raise AssertionError("fewer than 64 live [go_search] roots")
    roots = roots.map(lambda x: x[live])
    uni = make_uniform_eval_fn(env.num_actions)
    rows, rec = [], _KernelCalls()
    for name, kw in (("W=16", dict(wave_size=16)), ("W=1", dict(wave_size=1)),
                     ("W=1 table 256", dict(wave_size=1, tt_size=256))):
        cfg = MCTSConfig(num_simulations=128, max_children=32,
                         dirichlet_epsilon=0.0, **kw)
        run = make_host_search(env, uni, cfg)
        with rec:
            gpu = run(roots.map(lambda x: x.cuda()))
        cpu = run(roots)
        row = {"case": name,
               "differing_counts": int((gpu.visit_counts.cpu() != cpu.visit_counts).sum()),
               "same_actions": bool(torch.equal(
                   select_action(None, gpu.visit_counts, 0.0).cpu(),
                   select_action(None, cpu.visit_counts, 0.0))),
               "max_depth": int(cpu.tree.depth.max())}
        ok = row["differing_counts"] == 0 and row["same_actions"]
        if cfg.tt_size:
            g, c = gpu.tree.tt, cpu.tree.tt
            row.update(hits=int(c.hits.sum()), stores=int(c.stores.sum()),
                       table_equal=bool(torch.equal(g.hits.cpu(), c.hits)
                                        and torch.equal(g.stores.cpu(), c.stores)))
            ok = ok and row["table_equal"] and row["stores"] > 0
        log("[go_search] card vs CPU: " + json.dumps(row))
        if not ok:
            raise AssertionError(f"Go searches differ between the card and the CPU: {row}")
        rows.append(row)
    _check_recorded("go_search", rec, each=False)
    return rows


def phase_go_main(env, eval_fn, convs: int, roots, tag: str, sims: int = 800) -> dict:
    """Go self-play at full width through ``phase_main_path`` (B=1024,
    W=16, ``sims`` simulations, K=32, recycle on, int8 executor, 2 moves, the
    second timed: its checks, exact ``s8_mm`` launches and recorded kernel
    calls), then one wave's env work on the card from mid-game roots
    (``profile_go_env.env_wave``: 1,024 [go_exact] positions, 16 leaves
    each, read back from arena rows, one move each: ms of ``step``,
    ``legal_mask`` and ``observation``, and host syncs)."""
    from alphazero_tpu_torch.scripts.profile_go_env import env_wave

    res = phase_main_path(env, eval_fn, "int8", sims=sims, moves=2,
                          s8_convs=convs, tag=tag)
    wave = env_wave(env, roots)
    waves = sims // 16 + 1
    summary = {"moves_per_s": res["timed_moves_per_s"],
               "eval_ms_per_wave": res["eval_ms_per_wave"],
               "env_ms_per_wave": wave["ms_per_wave"], "env_ms": wave["ms"],
               "env_syncs_per_wave": wave["syncs_per_wave"],
               "env_leaves": wave["leaves"],
               "env_s_per_move_est": wave["ms_per_wave"] * waves / 1e3,
               "gather_launches_per_move": res["gather_launches_per_move"],
               "s8_mm_launches": res["launches"]["s8_mm"]}
    log(f"[{tag}] " + json.dumps(summary))
    return {"main": res, **summary}


def phase_go_arena(games: int = 16, cand_sims: int = 128,
                   pool=("uniform_mcts_16", "uniform_mcts_64", "uniform_mcts_256")) -> dict:
    """The anchored ladder on Go: go9 as ``scripts/evaluate.py`` loads it
    (BN-folded bf16) at ``cand_sims`` simulations, W=16, against
    each anchor of ``pool`` through play_match_sides, ``games``
    games each, 4 random opening plies, T=0.1, 162 moves at most (the
    shape of ``tools/train_zoo_go9.py`` cut in games only); Bradley-Terry
    with uniform_mcts_256 at 1500 over this run's matches and the
    anchors' round-robin of ``docs/train_zoo_go9.json``.  Fails unless
    go9 takes three quarters of the games against uniform_mcts_16.  Then
    ``scripts/evaluate.py --game go`` as a subprocess: its JSON keys equal
    the JAX CLI's.  The first match's kernel calls are held against their
    plain versions."""
    from alphazero_tpu_torch.core import registry
    from alphazero_tpu_torch.elo.bradley_terry import fit_bradley_terry
    from alphazero_tpu_torch.eval import anchors
    from alphazero_tpu_torch.eval.arena import play_match_sides
    from alphazero_tpu_torch.mcts.search import MCTSConfig
    from alphazero_tpu_torch.ops.gather_rows import gather_rows
    from alphazero_tpu_torch.scripts.evaluate import load_eval_fn

    env = registry.create_game("go", 9)
    cand = (load_eval_fn(GO9_PATH, env, "cuda"),
            MCTSConfig(num_simulations=cand_sims, wave_size=16, dirichlet_epsilon=0.0))
    log("[go_arena] ladder depth: " + json.dumps({
        "games_per_anchor": games, "candidate_simulations": cand_sims, "wave": 16,
        "opening_plies": 4, "temperature": 0.1, "max_moves": 162}))
    gen = torch.Generator(device="cuda").manual_seed(41)
    rec, ladder, matches = _KernelCalls(), [], []
    gather_rows.launches = 0
    t_ladder = time.perf_counter()
    for i, name in enumerate(pool):
        before = gather_rows.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with rec if i == 0 else contextlib.nullcontext():
            res = play_match_sides(env, cand, anchors.make_anchor(env, name), gen, games,
                                   max_moves=162, temperature=0.1,
                                   opening_random_moves=4, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lanes = res.winner.shape[0]
        moves = int(res.states.move_count.sum()) - 4 * lanes
        wa, wb, d = int(res.wins_a), int(res.wins_b), int(res.draws)
        row = {"anchor": name, "result": f"+{wa} -{wb} ={d}", "wall_s": wall,
               "moves": moves, "moves_per_s": moves / wall,
               "plies_max": int(res.states.move_count.max()),
               "plies_mean": float(res.states.move_count.float().mean()),
               "gather_launches": gather_rows.launches - before}
        log("[go_arena] go9 vs " + json.dumps(row))
        ladder.append(row)
        matches.append((f"go9@{cand_sims}", name, wa, wb, d))
    ladder_wall = time.perf_counter() - t_ladder
    _check_recorded("go_arena ladder", rec, each=False)
    with open(os.path.join(ROOT, "docs", "train_zoo_go9.json")) as f:
        table = [tuple(m) for m in json.load(f)["matches"] if "zoo_go9" not in m[:2]]
    fit = {k: fit_bradley_terry(m, anchor=anchors.CANONICAL,
                                anchor_rating=anchors.CANONICAL_RATING)
           for k, m in (("this_run", matches), ("with_round_robin", matches + table))}
    total_moves = sum(r["moves"] for r in ladder)
    out = {"ladder": {
        "matches": ladder,
        "bt_rating": {k: v[f"go9@{cand_sims}"] for k, v in fit.items()},
        "anchor_ratings_with_round_robin": {a: fit["with_round_robin"][a] for a in pool},
        "wall_s": ladder_wall, "moves_per_s": total_moves / ladder_wall,
        "gather_launches": gather_rows.launches}}
    log("[go_arena] ladder: " + json.dumps({k: v for k, v in out["ladder"].items()
                                            if k != "matches"}))
    need = -(-3 * games // 4)
    if matches[0][2] < need:
        raise AssertionError(f"go9 took {matches[0][2]} of {games} games against "
                             f"{matches[0][1]}, fewer than {need}")
    # Its keys only are checked: 40 plies (cut from 162) keep it short.
    cmd = [sys.executable, "-m", "alphazero_tpu_torch.scripts.evaluate", "--game", "go",
           "--board-size", "9", "--model-a", os.path.join("models_zoo", "go9"),
           "--num-games", "2", "--simulations", "16", "--max-moves", "40"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd)} failed: {proc.stderr[-2000:]}")
    printed = json.loads(proc.stdout.strip().splitlines()[-1])
    want = _jax_cli_keys(os.path.join("alphazero_tpu", "scripts", "evaluate.py"))
    out["cli"] = {"printed": printed, "wall_s": time.perf_counter() - t0,
                  "keys_equal_jax": list(printed) == want}
    log("[go_arena] scripts/evaluate.py --game go: " + json.dumps(out["cli"]))
    if list(printed) != want:
        raise AssertionError(f"evaluate.py printed keys {list(printed)}, the JAX CLI {want}")
    return out


def phase_go(convs: int) -> dict:
    """Every Go phase in order; ``convs``: s8_mm launches a chunk of the
    6-block nets' int8 trunk."""
    from alphazero_tpu_torch.core import registry
    from alphazero_tpu_torch.models.io import load_model
    from alphazero_tpu_torch.models.quant import make_production_eval_fn
    from alphazero_tpu_torch.models.resnet import AZResNet

    walls, out = {}, {}

    def timed(phase, fn, /, *args, **kw):
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        walls[phase] = round(time.perf_counter() - t0, 1)
        return res

    positions = timed("go_exact", phase_go_exact)
    out["search"] = timed("go_search", phase_go_search)
    t0 = time.perf_counter()
    env9 = registry.create_game("go", 9)
    go9, _ = load_model(GO9_PATH, env9.observation_shape, device="cuda")
    int8_go9, calib = make_production_eval_fn(
        env9, go9, generator=torch.Generator(device="cuda").manual_seed(7))
    torch.cuda.synchronize()
    log(f"[go_main] calibration: {tuple(calib.shape)} rollout observations, "
        f"calibrated and quantised in {time.perf_counter() - t0:.2f} s")
    log("[go_main] depth cut: 192 simulations (was 800, then 400)")
    out["go_main"] = timed("go_main", phase_go_main, env9, int8_go9, convs,
                           positions[9].map(lambda x: x[:1024]), "go_main",
                           sims=192)
    env19 = registry.create_game("go", 19)
    fresh = AZResNet(env19.num_actions, obs_shape=env19.observation_shape,
                     generator=torch.Generator().manual_seed(0)).to("cuda")
    t0 = time.perf_counter()
    int8_go19, calib = make_production_eval_fn(
        env19, fresh, generator=torch.Generator(device="cuda").manual_seed(7))
    torch.cuda.synchronize()
    log(f"[go19_main] fresh AZResNet() 6x64; calibration: {tuple(calib.shape)} "
        f"rollout observations in {time.perf_counter() - t0:.2f} s")
    log("[go19_main] depth cut: 192 simulations (was 800)")
    out["go19_main"] = timed("go19_main", phase_go_main, env19, int8_go19, convs,
                             positions[19], "go19_main", sims=192)
    # Cut with the chess phases: 4 moves an iteration (was 16); the ladder 8
    # games an anchor (was 16, the gate still three quarters of them) and
    # go9 at 64 simulations (was 128).  The lanes of a match play in
    # parallel, so its time follows the searches' depth, not the games
    # (go9 at 64 simulations took 26-28 s against uniform_mcts_64 where 128
    # took 46-51 s, in one call); a game stopped short of its end would
    # count as a draw, so the plies are not cut.
    # With the slice-11 phases: go9 at 32 simulations (was 64), and the
    # ladder without uniform_mcts_256 (its match took 106 s of the 171 s
    # ladder at 64 simulations: the anchor's 16 waves a move); the fit keeps
    # it through the round-robin, pinned at 1500.
    log("[go_train_config] depth cut: 4 moves an iteration (was 16); "
        "[go_arena] 8 games an anchor (was 16), go9 at 32 simulations (was 128, "
        "then 64), anchors uniform_mcts_16 and _64 (uniform_mcts_256 dropped)")
    out["train_config"] = timed("go_train_config", phase_train_config, "go_9x9.json",
                                "go_train_config", {"selfplay.max_moves": 4})
    out["arena"] = timed("go_arena", phase_go_arena, games=8, cand_sims=32,
                         pool=("uniform_mcts_16", "uniform_mcts_64"))
    log("[go] phase wall seconds: " + json.dumps(walls))
    out["walls"] = walls
    return out


# ---- Chess (slice 10) ------------------------------------------------------

_CHESS_FIELDS = ("board", "to_play", "castling", "rook_start", "king_start",
                 "ep_square", "halfmove", "move_count", "terminal", "winner",
                 "in_check", "legal", "hash", "history", "rep_count")
CHESS_DEV_PATH = os.path.join(ROOT, "models_zoo", "chess_dev")
# Published perft totals (chessprogramming wiki; tests/test_chess.py).
_PERFT = (
    ("start", "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1", 4, 197_281),
    ("kiwipete", "r3k2r/p1ppqpb1/bn2pnp1/3PN3/1p2P3/2N2Q1p/PPPBBPPP/R3K2R w KQkq - 0 1",
     3, 97_862),
    ("pos3", "8/2p5/3p4/KP5r/1R3p1k/8/4P1P1/8 w - - 0 1", 4, 43_238),
    ("pos4", "r3k2r/Pppp1ppp/1b3nbN/nP6/BBP1P3/q4N2/Pp1P2PP/R2Q1RK1 w kq - 0 1", 3, 9_467),
    ("pos5", "rnbq1k1r/pp1Pbppp/2p5/8/2B5/8/PPP1NnPP/RNBQK2R w KQ - 1 8", 3, 62_379),
    ("pos6", "r4rk1/1pp1qppp/p1np1n2/2b1p1B1/2B1P1b1/P1NP1N2/1PP1QPPP/R4RK1 w - - 0 10",
     3, 89_890))


def _chess_perft(env, st, depth: int) -> int:
    for d in range(depth):
        legal = env.legal_mask(st)
        if d == depth - 1:
            return int(legal.sum())
        b, a = torch.nonzero(legal, as_tuple=True)
        st = env.step(st.map(lambda x: x[b]), a)


def _chess_move_kinds(st, acts):
    """(castlings, en-passant captures, promotions) among ``acts`` on the
    live lanes of ``st`` (CPU)."""
    from alphazero_tpu_torch.games.chess import _tables
    from alphazero_tpu_torch.games.chess_tables import KING, PAWN

    tb = _tables("cpu")
    B = acts.shape[0]
    live = ~st.terminal
    frm, mt = acts // 73, acts % 73
    flat = st.board.reshape(B, 64).long()
    p = flat.gather(1, frm[:, None])[:, 0]
    dr = torch.where(mt >= 64, torch.where(st.to_play == 0, 1, -1), tb["dr"][mt])
    dc = tb["dc"][mt]
    to = (frm + 8 * dr + dc).clamp(0, 63)
    tgt = flat.gather(1, to[:, None])[:, 0]
    pawn = live & (p >= 0) & (p % 6 == PAWN)
    castle = live & (p >= 0) & (p % 6 == KING) & (tgt >= 0) & (tgt // 6 == p // 6)
    ep = pawn & (dc != 0) & (to == st.ep_square.long())
    promo = pawn & ((to // 8 == 0) | (to // 8 == 7))
    return int(castle.sum()), int(ep.sum()), int(promo.sum())


def phase_chess_exact(plies: int = 256) -> dict:
    """Chess on the card against the CPU, exactly: 4,096 standard lanes,
    1,024 lanes each of Chess960 numbers 0, 333 and 959, and 256 lanes of
    a king-and-rook ending whose 50-move clock stands at 60, played
    ``plies`` random plies (legal moves drawn on the card, the same on both
    devices; terminal lanes frozen), every ``ChessState`` field compared
    after every ply; the legal mask, the 18 planes (standard and Chess960
    flag, bit for bit) and ``position_hash`` every 8 plies, the arena-row
    round trip on the card every 32.  Prints what the playouts met: checks,
    checkmates, stalemates, en-passant captures, castlings, promotions,
    draws by repetition, by the 50-move rule and by material.  Then perft
    on the card against the published totals."""
    from alphazero_tpu_torch.core.types import cat_states
    from alphazero_tpu_torch.games import chess_fen
    from alphazero_tpu_torch.games.chess import ChessEnv, _insufficient_material

    env, env960 = ChessEnv(), ChessEnv(chess960_position=0)
    cpu = cat_states([ChessEnv(chess960_position=n).init(B, device="cpu")
                      for n, B in ((None, 4096), (0, 1024), (333, 1024), (959, 1024))]
                     + [chess_fen.state_from_fen(
                         env, ["k7/8/8/8/8/8/8/K6R w - - 60 80"] * 256, device="cpu")])
    gpu = cpu.map(lambda x: x.cuda())
    B = cpu.batch_size
    gen = torch.Generator(device="cuda").manual_seed(51)
    kinds = dict(checks=0, castlings=0, ep_captures=0, promotions=0)
    differs = {}
    t0 = time.perf_counter()

    def packed(st):  # every field's bytes, one row a lane
        return torch.cat([getattr(st, f).reshape(B, -1).contiguous().view(torch.uint8)
                          for f in _CHESS_FIELDS], 1)

    def compare(where, full):
        if not torch.equal(packed(gpu).cpu(), packed(cpu)):
            for f in _CHESS_FIELDS:
                if not torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)):
                    differs.setdefault(f, where)
        if not full:
            return
        pairs = [("legal_mask", env.legal_mask(gpu), env.legal_mask(cpu)),
                 ("observation", env.observation(gpu).view(torch.int16),
                  env.observation(cpu).view(torch.int16)),
                 ("observation960", env960.observation(gpu).view(torch.int16),
                  env960.observation(cpu).view(torch.int16)),
                 ("position_hash", env.position_hash(gpu), env.position_hash(cpu))]
        for name, g, c in pairs:
            if not torch.equal(g.cpu(), c):
                differs.setdefault(name, where)

    for ply in range(plies):
        compare(ply, ply % 8 == 0)
        if ply % 32 == 0:
            back = env.from_arena_rows(*env.arena_rows(gpu))
            if not all(torch.equal(getattr(back, f), getattr(gpu, f)) for f in _CHESS_FIELDS):
                differs.setdefault("arena_rows", ply)
        w = env.legal_mask(gpu).float()
        w = torch.where(w.sum(1, keepdim=True) > 0, w, torch.ones_like(w))
        acts = torch.multinomial(w, 1, generator=gen)[:, 0]
        c, e, p = _chess_move_kinds(cpu, acts.cpu())
        kinds["castlings"] += c
        kinds["ep_captures"] += e
        kinds["promotions"] += p
        cpu, gpu = env.step(cpu, acts.cpu()), env.step(gpu, acts)
        kinds["checks"] += int((cpu.in_check & ~cpu.terminal).sum())
    compare(plies, True)
    torch.cuda.synchronize()
    played_s = time.perf_counter() - t0
    left = env._legal_bits(cpu.board, cpu.to_play, cpu.castling, cpu.rook_start,
                           cpu.king_start, cpu.ep_square)[0]
    term = cpu.terminal
    ends = dict(
        checkmates=int((term & (cpu.winner >= 0)).sum()),
        stalemates=int((term & (left == 0).all(1) & ~cpu.in_check).sum()),
        repetition_draws=int((term & (cpu.rep_count >= 3)).sum()),
        fifty_move_draws=int((term & (cpu.halfmove >= 100)).sum()),
        material_draws=int((term & _insufficient_material(cpu.board)).sum()),
        live=int((~term).sum()))
    row = {"lanes": B, "plies": plies, "played_and_compared_s": played_s,
           **kinds, **ends, "equal": not differs, "first_difference": differs}
    log("[chess_exact] card vs CPU: " + json.dumps(row))
    if differs:
        raise AssertionError(f"chess differs between the card and the CPU: {differs}")
    if not all(kinds.values()) or not all(v for k, v in ends.items() if k != "live"):
        raise AssertionError(f"the playouts missed a rule: {kinds} {ends}")
    perft = []
    for name, fen, depth, want in _PERFT:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = _chess_perft(env, chess_fen.state_from_fen(env, fen), depth)
        perft.append({"position": name, "depth": depth, "nodes": got, "published": want,
                      "s": time.perf_counter() - t1})
        log("[chess_exact] perft on the card: " + json.dumps(perft[-1]))
        if got != want:
            raise AssertionError(f"perft {name} depth {depth}: {got}, published {want}")
    return {"playouts": row, "perft": perft}


def phase_chess_search() -> list:
    """The search on chess, card against CPU: B=64 live roots (0 to 40
    random plies on the CPU), 128 simulations, the uniform evaluator with
    value 0, no noise, K=32, at W=16 and at W=1, both with a 256-entry
    table: equal visit counts, actions, table hits and stores.  Then the
    mate in one of ``tests/test_search_multigame.py`` (Qh5#) on the card,
    W=16 and W=1, 200 simulations.  The card's kernel calls are held
    against their plain versions."""
    from alphazero_tpu_torch.core.types import where_lanes
    from alphazero_tpu_torch.games import chess_fen
    from alphazero_tpu_torch.games.chess import ChessEnv
    from alphazero_tpu_torch.mcts.search import MCTSConfig, make_host_search, select_action
    from alphazero_tpu_torch.models.stub import make_uniform_eval_fn

    env = ChessEnv()
    gen = torch.Generator().manual_seed(52)
    roots = env.init(96, device="cpu")
    plies = torch.arange(96) % 41
    for ply in range(40):
        w = env.legal_mask(roots).float()
        w = torch.where(w.sum(1, keepdim=True) > 0, w, torch.ones_like(w))
        acts = torch.multinomial(w, 1, generator=gen)[:, 0]
        roots = where_lanes(plies > ply, env.step(roots, acts), roots)
    live = torch.nonzero(~roots.terminal)[:64, 0]
    if live.numel() < 64:
        raise AssertionError("fewer than 64 live [chess_search] roots")
    roots = roots.map(lambda x: x[live])
    uni = make_uniform_eval_fn(env.num_actions)
    rows, rec = [], _KernelCalls()
    for name, wave in (("W=16 table 256", 16), ("W=1 table 256", 1)):
        cfg = MCTSConfig(num_simulations=128, max_children=32, dirichlet_epsilon=0.0,
                         wave_size=wave, tt_size=256)
        run = make_host_search(env, uni, cfg)
        with rec:
            gpu = run(roots.map(lambda x: x.cuda()))
        cpu = run(roots)
        g, c = gpu.tree.tt, cpu.tree.tt
        row = {"case": name,
               "differing_counts": int((gpu.visit_counts.cpu() != cpu.visit_counts).sum()),
               "same_actions": bool(torch.equal(
                   select_action(None, gpu.visit_counts, 0.0).cpu(),
                   select_action(None, cpu.visit_counts, 0.0))),
               "max_depth": int(cpu.tree.depth.max()),
               "hits": int(c.hits.sum()), "stores": int(c.stores.sum()),
               "table_equal": bool(torch.equal(g.hits.cpu(), c.hits)
                                   and torch.equal(g.stores.cpu(), c.stores))}
        log("[chess_search] card vs CPU: " + json.dumps(row))
        if not (row["differing_counts"] == 0 and row["same_actions"]
                and row["table_equal"] and row["stores"] > 0):
            raise AssertionError(f"chess searches differ between the card and the CPU: {row}")
        rows.append(row)
    s = chess_fen.state_from_fen(
        env, "rnbqkbnr/ppppp2p/5p2/6p1/4P3/8/PPPP1PPP/RNBQKBNR w KQkq - 0 3")
    mate = chess_fen.san_to_action(env, s, "Qh5#")
    for wave in (16, 1):
        cfg = MCTSConfig(num_simulations=200, dirichlet_epsilon=0.0, wave_size=wave)
        with rec:
            out = make_host_search(env, uni, cfg)(s)
        best = int(out.visit_counts[0].argmax())
        row = {"case": f"mate in one W={wave}", "best": best, "mate": mate,
               "visits_to_mate": int(out.visit_counts[0, mate])}
        log("[chess_search] " + json.dumps(row))
        if best != mate:
            raise AssertionError(f"the search missed Qh5#: {row}")
        rows.append(row)
    _check_recorded("chess_search", rec, each=False)
    return rows


def phase_chess_main(env, eval_fn, convs: int, sims: int = 800) -> dict:
    """Chess self-play at full width through ``phase_main_path`` (B=1024,
    W=16, ``sims`` simulations, K=32, recycle on, chess_dev on the int8
    executor, 2 moves from the start, the second timed; ``s8_mm`` exactly
    13 x (32 chunks x sims / 16 waves + 2 for the roots) launches a move
    (13 x 1,602 at 800) and every recorded kernel call bit-equal),
    then one wave's env work on 1,024 mid-game roots (40 random plies on
    the card) x 16 leaves (``profile_go_env.env_wave``: ms of ``step``,
    ``legal_mask`` and ``observation``, and host syncs)."""
    from alphazero_tpu_torch.core.types import where_lanes
    from alphazero_tpu_torch.scripts.profile_go_env import env_wave

    res = phase_main_path(env, eval_fn, "int8", sims=sims, moves=2, s8_convs=convs,
                          tag="chess_main")
    per_move = 32 * sims // 16 + 2
    if res["launches"]["s8_mm"] != convs * per_move * 2:
        raise AssertionError(f"[chess_main] s8_mm launches {res['launches']}, not "
                             f"{convs} x {per_move} a move")
    gen = torch.Generator(device="cuda").manual_seed(53)
    roots = env.init(1024)
    for _ in range(40):
        w = env.legal_mask(roots).float()
        w = torch.where(w.sum(1, keepdim=True) > 0, w, torch.ones_like(w))
        nxt = env.step(roots, torch.multinomial(w, 1, generator=gen)[:, 0])
        roots = where_lanes(nxt.terminal, roots, nxt)  # keep every root live
    wave = env_wave(env, roots)
    waves = sims // 16 + 1
    summary = {"moves_per_s": res["timed_moves_per_s"],
               "eval_ms_per_wave": res["eval_ms_per_wave"],
               "env_ms_per_wave": wave["ms_per_wave"], "env_ms": wave["ms"],
               "env_syncs_per_wave": wave["syncs_per_wave"],
               "env_leaves": wave["leaves"],
               "env_s_per_move_est": wave["ms_per_wave"] * waves / 1e3,
               "gather_launches_per_move": res["gather_launches_per_move"],
               "s8_mm_launches": res["launches"]["s8_mm"]}
    log("[chess_main] " + json.dumps(summary))
    return {"main": res, **summary}


def phase_chess_arena(games: int = 16, cand_sims: int = 128) -> dict:
    """chess_dev as ``scripts/evaluate.py`` loads it (BN-folded bf16) at
    ``cand_sims`` simulations, W=16, against uniform_mcts_16 through
    play_match_sides: ``games`` games, 4 mirrored opening plies, T=0.1,
    160 plies at most (``docs/train_zoo_chess.json``'s match cut in games
    and plies).  Fails unless chess_dev loses at most 2 games and wins more
    than it loses.  Then ``scripts/evaluate.py --game chess`` as a
    subprocess, cut to 40 plies: its JSON keys equal the JAX CLI's.  The
    match's kernel calls are held against their plain versions."""
    from alphazero_tpu_torch.core import registry
    from alphazero_tpu_torch.eval import anchors
    from alphazero_tpu_torch.eval.arena import play_match_sides
    from alphazero_tpu_torch.mcts.search import MCTSConfig
    from alphazero_tpu_torch.ops.gather_rows import gather_rows
    from alphazero_tpu_torch.scripts.evaluate import load_eval_fn

    env = registry.create_game("chess", 8)
    cand = (load_eval_fn(CHESS_DEV_PATH, env, "cuda"),
            MCTSConfig(num_simulations=cand_sims, wave_size=16, dirichlet_epsilon=0.0))
    log("[chess_arena] depth: " + json.dumps({
        "games": games, "candidate_simulations": cand_sims, "wave": 16,
        "opening_plies": 4, "temperature": 0.1, "max_moves": 160}))
    gen = torch.Generator(device="cuda").manual_seed(61)
    rec = _KernelCalls()
    gather_rows.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with rec:
        res = play_match_sides(env, cand, anchors.make_anchor(env, "uniform_mcts_16"), gen,
                               games, max_moves=160, temperature=0.1,
                               opening_random_moves=4, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check_recorded("chess_arena", rec, each=False)
    lanes = res.winner.shape[0]
    moves = int(res.states.move_count.sum()) - 4 * lanes
    wa, wb, d = int(res.wins_a), int(res.wins_b), int(res.draws)
    out = {"match": {"anchor": "uniform_mcts_16", "result": f"+{wa} -{wb} ={d}",
                     "wall_s": wall, "moves": moves, "moves_per_s": moves / wall,
                     "plies_max": int(res.states.move_count.max()),
                     "plies_mean": float(res.states.move_count.float().mean()),
                     "checkmates": int((res.states.winner >= 0).sum()),
                     "gather_launches": gather_rows.launches}}
    log("[chess_arena] chess_dev vs " + json.dumps(out["match"]))
    if not (wb <= 2 and wa > wb):
        raise AssertionError(f"chess_dev against uniform_mcts_16: +{wa} -{wb} ={d}")
    cmd = [sys.executable, "-m", "alphazero_tpu_torch.scripts.evaluate", "--game", "chess",
           "--board-size", "8", "--model-a", os.path.join("models_zoo", "chess_dev"),
           "--num-games", "2", "--simulations", "16", "--max-moves", "40"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd)} failed: {proc.stderr[-2000:]}")
    printed = json.loads(proc.stdout.strip().splitlines()[-1])
    want = _jax_cli_keys(os.path.join("alphazero_tpu", "scripts", "evaluate.py"))
    out["cli"] = {"printed": printed, "wall_s": time.perf_counter() - t0,
                  "keys_equal_jax": list(printed) == want}
    log("[chess_arena] scripts/evaluate.py --game chess: " + json.dumps(out["cli"]))
    if list(printed) != want:
        raise AssertionError(f"evaluate.py printed keys {list(printed)}, the JAX CLI {want}")
    return out


def phase_chess_cli() -> dict:
    """The chess CLIs on the card, in this process, each cut in depth:
    ``scripts/self_play.py --game chess`` with chess_dev on the int8
    executor (256 games, 64 simulations, 2 plies; its kernel calls held
    against their plain versions) and BN-folded (64 games),
    ``scripts/train.py --game chess`` (a 2x32 net, 64 games of 8 plies, 2
    train steps), and ``scripts/tournament.py --game chess`` (chess_dev and
    the uniform player, 2 games, 2 simulations, the CLI's 512 plies)."""
    import io
    import shutil
    import tempfile

    from alphazero_tpu_torch.scripts import self_play as self_play_cli
    from alphazero_tpu_torch.scripts import tournament as tournament_cli
    from alphazero_tpu_torch.scripts import train as train_cli

    def run(main, argv):
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            main(argv)
        torch.cuda.synchronize()
        return json.loads(buf.getvalue().strip().splitlines()[-1]), time.perf_counter() - t0

    out, rec = {}, _KernelCalls()
    chess = ["--game", "chess", "--board-size", "8"]
    with tempfile.TemporaryDirectory() as tmp:
        for label, games, extra in (("int8", 256, ["--inference", "int8"]),
                                    ("folded", 64, ["--inference", "folded"])):
            with rec if label == "int8" else contextlib.nullcontext():
                stats, wall = run(self_play_cli.main, chess + [
                    "--model", CHESS_DEV_PATH, "--num-games", str(games),
                    "--simulations", "64", "--max-moves", "2",
                    "--output-dir", os.path.join(tmp, label)] + extra)
            out[f"self_play_{label}"] = {**stats, "wall_s": wall}
            log(f"[chess_cli] scripts/self_play.py --inference {label}: "
                + json.dumps(out[f"self_play_{label}"]))
            if not (stats["games"] == games and stats["moves"] == 2 * games):
                raise AssertionError(f"self_play --game chess ({label}): {stats}")
        _check_recorded("chess_cli self_play int8", rec, each=False)
        ckpt = os.path.join(tmp, "train")
        t0 = time.perf_counter()
        train_cli.main(chess + [
            "--blocks", "2", "--channels", "32", "--iterations", "1",
            "--games-per-iteration", "64", "--simulations", "16", "--wave", "16",
            "--max-moves", "8", "--train-steps", "2", "--train-batch-size", "64",
            "--replay-capacity", "4096", "--min-replay", "1", "--no-recycle",
            "--checkpoint-every", "1",
            "--checkpoint-dir", ckpt])
        with open(os.path.join(ckpt, "history.json")) as f:
            (entry,) = json.load(f)
        out["train"] = {"moves": entry["moves"], "loss": entry["loss"],
                        "wall_s": time.perf_counter() - t0}
        log("[chess_cli] scripts/train.py --game chess: " + json.dumps(out["train"]))
        if not (entry["moves"] == 64 * 8 and np.isfinite(entry["loss"])):
            raise AssertionError(f"train --game chess did not train: {entry}")
        zoo = os.path.join(tmp, "zoo")
        os.makedirs(zoo)
        shutil.copy(CHESS_DEV_PATH, os.path.join(zoo, "chess_dev.msgpack"))
        shutil.copy(CHESS_DEV_PATH + ".json", os.path.join(zoo, "chess_dev.msgpack.json"))
        printed, wall = run(tournament_cli.main, chess + [
            "--models-dir", zoo, "--include-random", "--games-per-pair", "2",
            "--simulations", "2", "--output", os.path.join(tmp, "t.json")])
        out["tournament"] = {"printed": printed, "wall_s": wall}
        log("[chess_cli] scripts/tournament.py --game chess: " + json.dumps(out["tournament"]))
        players = sorted(r["player"] for r in printed.get("elo", []))
        if set(printed) != {"elo", "bt"} or players != ["chess_dev.msgpack", "random"]:
            raise AssertionError(f"tournament --game chess printed {printed}")
    return out


def phase_chess() -> dict:
    """Every chess phase in order."""
    from alphazero_tpu_torch.core import registry
    from alphazero_tpu_torch.models.io import load_model
    from alphazero_tpu_torch.models.quant import make_production_eval_fn

    walls, out = {}, {}

    def timed(phase, fn, /, *args, **kw):
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        walls[phase] = round(time.perf_counter() - t0, 1)
        return res

    log("[chess_exact] depth cut: 128 plies (was 256); [chess_main] 192 "
        "simulations (was 800, then 400); [chess_train_config] 4 moves an "
        "iteration (was 16, then 8)")
    out["exact"] = timed("chess_exact", phase_chess_exact, plies=128)
    out["search"] = timed("chess_search", phase_chess_search)
    t0 = time.perf_counter()
    env = registry.create_game("chess", 8)
    model, _ = load_model(CHESS_DEV_PATH, env.observation_shape, device="cuda")
    int8_eval, calib = make_production_eval_fn(
        env, model, generator=torch.Generator(device="cuda").manual_seed(7))
    torch.cuda.synchronize()
    log(f"[chess_main] chess_dev {model.cfg.num_blocks}x{model.cfg.channels}; "
        f"calibration: {tuple(calib.shape)} rollout observations, calibrated and "
        f"quantised in {time.perf_counter() - t0:.2f} s")
    out["chess_main"] = timed("chess_main", phase_chess_main, env, int8_eval,
                              1 + 2 * model.cfg.num_blocks, sims=192)
    out["train_config"] = timed("chess_train_config", phase_train_config, "chess.json",
                                "chess_train_config", {"selfplay.max_moves": 4},
                                reload=True)
    out["arena"] = timed("chess_arena", phase_chess_arena)
    out["cli"] = timed("chess_cli", phase_chess_cli)
    log("[chess] phase wall seconds: " + json.dumps(walls))
    out["walls"] = walls
    return out


FLAGSHIP_PATH = os.path.join(ROOT, "models_zoo", "flagship_gomoku15")


def _randwire(env, dtype=torch.bfloat16, live: bool = False, seed: int = 11):
    """``RandWireConfig()`` at full width (4 blocks x 8 nodes x 64 channels)
    for ``env``, its weights drawn from a CPU generator seeded ``seed``, on
    the CPU; with ``live`` the two zero-initialised head kernels drawn from
    N(0, 0.05) too, so the outputs depend on the whole trunk."""
    from alphazero_tpu_torch.models.randwire import DDWRandWireResNet, RandWireConfig

    gen = torch.Generator().manual_seed(seed)
    model = DDWRandWireResNet(env.num_actions, RandWireConfig(dtype=dtype),
                              env.observation_shape, gen)
    if live:
        with torch.no_grad():
            for w in (model.policy_fc.weight, model.value_fc2.weight):
                w.normal_(0.0, 0.05, generator=gen)
    return model


def phase_randwire_exact(env) -> dict:
    """The full-width RandWire net (live heads) on the card against the
    port's CPU forward, on 256 random-playout observations: f32 (TF32 off)
    and bf16 compute, each side in the same dtype."""
    from alphazero_tpu_torch.models.export_torch import full_f32

    obs = env.observation(_random_states(env, 256, 40, seed=3, device="cpu")).float()
    res = {}
    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        cpu = _randwire(env, dtype, live=True)
        with torch.no_grad():
            ref_l, ref_v = cpu(obs)
        card = _randwire(env, dtype, live=True).cuda()
        with full_f32(), torch.no_grad():
            l, v = card(obs.cuda())
        torch.cuda.synchronize()
        res[label] = {"logit_err": float((l.cpu() - ref_l).abs().max()),
                      "value_err": float((v.cpu() - ref_v).abs().max()),
                      "logit_scale": float(ref_l.abs().max()),
                      "value_scale": float(ref_v.abs().max())}
    # f32: summation order only (TF32 off): 1e-3 absolute, as for [net].
    # bf16: the tests' bound for a bf16 net against another framework's,
    # 5 % of the logit scale and 0.05 of the value (the two sides' convs
    # accumulate in other orders, and a flipped bf16 rounding travels
    # through 2 x 8 nodes a block).
    limits = {"f32": {"logit_err": 1e-3, "value_err": 1e-3},
              "bf16": {"logit_err": 0.05 * res["bf16"]["logit_scale"], "value_err": 0.05}}
    res["limits"] = limits
    log("[randwire_exact] RandWireConfig() 4x8x64 on Gomoku 15x15, 256 observations: "
        + json.dumps(res))
    for label in ("f32", "bf16"):
        for k, lim in limits[label].items():
            if not res[label][k] <= lim:
                raise AssertionError(f"[randwire_exact] {label} {k} {res[label][k]} > {lim}")
    return res


def phase_randwire_main(env) -> dict:
    """A freshly seeded ``RandWireConfig()`` net on its raw bf16 evaluator
    (the path its Pipeline actor takes) as [main]: B=1024, W=16, 192
    simulations (cut from 800), K=32, 2 moves, the second timed; then one wave's env work
    on 1,024 mid-game roots (20 random plies) x 16 leaves."""
    from alphazero_tpu_torch.core.types import where_lanes
    from alphazero_tpu_torch.models.io import inference_eval_fn
    from alphazero_tpu_torch.scripts.profile_go_env import env_wave

    model = _randwire(env).cuda()
    # Cut with the slice-12 phases, to hold the script under 650 s.
    log("[randwire_main] depth cut: 192 simulations (was 800)")
    res = phase_main_path(env, inference_eval_fn(model), "randwire_raw_bf16",
                          sims=192, moves=2, tag="randwire_main")
    gen = torch.Generator(device="cuda").manual_seed(61)
    roots = env.init(1024)
    for _ in range(20):
        w = env.legal_mask(roots).float()
        nxt = env.step(roots, torch.multinomial(w, 1, generator=gen)[:, 0])
        roots = where_lanes(nxt.terminal, roots, nxt)  # keep every root live
    wave = env_wave(env, roots)
    summary = {"moves_per_s": res["timed_moves_per_s"],
               "move_s": res["move_s"],
               "eval_ms_per_wave": res["eval_ms_per_wave"],
               "eval_share_est": res["eval_share_est"],
               "env_ms_per_wave": wave["ms_per_wave"], "env_ms": wave["ms"],
               "env_syncs_per_wave": wave["syncs_per_wave"],
               "gather_launches_per_move": res["gather_launches_per_move"],
               "peak_mem_gb": res["peak_mem_gb"]}
    log("[randwire_main] " + json.dumps(summary))
    return {"main": res, **summary}


def phase_randwire_train() -> dict:
    """``scripts/train.py --model randwire`` at config/gomoku_15x15.json's
    shape (its games, train batch, replay, learner and W=1; no recycling,
    as the file has none), cut in depth only (printed); the net is
    ``RandWireConfig()``.  Its actor falls back to the raw module (no
    BatchNorm to fold).  Losses finite; every distinct gather call held
    against its plain version; the last checkpoint reloads bit for bit into
    a fresh pipeline; ``save_model`` -> ``load_model`` gives bit-equal
    outputs on the card."""
    import tempfile

    from alphazero_tpu_torch.models.io import load_model, save_model
    from alphazero_tpu_torch.ops.gather_rows import gather_rows
    from alphazero_tpu_torch.ops.s8_mm import s8_mm
    from alphazero_tpu_torch.scripts import train as train_cli

    with open(os.path.join(ROOT, "config", "gomoku_15x15.json")) as f:
        cfg = json.load(f)
    cuts = {"iterations": (cfg["iterations"], 2),
            "max_moves": (cfg["selfplay"]["max_moves"], 4),
            "simulations": (cfg["selfplay"]["mcts"]["num_simulations"], 64),
            "train_steps": (cfg["train_steps_per_iteration"], 4),
            "min_replay": (cfg["min_replay_before_training"], 1),
            "checkpoint_every": (cfg["checkpoint_every"], 1)}
    log("[randwire_train] depth cuts of config/gomoku_15x15.json (was, now): "
        + json.dumps(cuts))
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "run")
        argv = ["--model", "randwire", "--game", "gomoku",
                "--board-size", str(cfg["board_size"]),
                "--games-per-iteration", str(cfg["games_per_iteration"]),
                "--wave", "1", "--no-recycle",
                "--train-batch-size", str(cfg["train_batch_size"]),
                "--replay-capacity", str(cfg["replay_capacity"]),
                "--lr", str(cfg["learner"]["learning_rate"]),
                "--weight-decay", str(cfg["learner"]["weight_decay"]),
                "--checkpoint-dir", ckpt]
        for flag, (_, now) in cuts.items():
            argv += ["--" + flag.replace("_", "-"), str(now)]
        gather_rows.launches = 0
        s8_mm.launches = 0
        t0 = time.perf_counter()
        with _KernelCalls() as recorded:
            train_cli.main(argv)
        torch.cuda.synchronize()
        res["wall_s"] = time.perf_counter() - t0
        res["launches"] = {"gather_rows": gather_rows.launches, "s8_mm": s8_mm.launches}
        with open(os.path.join(ckpt, "history.json")) as f:
            history = json.load(f)
        for e in history:
            log("[randwire_train] iteration: " + json.dumps(e))
        kept = []
        config = train_cli.pipeline_config(train_cli.build_parser().parse_args(argv))
        res["checkpoint_reload_bit_equal"] = _reload_checkpoint(config, kept)
        fresh = kept[0]
        res["inference_mode"] = fresh.inference_mode
        model = fresh.state.module
        save_model(os.path.join(tmp, "rw"), model, "randwire", fresh.env.num_actions,
                   model.cfg)
        back, meta = load_model(os.path.join(tmp, "rw"), fresh.env.observation_shape)
        obs = fresh.env.observation(_random_states(fresh.env, 64, 40, seed=9,
                                                   device="cuda"))
        with torch.no_grad():
            a, b = model(obs), back(obs)
        res["bundle_outputs_bit_equal"] = (torch.equal(a[0], b[0])
                                           and torch.equal(a[1], b[1]))
    held = _check_recorded("randwire_train", recorded, each=False)
    res["signatures"] = len(held)
    log("[randwire_train] " + json.dumps(res))
    if not (len(history) == 2 and all(np.isfinite(e["loss"]) for e in history)):
        raise AssertionError(f"[randwire_train] did not train: {history}")
    if res["launches"]["gather_rows"] <= 0 or res["launches"]["s8_mm"] != 0:
        raise AssertionError(f"[randwire_train] launches {res['launches']}")
    if not (res["checkpoint_reload_bit_equal"] and res["bundle_outputs_bit_equal"]
            and res["inference_mode"] == "raw" and meta["kind"] == "randwire"):
        raise AssertionError(f"[randwire_train] {res}")
    return res


def phase_export() -> dict:
    """The flagship exported on the card host: its TorchScript ``.pt`` run
    by a Python that cannot import the port, on the card, against the
    port's folded f32 eval (TF32 off on both sides); its ONNX file read
    back and replayed with numpy against the same; the int8 executor
    (calibrated on the same positions, production knobs) against the
    exported net, with its s8_mm calls held against the plain product; then
    ``scripts/export_model.py --bundle models_zoo/chess_dev --torchscript
    --onnx --package``."""
    import io
    import subprocess
    import tempfile
    import zipfile

    from alphazero_tpu_torch import production
    from alphazero_tpu_torch.core import registry
    from alphazero_tpu_torch.models import quant
    from alphazero_tpu_torch.models.export_onnx import export_onnx, load_and_run_onnx
    from alphazero_tpu_torch.models.export_torch import export_torchscript, full_f32
    from alphazero_tpu_torch.models.io import load_model
    from alphazero_tpu_torch.models.resnet import make_inference_eval_fn
    from alphazero_tpu_torch.ops.s8_mm import s8_mm
    from alphazero_tpu_torch.scripts import export_model as export_cli

    env = registry.create_game("gomoku", 15)
    model, _ = load_model(FLAGSHIP_PATH, env.observation_shape)
    obs = env.observation(_random_states(env, 64, 40, seed=5, device="cpu")).float()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        pt = export_torchscript(model, env.observation_shape, os.path.join(tmp, "f.pt"))
        np.save(os.path.join(tmp, "obs.npy"), obs.numpy())
        code = (
            "import importlib.util, numpy as np, torch\n"
            "assert importlib.util.find_spec('alphazero_tpu_torch') is None\n"
            "torch.backends.cudnn.allow_tf32 = False\n"
            "torch.backends.cuda.matmul.allow_tf32 = False\n"
            "m = torch.jit.load('f.pt', map_location='cuda')\n"
            "with torch.no_grad():\n"
            "    l, v = m(torch.from_numpy(np.load('obs.npy')).cuda())\n"
            "np.save('l.npy', l.cpu().numpy()); np.save('v.npy', v.cpu().numpy())\n"
            "print(torch.cuda.get_device_name(0))\n")
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-I", "-c", code], cwd=tmp,
                             capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            raise AssertionError(f"[export] standalone TorchScript run failed: {out.stderr}")
        res["standalone_s"] = time.perf_counter() - t0
        ts_l = torch.from_numpy(np.load(os.path.join(tmp, "l.npy")))
        ts_v = torch.from_numpy(np.load(os.path.join(tmp, "v.npy")))
        with full_f32():
            ref_l, ref_v = make_inference_eval_fn(model, torch.float32)(obs.cuda())
        ref_l, ref_v = ref_l.cpu(), ref_v.cpu()
        res["torchscript"] = {"device": out.stdout.strip(),
                              "logit_err": float((ts_l - ref_l).abs().max()),
                              "value_err": float((ts_v - ref_v).abs().max()),
                              "logit_scale": float(ref_l.abs().max())}
        onnx_path = export_onnx(model, env.observation_shape, os.path.join(tmp, "f.onnx"))
        t0 = time.perf_counter()
        ol, ov = load_and_run_onnx(onnx_path, obs[:16].numpy())
        res["onnx"] = {"numpy_s": time.perf_counter() - t0,
                       "bytes": os.path.getsize(onnx_path),
                       "logit_err": float(np.abs(ol - ref_l[:16].numpy()).max()),
                       "value_err": float(np.abs(ov - ref_v[:16].numpy()).max())}
        s8_mm.launches = 0
        with _KernelCalls() as rec:
            int8_eval = quant.make_int8_eval_fn(
                model, calib_obs=obs.cuda(), chunk=production.INT8_CHUNK,
                residual=production.INT8_RESIDUAL, heads=production.INT8_HEADS,
                calib_percentile=production.INT8_CALIB_PERCENTILE)
            il, iv = int8_eval(obs.cuda())
        il, iv = il.float().cpu(), iv.float().cpu()
        res["s8_mm_launches"] = s8_mm.launches
        res["int8_vs_export"] = {
            "argmax_agree": float((il.argmax(-1) == ts_l.argmax(-1)).float().mean()),
            "logit_corr": float(np.corrcoef(il.numpy().ravel(), ts_l.numpy().ravel())[0, 1]),
            "value_mean_abs": float((iv - ts_v).abs().mean())}
        _check_recorded("export int8", rec)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            export_cli.main(["--bundle", CHESS_DEV_PATH,
                             "--torchscript", os.path.join(tmp, "c.pt"),
                             "--onnx", os.path.join(tmp, "c.onnx"),
                             "--package", os.path.join(tmp, "c.zip")])
        cli = json.loads(buf.getvalue().strip().splitlines()[-1])
        with zipfile.ZipFile(os.path.join(tmp, "c.zip")) as z:
            meta = json.loads(z.read("metadata.json"))
        res["export_model_cli"] = {"wall_s": time.perf_counter() - t0,
                                   "torchscript_parity": cli["torchscript_parity"],
                                   "onnx_parity": cli["onnx_parity"],
                                   "package": {"game": meta["game"],
                                               "board_size": meta["board_size"]}}
    # The .pt (traced with TF32 off) and the folded eval run f32 cuDNN
    # convolutions: 1e-4.  numpy sums the ONNX convolutions in another
    # order: 1e-3 of logits of scale ~25.  The int8 trunk against the f32
    # net: the JAX package's int8-vs-bf16 bars for the policy (0.9 argmax
    # agreement, 0.99 correlation); its value bar (0.02 mean difference, on
    # its own test positions) was missed at 0.0456 on these 40-ply random
    # positions in the first card call, so the value is held to 0.1, a
    # twentieth of its range.
    limits = {"torchscript": 1e-4, "onnx": 1e-3,
              "int8_vs_export": {"argmax_agree": 0.9, "logit_corr": 0.99,
                                 "value_mean_abs": 0.1}}
    res["limits"] = limits
    log("[export] " + json.dumps(res))
    for k in ("torchscript", "onnx"):
        if not (res[k]["logit_err"] <= limits[k] and res[k]["value_err"] <= limits[k]):
            raise AssertionError(f"[export] {k} deviates: {res[k]}")
    iv8, lim8 = res["int8_vs_export"], limits["int8_vs_export"]
    if not (iv8["argmax_agree"] >= lim8["argmax_agree"]
            and iv8["logit_corr"] >= lim8["logit_corr"]
            and iv8["value_mean_abs"] <= lim8["value_mean_abs"]):
        raise AssertionError(f"[export] int8 executor vs export: {iv8}")
    if res["s8_mm_launches"] <= 0:
        raise AssertionError("[export] the int8 check launched no s8_mm kernel")
    if res["export_model_cli"]["package"] != {"game": "chess", "board_size": 8}:
        raise AssertionError(f"[export] export_model.py --bundle chess_dev: {cli}, {meta}")
    return res


def phase_facade() -> dict:
    """``AlphaZero`` on ``default_pipeline_config("gomoku")`` (what
    ``for_game("gomoku")`` builds: 6x64 BN net, 256 games, W=1, the int8
    executor), cut in depth (printed): one ``run_self_play``, one
    ``train_network`` iteration, ``evaluate_model`` over 4 games (100
    simulations, 4 mirrored opening plies), ``get_best_action`` (200
    simulations) and ``save``; the kernel calls of all of it held against
    their plain versions."""
    import tempfile

    from alphazero_tpu_torch.facade import AlphaZero
    from alphazero_tpu_torch.models.io import load_model
    from alphazero_tpu_torch.ops.gather_rows import gather_rows
    from alphazero_tpu_torch.ops.s8_mm import s8_mm
    from alphazero_tpu_torch.utils.config import default_pipeline_config

    base = default_pipeline_config("gomoku")
    cuts = {"selfplay.max_moves": (base.selfplay.max_moves, 8),
            "selfplay.mcts.num_simulations": (base.selfplay.mcts.num_simulations, 64),
            "train_steps_per_iteration": (base.train_steps_per_iteration, 4),
            "min_replay_before_training": (base.min_replay_before_training, 1)}
    log("[facade] depth cuts of for_game('gomoku')'s config (was, now): "
        + json.dumps(cuts))
    res, walls = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = dataclasses.replace(
            base, selfplay=dataclasses.replace(
                base.selfplay, max_moves=8,
                mcts=dataclasses.replace(base.selfplay.mcts, num_simulations=64)),
            train_steps_per_iteration=4, min_replay_before_training=1,
            checkpoint_dir=os.path.join(tmp, "ckpt"), checkpoint_every=1)

        def timed(name, fn, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            walls[name] = round(time.perf_counter() - t0, 2)
            return out

        gather_rows.launches = 0
        s8_mm.launches = 0
        with _KernelCalls() as rec:
            az = timed("init", AlphaZero, cfg)
            entry = timed("run_self_play", az.run_self_play)
            history = timed("train_network", az.train_network, 1)
            match = timed("evaluate_model", az.evaluate_model, num_games=4)
            best = timed("get_best_action", az.get_best_action,
                         az.env.init(1, device="cuda"))
            path = os.path.join(tmp, "facade.msgpack")
            timed("save", az.save, path)
        back, meta = load_model(path, az.env.observation_shape)
        saved_equal = all(torch.equal(back.state_dict()[k], v)
                          for k, v in az.model.state_dict().items())
    held = _check_recorded("facade", rec, each=False)
    res = {"walls_s": walls, "inference_mode": az.pipeline.inference_mode,
           "self_play": {k: entry[k] for k in ("moves", "games", "moves_per_s",
                                               "replay_size", "total_games")},
           "train_loss": history[-1].get("loss"), "match": match,
           "best_action": best, "saved_bit_equal": saved_equal,
           "bundle_kind": meta["kind"], "signatures": len(held),
           "launches": {"gather_rows": gather_rows.launches, "s8_mm": s8_mm.launches},
           "kernels": sorted({r["kernel"] for r in held})}
    log("[facade] " + json.dumps(res))
    if not (entry["moves"] == 8 * cfg.games_per_iteration
            and np.isfinite(res["train_loss"]) and sum(match.values()) == 4
            and 0 <= best < az.env.num_actions and saved_equal
            and min(res["launches"].values()) > 0 and res["inference_mode"] == "int8"):
        raise AssertionError(f"[facade] {res}")
    return res


def phase_serve() -> dict:
    """``api_server.serve`` on 127.0.0.1:0 in a thread with the flagship,
    the default 200 simulations and an API key: model info, a Gomoku game
    (a human move, two engine moves, the state), a chess game (the flagship
    does not fit it: the uniform engine) with a click-pair move, a bad game
    (400), a call without the key (401) and the page; each request's status
    and latency, and the engine's kernel calls held against their plain
    versions."""
    import threading
    import urllib.error
    import urllib.request

    from alphazero_tpu_torch import api_server
    from alphazero_tpu_torch.ops.gather_rows import gather_rows

    key = "smoke-key"
    server = api_server.serve("127.0.0.1", 0, model=FLAGSHIP_PATH, api_key=key)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    requests = []

    def call(label, method, path, body=None, auth=True):
        headers = {"Content-Type": "application/json"}
        if auth:
            headers["X-API-Key"] = key
        req = urllib.request.Request(base + path, method=method, headers=headers,
                                     data=None if body is None else json.dumps(body).encode())
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=600) as resp:
                code, raw, ctype = resp.status, resp.read(), resp.headers["Content-Type"]
        except urllib.error.HTTPError as e:
            code, raw, ctype = e.code, e.read(), e.headers["Content-Type"]
        ms = (time.perf_counter() - t0) * 1e3
        payload = json.loads(raw) if "json" in ctype else raw.decode()
        requests.append({"request": label, "status": code, "ms": round(ms, 2)})
        return code, payload

    gather_rows.launches = 0
    try:
        with _KernelCalls() as rec:
            checks = {}
            code, info = call("model info", "GET", "/api/model")
            checks["model"] = code == 200 and info["model"] == FLAGSHIP_PATH
            code, game = call("new gomoku game", "POST", "/api/games", {"game": "gomoku"})
            gid = game["id"]
            checks["new"] = code == 201 and len(game["cells"]) == 225
            code, st = call("human move", "POST", f"/api/games/{gid}/move", {"action": 112})
            checks["human"] = code == 200 and st["move_count"] == 1
            for i in (1, 2):
                code, st = call(f"ai move {i}", "POST", f"/api/games/{gid}/ai_move", {})
                checks[f"ai{i}"] = (code == 200 and st["ai"]["visits"] >= 200
                                    and st["cells"][st["ai"]["action"]] != -1)
                if i == 1:
                    code, st = call("human move 2", "POST", f"/api/games/{gid}/move",
                                    {"action": int(st["legal_actions"][0])})
            code, st = call("state", "GET", f"/api/games/{gid}")
            checks["state"] = code == 200 and st["move_count"] == 4
            code, chess = call("new chess game", "POST", "/api/games", {"game": "chess"})
            code2, st = call("chess click pair e2e4", "POST",
                             f"/api/games/{chess['id']}/move", {"from": 12, "to": 28})
            checks["chess"] = (code == 201 and code2 == 200 and st["cells"][28] == 0
                               and st["cells"][12] == -1)
            code, _ = call("bad game", "POST", "/api/games", {"game": "checkers"})
            checks["bad_game_400"] = code == 400
            code, _ = call("no key", "GET", "/api/model", auth=False)
            checks["no_key_401"] = code == 401
            code, page = call("page", "GET", "/", auth=False)
            checks["page"] = code == 200 and "alphazero_tpu" in page
        held = _check_recorded("serve", rec, each=False)
    finally:
        server.shutdown()
        server.server_close()
        server.store.close()
        thread.join(timeout=30)
    for r in requests:
        log("[serve] " + json.dumps(r))
    res = {"checks": checks, "requests": requests, "signatures": len(held),
           "gather_launches": gather_rows.launches,
           "server_thread_stopped": not thread.is_alive()}
    log("[serve] " + json.dumps({k: v for k, v in res.items() if k != "requests"}))
    if not (all(checks.values()) and res["server_thread_stopped"]
            and res["gather_launches"] > 0):
        raise AssertionError(f"[serve] {res}")
    return res


def phase_slice11() -> dict:
    """Every phase of slice 11 in order: RandWire, export, the facade and
    the REST server."""
    from alphazero_tpu_torch.core import registry

    walls, out = {}, {}

    def timed(phase, fn, /, *args, **kw):
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        walls[phase] = round(time.perf_counter() - t0, 1)
        return res

    env = registry.create_game("gomoku", 15)
    out["randwire_exact"] = timed("randwire_exact", phase_randwire_exact, env)
    out["randwire_main"] = timed("randwire_main", phase_randwire_main, env)
    out["randwire_train"] = timed("randwire_train", phase_randwire_train)
    out["export"] = timed("export", phase_export)
    out["facade"] = timed("facade", phase_facade)
    out["serve"] = timed("serve", phase_serve)
    log("[slice11] phase wall seconds: " + json.dumps(walls))
    out["walls"] = walls
    return out


# ---- slice 12: the scanned actor, data parallelism, scripts, records ------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_scan_main(env, int8_eval, convs: int, sims: int = 192) -> dict:
    """``play_games`` (the scanned actor) with the production int8 executor
    at [main]'s width: B=1024, W=16, K=32, recycle on, T=1 with root noise,
    2 moves (the depth cut, printed).  s8_mm launches exactly as the
    evaluated batches predict; the first move's actions equal the host
    actor's from the same generator; the kernel calls of the run are held
    against their plain versions.  Returns the output too, for [records]."""
    from alphazero_tpu_torch import production
    from alphazero_tpu_torch.mcts.search import MCTSConfig
    from alphazero_tpu_torch.ops.gather_rows import gather_rows
    from alphazero_tpu_torch.ops.s8_mm import s8_mm
    from alphazero_tpu_torch.selfplay.actor import (
        SelfPlayConfig, make_host_actor, play_games)

    B, W, moves = 1024, 16, 2
    log(f"[scan_main] depth cut: {moves} moves at {sims} simulations "
        "(the main path: 800 simulations to the end of the game)")
    batches = []

    def counted_eval(obs, to_play=None):
        batches.append(obs.shape[0])
        return int8_eval(obs, to_play)

    cfg = SelfPlayConfig(mcts=MCTSConfig(num_simulations=sims, wave_size=W,
                                         max_children=32),
                         max_moves=moves, recycle=True)
    gather_rows.launches = 0
    s8_mm.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _KernelCalls() as rec:
        out = play_games(env, counted_eval, torch.Generator(device="cuda").manual_seed(3),
                         cfg, B, record_states=True, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"gather_rows": gather_rows.launches, "s8_mm": s8_mm.launches}
    expected = _s8_launches_expected(batches, convs, production.INT8_CHUNK)
    step, states = make_host_actor(env, int8_eval, cfg, B, device="cuda")
    _, host_rec = step(states, torch.Generator(device="cuda").manual_seed(3))
    same_first = torch.equal(host_rec.action, out.actions[0])
    held = _check_recorded("scan_main", rec, each=False)
    res = {"B": B, "wave": W, "simulations": sims, "moves": moves, "wall_s": wall,
           "moves_per_s": moves * B / wall, "launches": launches,
           "s8_mm_launches_expected": expected, "evaluations": len(batches),
           "first_move_equals_host_actor": same_first, "signatures": len(held),
           "moves_played": int(out.length.sum())}
    log("[scan_main] " + json.dumps(res))
    if launches["s8_mm"] != expected or expected <= 0 or launches["gather_rows"] <= 0:
        raise AssertionError(f"[scan_main] launches {launches}, s8_mm predicted {expected}")
    if not same_first:
        raise AssertionError("[scan_main] the first move differs from the host actor's")
    if not (out.active.all() and torch.allclose(out.policies.sum(-1),
                                                torch.ones((), device="cuda"))):
        raise AssertionError("[scan_main] bad policies or inactive lanes")
    res["output"] = out
    return res


def phase_records(env, out, games: int = 64) -> dict:
    """``games`` of [scan_main]'s games as GameRecords, encoded by the
    native encoder and by ``json``: the same bytes; the native module must
    be the one used; both times (best of 3)."""
    from alphazero_tpu_torch import native
    from alphazero_tpu_torch.selfplay.game_record import records_from_selfplay

    records = records_from_selfplay(env, out, max_games=games)
    mod = native.get_azrecord()
    if mod is None:
        raise AssertionError("[records] the native encoder did not build")
    times = {}
    for kind, encode in (("native", lambda r: r.to_json_bytes()),
                         ("json", lambda r: json.dumps(r.to_json()).encode())):
        best = None
        for _ in range(3):
            t0 = time.perf_counter()
            data = [encode(r) for r in records]
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        times[kind] = (best, data)
    equal = times["native"][1] == times["json"][1]
    res = {"records": len(records), "bytes": sum(len(d) for d in times["json"][1]),
           "native_s": times["native"][0], "json_s": times["json"][0],
           "speedup": times["json"][0] / times["native"][0], "bytes_equal": equal,
           "native_module": mod.__file__ and os.path.relpath(mod.__file__, ROOT)}
    log("[records] " + json.dumps(res))
    if not equal:
        raise AssertionError("[records] native bytes differ from json's")
    return res


def _dist_learner(model_path, env, batch, rows=None, timed_steps: int = 5):
    """One train_step of the flagship bundle in f32 (TF32 off,
    deterministic cuDNN) on ``batch`` (its ``rows``, where given): the
    metrics, gradients, parameters and running statistics after it; then
    ``timed_steps`` more steps, timed (steps/s)."""
    from alphazero_tpu_torch.models.io import load_model
    from alphazero_tpu_torch.training import learner, replay

    model, _ = load_model(model_path, env.observation_shape, device="cuda")
    model.cfg = dataclasses.replace(model.cfg, dtype=torch.float32)
    cfg = learner.LearnerConfig(learning_rate=1e-3, scheduler="constant",
                                warmup_steps=0)
    state = learner.create_train_state(model, cfg)
    b = replay.Batch(*(x if rows is None else x[rows] for x in batch))
    b = replay.Batch(*(x.cuda() for x in b))
    with _deterministic():
        state, m = learner.train_step(state, b, cfg)
        res = {"loss": [float(x) for x in m],
               "grads": {k: p.grad.to("cpu", copy=True)
                         for k, p in model.named_parameters()},
               "params": {k: p.detach().to("cpu", copy=True)
                          for k, p in model.named_parameters()},
               "stats": {k: v.to("cpu", copy=True) for k, v in model.named_buffers()
                         if "running" in k}}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            state, m = learner.train_step(state, b, cfg)
        float(m.loss)
        res["steps_per_s"] = timed_steps / (time.perf_counter() - t0)
    return res


def _dist_batch(env, B: int = 1024):
    rng = np.random.RandomState(15)
    obs = env.observation(_random_states(env, B, 60, seed=15, device="cpu"))
    policy = torch.softmax(torch.from_numpy(
        rng.normal(size=(B, env.num_actions)).astype(np.float32) * 2), -1)
    value = torch.from_numpy(np.tanh(rng.normal(size=B)).astype(np.float32))
    return obs, policy, value


def _dist_pipeline_config(ckpt_dir, games: int, inference: str):
    """A fresh 6x64 BatchNorm net (its zero heads make every evaluation
    exactly uniform, whatever the batch), 4 moves at 32 simulations, W=16,
    no root noise, T=0, no recycling (every move enters the ring), one
    learner step at batch 1024."""
    from alphazero_tpu_torch.mcts.search import MCTSConfig
    from alphazero_tpu_torch.models.resnet import ResNetConfig
    from alphazero_tpu_torch.selfplay.actor import SelfPlayConfig
    from alphazero_tpu_torch.training.learner import LearnerConfig
    from alphazero_tpu_torch.training.pipeline import PipelineConfig

    return PipelineConfig(
        board_size=15, model=ResNetConfig(),
        selfplay=SelfPlayConfig(
            mcts=MCTSConfig(num_simulations=32, wave_size=16, max_children=32,
                            dirichlet_epsilon=0.0),
            max_moves=4, temperature=0.0, final_temperature=0.0),
        learner=LearnerConfig(scheduler="constant", warmup_steps=0),
        iterations=1, games_per_iteration=games, train_steps_per_iteration=1,
        train_batch_size=1024, replay_capacity=4096, min_replay_before_training=1,
        checkpoint_dir=ckpt_dir, checkpoint_every=1, inference=inference)


def _ring(pipe) -> dict:
    buf = pipe.buffer
    return {"size": buf.size, "position": buf.position, "policy": buf.policy.cpu(),
            "value": buf.value.cpu(), "board": buf.states.board.cpu(),
            "move_count": buf.states.move_count.cpu()}


def _rings_equal(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor) else a[k] == b[k]
               for k in a)


def _compare_dist(ranked: dict, one: dict) -> dict:
    """A learner step against one process's on the whole batch, by the CPU
    test's tolerances: the loss (rtol 1e-5), the running statistics (rtol
    1e-4, atol 1e-6; ``stats_excess`` <= 0 meets them), the gradients
    element by element (rtol 1e-4, atol 1e-7: the elements outside, and
    the norm of the difference relative to the gradient's), and the
    parameters after the step (the elements more than 1e-6 off, where the
    global gradient is 1e-6 or more)."""
    def excess(a, b, rtol, atol):
        return (a - b).abs() - (atol + rtol * b.abs())

    ga = torch.cat([ranked["grads"][k].ravel() for k in one["grads"]])
    gb = torch.cat([g.ravel() for g in one["grads"].values()])
    pa = torch.cat([ranked["params"][k].ravel() for k in one["params"]])
    pb = torch.cat([p.ravel() for p in one["params"].values()])
    big = gb.abs() >= 1e-6
    return {
        "loss_rel_err": max(abs(a - b) / abs(b)
                            for a, b in zip(ranked["loss"][:3], one["loss"][:3])),
        "stats_excess": max(float(excess(ranked["stats"][k], v, 1e-4, 1e-6).max())
                            for k, v in one["stats"].items()),
        "grad_elements_over": int((excess(ga, gb, 1e-4, 1e-7) > 0).sum()),
        "grad_norm_rel_err": float((ga - gb).norm() / gb.norm()),
        "param_elements_over": int(((pa - pb).abs()[big] > 1e-6).sum()),
        "param_max_abs_err": float((pa - pb).abs()[big].max()),
        "elements": gb.numel(), "params_with_grad_under_1e-6": int((~big).sum()),
    }


@contextlib.contextmanager
def _deterministic():
    """TF32 off and cuDNN's deterministic algorithms (its weight gradients
    may otherwise add in any order), for comparisons of learner steps."""
    flags = [(torch.backends.cuda.matmul, "allow_tf32", False),
             (torch.backends.cudnn, "allow_tf32", False),
             (torch.backends.cudnn, "deterministic", True),
             (torch.backends.cudnn, "benchmark", False)]
    keep = [getattr(m, n) for m, n, _ in flags]
    for m, n, v in flags:
        setattr(m, n, v)
    try:
        yield
    finally:
        for (m, n, _), v in zip(flags, keep):
            setattr(m, n, v)


def phase_dist_one(env, model_path) -> dict:
    """A one-rank NCCL process group: one learner step of the flagship at
    batch 1024 (f32, deterministic cuDNN) bit-equal to the same step with no
    group; then one ``Pipeline(mesh=)`` iteration on the flagship's 6x64
    BatchNorm shape with the int8 executor under the group (256 games, 4
    moves, 32 simulations, W=16), its kernel calls held against their plain
    versions."""
    import tempfile

    import torch.distributed as dist

    from alphazero_tpu_torch.ops.gather_rows import gather_rows
    from alphazero_tpu_torch.ops.s8_mm import s8_mm
    from alphazero_tpu_torch.parallel import mesh as meshlib
    from alphazero_tpu_torch.training.pipeline import Pipeline

    batch = _dist_batch(env)
    alone = _dist_learner(model_path, env, batch)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        grouped = _dist_learner(model_path, env, batch)
        same = (alone["loss"] == grouped["loss"]
                and all(torch.equal(alone[s][k], grouped[s][k])
                        for s in ("grads", "params", "stats") for k in alone[s]))
        with tempfile.TemporaryDirectory() as tmp:
            mesh = meshlib.make_mesh()
            pipe = Pipeline(_dist_pipeline_config(tmp, 256, "int8"), mesh=mesh)
            gather_rows.launches = 0
            s8_mm.launches = 0
            with _KernelCalls() as rec:
                entry = pipe.run_iteration(0)
            launches = {"gather_rows": gather_rows.launches, "s8_mm": s8_mm.launches}
            pipe.save_checkpoint(0)
            files = sorted(os.listdir(tmp))
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    held = _check_recorded("dist_one", rec, each=False)
    res = {"backend": backend, "mesh": mesh.shape, "learner_bit_equal": same,
           "loss": grouped["loss"], "learner_steps_per_s": {
               "no_group": alone["steps_per_s"], "group": grouped["steps_per_s"]},
           "iteration": entry, "launches": launches,
           "files": files, "signatures": len(held)}
    log("[dist_one] " + json.dumps(res))
    if not (same and launches["s8_mm"] > 0 and launches["gather_rows"] > 0
            and np.isfinite(entry["loss"]) and files == ["ckpt_0.pt", "history.json"]):
        raise AssertionError(f"[dist_one] {res}")
    return res


def dist_worker(rank: int, port: int, out_dir: str) -> int:
    """One of [dist_two]'s two ranks (gloo, both on cuda:0): its half of the
    learner batch, and one Pipeline(mesh=) iteration on its 128 lanes."""
    from alphazero_tpu_torch.core import registry
    from alphazero_tpu_torch.ops.gather_rows import gather_rows
    from alphazero_tpu_torch.parallel import distributed
    from alphazero_tpu_torch.training.pipeline import Pipeline

    torch.set_num_threads(2)  # two ranks share the host's cores
    distributed.initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo", device="cuda")
    env = registry.create_game("gomoku", 15)
    learner = _dist_learner(os.path.join(ROOT, "models_zoo", "flagship_gomoku15"),
                            env, _dist_batch(env),
                            rows=slice(512 * rank, 512 * (rank + 1)))
    pipe = Pipeline(_dist_pipeline_config(os.path.join(out_dir, "ckpt"), 256, "folded"))
    gather_rows.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    entry = pipe.run_iteration(0)
    torch.cuda.synchronize()
    res = {"learner": learner, "ring": _ring(pipe), "entry": entry,
           "iteration_s": time.perf_counter() - t0, "lanes": pipe.local_games,
           "gather_launches": gather_rows.launches}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()
    return 0


def phase_dist_two(env, model_path) -> dict:
    """Two processes joined by gloo, both on cuda:0 (NCCL refuses two ranks
    on one card): the learner step at batch 1024 (512 a rank) against one
    process's on the whole batch (the loss and running statistics within
    the CPU test's tolerances, the gradients and parameters no further off
    than one process's step on the same rows in another order), and one
    ``Pipeline(mesh=)`` iteration at 256 games (128 a rank, no root noise,
    T=0, the folded net) whose ring equals one process's."""
    import tempfile

    from alphazero_tpu_torch.training.pipeline import Pipeline

    # One process first, then the two ranks with the card to themselves.
    # The same step on the batch's rows in another order: how far the
    # order of the f32 sums alone moves it on the card.
    batch = _dist_batch(env)
    one = _dist_learner(model_path, env, batch)
    perm = torch.from_numpy(np.random.RandomState(6).permutation(1024))
    floor = _compare_dist(_dist_learner(model_path, env, batch, rows=perm,
                                        timed_steps=0), one)
    with tempfile.TemporaryDirectory() as tmp:
        pipe = Pipeline(_dist_pipeline_config(os.path.join(tmp, "one"), 256, "folded"))
        t0 = time.perf_counter()
        entry = pipe.run_iteration(0)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        ring = _ring(pipe)
        del pipe
        torch.cuda.empty_cache()
        port = _free_port()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--dist-worker", str(r), str(port), tmp],
                                  cwd=ROOT, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=600)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
        for r, (p, text) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"[dist_two] rank {r} failed:\n{text[-3000:]}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
    res = {"backend": "gloo", "learner": [_compare_dist(r["learner"], one) for r in ranks],
           "learner_rows_permuted": floor,
           "ring_equal_one_process": [_rings_equal(r["ring"], ring) for r in ranks],
           "ring_size": ring["size"], "lanes_a_rank": [r["lanes"] for r in ranks],
           "loss": {"ranks": [r["entry"]["loss"] for r in ranks], "one": entry["loss"]},
           "iteration_s": {"ranks": [r["iteration_s"] for r in ranks], "one": one_s},
           "learner_steps_per_s": {"ranks": [r["learner"]["steps_per_s"] for r in ranks],
                                   "one": one["steps_per_s"]},
           "gather_launches": [r["gather_launches"] for r in ranks]}
    log("[dist_two] " + json.dumps(res))
    # The loss and the running statistics meet the CPU test's tolerances.
    # The gradients and parameters cannot on the card: one process misses
    # them against itself with the rows reordered (cuDNN's f32 weight
    # gradients sum 230,400 terms an element, in an order the batch's
    # shape decides), so the ranks must come no further from one process
    # than that reordering does, with a margin of 1.5.
    learner_ok = all(
        c["loss_rel_err"] <= 1e-5 and c["stats_excess"] <= 0
        and c["grad_norm_rel_err"] <= 1.5 * floor["grad_norm_rel_err"]
        and c["grad_elements_over"] <= 1.5 * floor["grad_elements_over"]
        and c["param_elements_over"] <= 1.5 * floor["param_elements_over"]
        for c in res["learner"])
    if not (learner_ok and all(res["ring_equal_one_process"])
            and ring["size"] > 0 and min(res["gather_launches"]) > 0):
        raise AssertionError(f"[dist_two] {res}")
    return res


def phase_scripts() -> dict:
    """The three scripts in this process, as a user runs them on the card:
    ``regression_test.py --device cuda`` (every check ok);
    ``benchmark.py`` at its width (B=1024, 6x64, 15x15) cut to 64
    simulations; ``hyperopt.py --trials 2 --iterations 1`` cut to 9x9, 32
    games, 8 simulations.  Gather launches counted; the kernel calls held
    against their plain versions."""
    import io
    import tempfile

    from alphazero_tpu_torch.ops.gather_rows import gather_rows
    from alphazero_tpu_torch.ops.s8_mm import s8_mm
    from alphazero_tpu_torch.scripts import benchmark, hyperopt, regression_test

    def run(main, argv):
        buf = io.StringIO()
        code = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            try:
                main(argv)
            except SystemExit as e:
                code = e.code
        torch.cuda.synchronize()
        lines = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
        return code, lines, time.perf_counter() - t0

    res = {}
    gather_rows.launches = 0
    s8_mm.launches = 0
    cwd = os.getcwd()
    with _KernelCalls() as rec, tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)  # hyperopt's trials write checkpoints/history.json
        code, lines, wall = run(regression_test.main, ["--device", "cuda"])
        res["regression_test"] = {"exit": code, "wall_s": wall, "checks": lines}
        log("[scripts] benchmark.py depth cut: 64 simulations (was 800)")
        code, lines, wall = run(benchmark.main, ["--simulations", "64"])
        res["benchmark"] = {"wall_s": wall, "line": lines[-1]}
        cut = ["--trials", "2", "--iterations", "1", "--games", "32",
               "--simulations", "8"]
        log("[scripts] hyperopt.py depth cut: " + " ".join(cut)
            + " (defaults 8 trials, 4 iterations, 32 games, 64 simulations)")
        try:
            code, lines, wall = run(hyperopt.main, cut + ["--output", "hyperopt.json"])
        finally:
            os.chdir(cwd)
        res["hyperopt"] = {"wall_s": wall, "best": lines[-1],
                           "trials": lines[:-1]}
    res["launches"] = {"gather_rows": gather_rows.launches, "s8_mm": s8_mm.launches}
    held = _check_recorded("scripts", rec, each=False)
    res["signatures"] = len(held)
    log("[scripts] " + json.dumps(res))
    reg = res["regression_test"]
    if not (reg["exit"] == 0 and reg["checks"][-1] == {"total": 9, "failed": 0}
            and all(c.get("ok", True) for c in reg["checks"])):
        raise AssertionError(f"[scripts] regression_test.py: {reg}")
    if list(res["benchmark"]["line"]) != ["nn_inference", "env_step", "search"]:
        raise AssertionError(f"[scripts] benchmark.py: {res['benchmark']}")
    if not (len(res["hyperopt"]["trials"]) == 2
            and np.isfinite(res["hyperopt"]["best"]["best"]["score"])):
        raise AssertionError(f"[scripts] hyperopt.py: {res['hyperopt']}")
    if res["launches"]["gather_rows"] <= 0:
        raise AssertionError("[scripts] no gather_rows launch")
    return res


def phase_anchor_eval(model_path, games: int = 8, cand_sims: int = 64) -> dict:
    """The anchor evaluation script (``scripts/anchor_eval.py``) as a user runs it: the
    flagship (BN-folded bf16) at ``cand_sims`` simulations, W=16, against
    each ``POOL`` anchor, ``games`` games each from 6 random opening plies,
    the cached round-robin merged, written to a temporary ``--output``.
    This is the ladder [arena] ran before (cut to 8 games an anchor and 64
    simulations, printed); its gate stays: three quarters of the games
    against uniform_mcts_16.  The kernel calls are held against their
    plain versions."""
    import tempfile

    from alphazero_tpu_torch.ops.gather_rows import gather_rows
    from alphazero_tpu_torch.scripts import anchor_eval

    log(f"[anchor_eval] depth cut: AE_GAMES={games} (default 64), "
        f"{cand_sims} simulations (default 800)")
    knobs = dict(AE_GAMES=str(games), AE_WAVE="16", AE_OPENING="6")
    os.environ.update(knobs)
    gather_rows.launches = 0
    try:
        with tempfile.TemporaryDirectory() as tmp, _KernelCalls() as rec:
            path = os.path.join(tmp, "anchor_evals.json")
            t0 = time.perf_counter()
            out = anchor_eval.main([model_path, str(cand_sims), "--output", path])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            with open(path) as f:
                written = json.load(f)
    finally:
        for k in knobs:
            os.environ.pop(k)
    held = _check_recorded("anchor_eval", rec, each=False)
    res = {"record": out, "wall_s": wall, "gather_launches": gather_rows.launches,
           "written_once": written == [out], "signatures": len(held)}
    log("[anchor_eval] " + json.dumps(res))
    first = out["matches"][0]
    need = -(-3 * games // 4)
    if not (res["written_once"] and first[1] == "uniform_mcts_16" and first[2] >= need):
        raise AssertionError(f"[anchor_eval] the flagship took {first} against "
                             f"uniform_mcts_16, fewer than {need} wins: {res}")
    return res


def phase_plugins() -> dict:
    """A game plugin written to a temporary directory (a 9x9 Gomoku under
    its own name), loaded with ``load_directory``, created by name and
    searched on the card (64 lanes, 64 simulations, W=16); its kernel
    calls held against their plain versions; the registry restored."""
    import tempfile

    from alphazero_tpu_torch import create_game
    from alphazero_tpu_torch.core import plugins, registry
    from alphazero_tpu_torch.mcts.search import MCTSConfig, search
    from alphazero_tpu_torch.models.stub import make_uniform_eval_fn

    saved = (dict(registry._REGISTRY), dict(registry._BY_TYPE))
    src = ("def register(register_game):\n"
           "    from alphazero_tpu_torch.core.types import GameType\n"
           "    from alphazero_tpu_torch.games.gomoku import GomokuEnv\n"
           "    register_game('smoke_gomoku9', GameType.UNKNOWN,\n"
           "                  lambda board_size=9, **kw: GomokuEnv(board_size=board_size, **kw))\n")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            with open(os.path.join(tmp, "smoke_plugin.py"), "w") as f:
                f.write(src)
            loaded = plugins.load_directory(tmp)
        env = create_game("smoke_gomoku9")
        with _KernelCalls() as rec:
            out = search(env, make_uniform_eval_fn(env.num_actions, value_noise=0.1),
                         env.init(64, device="cuda"),
                         MCTSConfig(num_simulations=64, wave_size=16),
                         torch.Generator(device="cuda").manual_seed(0))
        visits = out.visit_counts.sum(-1).unique().tolist()
        kind = registry.game_type_of("smoke_gomoku9").name
    finally:
        registry._REGISTRY.clear()
        registry._REGISTRY.update(saved[0])
        registry._BY_TYPE.clear()
        registry._BY_TYPE.update(saved[1])
        sys.modules.pop("smoke_plugin", None)
    held = _check_recorded("plugins", rec, each=False)
    res = {"loaded": loaded, "game_type": kind, "root_visits": visits,
           "signatures": len(held)}
    log("[plugins] " + json.dumps(res))
    if not (loaded == ["smoke_plugin"] and visits == [64] and kind == "UNKNOWN"):
        raise AssertionError(f"[plugins] {res}")
    return res


def phase_slice12(env, int8_eval, convs: int, model_path) -> dict:
    """Every phase of slice 12 in order."""
    walls, out = {}, {}

    def timed(phase, fn, /, *args, **kw):
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        walls[phase] = round(time.perf_counter() - t0, 1)
        return res

    out["scan_main"] = timed("scan_main", phase_scan_main, env, int8_eval, convs)
    log("[scan_pipeline] config/gomoku_15x15.json with host_actor=false")
    out["scan_pipeline"] = timed(
        "scan_pipeline", phase_train_config, tag="scan_pipeline",
        cuts={"host_actor": False, "selfplay.max_moves": 4,
              "train_steps_per_iteration": 2})
    out["dist_one"] = timed("dist_one", phase_dist_one, env, model_path)
    out["dist_two"] = timed("dist_two", phase_dist_two, env, model_path)
    out["scripts"] = timed("scripts", phase_scripts)
    out["records"] = timed("records", phase_records, env,
                           out["scan_main"].pop("output"))
    out["anchor_eval"] = timed("anchor_eval", phase_anchor_eval, model_path)
    out["plugins"] = timed("plugins", phase_plugins)
    log("[slice12] phase wall seconds: " + json.dumps(walls))
    out["walls"] = walls
    return out


def _named_tensors(tree, prefix="") -> dict:
    """The tensors of a nested dict/list tree by dotted path."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree} if isinstance(tree, torch.Tensor) else {}
    out = {}
    for k, v in items:
        out.update(_named_tensors(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _learner_run(model_path, env, batch_cpu, cfg, device, steps, dtype=None,
                 perm=None):
    """``steps`` train steps of the flagship bundle on one fixed batch on
    ``device`` (its rows in the order ``perm``, where given); returns
    (initial params, final params, losses, step seconds, the first step's
    gradients after the clip)."""
    from alphazero_tpu_torch.models.io import load_model
    from alphazero_tpu_torch.training import learner, replay

    model, _ = load_model(model_path, env.observation_shape, device=device)
    if dtype is not None:
        model.cfg = dataclasses.replace(model.cfg, dtype=dtype)
    init = {k: v.detach().clone() for k, v in model.named_parameters()}
    state = learner.create_train_state(model, cfg)
    batch = replay.Batch(*(x if perm is None else x[perm] for x in batch_cpu))
    batch = replay.Batch(*(x.to(device) for x in batch))
    losses, times, grads = [], [], None
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = learner.train_step(state, batch, cfg)
        losses.append(m.loss)
        if device == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if grads is None:
            grads = torch.cat([p.grad.detach().ravel().cpu() for p in model.parameters()])
    final = {k: v.detach().cpu() for k, v in model.named_parameters()}
    return ({k: v.cpu() for k, v in init.items()}, final,
            [float(x) for x in losses], times, grads)


def _compare_learners(card, cpu, lr) -> dict:
    """Card against CPU after the same steps: the first step's gradients,
    the per-step losses, and the updates (final - initial params) of all
    parameters."""
    (_, f_card, l_card, _, g_card), (init, f_cpu, l_cpu, _, g_cpu) = card, cpu
    d_card = torch.cat([(f_card[k] - init[k]).ravel() for k in init])
    d_cpu = torch.cat([(f_cpu[k] - init[k]).ravel() for k in init])
    diff = (d_card - d_cpu).abs()
    return {
        "loss_card": l_card, "loss_cpu": l_cpu,
        "grad_rel_err": float((g_card - g_cpu).norm() / g_cpu.norm()),
        "loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu)),
        "update_rel_err": float((d_card - d_cpu).norm() / d_cpu.norm()),
        "param_max_abs_err": float(diff.max()),
        "param_share_off_0.1lr": float((diff > 0.1 * lr).float().mean()),
        "params": d_cpu.numel(),
    }


class _KernelCalls:
    """While active, keeps the inputs of the first call of each distinct
    signature (shapes, strides, dtypes, each base's offset from 16 bytes)
    of the kernel wrappers that the search and the int8 executor call, and
    counts the calls of each.  It wraps the names those modules bound at
    import and passes every call on unchanged, so the wrappers' own launch
    counts stay what the path launched."""

    def __init__(self):
        self.cases = {}  # (name, signature) -> [args, calls]

    @staticmethod
    def _sig(x):
        if isinstance(x, (tuple, list)):
            return tuple(_KernelCalls._sig(t) for t in x)
        return (tuple(x.shape), tuple(x.stride()), str(x.dtype).replace("torch.", ""),
                x.data_ptr() % 16)

    def _wrap(self, name, fn):
        def call(*args):
            key = (name, self._sig(args))
            self.cases.setdefault(key, [args, 0])[1] += 1
            return fn(*args)
        return call

    def __enter__(self):
        from alphazero_tpu_torch.mcts import search
        from alphazero_tpu_torch.models import quant

        self._orig = [(search, "gather_rows"), (search, "gather_rows_many"),
                      (quant, "s8_mm")]
        self._orig = [(m, n, getattr(m, n)) for m, n in self._orig]
        for m, n, fn in self._orig:
            setattr(m, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for m, n, fn in self._orig:
            setattr(m, n, fn)


def _hold_recorded(cases) -> list:
    """Each recorded call again through its kernel and its plain version on
    the same tensors: bit for bit (the s8 products are exact; a gather
    moves bytes).  TF32 off: the plain s8 product is an f32 matmul, exact
    only in full f32 (K <= 1024 terms of at most 128**2)."""
    from alphazero_tpu_torch.ops.gather_rows import (
        gather_rows, gather_rows_many, gather_rows_many_plain, gather_rows_plain)
    from alphazero_tpu_torch.ops.s8_mm import s8_mm, s8_mm_plain

    fns = {"s8_mm": (s8_mm, s8_mm_plain), "gather_rows": (gather_rows, gather_rows_plain),
           "gather_rows_many": (gather_rows_many, gather_rows_many_plain)}
    rows = []
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for (name, sig), (args, calls) in cases.items():
            kern, plain = fns[name]
            out, ref = kern(*args), plain(*args)
            outs = out if isinstance(out, tuple) else (out,)
            refs = ref if isinstance(ref, tuple) else (ref,)
            equal = all(o.dtype == r.dtype and o.shape == r.shape
                        and torch.equal(o.view(torch.uint8), r.view(torch.uint8))
                        for o, r in zip(outs, refs))
            rows.append({"kernel": name, "inputs": sig, "calls": calls,
                         "bit_equal": equal})
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return rows


def _check_recorded(tag: str, rec: "_KernelCalls", each: bool = True) -> list:
    """Holds every call ``rec`` recorded against its plain version, prints
    each signature (or, with ``each`` false, one summary line), and fails
    unless there was at least one and all are bit-equal."""
    held = _hold_recorded(rec.cases)
    if each:
        for r in held:
            log(f"[{tag}] kernel vs plain: " + json.dumps(r))
    else:
        log(f"[{tag}] kernel vs plain: " + json.dumps({
            "signatures": len(held), "calls": sum(r["calls"] for r in held),
            "kernels": sorted({r["kernel"] for r in held}),
            "bit_equal": all(r["bit_equal"] for r in held)}))
    bad = [r for r in held if not r["bit_equal"]]
    if bad or not held:
        raise AssertionError(f"[{tag}] kernels disagree with their plain "
                             f"versions at the path's shapes: {bad or 'no calls'}")
    return held


def phase_train(env, model_path) -> dict:
    """The training slice at the flagship width (6x64 SE-ResNet, 15x15).

    Learner: the flagship bundle in train mode on one fixed batch of 1024
    (mid-game observations, random targets from a seed), 2 AdamW steps at
    lr 1e-3 on the card and on the CPU, in float32 (TF32 off) and in the
    production policy (bf16 compute, f32 master weights); then 30 steps on
    the card, whose loss must fall, timed.  Pipeline: the int8 executor from
    the flagship weights, 2 iterations at a reduced depth; s8_mm and
    gather_rows must launch in each actor run, the learner's weights and
    the refreshed quantised parameters must change, and a checkpoint must
    restore bit for bit.  Every distinct s8_mm and gather call of the
    second iteration (shape, layout and alignment) is held against its plain
    version on its own inputs, and the refreshed evaluator on 256 replay
    observations against the same evaluator with the plain s8 product, bit
    for bit."""
    import tempfile

    from alphazero_tpu_torch.mcts.search import MCTSConfig
    from alphazero_tpu_torch.models.io import load_model
    from alphazero_tpu_torch.ops.gather_rows import gather_rows
    from alphazero_tpu_torch.models import quant
    from alphazero_tpu_torch.ops.s8_mm import s8_mm, s8_mm_plain
    from alphazero_tpu_torch.selfplay.actor import SelfPlayConfig
    from alphazero_tpu_torch.training import replay
    from alphazero_tpu_torch.training.learner import LearnerConfig
    from alphazero_tpu_torch.training.pipeline import Pipeline, PipelineConfig

    t_phase = time.perf_counter()
    # 2 steps on each side (cut from 3 with the chess phases; printed).
    B, A, lr, steps = 1024, env.num_actions, 1e-3, 2
    log(f"[train] learner depth cut: {steps} steps on each side (was 3)")
    rng = np.random.RandomState(5)
    obs = env.observation(_random_states(env, B, 60, seed=5, device="cpu"))
    policy = torch.softmax(torch.from_numpy(
        rng.normal(size=(B, A)).astype(np.float32) * 2), -1)
    value = torch.from_numpy(np.tanh(rng.normal(size=B)).astype(np.float32))
    batch = (obs, policy, value)
    cfg = LearnerConfig(learning_rate=lr, scheduler="constant", warmup_steps=0)

    res = {}
    perm = torch.from_numpy(np.random.RandomState(6).permutation(B))
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        card32 = _learner_run(model_path, env, batch, cfg, "cuda", steps, torch.float32)
        res["f32"] = _compare_learners(
            card32, _learner_run(model_path, env, batch, cfg, "cpu", steps,
                                 torch.float32), lr)
        # The card against itself on the same batch in another row order:
        # what the order of the f32 sums alone does.
        res["f32_card_permuted"] = _compare_learners(
            card32, _learner_run(model_path, env, batch, cfg, "cuda", steps,
                                 torch.float32, perm), lr)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    res["bf16"] = _compare_learners(
        _learner_run(model_path, env, batch, cfg, "cuda", steps),
        _learner_run(model_path, env, batch, cfg, "cpu", steps), lr)
    for k in ("f32", "f32_card_permuted", "bf16"):
        log(f"[train] learner {k}, {steps} steps: " + json.dumps(res[k]))
    # Limits.  The first step starts from the same weights: its gradients
    # differ by the order of the sums alone (f32) or by bf16 rounding.
    # Adam then divides each gradient by its own RMS, so an element whose
    # gradient is near 0 moves by about lr * sign(g) on either side, and the
    # later steps and updates diverge further (on the CPU alone, permuting
    # the batch rows of a 128-batch gave a 0.9 % update difference and
    # 0.27 % of elements off by 0.1 lr).  f32: gradients within 1e-3,
    # losses within 1e-4, updates within 5 %, at most 2 % of elements off
    # by 0.1 lr.  bf16 (8-bit mantissas in every conv and dense layer):
    # gradients within 5 %, losses within 1e-2, updates within 30 %.  What
    # catches a wrong learner is the first step's gradients (the same
    # weights on both sides) and the losses of the later steps; the update
    # limits catch a wrong optimizer.  The largest element difference is
    # printed but not bounded: an element whose gradient flips sign lands
    # about 2 lr a step away, the most two Adam runs can differ by.
    limits = {"f32": {"grad_rel_err": 1e-3, "loss_rel_err": 1e-4,
                      "update_rel_err": 0.05, "param_share_off_0.1lr": 0.02},
              "bf16": {"grad_rel_err": 0.05, "loss_rel_err": 1e-2,
                       "update_rel_err": 0.3}}
    log("[train] limits: " + json.dumps(limits))
    for k, lim in limits.items():
        over = {m: res[k][m] for m, v in lim.items() if not res[k][m] <= v}
        if over:
            raise AssertionError(f"{k} learner on the card disagrees with the "
                                 f"CPU beyond the limits: {over}")

    torch.cuda.reset_peak_memory_stats()
    _, _, losses, times, _ = _learner_run(model_path, env, batch, cfg, "cuda", 30)
    res["learner"] = {
        "batch": B, "steps": 30, "loss_first": losses[0], "loss_last": losses[-1],
        "train_steps_per_s": (len(times) - 1) / sum(times[1:]),
        "first_step_s": times[0],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    log("[train] learner on the card: " + json.dumps(res["learner"]))
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall over 30 steps: {losses}")

    # The Pipeline, int8 executor, from the flagship weights.
    flagship, meta = load_model(model_path, env.observation_shape, device="cuda")
    with tempfile.TemporaryDirectory() as ckpt_dir:
        pcfg = PipelineConfig(
            board_size=15, model=flagship.cfg,
            selfplay=SelfPlayConfig(
                mcts=MCTSConfig(num_simulations=32, wave_size=16, max_children=32),
                max_moves=32, recycle=True),
            learner=cfg, iterations=2, games_per_iteration=256,
            train_steps_per_iteration=8, train_batch_size=B,
            replay_capacity=100_000, min_replay_before_training=1,
            checkpoint_dir=ckpt_dir, checkpoint_every=1, inference="int8")
        mcts = pcfg.selfplay.mcts
        log("[train] pipeline depth cut: 32 moves an iteration (was 64)")
        log("[train] pipeline depth: " + json.dumps({
            "games_per_iteration": pcfg.games_per_iteration,
            "simulations": mcts.num_simulations, "wave": mcts.wave_size,
            "max_moves": pcfg.selfplay.max_moves,
            "train_steps_per_iteration": pcfg.train_steps_per_iteration,
            "train_batch_size": pcfg.train_batch_size,
            "iterations": pcfg.iterations, "recycle": pcfg.selfplay.recycle,
            "inference": pcfg.inference}))
        pipe = Pipeline(pcfg)
        pipe.state.module.load_state_dict(flagship.state_dict())
        start = {k: v.clone() for k, v in pipe.state.module.state_dict().items()}
        torch.cuda.reset_peak_memory_stats()
        entries, trees = [], []
        # The second iteration (the refreshed evaluator) runs with its
        # kernel calls recorded; the first runs as it is, so its actor time
        # holds no recording.
        recorded = _KernelCalls()
        for it in range(2):
            gather_rows.launches = 0
            s8_mm.launches = 0
            with recorded if it == 1 else contextlib.nullcontext():
                entry = pipe.run_iteration(it)
            entry["launches"] = {"gather_rows": gather_rows.launches,
                                 "s8_mm": s8_mm.launches}
            entry["calls_recorded"] = it == 1
            pipe.save_checkpoint(it)
            entries.append(entry)
            trees.append(pipe.eval_tree)
            log(f"[train] pipeline iteration {it}: " + json.dumps(entry))
        pipe.save_history()
        # The kernels at the Pipeline's own shapes, after its counts were
        # read.  TF32 off: the plain s8 product is an f32 matmul, exact only
        # in full f32 (K <= 1024 terms of at most 128**2).
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            held = _hold_recorded(recorded.cases)
            obs = replay.sample(pipe.buffer, env,
                                torch.Generator(device="cuda").manual_seed(9),
                                256, False).obs
            with torch.no_grad():
                l_k, v_k = pipe.evaluate(obs)
                quant.s8_mm = s8_mm_plain
                try:
                    l_p, v_p = pipe.evaluate(obs)
                finally:
                    quant.s8_mm = s8_mm
            torch.cuda.synchronize()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        for r in held:
            log("[train] pipeline kernel vs plain: " + json.dumps(r))
        eval_equal = torch.equal(l_k, l_p) and torch.equal(v_k, v_p)
        log("[train] refreshed int8 evaluator vs plain s8, 256 replay "
            f"observations: bit_equal={eval_equal}")
        bad = [r for r in held if not r["bit_equal"]]
        kinds = {r["kernel"] for r in held}
        if bad or not eval_equal:
            raise AssertionError(f"kernels at the Pipeline's shapes disagree "
                                 f"with their plain versions: {bad}, "
                                 f"evaluator bit_equal={eval_equal}")
        if "s8_mm" not in kinds or not kinds & {"gather_rows", "gather_rows_many"}:
            raise AssertionError(f"no s8_mm or gather call recorded: {kinds}")
        for e in entries:
            if e["launches"]["gather_rows"] <= 0 or e["launches"]["s8_mm"] <= 0:
                raise AssertionError(f"the actor launched no gather_rows or s8_mm: {e}")
            if not (e["replay_size"] > 0 and np.isfinite(e["loss"])
                    and np.isfinite(e["grad_norm"])):
                raise AssertionError(f"pipeline iteration did not train: {e}")
        moved = [k for k, v in pipe.state.module.state_dict().items()
                 if not torch.equal(v, start[k])]
        if not moved:
            raise AssertionError("the learner's weights did not change")
        before, after = _named_tensors(trees[0]), _named_tensors(trees[1])
        refreshed = [k for k in before if not torch.equal(before[k], after[k])]
        if not refreshed:
            raise AssertionError("the quantised parameters were not refreshed")
        fresh = Pipeline(pcfg)
        restored = fresh.restore_checkpoint()
        sd_a, sd_b = fresh.state.module.state_dict(), pipe.state.module.state_dict()
        opt_a = fresh.state.optimizer.state_dict()["state"]
        opt_b = pipe.state.optimizer.state_dict()["state"]
        same = (restored == 1 and fresh.state.step == pipe.state.step
                and all(torch.equal(sd_a[k], sd_b[k]) for k in sd_b)
                and all(torch.equal(opt_a[i][n], opt_b[i][n])
                        for i in opt_b for n in opt_b[i])
                and torch.equal(fresh.generator.get_state(), pipe.generator.get_state()))
        history = os.path.exists(os.path.join(ckpt_dir, "history.json"))
        res["pipeline"] = {
            "iterations": entries, "params_changed": len(moved),
            "quantised_refreshed": f"{len(refreshed)} of {len(before)} tensors", "checkpoint_bit_equal": same,
            "checkpoints": pipe.checkpoints(), "history_json": history,
        }
        log("[train] pipeline: " + json.dumps({k: v for k, v in res["pipeline"].items()
                                               if k != "iterations"}))
        if not (same and history):
            raise AssertionError(f"checkpoint or history failed: {res['pipeline']}")
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"[train] phase wall time {res['wall_s']:.1f} s")
    return res


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--dist-worker":
        sys.path.insert(0, ROOT)
        return dist_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from alphazero_tpu_torch.core import registry

    t_start = time.perf_counter()
    walls = {}

    def timed(phase, fn, /, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        walls[phase] = round(time.perf_counter() - t0, 1)
        return out

    name, _ = phase_device()
    timed("build", phase_build)
    rows = timed("kernels", phase_kernels)
    prod_rows = timed("products", phase_products)
    env = registry.create_game("gomoku", 15)
    model_path = os.path.join(ROOT, "models_zoo", "flagship_gomoku15")
    phase_net(env, model_path)

    from alphazero_tpu_torch.models.io import load_model
    from alphazero_tpu_torch.models.quant import make_production_eval_fn
    from alphazero_tpu_torch.models.resnet import make_inference_eval_fn

    model, _ = load_model(model_path, env.observation_shape, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    int8_eval, calib = make_production_eval_fn(
        env, model, generator=torch.Generator(device="cuda").manual_seed(7))
    torch.cuda.synchronize()
    log(f"[calibration] {tuple(calib.shape)} rollout observations, calibrated "
        f"and quantised in {time.perf_counter() - t0:.2f} s")
    phase_net_int8(env, model, calib)
    convs = 1 + 2 * model.cfg.num_blocks  # bf16 heads: trunk convs only
    # Cut to keep the script near 300 s: [main] plays 2 moves (was 3), one
    # of them timed.
    log("[main] depth cut: 2 moves (was 3), the second timed")
    main_res = timed("main", phase_main_path, env, int8_eval, "int8",
                     sims=800, moves=2, s8_convs=convs)
    # The sequential path at the shipped config's width (256 games), and
    # tree reuse at bench.py's reuse shape, against the same greedy moves
    # without reuse.
    # Cut with the chess phases, to hold the script under 700 s: [w1_main]
    # at 400 simulations, [reuse_base] and [reuse_main] at 192 (12 waves of
    # 16; were 800); with the slice-11 phases [w1_main] at 200 (the reuse
    # pair at 96 saved no simulation: some lane of 1024 always plays a child
    # of one visit).
    log("[w1_main] depth cut: 200 simulations (was 800, then 400); [reuse_base] "
        "[reuse_main]: 192 (were 800)")
    w1_res = timed("w1_main", phase_main_path, env, int8_eval, "int8",
                   sims=200, moves=2, s8_convs=convs, B=256, W=1, tag="w1_main")
    if w1_res["launches"]["s8_mm"] != convs * (1 + 200) * 2:
        raise AssertionError(f"[w1_main] s8_mm launches {w1_res['launches']}, "
                             f"not {convs} x (1 + 200) a move")
    # Cut with the Go phases, which took the script past 600 s: 2 moves
    # each (was 3), the second timed (after reuse, a re-rooted tree).
    log("[reuse_base] [reuse_main] depth cut: 2 moves each (was 3), the second timed")
    base_res = timed("reuse_base", phase_main_path, env, int8_eval, "int8",
                     sims=192, moves=2, s8_convs=convs, greedy=True,
                     tag="reuse_base")
    reuse_res = timed("reuse_main", phase_main_path, env, int8_eval, "int8",
                      sims=192, moves=2, s8_convs=convs, reuse=True,
                      tag="reuse_main")
    log("[reuse_main] timed moves/s (move 2) with reuse "
        f"{reuse_res['timed_moves_per_s']:.2f} against "
        f"{base_res['timed_moves_per_s']:.2f} for the same greedy moves without "
        f"([reuse_base]), {main_res['timed_moves_per_s']:.2f} at temperature 1 "
        "with recycling ([main]); this run")
    timed("main_folded", phase_main_path, env, make_inference_eval_fn(model),
          "folded", sims=192, moves=2)
    probe_launches = timed("probe_path", phase_probe_path)
    timed("card_vs_cpu", phase_card_vs_cpu)
    timed("search_options", phase_search_options)
    timed("parity", phase_parity)
    timed("train", phase_train, env, model_path)
    log("[train_config] depth cut: 4 moves an iteration (was 8)")
    timed("train_config", phase_train_config, cuts={"selfplay.max_moves": 4})
    log("[variants] depth cut: 96 simulations (was 800, then 192)")
    timed("variants", phase_variants, int8_eval, convs, main_res, sims=96)
    timed("arena", phase_arena)
    go = phase_go(convs)
    walls.update(go["walls"])
    chess = phase_chess()
    walls.update(chess["walls"])
    slice11 = phase_slice11()
    walls.update(slice11["walls"])
    # The anchored ladder (8 games an anchor, was 16; the flagship at 64
    # simulations, was 128: cuts made with the chess and slice-11 phases)
    # runs through the anchor evaluation script in [anchor_eval].
    slice12 = phase_slice12(env, int8_eval, convs, model_path)
    walls.update(slice12["walls"])

    head = rows[0]  # child stats: the most rows of any gather per level
    kernels = [{
        "name": "gather_rows",
        "route": "cuda",
        "source": "alphazero_tpu_torch/csrc/gather_rows.cu",
        "replaces": "alphazero_tpu/ops/gather_rows.py:58",
        "launches": main_res["launches"]["gather_rows"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": head["ms"],
        "graph_ms": head["graph_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": "bytes",
        "library_ms": head["library_ms"],
    }]
    # One line per product kernel: the case named here gives the times (the
    # main path's conv shape for s8_mm), all its cases the largest error.
    for kname, source, case, replaces, launches in (
            ("s8_mm", "wgmma_mm", "conv3x3_64",
             "tools/profile_fused_shapes.py:46", main_res["launches"]["s8_mm"]),
            ("s8_mm_multi", "wgmma_mm", "probe_5x128x64",
             "tools/profile_fused_shapes.py:68", probe_launches["s8_mm_multi"]),
            ("chained_dot", "wgmma_mm", "s8_3600x576x64",
             "tools/profile_inkernel_dot.py:23", probe_launches["chained_dot"]),
            ("tiled_mm", "wgmma_mm", "s8_8192x2048x2048",
             "tools/profile_pallas_mm.py:30", probe_launches["tiled_mm"])):
        mine = [r for r in prod_rows if r["kernel"] == kname]
        row = next(r for r in mine if r["case"] == case)
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": f"alphazero_tpu_torch/csrc/{source}.cu",
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": row["ms"],
            "graph_ms": row["graph_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    log("[timing] phase wall seconds: " + json.dumps(walls))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
