"""Where one chunk of the int8 executor spends its time on the card.

Builds the production executor for the flagship bundle (rollout
calibration, ``production.py``) and times one chunk of 512 positions through
``models/quant.forward_int8_from_q``: its time by CUDA events, the host's
time to enqueue it, its kernel launches and summed device time (from
``torch.profiler``), the top kernels by device time, and each piece of one
block on its own (pad, im2col copy in 4-byte words and byte-wise, the s8
conv, requant, quantise, tap sums, SE gate, heads).  The chunk is measured
three times: with the fused epilogues (``ops/int8_epilogue.py``) and the SE
gate's kernel (``ops/se_gate.py``); under ``plain_gate``, with the gate
taking its plain chain (``quant._gate_fused`` patched), the chunk as it was
before the gate's kernel; and under ``plain``, with every epilogue taking
its plain passes too (``quant._fused`` patched).  ``epilogue`` holds
``epilogue_rows``: each epilogue form, kernel against plain passes, checked
bit for bit and timed from a CUDA graph that keeps no input or output in
L2; ``epilogue_chunk`` sums them over the 13 trunk convs of a chunk.
``gate`` holds ``gate_row``: the gate's kernel against its plain chain, in
bf16 ulps, timed the same way.  Prints one JSON line.

    python -m alphazero_tpu_torch.scripts.profile_int8_chunk
"""
from __future__ import annotations

import argparse
import json
import time
from unittest import mock

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="models_zoo/flagship_gomoku15")
    p.add_argument("--top", type=int, default=10)
    args = p.parse_args(argv)

    import torch
    import torch.nn.functional as F

    from alphazero_tpu_torch import production
    from alphazero_tpu_torch.core import registry
    from alphazero_tpu_torch.models import quant
    from alphazero_tpu_torch.models.io import load_model
    from alphazero_tpu_torch.scripts.profile_s8_dots import cuda_ms

    if not torch.cuda.is_available():
        raise SystemExit("profile_int8_chunk needs a CUDA card")
    env = registry.create_game("gomoku", 15)
    model, _ = load_model(args.model, env.observation_shape, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    _, calib = quant.make_production_eval_fn(env, model, generator=gen)
    qp = quant._executor_params(quant.build_quantized_params(
        model, calib, calib_percentile=production.INT8_CALIB_PERCENTILE))
    chunk = production.INT8_CHUNK
    xq = quant._quant_act(calib[:chunk].float().permute(0, 2, 3, 1),
                          qp["in_scale"]).contiguous()
    modes = (production.INT8_RESIDUAL, production.INT8_HEADS)

    def forward():
        return quant.forward_int8_from_q(qp, xq, *modes)

    def bytewise_im2col(x):
        B, H, W, C = x.shape
        xp = F.pad(x, (0, 0, 1, 1, 1, 1))
        sB, sH, sW, sC = xp.stride()
        return xp.as_strided((B, H, W, 3, 3, C), (sB, sH, sW, sH, sW, sC)
                             ).reshape(B * H * W, 9 * C)

    with torch.no_grad():
        blk = qp["blocks"][0]
        aq = torch.randint(0, 128, (chunk, 15, 15, blk["wq1"].shape[2]),
                           device="cuda", dtype=torch.int8)
        acc = quant._conv_i8(aq, blk["wq1"])
        h = quant._requant(acc, blk["m1"], blk["b1"])
        pieces = {
            "pad": lambda: F.pad(aq, (0, 0, 1, 1, 1, 1)),
            "im2col_words": lambda: quant._im2col(aq, 3, 3),
            "im2col_bytes": lambda: bytewise_im2col(aq),
            "conv_i8": lambda: quant._conv_i8(aq, blk["wq1"]),
            "requant": lambda: quant._requant(acc, blk["m1"], blk["b1"]),
            "quant_act": lambda: quant._quant_act(h, blk["mid_scale"], lo=0.0),
            "tap_sums": lambda: quant._tap_sums(aq),
            "se_gate": lambda: quant._se_gate_precomputed(aq, blk),
            "heads": lambda: quant._heads(qp, h.to(torch.bfloat16)),
        }
        piece_ms = {k: cuda_ms(fn, 20) for k, fn in pieces.items()}
        rows = epilogue_rows(qp, chunk, 15, modes[0])
        gate = gate_row(qp, chunk, 15)
        measured = {"fused": chunk_stats(forward, cuda_ms, args.top)}
        with mock.patch.object(quant, "_gate_fused", lambda taps: False):
            measured["plain_gate"] = chunk_stats(forward, cuda_ms, args.top)
            with mock.patch.object(quant, "_fused", lambda acc: False):
                measured["plain"] = chunk_stats(forward, cuda_ms, args.top)

    # The 13 trunk convs of a chunk: the stem, each block's conv1, and its
    # conv2, the last one with the bf16 copy the bf16 heads read.
    n = len(qp["blocks"])
    per_chunk = {"stem": 1, "conv1": n, "conv2": n - 1, "conv2_a": 1}
    if modes[0] == "bf16" or modes[1] != "bf16":
        per_chunk.update(conv2=n, conv2_a=0)
    by_form = {r["form"]: r for r in rows}
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "chunk": chunk,
        "residual": modes[0], "heads": modes[1], **measured["fused"],
        "plain_gate": measured["plain_gate"], "plain": measured["plain"],
        "piece_ms": piece_ms, "epilogue": rows, "gate": gate,
        "epilogue_chunk": {
            k: sum(c * by_form[f][k] for f, c in per_chunk.items() if c)
            for k in ("ms", "graph_ms", "plain_ms", "plain_graph_ms",
                      "bound_ms")},
    }))


def cycled_graph_ms(fns, reps: int = 5) -> float:
    """Device milliseconds a call: ``reps`` rounds over ``fns`` captured in
    one CUDA graph and replayed, every output kept so that no call writes
    where another did.  Where each of ``fns`` reads its own inputs, and all
    of them together are larger than the L2 cache, no call finds its inputs
    there either (``profile_s8_dots.graph_ms`` replays one call, whose
    inputs then stay in L2 where they fit)."""
    import torch

    from alphazero_tpu_torch.scripts.profile_s8_dots import cuda_ms

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph, keep = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        for _ in range(reps):
            keep += [fn() for fn in fns]
    ms = cuda_ms(graph.replay, 5) / (reps * len(fns))
    del keep, graph
    return ms


def epilogue_rows(qp, B: int, side: int, residual: str, sets: int = 4,
                  seed: int = 0) -> list:
    """Each trunk epilogue form of the executor's parameters ``qp``
    (``quant._executor_params``, on the card) at the accumulator
    ``[B, side, side, O]`` of its first block, on ``sets`` input sets: random
    s8 activations through the block's conv1, the residual of each kind and
    the SE gate from the tap sums.  Forms: ``stem``, ``conv1``, ``conv2``
    (with the bf16 copy only under ``residual="bf16"``) and, under
    ``residual="int8"``, ``conv2_a`` (the last block's, with the copy the
    bf16 heads read).  A row a form: ``bit_equal`` (each output of the
    kernel, ``quant._epilogue_*``, against the plain passes,
    ``quant._epilogue_*_plain``, on every set by ``torch.equal``); ``ms``
    and ``plain_ms`` eager by CUDA events, the sets in turn (the host's
    launches included); ``graph_ms`` and ``plain_graph_ms`` by
    ``cycled_graph_ms`` (device time, inputs and outputs not in L2); and
    ``bound_ms``, the bytes the kernel reads and writes at 3.35 TB/s."""
    import torch

    from alphazero_tpu_torch.models import quant
    from alphazero_tpu_torch.scripts.profile_s8_dots import cuda_ms

    gen = torch.Generator(device="cuda").manual_seed(seed)
    st, blk = qp["stem"], qp["blocks"][0]
    s_prev = st["out_scale"]
    data = []
    for _ in range(sets):
        x = torch.randint(0, 128, (B, side, side, blk["wq1"].shape[2]),
                          generator=gen, device="cuda", dtype=torch.int8)
        acc = quant._conv_i8(x, blk["wq1"])
        hq, taps = quant._epilogue_conv1_plain(acc, blk)
        g = quant._se_gate_from_taps(taps, side * side, blk)
        a = quant._epilogue_stem_plain(acc, st)[1]
        data.append({"acc": acc, "aq": x, "a": a, "g": g})

    keep_a = residual == "bf16"
    forms = {
        "stem": (keep_a, lambda d, w: quant._epilogue_stem(d["acc"], st, w),
                 lambda d: quant._epilogue_stem_plain(d["acc"], st), ()),
        "conv1": (None, lambda d, w: quant._epilogue_conv1(d["acc"], blk),
                  lambda d: quant._epilogue_conv1_plain(d["acc"], blk), ()),
    }

    def conv2(d, w):
        return quant._epilogue_conv2(d["acc"], blk, d["g"], d["a"], d["aq"],
                                     s_prev, residual, w)

    def conv2_plain(d):
        return quant._epilogue_conv2_plain(d["acc"], blk, d["g"], d["a"],
                                           d["aq"], s_prev, residual)

    reads = ("g", "aq" if residual == "int8" else "a")
    forms["conv2"] = (keep_a, conv2, conv2_plain, reads)
    if not keep_a:
        forms["conv2_a"] = (True, conv2, conv2_plain, reads)

    rows = []
    for form, (want_a, kern, plain, extra) in forms.items():
        equal = True
        for d in data:
            outs, refs = kern(d, want_a), plain(d)
            # The bf16 copy is left out where it is not wanted.
            equal &= all((o is None and i == 1 and want_a is False)
                         or (o is not None and o.dtype == r.dtype
                             and torch.equal(o, r))
                         for i, (o, r) in enumerate(zip(outs, refs)))
        torch.cuda.synchronize()
        moved = (outs[0].nbytes + (0 if outs[1] is None else outs[1].nbytes)
                 + sum(data[0][k].nbytes for k in ("acc",) + extra))
        kerns = [lambda d=d: kern(d, want_a) for d in data]
        plains = [lambda d=d: plain(d) for d in data]
        rows.append({
            "form": form, "shape": list(data[0]["acc"].shape),
            "residual": residual, "want_a": want_a, "bit_equal": bool(equal),
            "ms": cuda_ms(lambda: [f() for f in kerns], 5) / sets,
            "graph_ms": cycled_graph_ms(kerns),
            "plain_ms": cuda_ms(lambda: [f() for f in plains], 5) / sets,
            "plain_graph_ms": cycled_graph_ms(plains),
            "bytes": moved, "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
        })
    return rows


def gate_row(qp, B: int, side: int, sets: int = 4, seed: int = 1) -> dict:
    """The SE gate of the first block of the executor's parameters ``qp``
    (``quant._executor_params``, on the card) at ``B`` boards of ``side``,
    on ``sets`` sets of tap sums (random s8 activations through the block's
    conv1 and its plain epilogue): the kernel (``quant._se_gate_block``)
    against the plain chain (``quant._se_gate_from_taps``), ``max_ulps``
    and ``equal_share`` of the gates' bf16 values over every set; ``ms``
    and ``plain_ms`` eager by CUDA events, ``graph_ms`` and
    ``plain_graph_ms`` by ``cycled_graph_ms``; ``launches`` and
    ``plain_launches`` of one call (``torch.profiler``); and ``bound_ms``,
    the bytes the kernel reads and writes at 3.35 TB/s."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from alphazero_tpu_torch.models import quant
    from alphazero_tpu_torch.scripts.profile_s8_dots import cuda_ms

    gen = torch.Generator(device="cuda").manual_seed(seed)
    blk, hw = qp["blocks"][0], side * side
    taps = []
    for _ in range(sets):
        x = torch.randint(0, 128, (B, side, side, blk["wq1"].shape[2]),
                          generator=gen, device="cuda", dtype=torch.int8)
        taps.append(quant._epilogue_conv1_plain(quant._conv_i8(x, blk["wq1"]), blk)[1])
    kerns = [lambda t=t: quant._se_gate_block(t, hw, blk) for t in taps]
    plains = [lambda t=t: quant._se_gate_from_taps(t, hw, blk) for t in taps]
    ulps = torch.cat([(k().view(torch.int16).int() - p().view(torch.int16).int()).abs().ravel()
                      for k, p in zip(kerns, plains)])

    def launches(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(e.count for e in _kernels(prof))

    gw = blk["gate"]
    moved = (taps[0].nbytes + B * gw.O * 2
             + sum(t.nbytes for t in (gw.w, gw.m, gw.bias, gw.w1, gw.b1, gw.w2, gw.b2)))
    return {
        "shape": list(taps[0].shape), "hw": hw, "O": gw.O, "hidden": gw.hidden,
        "max_ulps": int(ulps.max()), "equal_share": float((ulps == 0).float().mean()),
        "ms": cuda_ms(lambda: [f() for f in kerns], 5) / sets,
        "graph_ms": cycled_graph_ms(kerns),
        "plain_ms": cuda_ms(lambda: [f() for f in plains], 5) / sets,
        "plain_graph_ms": cycled_graph_ms(plains),
        "launches": launches(kerns[0]), "plain_launches": launches(plains[0]),
        "bytes": moved, "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
    }


def chunk_stats(forward, cuda_ms, top: int) -> dict:
    """One chunk's time by CUDA events, the host's time to enqueue it, its
    launches and device time (``torch.profiler``) and its top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    chunk_ms = cuda_ms(forward, 20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        forward()
    enqueue_ms = (time.perf_counter() - t0) * 100
    torch.cuda.synchronize()

    reps = 4
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            forward()
        torch.cuda.synchronize()

    kernels = sorted(_kernels(prof), key=_dev_us, reverse=True)
    return {
        "chunk_ms": chunk_ms, "host_enqueue_ms": enqueue_ms,
        "device_ms": sum(_dev_us(e) for e in kernels) / reps / 1e3,
        "launches": sum(e.count for e in kernels) / reps,
        "top_kernels_by_device": [
            {"name": e.key[:100], "device_ms": _dev_us(e) / reps / 1e3,
             "launches": e.count / reps} for e in kernels[:top]],
    }


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))


def _kernels(prof) -> list:
    """The device activities of a ``torch.profiler`` run, by name."""
    return [e for e in prof.key_averages()
            if e.self_cpu_time_total == 0 and _dev_us(e) > 0]


if __name__ == "__main__":
    main()
