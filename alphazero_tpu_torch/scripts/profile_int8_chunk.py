"""Where one chunk of the int8 executor spends its time on the card.

Builds the production executor for the flagship bundle (rollout
calibration, ``production.py``) and times one chunk of 512 positions through
``models/quant.forward_int8_from_q``: its time by CUDA events, the host's
time to enqueue it, its kernel launches and summed device time (from
``torch.profiler``), the top kernels by device time, and each piece of one
block on its own (pad, im2col copy in 4-byte words and byte-wise, the s8
conv, requant, quantise, tap sums, SE gate, heads).  Prints one JSON line.

    python -m alphazero_tpu_torch.scripts.profile_int8_chunk
"""
from __future__ import annotations

import argparse
import json
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="models_zoo/flagship_gomoku15")
    p.add_argument("--top", type=int, default=10)
    args = p.parse_args(argv)

    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

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

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kernels = sorted((e for e in prof.key_averages()
                      if e.self_cpu_time_total == 0 and dev_us(e) > 0),
                     key=dev_us, reverse=True)
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "chunk": chunk,
        "residual": modes[0], "heads": modes[1],
        "chunk_ms": chunk_ms, "host_enqueue_ms": enqueue_ms,
        "device_ms": sum(dev_us(e) for e in kernels) / reps / 1e3,
        "launches": sum(e.count for e in kernels) / reps,
        "piece_ms": piece_ms,
        "top_kernels_by_device": [
            {"name": e.key[:100], "device_ms": dev_us(e) / reps / 1e3,
             "launches": e.count / reps} for e in kernels[:args.top]],
    }))


if __name__ == "__main__":
    main()
