"""Where one self-play move's time goes on the card.

Plays one warm-up move and one timed move, then profiles one move of the main path
(flagship bundle, B games, 800 simulations, W=16; ``--inference folded``:
the BN-folded bf16 net, ``--inference int8``: the production int8 executor) with
``torch.profiler`` and prints one JSON line: the move's wall time (the
profiler's own host cost included), the summed device time of all kernels,
the device-busy share (device time over wall time), the operators' host
time and call count, the top operators by device and by host time, and the
top kernels by device time (where the hand-written kernels show, which no
operator owns).

    python -m alphazero_tpu_torch.scripts.profile_move --batch 1024 --inference int8
"""
from __future__ import annotations

import argparse
import json
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="models_zoo/flagship_gomoku15")
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--simulations", type=int, default=800)
    p.add_argument("--wave", type=int, default=16)
    p.add_argument("--top", type=int, default=12)
    p.add_argument("--inference", default="folded", choices=["folded", "int8"])
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from alphazero_tpu_torch.core import registry
    from alphazero_tpu_torch.mcts.search import MCTSConfig
    from alphazero_tpu_torch.models.io import load_model
    from alphazero_tpu_torch.models.resnet import make_inference_eval_fn
    from alphazero_tpu_torch.selfplay.actor import SelfPlayConfig, make_host_actor

    if not torch.cuda.is_available():
        raise SystemExit("profile_move needs a CUDA card")
    env = registry.create_game("gomoku", 15)
    model, _ = load_model(args.model, env.observation_shape, device="cuda")
    config = SelfPlayConfig(
        mcts=MCTSConfig(num_simulations=args.simulations, wave_size=args.wave),
        recycle=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.inference == "int8":
        from alphazero_tpu_torch.models.quant import make_production_eval_fn

        eval_fn, _ = make_production_eval_fn(env, model, generator=gen)
    else:
        eval_fn = make_inference_eval_fn(model)
    step, states = make_host_actor(env, eval_fn, config, args.batch,
                                   device="cuda")
    states, _ = step(states, gen)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states, _ = step(states, gen)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        states, _ = step(states, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # Kernel-level entries carry no host time; operator-level entries carry
    # the device time of the kernels they launched.  Sum the former only,
    # or every kernel counts twice.
    kernels = [e for e in events if e.self_cpu_time_total == 0 and dev_us(e) > 0]
    ops = [e for e in events if e.self_cpu_time_total > 0]
    device_us = sum(dev_us(e) for e in kernels)
    host_us = sum(e.self_cpu_time_total for e in ops)

    def rows(es, key):
        return [{"name": e.key[:100], "device_ms": dev_us(e) / 1e3,
                 "host_ms": e.self_cpu_time_total / 1e3, "calls": e.count}
                for e in sorted(es, key=key, reverse=True)[:args.top]]

    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "inference": args.inference,
        "batch": args.batch, "simulations": args.simulations,
        "wave": args.wave, "move_wall_unprofiled_s": plain_wall,
        "move_wall_s": wall,
        "device_s": device_us / 1e6,
        "device_busy_share": device_us / 1e6 / wall,
        "op_host_s": host_us / 1e6,
        "op_calls": sum(e.count for e in ops),
        "kernel_launches": sum(e.count for e in kernels),
        "top_kernels_by_device": rows(kernels, dev_us),
        "top_ops_by_device": rows(ops, dev_us),
        "top_ops_by_host": rows(ops, lambda e: e.self_cpu_time_total),
    }))


if __name__ == "__main__":
    main()
