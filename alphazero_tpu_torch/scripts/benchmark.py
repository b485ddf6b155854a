"""Benchmark CLI (counterpart of ``alphazero_tpu/scripts/benchmark.py``):
NN inference throughput, env-step throughput and batched-search
throughput, printed as one JSON line with the JAX script's keys.

    python -m alphazero_tpu_torch.scripts.benchmark [--device cpu]
        [--game gomoku] [--board-size 15] [--batch 1024]
        [--simulations 800] [--blocks 6] [--channels 64]

The net is a freshly initialised ``AZResNet`` run as it is, in eval mode in
its float32 parameters (the JAX script applies the raw flax module); the
search runs ``MCTSConfig``'s defaults (one walker a wave).  Each time is the
mean over the timed calls, with the card synchronised before and after the
loop.
"""
from __future__ import annotations

import argparse
import json
import time


def timeit(fn, *args, warmup=1, iters=3, device=None):
    import torch

    def sync():
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        fn(*args)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    sync()
    return (time.perf_counter() - t0) / iters


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--game", default="gomoku",
                   choices=["gomoku", "go", "chess"])
    p.add_argument("--board-size", type=int, default=15)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--simulations", type=int, default=800)
    p.add_argument("--blocks", type=int, default=6)
    p.add_argument("--channels", type=int, default=64)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    from alphazero_tpu_torch.core import registry
    from alphazero_tpu_torch.mcts.search import MCTSConfig, search
    from alphazero_tpu_torch.models.resnet import AZResNet, ResNetConfig

    dev = torch.device(args.device)
    env = registry.create_game(args.game, args.board_size)
    model = AZResNet(env.num_actions,
                     ResNetConfig(num_blocks=args.blocks, channels=args.channels),
                     obs_shape=env.observation_shape,
                     generator=torch.Generator().manual_seed(0)).to(dev).eval()

    def infer(o):
        with torch.no_grad():
            return model(o)

    results = {}
    B = args.batch

    # NN inference
    obs = torch.zeros((B,) + tuple(env.observation_shape), device=dev)
    dt = timeit(infer, obs, device=dev)
    results["nn_inference"] = {
        "batch": B,
        "latency_ms": round(dt * 1e3, 2),
        "positions_per_s": round(B / dt),
    }

    # Env stepping
    states = env.init(B, device=dev)
    acts = torch.zeros((B,), dtype=torch.int32, device=dev)
    dt = timeit(env.step, states, acts, device=dev)
    results["env_step"] = {
        "batch": B,
        "latency_ms": round(dt * 1e3, 2),
        "steps_per_s": round(B / dt),
    }

    # Batched search
    def eval_fn(o, tp=None):
        return infer(o)

    cfg = MCTSConfig(num_simulations=args.simulations)
    gen = torch.Generator(device=dev).manual_seed(1)
    dt = timeit(lambda s: search(env, eval_fn, s, cfg, gen), states,
                warmup=1, iters=2, device=dev)
    results["search"] = {
        "batch": B,
        "simulations": args.simulations,
        "latency_s": round(dt, 2),
        "sims_per_s": round(B * args.simulations / dt),
        "moves_per_s": round(B / dt, 1),
    }
    print(json.dumps(results))


if __name__ == "__main__":
    main()
