"""Where one search wave's Go env work goes on the card.

Plays ``--roots`` random games on the card (seeded; lane b plays ``b %
(plies + 1)`` uniform legal moves, passes rare), repeats each root
``--wave`` times as the leaves of one wave, and runs what the search runs
on them: the leaves read back from arena rows (so ``step`` finds no kept
statistics), one legal move each through ``step``, then ``legal_mask``
and ``observation`` of the children.  Prints one JSON line a board size: each part's
milliseconds (host clock around a synchronised call, mean of ``--reps``),
the host syncs of one wave (CUDA's sync debug mode), and, from
``torch.profiler`` over one wave, the device time, the kernel launches,
and the top kernels and operators by device and by host time.

    python -m alphazero_tpu_torch.scripts.profile_go_env --sizes 9 19
"""
from __future__ import annotations

import argparse
import json
import time
import warnings


def random_playouts(env, B: int, max_plies: int, gen, device="cuda"):
    """Seeded random Go playouts on ``device`` (``gen``'s): lane b plays ``b
    % (max_plies + 1)`` moves drawn uniformly from its legal points, a pass
    taking about one draw in 32 (and every draw where no point is legal);
    games that end stop there."""
    import torch

    from alphazero_tpu_torch.core.types import where_lanes

    plies = torch.arange(B, device=device) % (max_plies + 1)
    st = env.init(B, device=device)
    for ply in range(max_plies):
        legal = env.legal_mask(st)
        points = legal[:, :-1].float()
        pas = legal[:, -1:].float() * (points.sum(1, keepdim=True) / 31).clamp(min=1)
        w = torch.cat([points, pas], 1)
        w = torch.where(w.sum(1, keepdim=True) > 0, w, torch.ones_like(w))
        acts = torch.multinomial(w, 1, generator=gen)[:, 0]
        st = where_lanes(plies > ply, env.step(st, acts), st)
    return st


def _wave(env, roots, wave: int, gen):
    """``one_wave(timed=False)``: what the search does to a wave's leaves,
    ``wave`` of them a root, read back from arena rows (so ``step`` finds
    no kept statistics), one legal move each; with ``timed`` the parts'
    milliseconds are appended to ``one_wave.parts``."""
    import torch

    leaves = roots.map(lambda x: x.repeat_interleave(wave, 0))
    w = env.legal_mask(leaves).float()
    w = torch.where(w.sum(1, keepdim=True) > 0, w, torch.ones_like(w))
    acts = torch.multinomial(w, 1, generator=gen)[:, 0]
    rows = env.arena_rows(leaves)

    def one_wave(timed: bool = False):
        leaf = env.from_arena_rows(*rows)
        marks = [time.perf_counter()]
        child = env.step(leaf, acts)
        if timed:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        env.legal_mask(child)
        if timed:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        env.observation(child)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if timed:
            for k, a, b in zip(("step", "legal_mask", "observation"), marks, marks[1:]):
                one_wave.parts.setdefault(k, []).append((b - a) * 1e3)
        return marks[-1] - marks[0]

    one_wave.parts = {}
    one_wave.leaves = leaves.batch_size
    return one_wave


def env_wave(env, roots, wave: int = 16, reps: int = 5, gen=None) -> dict:
    """One wave's env work on the card from ``roots``: each part's ms (host
    clock around a synchronised call, mean of ``reps`` after 3 warm-ups)
    and the host syncs of one wave (CUDA's sync debug mode)."""
    import torch

    one_wave = _wave(env, roots, wave,
                     gen or torch.Generator(device="cuda").manual_seed(5))
    for _ in range(3):
        one_wave()
    for _ in range(reps):
        one_wave(timed=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            one_wave()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ms = {k: sum(v) / len(v) for k, v in one_wave.parts.items()}
    return {"leaves": one_wave.leaves, "ms": ms, "ms_per_wave": sum(ms.values()),
            "syncs_per_wave": sum("synchroniz" in str(c.message) for c in caught)}


def profile_wave(env, starts, wave: int, reps: int, top: int, gen) -> dict:
    """``env_wave`` from ``starts``, then one wave under ``torch.profiler``:
    its device time, kernel launches, and the top kernels and operators by
    device and by host time (any env with arena rows)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    res = env_wave(env, starts, wave, reps, gen)
    one_wave = _wave(env, starts, wave, gen)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = one_wave()
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kernels = [e for e in events if e.self_cpu_time_total == 0 and dev_us(e) > 0]
    ops = [e for e in events if e.self_cpu_time_total > 0]

    def rows_of(es, key):
        return [{"name": e.key[:90], "device_ms": dev_us(e) / 1e3,
                 "host_ms": e.self_cpu_time_total / 1e3, "calls": e.count}
                for e in sorted(es, key=key, reverse=True)[:top]]

    return {
        "card": torch.cuda.get_device_name(0), **res, "profiled_wave_s": wall,
        "device_ms": sum(dev_us(e) for e in kernels) / 1e3,
        "kernel_launches": sum(e.count for e in kernels),
        "op_calls": sum(e.count for e in ops),
        "top_kernels_by_device": rows_of(kernels, dev_us),
        "top_ops_by_device": rows_of(ops, dev_us),
        "top_ops_by_host": rows_of(ops, lambda e: e.self_cpu_time_total),
    }


def profile_size(n: int, roots: int, wave: int, plies: int, reps: int,
                 top: int) -> dict:
    import torch

    from alphazero_tpu_torch.games.go import GoEnv

    env = GoEnv(board_size=n)
    gen = torch.Generator(device="cuda").manual_seed(n)
    starts = random_playouts(env, roots, plies, gen)
    return {"board": n, "roots_plies": f"0-{plies}",
            **profile_wave(env, starts, wave, reps, top, gen)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--sizes", type=int, nargs="+", default=[9, 19])
    p.add_argument("--roots", type=int, default=1024)
    p.add_argument("--wave", type=int, default=16)
    p.add_argument("--plies", type=int, default=120)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--top", type=int, default=12)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_go_env needs a CUDA card")
    for n in args.sizes:
        plies = args.plies if n <= 9 else 2 * args.plies
        print(json.dumps(profile_size(n, args.roots, args.wave, plies, args.reps,
                                      args.top)), flush=True)


if __name__ == "__main__":
    main()
