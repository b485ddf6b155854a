"""Regression smoke suite (counterpart of
``alphazero_tpu/scripts/regression_test.py``): the same checks, names and
order, one JSON line per check, then ``{"total", "failed"}``; exits 1 if
any check failed.

    python -m alphazero_tpu_torch.scripts.regression_test [--device cpu]
        [--games gomoku,go,chess] [--skip-perf]
"""
from __future__ import annotations

import argparse
import json
import time
import traceback


def check(name, fn, results):
    t0 = time.perf_counter()
    try:
        fn()
        results.append({"check": name, "ok": True,
                        "s": round(time.perf_counter() - t0, 2)})
    except Exception as e:  # noqa: BLE001 — every failure is a result
        results.append({
            "check": name, "ok": False, "error": f"{type(e).__name__}: {e}",
            "trace": traceback.format_exc(limit=3),
        })
    print(json.dumps(results[-1]))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--skip-perf", action="store_true")
    p.add_argument("--games", default="gomoku,go,chess")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)
    games = args.games.split(",")

    import torch

    from alphazero_tpu_torch.core import registry
    from alphazero_tpu_torch.mcts.search import MCTSConfig, search
    from alphazero_tpu_torch.models.resnet import AZResNet, ResNetConfig
    from alphazero_tpu_torch.models.stub import make_uniform_eval_fn
    from alphazero_tpu_torch.selfplay.actor import SelfPlayConfig, play_games

    dev = torch.device(args.device)
    results = []

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def game_checks(name):
        env = registry.create_game(name, None)

        def init_and_step():
            s = env.init(1, device=dev)
            legal = env.legal_mask(s)[0]
            assert int(legal.sum()) > 0
            a = int(torch.nonzero(legal)[0, 0])
            s2 = env.step(s, torch.tensor([a], device=dev))
            assert int(s2.move_count[0]) == 1
            obs = env.observation(s2)
            assert tuple(obs.shape[1:]) == tuple(env.observation_shape)

        check(f"{name}.init_step_obs", init_and_step, results)

        def search_runs():
            eval_fn = make_uniform_eval_fn(env.num_actions)
            cfg = MCTSConfig(num_simulations=16, dirichlet_epsilon=0.0)
            states = env.init(2, device=dev)
            gen = torch.Generator(device=dev).manual_seed(0)
            out = search(env, eval_fn, states, cfg, gen)
            assert int(out.visit_counts.sum()) == 32

        check(f"{name}.search", search_runs, results)

    for g in games:
        game_checks(g)

    def selfplay_completes():
        env = registry.create_game("gomoku", 5)
        eval_fn = make_uniform_eval_fn(env.num_actions, value_noise=0.1)
        cfg = SelfPlayConfig(
            mcts=MCTSConfig(num_simulations=8), max_moves=25,
            temperature_drop_move=4,
        )
        gen = torch.Generator(device=dev).manual_seed(0)
        out = play_games(env, eval_fn, gen, cfg, batch_size=4, device=dev)
        assert bool((out.length > 0).all())

    check("selfplay.completes", selfplay_completes, results)

    def model_forward():
        env = registry.create_game("gomoku", 9)
        model = AZResNet(env.num_actions, ResNetConfig(num_blocks=1, channels=16),
                         obs_shape=env.observation_shape,
                         generator=torch.Generator().manual_seed(0)).to(dev)
        obs = torch.zeros((2,) + tuple(env.observation_shape), device=dev)
        with torch.no_grad():
            logits, value = model(obs)
        assert tuple(logits.shape) == (2, env.num_actions)

    check("model.forward", model_forward, results)

    if not args.skip_perf:
        def perf_floor():
            env = registry.create_game("gomoku", 15)
            eval_fn = make_uniform_eval_fn(env.num_actions)
            cfg = MCTSConfig(num_simulations=50, dirichlet_epsilon=0.0)
            states = env.init(8, device=dev)
            search(env, eval_fn, states, cfg)  # warm-up
            sync()
            t0 = time.perf_counter()
            search(env, eval_fn, states, cfg)
            sync()
            dt = time.perf_counter() - t0
            sims_per_s = 8 * 50 / dt
            assert sims_per_s > 100, f"{sims_per_s:.0f} sims/s"

        check("perf.search_floor", perf_floor, results)

    bad = [r for r in results if not r["ok"]]
    print(json.dumps({"total": len(results), "failed": len(bad)}))
    raise SystemExit(1 if bad else 0)


if __name__ == "__main__":
    main()
