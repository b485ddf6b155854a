"""Self-play generation CLI (counterpart of
``alphazero_tpu/scripts/self_play.py``, the same flags plus ``--device``
and ``--spans``).

Generates games with a model bundle or the uniform stub and writes
GameRecord JSONs; prints one JSON stats line.  ``--inference folded`` (the
default) runs the BN-folded bf16 net; ``--inference int8`` runs the
production executor of ``production.py`` (rollout calibration on the folded
net, then the int8 trunk of ``models/quant.py``).  ``--spans PATH``
records the run's spans and counters (``utils/telemetry.py``) and writes
them to ``PATH`` as a Chrome trace, on the time base of ``torch.profiler``'s
traces.

    python -m alphazero_tpu_torch.scripts.self_play \\
        --model models_zoo/flagship_gomoku15 --num-games 64
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--game", default="gomoku",
                   choices=["gomoku", "go", "chess"])
    p.add_argument("--board-size", type=int, default=15)
    p.add_argument("--num-games", type=int, default=64)
    p.add_argument("--simulations", type=int, default=800)
    p.add_argument("--max-moves", type=int, default=None)
    p.add_argument("--model", default=None,
                   help="model bundle path (models/io.py); default: uniform")
    p.add_argument("--output-dir", default="data/games")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--temperature-drop", type=int, default=30)
    p.add_argument("--wave", type=int, default=16,
                   help="virtual-loss descents per wave sharing one NN batch "
                   "(MCTSConfig.wave_size; 1 = the sequential search)")
    p.add_argument("--inference", default="folded", choices=["folded", "int8"],
                   help="executor for --model: BN-folded bf16, or the "
                   "production int8 trunk (production.py)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--spans", default=None, metavar="PATH",
                   help="record the run's spans and counters and write them "
                   "to PATH as a Chrome trace")
    args = p.parse_args(argv)

    import torch

    from alphazero_tpu_torch.core import registry
    from alphazero_tpu_torch.mcts.search import MCTSConfig
    from alphazero_tpu_torch.models.stub import make_uniform_eval_fn
    from alphazero_tpu_torch.scripts.evaluate import default_max_moves
    from alphazero_tpu_torch.selfplay import game_record
    from alphazero_tpu_torch.selfplay.actor import (
        SelfPlayConfig, make_host_actor, stack_records,
    )
    from alphazero_tpu_torch.utils import telemetry

    device = torch.device(args.device)
    env = registry.create_game(args.game, args.board_size)
    if args.model:
        from alphazero_tpu_torch.models.io import load_model
        from alphazero_tpu_torch.models.resnet import make_inference_eval_fn

        model, _ = load_model(args.model, env.observation_shape, device=device)
        if args.inference == "int8":
            from alphazero_tpu_torch.models.quant import make_production_eval_fn

            calib_gen = torch.Generator(device=device).manual_seed(args.seed + 7)
            eval_fn, _ = make_production_eval_fn(env, model, device=device,
                                                 generator=calib_gen)
        else:
            eval_fn = make_inference_eval_fn(model)  # BN-folded, cfg.dtype
    else:
        eval_fn = make_uniform_eval_fn(env.num_actions, value_noise=0.1)

    max_moves = args.max_moves or default_max_moves(args.game, env.board_size)
    config = SelfPlayConfig(
        mcts=MCTSConfig(num_simulations=args.simulations,
                        wave_size=max(1, min(args.wave, args.simulations))),
        max_moves=max_moves,
        temperature_drop_move=args.temperature_drop,
    )

    step, states = make_host_actor(env, eval_fn, config, args.num_games,
                                   device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    recs = []
    think_ms = []  # per-move host wall ms (a sync every 16 moves lumps there)
    t_prev = t0
    with (telemetry.recording() if args.spans
          else contextlib.nullcontext()) as spans:
        for t in range(config.max_moves):
            states, rec = step(states, gen)
            recs.append(rec)
            if (t + 1) % 16 == 0 and bool(env.terminal_flag(states).all()):
                think_ms.append((time.perf_counter() - t_prev) * 1000)
                break
            now = time.perf_counter()
            think_ms.append((now - t_prev) * 1000)
            t_prev = now
    out = stack_records(env, states, recs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0
    if args.spans:
        telemetry.export_chrome(spans, args.spans)

    records = game_record.records_from_selfplay(env, out, think_ms=think_ms)
    os.makedirs(args.output_dir, exist_ok=True)
    for i, rec in enumerate(records):
        rec.save(os.path.join(args.output_dir, f"game_{args.seed}_{i}.json"))

    moves = int(out.length.sum())
    stats = {
        "games": len(records),
        "moves": moves,
        "elapsed_s": round(elapsed, 1),
        "games_per_min": round(len(records) / elapsed * 60, 1),
        "moves_per_s": round(moves / elapsed, 1),
    }
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
