"""Hyperparameter search CLI (counterpart of
``alphazero_tpu/scripts/hyperopt.py``).  Uses Optuna when it is installed,
otherwise a built-in random search whose draws are the JAX script's (the
same ``SPACE`` and ``random.Random(seed)`` calls, so the same trials).
Each trial runs a short training pipeline (a 2x32 net, ``history.json``
under ``checkpoints/``) and scores it by its final loss; the results, best
first, go to ``--output``.

    python -m alphazero_tpu_torch.scripts.hyperopt [--device cpu]
        [--trials 8] [--iterations 4] [--games 32] [--simulations 64]
"""
from __future__ import annotations

import argparse
import json
import math
import random

SPACE = {
    "learning_rate": ("log", 1e-4, 1e-2),
    "weight_decay": ("log", 1e-5, 1e-3),
    "c_puct": ("uniform", 0.8, 3.0),
    "dirichlet_alpha": ("log", 0.05, 0.6),
}


def sample_params(rng: random.Random):
    out = {}
    for name, (kind, lo, hi) in SPACE.items():
        if kind == "log":
            out[name] = math.exp(rng.uniform(math.log(lo), math.log(hi)))
        else:
            out[name] = rng.uniform(lo, hi)
    return out


def run_trial(args, params) -> float:
    from alphazero_tpu_torch.mcts.search import MCTSConfig
    from alphazero_tpu_torch.models.resnet import ResNetConfig
    from alphazero_tpu_torch.selfplay.actor import SelfPlayConfig
    from alphazero_tpu_torch.training.learner import LearnerConfig
    from alphazero_tpu_torch.training.pipeline import Pipeline, PipelineConfig

    config = PipelineConfig(
        game=args.game,
        board_size=args.board_size,
        model=ResNetConfig(num_blocks=2, channels=32),
        selfplay=SelfPlayConfig(
            mcts=MCTSConfig(
                num_simulations=args.simulations,
                c_puct=params["c_puct"],
                dirichlet_alpha=params["dirichlet_alpha"],
            ),
            max_moves=args.board_size ** 2 + 1,
        ),
        learner=LearnerConfig(
            learning_rate=params["learning_rate"],
            weight_decay=params["weight_decay"],
            scheduler="constant",
            total_steps=args.iterations * 16,
        ),
        iterations=args.iterations,
        games_per_iteration=args.games,
        train_steps_per_iteration=16,
        train_batch_size=256,
        min_replay_before_training=256,
        checkpoint_every=10 ** 9,
        seed=args.seed,
    )
    history = Pipeline(config, device=args.device).run()
    losses = [h["loss"] for h in history if "loss" in h]
    return losses[-1] if losses else float("inf")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--game", default="gomoku")
    p.add_argument("--board-size", type=int, default=9)
    p.add_argument("--trials", type=int, default=8)
    p.add_argument("--iterations", type=int, default=4)
    p.add_argument("--games", type=int, default=32)
    p.add_argument("--simulations", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", default="hyperopt_results.json")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)

    try:
        import optuna  # noqa: F401

        use_optuna = True
    except ImportError:
        use_optuna = False

    results = []
    if use_optuna:
        import optuna

        def objective(trial):
            params = {
                "learning_rate": trial.suggest_float(
                    "learning_rate", 1e-4, 1e-2, log=True),
                "weight_decay": trial.suggest_float(
                    "weight_decay", 1e-5, 1e-3, log=True),
                "c_puct": trial.suggest_float("c_puct", 0.8, 3.0),
                "dirichlet_alpha": trial.suggest_float(
                    "dirichlet_alpha", 0.05, 0.6, log=True),
            }
            score = run_trial(args, params)
            results.append({"params": params, "score": score})
            return score

        study = optuna.create_study(direction="minimize")
        study.optimize(objective, n_trials=args.trials)
    else:
        rng = random.Random(args.seed)
        for _ in range(args.trials):
            params = sample_params(rng)
            score = run_trial(args, params)
            results.append({"params": params, "score": score})
            print(json.dumps(results[-1]))

    results.sort(key=lambda r: r["score"])
    with open(args.output, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps({"best": results[0]}))


if __name__ == "__main__":
    main()
