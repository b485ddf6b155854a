"""The flagship recipe: Gomoku 15x15, the 6-block 64-channel SE-ResNet,
800-simulation self-play (counterpart of ``tools/train_flagship.py``).

Trains for a bounded budget, keeps the weights every ``FLAG_EVAL_EVERY``
iterations and plays each kept net against the iteration-0 net and its
predecessor (``play_match``: one batched search, colours swapped between
the halves, fixed simulations), rated with sequential Elo
(``elo/tracker.py``).  The arena evaluates each kept net as JAX's tool
does, the raw BatchNorm net through ``model.apply`` (``make_raw_eval_fn``:
bf16 convs and dense layers from the float32 weights, BatchNorm's running
statistics and affine in float32), not the BN-folded bf16 net the actors
run.  Writes the record (pipeline history, the arena
series, the Elo table) to ``--output``, the final weights as a bundle and
the loss and Elo plots beside it.

    python -m alphazero_tpu_torch.tools.train_flagship [--device cuda]

Env knobs: FLAG_ITERS (16), FLAG_GAMES (256), FLAG_SIMS (800),
FLAG_EVAL_EVERY (4), FLAG_EVAL_GAMES (128), FLAG_EVAL_SIMS (100);
FLAG_MODEL_OUT (default ``flagship_gomoku15`` beside ``--output``).
"""
from __future__ import annotations

import argparse
import copy
import os
import time

from alphazero_tpu_torch.tools import _common


def knobs() -> dict:
    env = os.environ.get
    return {"iters": int(env("FLAG_ITERS", "16")), "games": int(env("FLAG_GAMES", "256")),
            "sims": int(env("FLAG_SIMS", "800")),
            "eval_every": int(env("FLAG_EVAL_EVERY", "4")),
            "eval_games": int(env("FLAG_EVAL_GAMES", "128")),
            "eval_sims": int(env("FLAG_EVAL_SIMS", "100"))}


def recipe(k: dict, checkpoint_dir: str):
    from alphazero_tpu_torch.mcts.search import MCTSConfig
    from alphazero_tpu_torch.models.resnet import ResNetConfig
    from alphazero_tpu_torch.selfplay.actor import SelfPlayConfig
    from alphazero_tpu_torch.training.learner import LearnerConfig
    from alphazero_tpu_torch.training.pipeline import PipelineConfig

    return PipelineConfig(
        game="gomoku", board_size=15,
        model=ResNetConfig(),  # the flagship: 6 blocks, 64 channels, BN
        selfplay=SelfPlayConfig(
            mcts=MCTSConfig(num_simulations=k["sims"], wave_size=16),
            max_moves=225, temperature_drop_move=30,
        ),
        learner=LearnerConfig(total_steps=max(k["iters"] * 64, 256)),
        iterations=k["iters"],
        games_per_iteration=k["games"],
        train_steps_per_iteration=64,
        train_batch_size=1024,
        replay_capacity=200_000,
        min_replay_before_training=4_096,
        checkpoint_dir=checkpoint_dir,
        checkpoint_every=10**9,  # the kept nets stay in memory
    )


def arena_config(k: dict):
    from alphazero_tpu_torch.eval.arena import ArenaConfig
    from alphazero_tpu_torch.mcts.search import MCTSConfig

    return ArenaConfig(mcts=MCTSConfig(num_simulations=k["eval_sims"],
                                       dirichlet_epsilon=0.0), max_moves=225)


class Run:
    """The recipe's state between iterations: the pipeline, the kept nets
    (copies of the learner's module by iteration), the Elo table and the
    arena series.  ``train(start, stop)`` runs iterations ``start`` to
    ``stop - 1``, each followed by its arena where one is due."""

    def __init__(self, k: dict, cfg, device):
        from alphazero_tpu_torch.elo.tracker import EloTracker
        from alphazero_tpu_torch.training.pipeline import Pipeline

        self.k, self.device = k, device
        self.pipe = Pipeline(cfg, device=device)
        self.arena_cfg = arena_config(k)
        self.nets = {0: self.keep()}
        self.elo = EloTracker()
        self.elo.add_player("iter_0")
        self.series = []

    def keep(self):
        return copy.deepcopy(self.pipe.state.module)

    def rate(self, it: int) -> None:
        from alphazero_tpu_torch.eval.arena import play_match
        from alphazero_tpu_torch.models.resnet import make_raw_eval_fn

        k, step = self.k, it + 1
        if step % k["eval_every"] and step != k["iters"]:
            return
        self.nets[step] = self.keep()
        name = f"iter_{step}"
        self.elo.add_player(name)
        opponents = ["iter_0"]
        prev = sorted(s for s in self.nets if 0 < s < step)
        if prev:
            opponents.append(f"iter_{prev[-1]}")
        for opp in dict.fromkeys(opponents):
            opp_step = int(opp.split("_")[1])
            res = play_match(self.pipe.env, make_raw_eval_fn(self.nets[step]),
                             make_raw_eval_fn(self.nets[opp_step]),
                             _common.generator(self.device, 9000 + step * 100 + opp_step),
                             self.arena_cfg, k["eval_games"], device=self.device)
            wa, wb, dr = int(res.wins_a), int(res.wins_b), int(res.draws)
            self.elo.add_series(name, opp, wa, wb, dr)
            rec = {"player": name, "opponent": opp, "wins": wa, "losses": wb,
                   "draws": dr, "rating": round(self.elo.get_rating(name), 1),
                   "opp_rating": round(self.elo.get_rating(opp), 1)}
            self.series.append(rec)
            print(f"  arena {name} vs {opp}: +{wa} -{wb} ={dr} "
                  f"({rec['rating']} vs {rec['opp_rating']})", flush=True)

    def train(self, start: int, stop: int) -> None:
        _common.train_iterations(self.pipe, stop, self.rate, start=start)

    def finish(self, out: str, bundle: str, wall_s: float) -> dict:
        """Writes the record to ``out``, the final weights as a bundle and
        the plots beside ``out``; returns the record."""
        from alphazero_tpu_torch.models.io import save_model
        from alphazero_tpu_torch.utils.visualization import (
            plot_elo_history, plot_training_history,
        )

        k, pipe = self.k, self.pipe
        payload = {
            "config": {
                "iterations": k["iters"], "games_per_iteration": k["games"],
                "simulations": k["sims"], "eval_games": k["eval_games"],
                "eval_sims": k["eval_sims"], "wall_s": round(wall_s, 1),
            },
            "history": pipe.history,
            "arena_series": self.series,
            "elo": {p: round(self.elo.get_rating(p), 1) for p, _ in self.elo.leaderboard()},
        }
        _common.write_json(out, payload)
        save_model(bundle, pipe.state.module, "resnet", pipe.env.num_actions,
                   pipe.config.model)
        print(f"wrote {out}, {bundle} (+.json)", flush=True)
        stem = os.path.splitext(out)[0]
        try:
            p1 = plot_training_history(pipe.history, _common.check_output(stem + "_loss.png"))
            p2 = plot_elo_history(self.elo, _common.check_output(stem + "_elo.png"))
            print(f"wrote {p1} and {p2}", flush=True)
        except ImportError as e:  # no matplotlib: the plots are optional, as in JAX
            print(f"plotting skipped: {e}", flush=True)
        return payload


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    _common.add_args(p, "train_flagship_gomoku15.json")
    args = p.parse_args(argv)
    k = knobs()
    out = _common.check_output(args.output)
    bundle = _common.check_output(os.environ.get(
        "FLAG_MODEL_OUT", _common.beside(out, "flagship_gomoku15")))

    import torch

    run = Run(k, recipe(k, _common.beside(out, "flagship_ckpt")), torch.device(args.device))
    t0 = time.time()
    run.train(0, k["iters"])
    return run.finish(out, bundle, time.time() - t0)


if __name__ == "__main__":
    main()
