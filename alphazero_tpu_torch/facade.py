"""High-level facade (counterpart of ``alphazero_tpu/facade.py``).

``AlphaZero`` ties the subsystems together as the reference's facade
does: build from a config (or a config file, or a game's defaults), run
self-play, train, evaluate against another net or the uniform stub, pick a
best action, and save the net as a bundle.
"""
from __future__ import annotations

import copy
import json
from typing import Optional

import torch

from alphazero_tpu_torch.models.io import inference_eval_fn


class AlphaZero:
    """One-stop engine on ``device`` (default ``cuda``): wraps the pipeline
    (self-play, training), the arena (evaluation) and a single-position
    search (best action)."""

    def __init__(self, config=None, device="cuda"):
        from alphazero_tpu_torch.training.pipeline import Pipeline, PipelineConfig

        if config is None:
            config = PipelineConfig()
        self.config = config
        self.device = torch.device(device)
        self.pipeline = Pipeline(config, device=device)
        self.env = self.pipeline.env
        self.model = self.pipeline.state.module

    @classmethod
    def from_config_file(cls, path: str, device="cuda") -> "AlphaZero":
        from alphazero_tpu_torch.training.pipeline import PipelineConfig
        from alphazero_tpu_torch.utils.config import from_dict

        with open(path) as f:
            return cls(from_dict(PipelineConfig, json.load(f)), device)

    @classmethod
    def for_game(cls, game: str, board_size: Optional[int] = None,
                 device="cuda") -> "AlphaZero":
        from alphazero_tpu_torch.utils.config import default_pipeline_config

        return cls(default_pipeline_config(game, board_size), device)

    # ---- the reference facade surface -----------------------------------

    def run_self_play(self, num_games: int = 0):
        """Self-play into the replay ring: as many pipeline iterations (of
        ``games_per_iteration`` lanes each) as give at least ``num_games``
        games; ``num_games=0`` runs one.  Returns the last iteration's entry
        with a ``total_games`` tally."""
        per_iter = self.config.games_per_iteration
        iters = max(1, -(-int(num_games) // per_iter)) if num_games else 1
        entry = None
        for i in range(iters):
            entry = self.pipeline.run_iteration(i)
        entry["total_games"] = per_iter * iters
        return entry

    def train_network(self, iterations: Optional[int] = None):
        return self.pipeline.run(iterations)

    def evaluate_model(self, other_params=None, num_games: int = 16,
                       simulations: int = 100):
        """Arena match of the current net against ``other_params`` (a
        ``state_dict`` of the same architecture) or, by default, the uniform
        stub with a small value noise; returns A's wins, losses and draws."""
        from alphazero_tpu_torch.eval.arena import ArenaConfig, play_match_host
        from alphazero_tpu_torch.mcts.search import MCTSConfig
        from alphazero_tpu_torch.models.stub import make_uniform_eval_fn

        eval_a = inference_eval_fn(self.model)
        if other_params is None:
            eval_b = make_uniform_eval_fn(self.env.num_actions, value_noise=0.1)
        else:
            other = copy.deepcopy(self.model)
            other.load_state_dict(other_params)
            eval_b = inference_eval_fn(other)

        cfg = ArenaConfig(
            mcts=MCTSConfig(num_simulations=simulations, dirichlet_epsilon=0.0,
                            wave_size=min(16, simulations)),
            max_moves=self.config.selfplay.max_moves,
            opening_random_moves=4,
        )
        gen = torch.Generator(device=self.device).manual_seed(0)
        res = play_match_host(self.env, eval_a, eval_b, gen, cfg, num_games,
                              device=self.device)
        return {"wins": int(res.wins_a), "losses": int(res.wins_b),
                "draws": int(res.draws)}

    def get_best_action(self, state, simulations: int = 200,
                        generator: Optional[torch.Generator] = None) -> int:
        """The most visited root action of a ``simulations``-deep search
        (no root noise) from ``state``, a batch of one position."""
        from alphazero_tpu_torch.mcts.search import MCTSConfig, search

        cfg = MCTSConfig(num_simulations=simulations, dirichlet_epsilon=0.0)
        out = search(self.env, inference_eval_fn(self.model), state, cfg,
                     generator)
        return int(torch.argmax(out.visit_counts[0]))

    def save(self, path: str):
        from alphazero_tpu_torch.models.io import save_model

        save_model(path, self.model, self.config.model_kind,
                   self.env.num_actions, self.model.cfg)
