"""Fixed anchor players: a stable rating scale (counterpart of
``alphazero_tpu/eval/anchors.py``).

Rating every candidate against the same parameter-free pool, and fitting
Bradley-Terry over the joint match table with a pool member pinned
(``elo/bradley_terry.py``), makes ratings comparable across runs of the
same game.

Pool, weak to strong:
  * ``uniform_mcts_N``: the uniform stub (``models/stub.py``, value noise
    0.1) under an N-simulation search;
  * ``attack_defense_64`` (Gomoku only): the attack/defense threat bonuses
    (``ops/attack_defense.py``) on the uniform policy, 64 simulations.
"""
from __future__ import annotations

from typing import Tuple

from alphazero_tpu_torch.mcts.search import MCTSConfig
from alphazero_tpu_torch.models.stub import make_uniform_eval_fn

# Weak to strong; uniform_mcts_256 is the canonical Bradley-Terry anchor,
# pinned at 1500 where it plays.
POOL = ("uniform_mcts_16", "uniform_mcts_64", "attack_defense_64",
        "uniform_mcts_256")
CANONICAL = "uniform_mcts_256"
CANONICAL_RATING = 1500.0


def make_anchor(env, name: str) -> Tuple:
    """(eval_fn, MCTSConfig) of a pool member.  The search config is part
    of the anchor: it plays at its own simulation count whatever the
    candidate's (``eval/arena.play_match_sides``)."""
    if name.startswith("uniform_mcts_"):
        sims = int(name.rsplit("_", 1)[1])
        eval_fn = make_uniform_eval_fn(env.num_actions, value_noise=0.1)
    elif name == "attack_defense_64":
        if "gomoku" not in type(env).__name__.lower():
            raise ValueError("attack_defense anchor is gomoku-only")
        from alphazero_tpu_torch.ops.attack_defense import policy_bias_eval_fn

        sims = 64
        eval_fn = policy_bias_eval_fn(
            make_uniform_eval_fn(env.num_actions, value_noise=0.1),
            board_size=env.board_size, scale=1.0)
    else:
        raise ValueError(f"unknown anchor {name!r} (pool: {POOL})")
    cfg = MCTSConfig(num_simulations=sims, dirichlet_epsilon=0.0,
                     wave_size=min(16, sims))
    return eval_fn, cfg
