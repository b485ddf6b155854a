"""Config system (counterpart of ``alphazero_tpu/utils/config.py``): the
nested dataclass tree of ``PipelineConfig`` to and from JSON, and per-game
defaults.

A torch dtype is written as its name ("torch.bfloat16") and read back as
that dtype.  The JAX package writes its dtypes as "<class 'jax...'>"
strings; reading one keeps the field's default, as the JAX reader does, so
the shipped ``config/*.json`` files load.  A dataclass with a
``json_fields()`` method is written with those fields alone.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Type

import torch


def to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        names = (cfg.json_fields() if hasattr(cfg, "json_fields")
                 else [f.name for f in dataclasses.fields(cfg)])
        return {name: to_dict(getattr(cfg, name)) for name in names}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    if isinstance(cfg, (type, torch.dtype)):
        return str(cfg)
    return cfg


def _default(f: dataclasses.Field) -> Any:
    if f.default is not dataclasses.MISSING:
        return f.default
    if f.default_factory is not dataclasses.MISSING:
        return f.default_factory()
    return None


def from_dict(cls: Type, d: Dict) -> Any:
    """Rebuild a (possibly nested) frozen dataclass from a dict; keys that
    are not fields of ``cls`` are ignored."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        default = _default(f)
        if isinstance(v, str) and v.startswith("<class"):
            continue  # a JAX dtype: keep the field default
        if isinstance(default, torch.dtype) and isinstance(v, str):
            kwargs[f.name] = getattr(torch, v.removeprefix("torch."))
        elif dataclasses.is_dataclass(default) and isinstance(v, dict):
            kwargs[f.name] = from_dict(type(default), v)
        elif isinstance(default, tuple) and isinstance(v, list):
            kwargs[f.name] = tuple(tuple(x) if isinstance(x, list) else x
                                   for x in v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def save_config(cfg: Any, path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_dict(cfg), f, indent=2)


def load_config(cls: Type, path: str) -> Any:
    with open(path) as f:
        return from_dict(cls, json.load(f))


def default_pipeline_config(game: str, board_size: int | None = None):
    """Working per-game defaults, the JAX package's values."""
    from alphazero_tpu_torch.mcts.search import MCTSConfig
    from alphazero_tpu_torch.models.resnet import ResNetConfig
    from alphazero_tpu_torch.selfplay.actor import SelfPlayConfig
    from alphazero_tpu_torch.training.learner import LearnerConfig
    from alphazero_tpu_torch.training.pipeline import PipelineConfig

    if game == "gomoku":
        n = board_size or 15
        return PipelineConfig(
            game="gomoku", board_size=n,
            model=ResNetConfig(num_blocks=6, channels=64),
            selfplay=SelfPlayConfig(
                mcts=MCTSConfig(num_simulations=800, dirichlet_alpha=0.15),
                max_moves=n * n + 1, temperature_drop_move=30),
            learner=LearnerConfig())
    if game == "go":
        n = board_size or 9
        return PipelineConfig(
            game="go", board_size=n,
            model=ResNetConfig(num_blocks=8, channels=96),
            selfplay=SelfPlayConfig(
                mcts=MCTSConfig(num_simulations=800, dirichlet_alpha=0.1),
                max_moves=2 * n * n, temperature_drop_move=20),
            learner=LearnerConfig())
    if game == "chess":
        return PipelineConfig(
            game="chess", board_size=8,
            model=ResNetConfig(num_blocks=10, channels=128),
            selfplay=SelfPlayConfig(
                mcts=MCTSConfig(num_simulations=800, dirichlet_alpha=0.3),
                max_moves=512, temperature_drop_move=30),
            learner=LearnerConfig())
    raise ValueError(f"unknown game {game!r}")
