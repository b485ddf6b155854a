"""Game registry + factory (counterpart of ``alphazero_tpu/core/registry.py``):
Gomoku, Go and chess."""
from __future__ import annotations

from typing import Any, Callable, Dict

from alphazero_tpu_torch.core.types import GameType


def _gomoku(**kwargs):
    from alphazero_tpu_torch.games.gomoku import GomokuEnv

    return GomokuEnv(**kwargs)


def _go(**kwargs):
    from alphazero_tpu_torch.games.go import GoEnv

    return GoEnv(**kwargs)


def _chess(**kwargs):
    from alphazero_tpu_torch.games.chess import ChessEnv

    return ChessEnv(**kwargs)


_REGISTRY: Dict[str, Callable[..., Any]] = {"gomoku": _gomoku, "go": _go,
                                            "chess": _chess}
_BY_TYPE: Dict[GameType, str] = {GameType.GOMOKU: "gomoku", GameType.GO: "go",
                                 GameType.CHESS: "chess"}


def registered_games():
    return sorted(_REGISTRY)


def create_game(name_or_type, board_size: int | None = None, **variant_args):
    """Create an environment by name ("gomoku", "go", "chess") or GameType;
    ``variant_args`` are the env's fields (chess: ``chess960_position``,
    ``history_len``, ``max_moves``)."""
    if isinstance(name_or_type, GameType):
        name = _BY_TYPE.get(name_or_type, "")
    else:
        name = str(name_or_type).lower()
    if name not in _REGISTRY:
        raise KeyError(f"unknown game {name!r}; known: {registered_games()}")
    kwargs = dict(variant_args)
    if board_size is not None:
        kwargs["board_size"] = board_size
    return _REGISTRY[name](**kwargs)
