"""Game registry + factory (counterpart of ``alphazero_tpu/core/registry.py``).

Gomoku and Go are ported; chess is a registered name that raises until its
slice lands.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

from alphazero_tpu_torch.core.types import GameType

_NOT_PORTED = {"chess": GameType.CHESS}


def _gomoku(**kwargs):
    from alphazero_tpu_torch.games.gomoku import GomokuEnv

    return GomokuEnv(**kwargs)


def _go(**kwargs):
    from alphazero_tpu_torch.games.go import GoEnv

    return GoEnv(**kwargs)


_REGISTRY: Dict[str, Callable[..., Any]] = {"gomoku": _gomoku, "go": _go}
_BY_TYPE: Dict[GameType, str] = {GameType.GOMOKU: "gomoku", GameType.GO: "go",
                                 **{t: n for n, t in _NOT_PORTED.items()}}


def registered_games():
    return sorted(set(_REGISTRY) | set(_NOT_PORTED))


def create_game(name_or_type, board_size: int | None = None, **variant_args):
    """Create an environment by name ("gomoku", "go") or GameType."""
    if isinstance(name_or_type, GameType):
        name = _BY_TYPE.get(name_or_type, "")
    else:
        name = str(name_or_type).lower()
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"game {name!r} is not yet ported to alphazero_tpu_torch"
        )
    if name not in _REGISTRY:
        raise KeyError(f"unknown game {name!r}; known: {registered_games()}")
    kwargs = dict(variant_args)
    if board_size is not None:
        kwargs["board_size"] = board_size
    return _REGISTRY[name](**kwargs)
