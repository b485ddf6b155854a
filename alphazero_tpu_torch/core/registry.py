"""Game registry + factory (counterpart of ``alphazero_tpu/core/registry.py``):
Gomoku, Go and chess built in, and whatever game plugins register
(``core/plugins.py``)."""
from __future__ import annotations

from typing import Any, Callable, Dict

from alphazero_tpu_torch.core.types import GameType

_REGISTRY: Dict[str, Callable[..., Any]] = {}
_BY_TYPE: Dict[GameType, str] = {}


def register_game(name: str, game_type: GameType, factory: Callable[..., Any]):
    """Register ``factory(**kwargs) -> env`` under ``name``; the first game
    registered for a ``game_type`` is the one ``create_game`` builds for
    that type."""
    if name in _REGISTRY:
        raise ValueError(f"game {name!r} already registered")
    _REGISTRY[name] = factory
    _BY_TYPE.setdefault(game_type, name)


def registered_games():
    return sorted(_REGISTRY)


def game_type_of(name: str) -> GameType:
    """GameType for a registered game name (UNKNOWN for plugins that
    registered without a builtin type)."""
    for gt, n in _BY_TYPE.items():
        if n == str(name).lower():
            return gt
    return GameType.UNKNOWN


def create_game(name_or_type, board_size: int | None = None, **variant_args):
    """Create an environment by name ("gomoku", "go", "chess" or a plugin's)
    or GameType; ``variant_args`` are the env's fields (chess:
    ``chess960_position``, ``history_len``, ``max_moves``)."""
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


# The built-ins import their env module at first use.
def _gomoku(**kwargs):
    from alphazero_tpu_torch.games.gomoku import GomokuEnv

    return GomokuEnv(**kwargs)


def _go(**kwargs):
    from alphazero_tpu_torch.games.go import GoEnv

    return GoEnv(**kwargs)


def _chess(**kwargs):
    from alphazero_tpu_torch.games.chess import ChessEnv

    return ChessEnv(**kwargs)


register_game("gomoku", GameType.GOMOKU, _gomoku)
register_game("go", GameType.GO, _go)
register_game("chess", GameType.CHESS, _chess)
