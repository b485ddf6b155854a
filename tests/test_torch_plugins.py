"""Game plugins (``core/plugins.py``) and the registry they register into
(``core/registry.py``), against the JAX package's."""
import importlib.metadata
import sys

import pytest
import torch

from alphazero_tpu.core import plugins as jplugins
from alphazero_tpu.core import registry as jregistry
from alphazero_tpu.core.types import GameType as JaxGameType
from alphazero_tpu_torch import GameResult, GameType, create_game, register_game
from alphazero_tpu_torch.core import plugins, registry

PLUGIN = '''
def register(register_game):
    from {pkg}.core.types import GameType
    from {pkg}.games.gomoku import GomokuEnv

    def tiny(board_size=5, **kw):
        return GomokuEnv(board_size=board_size, **kw)

    register_game("tiny_gomoku_{tag}", GameType.UNKNOWN, tiny)
'''


@pytest.fixture
def clean_registries():
    """Every plugin test removes what it registered, from both packages'
    registries (one worker runs many test files)."""
    jregistry.game_type_of("gomoku")  # the JAX built-ins load lazily
    saved = [(r, dict(r._REGISTRY), dict(r._BY_TYPE)) for r in (registry, jregistry)]
    mods = set(sys.modules)
    yield
    for r, reg, by_type in saved:
        r._REGISTRY.clear()
        r._REGISTRY.update(reg)
        r._BY_TYPE.clear()
        r._BY_TYPE.update(by_type)
    for m in set(sys.modules) - mods:
        if m.endswith("_plugin"):
            del sys.modules[m]


def _write_plugins(tmp_path, pkg, tag):
    for name in ("b_plugin.py", "a_plugin.py"):
        stem = name[:-3]
        (tmp_path / name).write_text(PLUGIN.format(pkg=pkg, tag=f"{tag}_{stem}"))
    (tmp_path / "not_a_plugin_module.py").write_text("raise RuntimeError\n")


def test_registry_matches_jax(clean_registries):
    assert registry.registered_games() == jregistry.registered_games()
    for name in ("gomoku", "go", "chess", "GO", "nope"):
        assert int(registry.game_type_of(name)) == int(jregistry.game_type_of(name))
    with pytest.raises(ValueError) as terr:
        register_game("go", GameType.GO, lambda **kw: None)
    with pytest.raises(ValueError) as jerr:
        jregistry.register_game("go", JaxGameType.GO, lambda **kw: None)
    assert str(terr.value) == str(jerr.value)
    register_game("x_game", GameType.UNKNOWN, lambda **kw: kw)
    jregistry.register_game("x_game", JaxGameType.UNKNOWN, lambda **kw: kw)
    assert registry.game_type_of("x_game") == GameType.UNKNOWN
    assert jregistry.game_type_of("x_game") == JaxGameType.UNKNOWN
    assert registry.registered_games() == jregistry.registered_games()
    assert create_game("x_game", 7, a=1) == {"a": 1, "board_size": 7}
    assert create_game(GameType.GO, 9).board_size == 9
    assert int(GameResult.WIN_PLAYER2) == 3


def test_load_directory_matches_jax(tmp_path, clean_registries):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    _write_plugins(tmp_path / "jax", "alphazero_tpu", "jax")
    jnames = jplugins.load_directory(str(tmp_path / "jax"))
    for m in [m for m in sys.modules if m.endswith("_plugin")]:
        del sys.modules[m]  # the port's files have the same module names
    _write_plugins(tmp_path / "port", "alphazero_tpu_torch", "port")
    names = plugins.load_directory(str(tmp_path / "port"))
    assert names == jnames == ["a_plugin", "b_plugin"]
    assert "tiny_gomoku_port_a_plugin" in registry.registered_games()
    assert registry.game_type_of("tiny_gomoku_port_b_plugin") == GameType.UNKNOWN
    assert plugins.load_directory(str(tmp_path / "missing")) == []


def test_missing_hook_raises(tmp_path, clean_registries, monkeypatch):
    (tmp_path / "hookless_plugin.py").write_text("X = 1\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    with pytest.raises(AttributeError) as terr:
        plugins.load_plugin("hookless_plugin")
    with pytest.raises(AttributeError) as jerr:
        jplugins.load_plugin("hookless_plugin")
    assert str(terr.value) == str(jerr.value)


def test_entry_points(monkeypatch, clean_registries):
    calls = []

    class EntryPoint:
        name = "fake_games"

        @staticmethod
        def load():
            def hook(register):
                calls.append(register)
                register("ep_game", GameType.UNKNOWN, lambda **kw: "env")
            return hook

    def entry_points(group=None):
        assert group == "alphazero_tpu_torch.games"
        return [EntryPoint]

    monkeypatch.setattr(importlib.metadata, "entry_points", entry_points)
    assert plugins.load_entry_points() == ["fake_games"]
    assert calls == [registry.register_game]
    assert create_game("ep_game") == "env"


def test_plugin_game_searches_on_cpu(tmp_path, clean_registries):
    from alphazero_tpu_torch.mcts.search import MCTSConfig, search
    from alphazero_tpu_torch.models.stub import make_uniform_eval_fn

    _write_plugins(tmp_path, "alphazero_tpu_torch", "search")
    plugins.load_directory(str(tmp_path))
    env = create_game("tiny_gomoku_search_a_plugin", 6)
    assert env.num_actions == 36
    out = search(env, make_uniform_eval_fn(36, value_noise=0.1),
                 env.init(3, device="cpu"),
                 MCTSConfig(num_simulations=16, wave_size=4),
                 torch.Generator().manual_seed(0))
    assert out.visit_counts.sum(-1).tolist() == [16, 16, 16]
