"""Game plugin loading (counterpart of ``alphazero_tpu/core/plugins.py``).

A plugin is any importable module, or an installed package advertising the
``alphazero_tpu_torch.games`` entry point, that exposes
``register(register_game)``: it registers env factories into the same
registry the built-ins use (``core/registry.py``).  The port has its own
entry-point group because a JAX plugin registers JAX envs.
"""
from __future__ import annotations

import importlib
import importlib.metadata
import logging
import os
import sys
from typing import List

from alphazero_tpu_torch.core.registry import register_game

log = logging.getLogger("alphazero_tpu_torch.plugins")

ENTRY_POINT_GROUP = "alphazero_tpu_torch.games"


def load_plugin(module_name: str) -> bool:
    """Import a module and call its ``register(register_game)`` hook."""
    mod = importlib.import_module(module_name)
    hook = getattr(mod, "register", None)
    if hook is None:
        raise AttributeError(
            f"plugin module {module_name!r} has no register() hook")
    hook(register_game)
    log.info("loaded game plugin %s", module_name)
    return True


def load_directory(path: str) -> List[str]:
    """Import every ``*_plugin.py`` in a directory, in name order; returns
    the module names."""
    loaded = []
    if not os.path.isdir(path):
        return loaded
    sys.path.insert(0, path)
    try:
        for fname in sorted(os.listdir(path)):
            if fname.endswith("_plugin.py"):
                name = fname[:-3]
                load_plugin(name)
                loaded.append(name)
    finally:
        sys.path.pop(0)
    return loaded


def load_entry_points() -> List[str]:
    """Discover installed plugin packages through the entry-point group;
    returns the entry points' names."""
    loaded = []
    for ep in importlib.metadata.entry_points(group=ENTRY_POINT_GROUP):
        hook = ep.load()
        hook(register_game)
        loaded.append(ep.name)
        log.info("loaded game plugin entry point %s", ep.name)
    return loaded
