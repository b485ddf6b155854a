"""The port's native GameRecord encoder (``native/azrecord.cpp``) writes
the bytes of ``json.dumps(record.to_json())``, and so the bytes of the JAX
package's Python path; the JAX package's own native encoder does not
round-trip float32 policies."""
import json
import struct
import sys

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from alphazero_tpu.selfplay import game_record as jrecord
from alphazero_tpu_torch import native
from alphazero_tpu_torch.core.types import GameResult, GameType
from alphazero_tpu_torch.selfplay.game_record import GameRecord

EDGES = [0.0, -0.0, 1.0, 1e-05, 1e16, 5e-324, 0.1, 1 / 3, 1e15, 0.0001,
         -2.5e-07, 1.7976931348623157e308, 123456789012345678.0, 2.0 ** -1074,
         float("nan"), float("inf"), float("-inf")]


@pytest.fixture(scope="module")
def encoder():
    mod = native.get_azrecord()
    assert mod is not None, "g++ could not build the encoder"
    return mod


def _record(policies, values, actions=None, timestamp="2026-01-01T00:00:00",
            result=GameResult.WIN_PLAYER2, game_type=GameType.GOMOKU):
    rec = GameRecord(game_type, 15, use_variant_rules=True, timestamp=timestamp)
    for t, (pol, val) in enumerate(zip(policies, values)):
        rec.add_move(actions[t] if actions else t, pol, val, thinking_time_ms=7 * t)
    rec.set_result(result)
    return rec


def _same(rec):
    data = rec.to_json_bytes()
    assert native.get_azrecord() is not None
    assert data == json.dumps(rec.to_json()).encode()
    return data


@settings(max_examples=60, deadline=None)
@given(st.lists(st.lists(st.floats(allow_nan=True, allow_infinity=True),
                         max_size=12), max_size=6),
       st.text(max_size=12))
def test_native_bytes_equal_json_doubles(encoder, policies, timestamp):
    """Any doubles, ragged policies, any timestamp text."""
    values = [p[0] if p else 0.5 for p in policies]
    _same(_record(policies, values, timestamp=timestamp or "t"))


@settings(max_examples=60, deadline=None)
@given(st.lists(st.lists(st.floats(width=32), min_size=1, max_size=16),
                min_size=1, max_size=6))
def test_native_bytes_equal_json_float32(encoder, policies):
    """float32 values widened to double, as the actor's policies are."""
    _same(_record(policies, [p[-1] for p in policies]))


def test_native_edge_cases_and_bit_patterns(encoder):
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2 ** 63, 20000, dtype=np.int64).tolist()
    random_doubles = [struct.unpack("<d", struct.pack("<q", b))[0] for b in bits]
    data = _same(_record([EDGES, random_doubles], [-0.0, 1e-05]))
    head = json.loads(data.replace(b"NaN", b"0").replace(b"-Infinity", b"0")
                      .replace(b"Infinity", b"0"))
    assert head["moves"][0]["value"] == 0.0 and head["result"] == 3


def test_timestamp_escapes_as_json(encoder):
    _same(_record([[0.5]], [0.25], timestamp='q"\\ \n\t\x01\x7f é 漢 \U0001F600'))


def test_empty_record(encoder):
    rec = GameRecord(GameType.GO, 9, timestamp="2026-01-01T00:00:00")
    assert _same(rec) == (b'{"game_type": 3, "board_size": 9, "use_variant_rules": '
                          b'false, "moves": [], "result": 0, "timestamp": '
                          b'"2026-01-01T00:00:00"}')


def test_native_bytes_equal_jax_python_path(encoder):
    """The same record through the port's native encoder and the JAX
    package's ``json`` path (``GameRecord.to_json``)."""
    rng = np.random.default_rng(1)
    pols = [rng.dirichlet(np.ones(225)).astype(np.float32) for _ in range(30)]
    vals = [float(np.float32(v)) for v in rng.uniform(-1, 1, 30)]
    acts = [int(a) for a in rng.integers(0, 225, 30)]
    ours = _record(pols, vals, acts)
    theirs = jrecord.GameRecord(jrecord.GameType.GOMOKU, 15, use_variant_rules=True,
                                timestamp="2026-01-01T00:00:00")
    for t, (p, v) in enumerate(zip(pols, vals)):
        theirs.add_move(acts[t], p, v, thinking_time_ms=7 * t)
    theirs.set_result(jrecord.GameResult.WIN_PLAYER2)
    assert _same(ours) == json.dumps(theirs.to_json()).encode()
    back = GameRecord.from_json(json.loads(ours.to_json_bytes()))
    assert [m.policy for m in back.moves] == [m.policy for m in ours.moves]


def test_jax_native_encoder_does_not_round_trip_float32(tmp_path, monkeypatch):
    """The JAX package's encoder writes each float with ``%.7g``
    (``alphazero_tpu/native/azrecord.cpp``): float32 policies come back
    changed, and its bytes differ from its own Python path's.  The port
    does not copy this.  The JAX extension is built here from its source
    into a temporary directory."""
    import alphazero_tpu.native as jnative

    monkeypatch.setattr(jnative, "_DIR", str(tmp_path))
    monkeypatch.setattr(jnative, "_SO", str(tmp_path / "_azrecord_jax.so"))
    monkeypatch.setattr(jnative, "_azrecord", None)
    monkeypatch.setattr(jnative, "_build_attempted", False)
    assert jnative._build()
    import importlib.machinery
    import importlib.util

    # Loaded under a name of its own, and dropped from ``sys.modules``
    # after: the JAX package imports its own build as ``_azrecord``.
    name = "jax_fault._azrecord"
    loader = importlib.machinery.ExtensionFileLoader(name, jnative._SO)
    mod = importlib.util.module_from_spec(
        importlib.util.spec_from_file_location(name, jnative._SO, loader=loader))
    loader.exec_module(mod)
    sys.modules.pop(name, None)
    monkeypatch.setattr(jnative, "get_azrecord", lambda: mod)
    rng = np.random.default_rng(2)
    pols = [rng.dirichlet(np.ones(225)).astype(np.float32) for _ in range(20)]
    rec = jrecord.GameRecord(jrecord.GameType.GOMOKU, 15, timestamp="t")
    for t, p in enumerate(pols):
        rec.add_move(t, p, 0.5)
    data = rec.to_json_bytes()
    assert data != json.dumps(rec.to_json()).encode()
    back = json.loads(data)
    got = np.array([m["policy"] for m in back["moves"]], np.float32)
    changed = float((got != np.stack(pols)).mean())
    assert changed > 0.1, changed
    ours = _record(pols, [0.5] * 20)
    mine = np.array([m["policy"] for m in json.loads(ours.to_json_bytes())["moves"]],
                    np.float32)
    assert np.array_equal(mine, np.stack(pols))
    want = np.stack(pols).astype(np.float64)
    rel = float((np.abs(got - want) / want).max())
    assert 0 < rel < 1e-6, rel  # 7 significant digits
