"""Model bundles (counterpart of ``alphazero_tpu/models/io.py``).

A bundle is ``path`` (flax msgpack of the variables tree) plus
``path + ".json"`` (``{"kind", "num_actions", "config"}``), for the kinds
``"resnet"`` (``AZResNet``) and ``"randwire"`` (``DDWRandWireResNet``).
The port reads and writes the msgpack itself: ``read_msgpack`` and
``write_msgpack`` cover the subset flax writes (maps, strings, binaries,
numbers, arrays, and ext type 1, an ndarray as a msgpack ``(shape,
dtype-name, bytes)`` triple, or 3, a numpy scalar as the same triple), and
``write_msgpack`` encodes each value as flax's ``msgpack`` does (the
smallest form of each integer, string, binary, map and array header, floats
as float64, maps in their insertion order), so a bundle read and written
again keeps its bytes.  ``save_model`` writes the variables with every
map's keys sorted, the order of a trained JAX state (``jax.tree_util``
sorts dict keys), which the ``models_zoo/`` bundles have.  No ``msgpack``
or ``flax`` package is needed.

A ``"resnet"`` bundle of ``block="nbt"`` (KataGo's nested-bottleneck
trunk, which has no JAX counterpart: ``convert.py`` refuses it) holds
``{"params": {state-dict name: float32 array}}`` under the port's own
names, and its JSON the nbt keys; only the port reads it.  Every other
bundle's JSON leaves those keys out, as JAX's does.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

from alphazero_tpu_torch.models.convert import (
    flax_from_randwire_state_dict, flax_from_state_dict,
    randwire_state_dict_from_flax, state_dict_from_flax,
)
from alphazero_tpu_torch.models.randwire import DDWRandWireResNet, RandWireConfig
from alphazero_tpu_torch.models.resnet import (
    AZResNet, ResNetConfig, make_eval_fn, make_inference_eval_fn,
)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def value(self) -> Any:
        b = self.uint(1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return bytes(self.take(b & 0x1F)).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self.take(self.uint(1 << (b - 0xC4))))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.uint(1 << (b - 0xC7))
            return self.ext(self.uint(1), n)
        if b == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= b <= 0xCF:  # uint 8..64
            return self.uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:  # int 8..64
            n = 1 << (b - 0xD0)
            return int.from_bytes(self.take(n), "big", signed=True)
        if 0xD4 <= b <= 0xD8:  # fixext 1..16
            n = 1 << (b - 0xD4)
            return self.ext(self.uint(1), n)
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return bytes(self.take(self.uint(1 << (b - 0xD9)))).decode()
        if b in (0xDC, 0xDD):  # array 16/32
            return [self.value() for _ in range(self.uint(2 if b == 0xDC else 4))]
        if b in (0xDE, 0xDF):  # map 16/32
            return self.map(self.uint(2 if b == 0xDE else 4))
        raise ValueError(f"unsupported msgpack byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, code: int, n: int):
        payload = bytes(self.take(n))
        if code not in (1, 3):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, buf = _Reader(payload).value()
        if isinstance(dtype, bytes):
            dtype = dtype.decode()
        if dtype == "bfloat16":
            raw = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
            arr = raw.view(np.float32)
        else:
            arr = np.frombuffer(buf, np.dtype(dtype))
        arr = arr.reshape(shape)
        return arr[()] if code == 3 else arr


def read_msgpack(data: bytes) -> Any:
    """Decode flax msgpack bytes into nested dicts of numpy arrays."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(data):
        raise ValueError("trailing bytes after msgpack object")
    return out


def _header(small: int | None, small_bits: int, wide: Tuple[int, ...],
            n: int) -> bytes:
    """A msgpack length header: the fix form below ``1 << small_bits``,
    else the first of the 1/2/4-byte (or 2/4-byte) forms that holds ``n``
    (``wide`` are their marker bytes, smallest first)."""
    if small is not None and n < (1 << small_bits):
        return bytes([small | n])
    sizes = (1, 2, 4) if len(wide) == 3 else (2, 4)
    for marker, size in zip(wide, sizes):
        if n < (1 << (8 * size)):
            return bytes([marker]) + n.to_bytes(size, "big")
    raise ValueError(f"msgpack length {n} too large")


def _pack_int(n: int) -> bytes:
    if 0 <= n < 0x80 or -32 <= n < 0:
        return (n & 0xFF).to_bytes(1, "big")
    if n > 0:
        for marker, size in ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)):
            if n < (1 << (8 * size)):
                return bytes([marker]) + n.to_bytes(size, "big")
    else:
        for marker, size in ((0xD0, 1), (0xD1, 2), (0xD2, 4), (0xD3, 8)):
            if n >= -(1 << (8 * size - 1)):
                return bytes([marker]) + n.to_bytes(size, "big", signed=True)
    raise ValueError(f"integer {n} out of msgpack range")


def _pack_ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = bytes([fixed[n]]) if n in fixed else _header(None, 0, (0xC7, 0xC8, 0xC9), n)
    return head + bytes([code]) + payload


def _pack(x: Any) -> bytes:
    if x is None:
        return b"\xc0"
    if isinstance(x, bool):
        return b"\xc3" if x else b"\xc2"
    if isinstance(x, int):
        return _pack_int(x)
    if isinstance(x, float):
        return b"\xcb" + struct.pack(">d", x)
    if isinstance(x, str):
        data = x.encode()
        return _header(0xA0, 5, (0xD9, 0xDA, 0xDB), len(data)) + data
    if isinstance(x, (bytes, bytearray)):
        return _header(None, 0, (0xC4, 0xC5, 0xC6), len(x)) + bytes(x)
    if isinstance(x, (list, tuple)):
        return (_header(0x90, 4, (0xDC, 0xDD), len(x))
                + b"".join(_pack(v) for v in x))
    if isinstance(x, dict):
        return (_header(0x80, 4, (0xDE, 0xDF), len(x))
                + b"".join(_pack(k) + _pack(v) for k, v in x.items()))
    if isinstance(x, (np.ndarray, np.generic)):
        arr = np.asarray(x)
        triple = _pack([list(arr.shape), arr.dtype.name, arr.tobytes("C")])
        return _pack_ext(1 if isinstance(x, np.ndarray) else 3, triple)
    raise TypeError(f"cannot msgpack {type(x).__name__}")


def write_msgpack(tree: Any) -> bytes:
    """Encode nested dicts of numpy arrays as flax msgpack bytes (the
    inverse of ``read_msgpack``)."""
    return _pack(tree)


def _model_config_dict(kind: str, num_actions: int, cfg) -> Dict:
    if isinstance(cfg, ResNetConfig):
        d = {k: getattr(cfg, k) for k in cfg.json_fields()}
    else:
        d = dataclasses.asdict(cfg)
    d.pop("dtype", None)
    return {"kind": kind, "num_actions": num_actions, "config": d}


def build_model(kind: str, num_actions: int, config: Dict,
                obs_shape=(11, 15, 15), generator: torch.Generator | None = None):
    """``(module, cfg)`` of model ``kind`` ("resnet" or "randwire") with
    config fields ``config``, freshly initialised from ``generator``."""
    if kind == "resnet":
        cfg = ResNetConfig(**config)
        return AZResNet(num_actions, cfg, obs_shape, generator), cfg
    if kind == "randwire":
        cfg = RandWireConfig(**config)
        return DDWRandWireResNet(num_actions, cfg, obs_shape, generator), cfg
    raise ValueError(f"unknown model kind {kind!r}")


def inference_eval_fn(model):
    """A built model's evaluator for search: BN-folded in bf16 for a
    ``AZResNet`` (``make_inference_eval_fn``), the module as it is for
    ``DDWRandWireResNet`` (no BatchNorm to fold; it computes in
    ``cfg.dtype``)."""
    if isinstance(model, AZResNet):
        return make_inference_eval_fn(model)
    return make_eval_fn(model.eval())


def _array(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def model_variables(model) -> Dict:
    """``model``'s weights as the flax variables tree (numpy float32), its
    keys sorted as in a trained JAX state."""
    if isinstance(model, DDWRandWireResNet):
        return _sorted(flax_from_randwire_state_dict(model.state_dict()))
    if model.cfg.block == "nbt":
        return _sorted({"params": {k: _array(v) for k, v in model.state_dict().items()
                                   if v.is_floating_point()}})
    return _sorted(flax_from_state_dict(model.state_dict(),
                                        model.cfg.num_blocks, model.cfg.norm))


def save_model(path: str, model, kind: str, num_actions: int, cfg) -> None:
    """Write ``path`` (flax msgpack of ``model``'s variables) and
    ``path + ".json"`` (its kind, action count and config): the bundle
    JAX's ``load_model`` reads."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(write_msgpack(model_variables(model)))
    with open(path + ".json", "w") as f:
        json.dump(_model_config_dict(kind, num_actions, cfg), f, indent=2)


def load_model(path: str, obs_shape, device="cuda"):
    """(model in eval mode on ``device``, bundle meta) from a saved bundle."""
    with open(path + ".json") as f:
        meta = json.load(f)
    model, _ = build_model(meta["kind"], meta["num_actions"], meta["config"],
                           obs_shape)
    with open(path, "rb") as f:
        variables = read_msgpack(f.read())
    if meta["kind"] == "randwire":
        sd = randwire_state_dict_from_flax(variables)
    elif model.cfg.block == "nbt":
        sd = {k: torch.from_numpy(np.array(v, dtype=np.float32))
              for k, v in variables["params"].items()}
        sd.update((k, v) for k, v in model.state_dict().items()
                  if k.endswith("num_batches_tracked"))
    else:
        sd = state_dict_from_flax(variables, model.cfg.num_blocks)
    model.load_state_dict(sd)
    return model.to(device).eval(), meta
