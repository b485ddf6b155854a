"""Weight carry-over between JAX variables trees and the port's modules.

``state_dict_from_flax`` maps ``{"params": ..., "batch_stats": ...}`` (nested
dicts of numpy arrays, as ``flax.serialization.msgpack_restore`` or
``models/io.read_msgpack`` give them) to the port's ``AZResNet.state_dict``:
conv kernels go HWIO -> OIHW, dense kernels [in, out] are transposed.

flax names modules by creation order: the top level holds ``Conv_0`` (stem),
``BatchNorm_0``, ``ResBlock_i``, then ``Conv_1``/``Dense_0`` (policy head)
and ``Conv_2``/``Dense_1``/``Dense_2`` (value head); each block holds
``Conv_0``, ``BatchNorm_0``, ``Conv_1``, ``BatchNorm_1`` and ``SEBlock_0``
with ``Dense_0``/``Dense_1``.  A ``norm="group"`` net has ``GroupNorm_i``
where a batch-norm net has ``BatchNorm_i``, and no ``batch_stats``.
``flax_from_state_dict`` maps the other way, to numpy arrays in flax's tree.
``randwire_state_dict_from_flax`` and ``flax_from_randwire_state_dict`` do
the same for ``DDWRandWireResNet``.

``folded_from_jax`` and ``quant_params_from_jax`` carry the flat ``fp`` and
``qp`` dicts of the JAX ``models/quant.py`` across as they are (NHWC/HWIO
layouts, [in, out] dense kernels, int8 weights, f32 scales): the port's
``models/quant.py`` keeps those layouts, so both packages can run on
identical quantised parameters.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _conv(sd, name, p):
    sd[f"{name}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def _dense(sd, name, p):
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{name}.bias"] = _t(p["bias"])


def _bn(sd, name, p, s):
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])
    if s is not None:
        sd[f"{name}.running_mean"] = _t(s["mean"])
        sd[f"{name}.running_var"] = _t(s["var"])
        sd[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)


def _norm_name(params) -> str | None:
    for name in ("BatchNorm", "GroupNorm"):
        if f"{name}_0" in params:
            return name
    return None


def state_dict_from_flax(variables: Dict, num_blocks: int) -> Dict[str, torch.Tensor]:
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    norm = _norm_name(params)

    def norm_pair(dst, src_p, src_s, i):
        if norm is not None:
            key = f"{norm}_{i}"
            _bn(sd, dst, src_p[key], src_s[key] if norm == "BatchNorm" else None)

    _conv(sd, "stem", params["Conv_0"])
    norm_pair("stem_bn", params, stats, 0)
    for i in range(num_blocks):
        blk, bst = params[f"ResBlock_{i}"], stats.get(f"ResBlock_{i}", {})
        pre = f"blocks.{i}"
        _conv(sd, f"{pre}.conv1", blk["Conv_0"])
        _conv(sd, f"{pre}.conv2", blk["Conv_1"])
        norm_pair(f"{pre}.bn1", blk, bst, 0)
        norm_pair(f"{pre}.bn2", blk, bst, 1)
        _dense(sd, f"{pre}.se.fc1", blk["SEBlock_0"]["Dense_0"])
        _dense(sd, f"{pre}.se.fc2", blk["SEBlock_0"]["Dense_1"])
    _heads_from_flax(sd, params)
    return sd


def _arr(sd, key) -> np.ndarray:
    return sd[key].detach().float().cpu().numpy().copy()


def _flax_conv(sd, name) -> Dict:
    """A conv's flax params (HWIO kernel, bias where it has one)."""
    out = {"kernel": _arr(sd, f"{name}.weight").transpose(2, 3, 1, 0)}
    if f"{name}.bias" in sd:
        out["bias"] = _arr(sd, f"{name}.bias")
    return out


def _flax_dense(sd, name) -> Dict:
    """A dense layer's flax params ([in, out] kernel, bias)."""
    return {"kernel": _arr(sd, f"{name}.weight").T.copy(),
            "bias": _arr(sd, f"{name}.bias")}


def flax_from_state_dict(sd: Dict[str, torch.Tensor], num_blocks: int,
                         norm: str = "batch") -> Dict[str, Dict]:
    """The port's ``AZResNet.state_dict`` as flax variables: numpy float32
    ``{"params": ..., "batch_stats": ...}`` (no ``batch_stats`` unless
    ``norm="batch"``), the tree JAX's ``model.init`` gives."""
    if any(".conv_p." in k for k in sd):
        raise ValueError("convert: block 'nbt' (KataGo's nested bottleneck) "
                         "has no JAX counterpart and no flax layout")

    def a(key):
        return _arr(sd, key)

    def conv(name):
        return _flax_conv(sd, name)

    def dense(name):
        return _flax_dense(sd, name)

    tag = {"batch": "BatchNorm", "group": "GroupNorm"}.get(norm)
    params: Dict = {}
    stats: Dict = {}

    def put_norm(p_dst, s_dst, name, i):
        if tag is None:
            return
        p_dst[f"{tag}_{i}"] = {"scale": a(f"{name}.weight"), "bias": a(f"{name}.bias")}
        if tag == "BatchNorm":
            s_dst[f"{tag}_{i}"] = {"mean": a(f"{name}.running_mean"),
                                   "var": a(f"{name}.running_var")}

    params["Conv_0"] = conv("stem")
    put_norm(params, stats, "stem_bn", 0)
    for i in range(num_blocks):
        pre = f"blocks.{i}"
        blk: Dict = {"Conv_0": conv(f"{pre}.conv1"), "Conv_1": conv(f"{pre}.conv2"),
                     "SEBlock_0": {"Dense_0": dense(f"{pre}.se.fc1"),
                                   "Dense_1": dense(f"{pre}.se.fc2")}}
        bst: Dict = {}
        put_norm(blk, bst, f"{pre}.bn1", 0)
        put_norm(blk, bst, f"{pre}.bn2", 1)
        params[f"ResBlock_{i}"] = blk
        if bst:
            stats[f"ResBlock_{i}"] = bst
    params["Conv_1"] = conv("policy_conv")
    params["Dense_0"] = dense("policy_fc")
    params["Conv_2"] = conv("value_conv")
    params["Dense_1"] = dense("value_fc1")
    params["Dense_2"] = dense("value_fc2")
    out = {"params": params}
    if tag == "BatchNorm":
        out["batch_stats"] = stats
    return out


def _heads_from_flax(sd, params):
    _conv(sd, "policy_conv", params["Conv_1"])
    _dense(sd, "policy_fc", params["Dense_0"])
    _conv(sd, "value_conv", params["Conv_2"])
    _dense(sd, "value_fc1", params["Dense_1"])
    _dense(sd, "value_fc2", params["Dense_2"])


def randwire_state_dict_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """A JAX ``DDWRandWireResNet`` variables tree as the port's
    ``DDWRandWireResNet.state_dict``.  flax names the stem ``Conv_0`` and
    ``GroupNorm_0``, each block ``block_{b}`` with ``router_{i}/Conv_0``
    (only for a node with several predecessors) and ``node_{i}`` holding
    ``Conv_0``, ``GroupNorm_0``, ``Conv_1``, ``GroupNorm_1`` and
    ``SEBlock_0``; the heads are ``Conv_1``/``Dense_0`` and
    ``Conv_2``/``Dense_1``/``Dense_2``, as in the ResNet."""
    params = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "stem", params["Conv_0"])
    _bn(sd, "stem_gn", params["GroupNorm_0"], None)
    b = 0
    while f"block_{b}" in params:
        blk, pre = params[f"block_{b}"], f"blocks.{b}"
        i = 0
        while f"node_{i}" in blk:
            if f"router_{i}" in blk:
                _conv(sd, f"{pre}.routers.{i}", blk[f"router_{i}"]["Conv_0"])
            node, npre = blk[f"node_{i}"], f"{pre}.nodes.{i}"
            _conv(sd, f"{npre}.conv1", node["Conv_0"])
            _bn(sd, f"{npre}.gn1", node["GroupNorm_0"], None)
            _conv(sd, f"{npre}.conv2", node["Conv_1"])
            _bn(sd, f"{npre}.gn2", node["GroupNorm_1"], None)
            _dense(sd, f"{npre}.se.fc1", node["SEBlock_0"]["Dense_0"])
            _dense(sd, f"{npre}.se.fc2", node["SEBlock_0"]["Dense_1"])
            i += 1
        b += 1
    _heads_from_flax(sd, params)
    return sd


def flax_from_randwire_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, Dict]:
    """The port's ``DDWRandWireResNet.state_dict`` as flax variables
    (numpy float32 ``{"params": ...}``), the tree JAX's ``model.init``
    gives."""
    def conv(name):
        return _flax_conv(sd, name)

    def dense(name):
        return _flax_dense(sd, name)

    def norm(name):
        return {"scale": _arr(sd, f"{name}.weight"), "bias": _arr(sd, f"{name}.bias")}

    params: Dict = {"Conv_0": conv("stem"), "GroupNorm_0": norm("stem_gn")}
    b = 0
    while f"blocks.{b}.nodes.0.conv1.weight" in sd:
        pre, blk = f"blocks.{b}", {}
        i = 0
        while f"{pre}.nodes.{i}.conv1.weight" in sd:
            if f"{pre}.routers.{i}.weight" in sd:
                blk[f"router_{i}"] = {"Conv_0": conv(f"{pre}.routers.{i}")}
            npre = f"{pre}.nodes.{i}"
            blk[f"node_{i}"] = {
                "Conv_0": conv(f"{npre}.conv1"), "GroupNorm_0": norm(f"{npre}.gn1"),
                "Conv_1": conv(f"{npre}.conv2"), "GroupNorm_1": norm(f"{npre}.gn2"),
                "SEBlock_0": {"Dense_0": dense(f"{npre}.se.fc1"),
                              "Dense_1": dense(f"{npre}.se.fc2")}}
            i += 1
        params[f"block_{b}"] = blk
        b += 1
    params.update(Conv_1=conv("policy_conv"), Dense_0=dense("policy_fc"),
                  Conv_2=conv("value_conv"), Dense_1=dense("value_fc1"),
                  Dense_2=dense("value_fc2"))
    return {"params": params}


def _tree_to_torch(x: Any, device) -> Any:
    if isinstance(x, dict):
        return {k: _tree_to_torch(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree_to_torch(v, device) for v in x]
    if isinstance(x, (int, str)):
        return x
    arr = np.array(x, copy=True)
    if arr.ndim == 0 and arr.dtype == np.int64:  # a count, e.g. num_blocks
        return int(arr)
    if arr.dtype not in (np.int8, np.int32, np.float32):
        raise TypeError(f"unexpected dtype {arr.dtype} in quantised parameters")
    return torch.from_numpy(arr).to(device)


def folded_from_jax(fp_numpy: Dict, device="cuda") -> Dict:
    """The folded-parameter dict ``fp`` of JAX ``extract_folded`` (leaves as
    numpy arrays) as the port's ``fp``."""
    return _tree_to_torch(fp_numpy, device)


def quant_params_from_jax(qp_numpy: Dict, device="cuda") -> Dict:
    """The quantised-parameter dict ``qp`` of JAX ``quantize`` /
    ``build_quantized_params`` (leaves as numpy arrays) as the port's
    ``qp``."""
    return _tree_to_torch(qp_numpy, device)
