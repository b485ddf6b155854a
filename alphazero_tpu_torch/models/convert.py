"""Weight carry-over from a JAX ``AZResNet`` variables tree.

``state_dict_from_flax`` maps ``{"params": ..., "batch_stats": ...}`` (nested
dicts of numpy arrays, as ``flax.serialization.msgpack_restore`` or
``models/io.read_msgpack`` give them) to the port's ``AZResNet.state_dict``:
conv kernels go HWIO -> OIHW, dense kernels [in, out] are transposed.

flax names modules by creation order: the top level holds ``Conv_0`` (stem),
``BatchNorm_0``, ``ResBlock_i``, then ``Conv_1``/``Dense_0`` (policy head)
and ``Conv_2``/``Dense_1``/``Dense_2`` (value head); each block holds
``Conv_0``, ``BatchNorm_0``, ``Conv_1``, ``BatchNorm_1`` and ``SEBlock_0``
with ``Dense_0``/``Dense_1``.

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
    sd[f"{name}.running_mean"] = _t(s["mean"])
    sd[f"{name}.running_var"] = _t(s["var"])
    sd[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)


def state_dict_from_flax(variables: Dict, num_blocks: int) -> Dict[str, torch.Tensor]:
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    batch = "BatchNorm_0" in params
    _conv(sd, "stem", params["Conv_0"])
    if batch:
        _bn(sd, "stem_bn", params["BatchNorm_0"], stats["BatchNorm_0"])
    for i in range(num_blocks):
        blk, bst = params[f"ResBlock_{i}"], stats.get(f"ResBlock_{i}", {})
        pre = f"blocks.{i}"
        _conv(sd, f"{pre}.conv1", blk["Conv_0"])
        _conv(sd, f"{pre}.conv2", blk["Conv_1"])
        if batch:
            _bn(sd, f"{pre}.bn1", blk["BatchNorm_0"], bst["BatchNorm_0"])
            _bn(sd, f"{pre}.bn2", blk["BatchNorm_1"], bst["BatchNorm_1"])
        _dense(sd, f"{pre}.se.fc1", blk["SEBlock_0"]["Dense_0"])
        _dense(sd, f"{pre}.se.fc2", blk["SEBlock_0"]["Dense_1"])
    _conv(sd, "policy_conv", params["Conv_1"])
    _dense(sd, "policy_fc", params["Dense_0"])
    _conv(sd, "value_conv", params["Conv_2"])
    _dense(sd, "value_fc1", params["Dense_1"])
    _dense(sd, "value_fc2", params["Dense_2"])
    return sd


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
