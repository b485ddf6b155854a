"""Seeded weights for the SE-ResNet, made on the device in one draw.

Every float parameter and BatchNorm statistic of the net comes from one
standard-normal draw of a ``torch.Generator`` on the device:

* conv and dense kernels: normal with variance 1 / fan_in (LeCun);
* biases and BatchNorm shifts and running means: normal, std 0.1;
* BatchNorm scales: 1 + normal with std 0.1;
* BatchNorm running variances: exp of a normal with std 0.2.

Unlike a fresh training init, the policy and value outputs are not zero:
logits and values spread as a trained net's do, so the search has real
priors and values to work with and lower precisions show.
"""
from __future__ import annotations

import torch


def _kind(name: str) -> str:
    last = name.rsplit(".", 1)[-1]
    if last == "running_var":
        return "var"
    if last in ("running_mean", "bias"):
        return "shift"
    if "bn" in name and last == "weight":
        return "scale"
    return "kernel"


def make(shapes: dict, seed: int, device) -> dict:
    """``{name: float32 tensor}`` for ``shapes`` (``{name: shape}``), on
    ``device``, from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [torch.Size(s).numel() for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        x = flat[at:at + n].view(shape)
        at += n
        kind = _kind(name)
        if kind == "kernel":
            fan_in = torch.Size(shape[1:]).numel()
            x = x / fan_in ** 0.5
        elif kind == "shift":
            x = 0.1 * x
        elif kind == "scale":
            x = 1.0 + 0.1 * x
        else:
            x = torch.exp(0.2 * x)
        out[name] = x.contiguous()
    return out


def net_shapes(module: torch.nn.Module) -> dict:
    """The float parameters and buffers of ``module`` and their shapes."""
    return {k: tuple(v.shape) for k, v in module.state_dict().items()
            if v.is_floating_point()}
