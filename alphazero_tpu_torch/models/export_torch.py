"""TorchScript export (counterpart of ``alphazero_tpu/models/export_torch.py``).

The port's nets are torch modules already, so the export is the
BN-folded ``AZResNet`` (``norm="none"``: convs with bias, SE gates and the
policy/value heads) in float32 on the CPU, traced by ``torch.jit.trace``
into a ``.pt`` that any LibTorch runtime loads without this package: the
forward contract is ``(policy_logits [B, A], value [B])`` from NCHW
float32 observation planes, as in the JAX package's export.
"""
from __future__ import annotations

import contextlib
import copy
from typing import Any, Tuple

import numpy as np
import torch

from alphazero_tpu_torch.models.resnet import (
    AZResNet, fold_batch_norm, make_inference_eval_fn, require_se_block,
)


@contextlib.contextmanager
def full_f32():
    """TF32 off for cuDNN convolutions and matmuls while the block runs."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def build_torch_module(model: AZResNet):
    """The folded float32 CPU copy of ``model`` (a ``norm="batch"`` or
    ``"none"`` ``AZResNet``) in eval mode.  Returns (module, info)."""
    require_se_block(model.cfg, "TorchScript export")
    if model.cfg.norm == "batch":
        folded = fold_batch_norm(model)
    elif model.cfg.norm == "none":
        folded = copy.deepcopy(model)
    else:
        raise ValueError("TorchScript export needs a batch- or none-norm AZResNet")
    module = folded.float().cpu().eval()
    return module, {"num_actions": model.num_actions,
                    "num_blocks": model.cfg.num_blocks,
                    "channels": model.cfg.channels}


def export_torchscript(model: AZResNet, obs_shape: Tuple[int, int, int],
                       out_path: str) -> str:
    """Trace the folded module on a dummy observation and save ``.pt``.

    ``torch.jit.trace`` records cuDNN's TF32 switch as a constant of each
    convolution; it is traced off, so on a CUDA runtime the ``.pt``
    computes its convolutions in full float32, the net the bundle holds
    (the JAX package's export records torch's default, on)."""
    module, _ = build_torch_module(model)
    dummy = torch.zeros((1,) + tuple(obs_shape), dtype=torch.float32)
    with full_f32(), torch.no_grad():
        traced = torch.jit.trace(module, dummy)
    traced.save(out_path)
    return out_path


def verify_export(model: AZResNet, obs: Any, pt_path: str,
                  atol: float = 2e-2) -> dict:
    """Load the ``.pt`` back and compare it with the port's folded eval in
    float32 (``make_inference_eval_fn``, the function the ``.pt`` holds) on
    ``obs``, both on ``model``'s device with TF32 off.  Returns the max abs
    deviations; raises past ``atol``."""
    device = next(model.parameters()).device
    obs = torch.as_tensor(np.asarray(obs, np.float32)).to(device)
    ts = torch.jit.load(pt_path, map_location=device).eval()
    with full_f32(), torch.no_grad():
        ml, mv = make_inference_eval_fn(model, torch.float32)(obs)
        tl, tv = ts(obs)
    dl = float((ml - tl).abs().max())
    dv = float((mv - tv).abs().max())
    if dl > atol or dv > atol:
        raise AssertionError(
            f"TorchScript export diverges: logits {dl:.4f}, value {dv:.4f}")
    return {"max_logit_dev": dl, "max_value_dev": dv}
