"""Uniform-policy stub evaluator (counterpart of ``alphazero_tpu/models/stub.py``):
zero logits (uniform over legal moves after the search's masked softmax) and
an optional small deterministic value derived from the observation."""
from __future__ import annotations

import torch


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def uniform_eval_fn(obs: torch.Tensor, to_play=None):
    """(obs [B, C, H, W]) -> zero logits over H*W actions and zero values;
    for another action count use ``make_uniform_eval_fn``."""
    B = obs.shape[0]
    A = obs.shape[-1] * obs.shape[-2]
    return (torch.zeros((B, A), dtype=torch.float32, device=obs.device),
            torch.zeros((B,), dtype=torch.float32, device=obs.device))


def make_uniform_eval_fn(num_actions: int, value_noise: float = 0.0):
    """With ``value_noise > 0`` the value is ``value_noise * sin(12.9898 *
    sum(0.12345 * obs))`` rounded as XLA computes the JAX stub on a bf16
    observation inside the JAX search: constants rounded to bf16, the
    products summed unrounded in f32, the sum, the angle and the sine
    rounded to bf16, and the last product kept in f32 (its consumer is
    f32).  The sine's value is so sensitive to the angle that any other
    rounding gives another value, and another search."""
    noise = float(torch.tensor(value_noise, dtype=torch.bfloat16))
    scale = float(torch.tensor(0.12345, dtype=torch.bfloat16))
    freq = float(torch.tensor(12.9898, dtype=torch.bfloat16))

    def eval_fn(obs, to_play=None):
        B = obs.shape[0]
        logits = torch.zeros((B, num_actions), dtype=torch.float32,
                             device=obs.device)
        if value_noise > 0.0:
            h = _bf16((obs.reshape(B, -1).float() * scale).sum(-1))
            value = _bf16(torch.sin(_bf16(h * freq))) * noise
        else:
            value = torch.zeros((B,), dtype=torch.float32, device=obs.device)
        return logits, value

    return eval_fn
