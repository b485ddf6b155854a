"""AlphaZero loss (counterpart of ``alphazero_tpu/training/loss.py``):
soft-target cross-entropy on the policy plus squared error on the value, in
float32.  L2 regularisation is the optimizer's weight decay
(``training/learner.py``)."""
from __future__ import annotations

from typing import NamedTuple

import torch


class LossOutput(NamedTuple):
    total: torch.Tensor
    policy_loss: torch.Tensor
    value_loss: torch.Tensor


def alphazero_loss(policy_logits: torch.Tensor,  # [B, A]
                   value_pred: torch.Tensor,  # [B]
                   policy_target: torch.Tensor,  # [B, A], rows sum to 1
                   value_target: torch.Tensor,  # [B] in [-1, 1]
                   policy_weight: float = 1.0,
                   value_weight: float = 1.0) -> LossOutput:
    logp = torch.log_softmax(policy_logits.float(), dim=-1)
    # Cross-entropy against the soft target: KL up to the target's (constant)
    # entropy, with the same gradient.
    policy_loss = -(policy_target * logp).sum(-1).mean()
    value_loss = (value_pred.float() - value_target).square().mean()
    total = policy_weight * policy_loss + value_weight * value_loss
    return LossOutput(total, policy_loss, value_loss)
