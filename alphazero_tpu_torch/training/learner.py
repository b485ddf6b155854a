"""Learner: optimizer, train state and train step (counterpart of
``alphazero_tpu/training/learner.py``).

The optimizer is optax's chain written out: ``clip_by_global_norm`` with
optax's formula (``g * max / norm`` where ``norm >= max``; torch's
``clip_grad_norm_`` scales by ``max / (norm + 1e-6)``), then AdamW (b1 0.9,
b2 0.999, eps 1e-8) with decoupled weight decay on every parameter, biases
and norm scales included, or, for ``optimizer="sgd"``, weight decay added
to the gradient and momentum SGD.  The learning rate of update ``k`` is
``schedule(k)``, counted from 0 as optax counts.  ``train_step`` runs the
model in train mode, so BatchNorm's running statistics update.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Tuple

import torch

from alphazero_tpu_torch.training import schedulers
from alphazero_tpu_torch.training.loss import alphazero_loss


@dataclasses.dataclass(frozen=True)
class LearnerConfig:
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    scheduler: str = "warmup_cosine"
    warmup_steps: int = 500
    total_steps: int = 100_000
    grad_clip_norm: float = 5.0
    policy_weight: float = 1.0
    value_weight: float = 1.0
    optimizer: str = "adamw"  # "adamw" | "sgd"
    momentum: float = 0.9


@dataclasses.dataclass
class TrainState:
    """``module`` (an ``AZResNet`` or a ``DDWRandWireResNet``) holds the
    float32 master weights and the BN running statistics; ``step`` counts
    the updates applied."""

    module: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


class TrainMetrics(NamedTuple):
    loss: torch.Tensor
    policy_loss: torch.Tensor
    value_loss: torch.Tensor
    grad_norm: torch.Tensor  # of the gradients before clipping


def make_optimizer(config: LearnerConfig, params) -> torch.optim.Optimizer:
    """The optimizer over ``params``; ``train_step`` sets its learning rate
    from the schedule before every update."""
    params = list(params)
    if config.optimizer == "sgd":
        return torch.optim.SGD(params, lr=0.0, momentum=config.momentum,
                               weight_decay=config.weight_decay)
    if config.optimizer != "adamw":
        raise ValueError(f"unknown optimizer {config.optimizer!r}")
    return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=config.weight_decay)


def create_train_state(model: torch.nn.Module, config: LearnerConfig) -> TrainState:
    return TrainState(module=model,
                      optimizer=make_optimizer(config, model.parameters()))


def learning_rate(config: LearnerConfig, step: int) -> float:
    return schedulers.make(config.scheduler, config.learning_rate,
                           config.total_steps, config.warmup_steps)(step)


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: torch.Tensor | None = None) -> None:
    """optax.clip_by_global_norm in place: where the global norm reaches
    ``max_norm`` every gradient becomes ``g / norm * max_norm``; below it
    the gradients are left as they are.  No host synchronisation."""
    if norm is None:
        norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def train_step(state: TrainState, batch, config: LearnerConfig
               ) -> Tuple[TrainState, TrainMetrics]:
    """One update on ``batch`` (``replay.Batch``: obs, policy, value).
    Updates ``state.module`` and ``state.optimizer`` in place and returns
    the state with ``step + 1``; the metrics stay on the device."""
    model, opt = state.module, state.optimizer
    logits, value = model(batch.obs, train=True)
    out = alphazero_loss(logits, value, batch.policy, batch.value,
                         config.policy_weight, config.value_weight)
    opt.zero_grad(set_to_none=False)
    out.total.backward()
    grads = [p.grad for group in opt.param_groups for p in group["params"]]
    gnorm = global_norm(grads)
    if config.grad_clip_norm and config.grad_clip_norm > 0:
        clip_by_global_norm(grads, config.grad_clip_norm, gnorm)
    lr = learning_rate(config, state.step)
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()
    metrics = TrainMetrics(out.total.detach(), out.policy_loss.detach(),
                           out.value_loss.detach(), gnorm.detach())
    return dataclasses.replace(state, step=state.step + 1), metrics
