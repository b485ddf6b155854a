"""Process groups and the collectives of data parallelism (counterpart of
``alphazero_tpu/parallel/distributed.py``).

The JAX package runs one SPMD program over every device and lets XLA insert
the collectives its shardings imply.  Here every rank of a
``torch.distributed`` process group runs the same program on its own share
of the games and of the training batch, and the code that must see the
global batch calls the collectives below: BatchNorm's moments
(``models/resnet.py``), the learner's gradients and metrics
(``training/learner.py``), the actor's records and the early stop
(``training/pipeline.py``).  Without a process group, or with one rank,
every function here is the identity.

Gloo takes CUDA tensors for ``all_reduce`` and ``broadcast`` but not for
``all_gather``, and NCCL takes CUDA tensors only, so ``all_gather`` moves a
tensor to the backend's device and back when they differ.
"""
from __future__ import annotations

import logging
import os
from typing import List, Optional

import torch
import torch.distributed as dist

log = logging.getLogger("alphazero_tpu_torch.distributed")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device="cuda") -> None:
    """Join (or start) the process group.  With no argument the address,
    world size and rank come from torchrun's ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``; ``coordinator_address`` is ``host:port``.
    A no-op with one process or where a group exists.  The backend is
    ``nccl`` on ``cuda`` and ``gloo`` on ``cpu`` unless ``backend`` names
    one; on ``cuda`` each process takes the card ``LOCAL_RANK`` (or its
    rank) modulo the cards there are, so two ranks on a one-card host share
    it (with ``gloo``: NCCL refuses two ranks on one card)."""
    n = (num_processes if num_processes is not None
         else int(os.environ.get("WORLD_SIZE", "1")))
    if n <= 1 or dist.is_initialized():
        return
    rank = (process_id if process_id is not None
            else int(os.environ.get("RANK", "0")))
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    init_method = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(backend, init_method=init_method, world_size=n,
                            rank=rank)
    log.info("distributed: rank %d of %d (%s)", rank, n, backend)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def host_local_batch(global_batch: int) -> int:
    """This process's slice of a batch split over the ranks."""
    n = world_size()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} % {n} hosts != 0")
    return global_batch // n


def make_global_array(local: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's equal-size shard concatenated along axis 0, in the
    mesh's data order (the JAX version assembles a sharded global array)."""
    return mesh.gather(local, 0)


def _comm_device(x: torch.Tensor) -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather(x: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's ``x`` (equal shapes and dtypes), indexed by rank.  The
    bytes are gathered, so any dtype (bool, bf16) travels."""
    if world_size() == 1:
        return [x]
    flat = x.contiguous().reshape((1,) + tuple(x.shape))
    raw = flat.view(torch.uint8).to(_comm_device(x))
    parts = [torch.empty_like(raw) for _ in range(world_size())]
    dist.all_gather(parts, raw)
    return [p.to(x.device).view(x.dtype)[0] for p in parts]


def all_gather_object(obj) -> list:
    """Every rank's picklable ``obj``, indexed by rank."""
    if world_size() == 1:
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def all_mean_(x: torch.Tensor) -> torch.Tensor:
    """``x`` replaced in place by its mean over the ranks."""
    if world_size() > 1:
        dist.all_reduce(x)
        x /= world_size()
    return x


def all_true(flag: bool, device) -> bool:
    """Whether ``flag`` holds on every rank."""
    if world_size() == 1:
        return bool(flag)
    t = torch.tensor([0 if flag else 1], dtype=torch.int32, device=device)
    dist.all_reduce(t)
    return int(t) == 0


def broadcast_(x: torch.Tensor, src: int = 0) -> torch.Tensor:
    """``x`` replaced in place by rank ``src``'s."""
    if world_size() > 1:
        dist.broadcast(x, src)
    return x


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


class _AllSum(torch.autograd.Function):
    """The sum over the ranks, whose gradient is the sum over the ranks of
    the gradients: each rank's loss reaches every rank's contribution."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, differentiably."""
    return _AllSum.apply(x) if world_size() > 1 else x
