"""The (data, model) mesh over a process group (counterpart of
``alphazero_tpu/parallel/mesh.py``).

The JAX mesh lays devices out on ``data`` and ``model`` axes and shards
arrays over them.  Here a mesh lays the ranks of the current
``torch.distributed`` group out the same way: each rank holds its data
row's share of every batch (``shard_batch``) and a copy of the weights
(``replicate``), and ``gather`` puts the shares back together in data
order.  As in the JAX package the model axis exists but nothing is sharded
over it: the ranks of one data row hold the same rows.  With no process
group the mesh is one rank.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from alphazero_tpu_torch.parallel import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    devices: Tuple[int, ...]  # ranks, row-major over (data, model)
    model_parallelism: int = 1

    @property
    def shape(self):
        return {DATA_AXIS: len(self.devices) // self.model_parallelism,
                MODEL_AXIS: self.model_parallelism}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def data_index(self) -> int:
        """This rank's row on the data axis."""
        return self.devices.index(distributed.rank()) // self.model_parallelism

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every data row's ``x`` (equal shapes) concatenated along ``dim``
        in data order."""
        if self.size == 1:
            return x
        parts = distributed.all_gather(x)
        rows = [parts[self.devices[i * self.model_parallelism]]
                for i in range(self.shape[DATA_AXIS])]
        return torch.cat(rows, dim)


def make_mesh(devices: Optional[Sequence[int]] = None,
              model_parallelism: int = 1) -> Mesh:
    """(data, model) mesh over every rank of the process group, or over
    ``devices``, which must list each rank once."""
    world = distributed.world_size()
    devices = tuple(devices if devices is not None else range(world))
    n = len(devices)
    if sorted(devices) != list(range(world)):
        raise ValueError(f"devices {devices} are not the {world} ranks of the "
                         "process group")
    if n % model_parallelism:
        raise ValueError(
            f"{n} devices not divisible by model_parallelism={model_parallelism}")
    return Mesh(devices, model_parallelism)


def _map_leaves(fn, tree):
    if isinstance(tree, torch.Tensor) or hasattr(tree, "ndim"):
        return fn(tree)
    if hasattr(tree, "map"):  # a batched env state
        return tree.map(fn)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return tree


def shard_batch(mesh: Mesh, tree):
    """This rank's rows of each leaf's leading axis: the leading axis split
    in ``data`` equal parts, part ``data_index``.  A leaf whose leading axis
    is not divisible by the data size is kept whole, as the JAX version
    replicates it; so are scalars."""
    n, i = mesh.shape[DATA_AXIS], mesh.data_index

    def take(x):
        if not (hasattr(x, "ndim") and x.ndim) or x.shape[0] % n:
            return x
        k = x.shape[0] // n
        return x[i * k:(i + 1) * k]

    return _map_leaves(take, tree) if n > 1 else tree


def replicate(mesh: Mesh, tree):
    """Every tensor of ``tree`` (a module's parameters and buffers too) set
    to rank 0's, in place; returns ``tree``."""
    if mesh.size == 1:
        return tree
    if isinstance(tree, torch.nn.Module):
        with torch.no_grad():
            for t in list(tree.parameters()) + list(tree.buffers()):
                distributed.broadcast_(t.data, mesh.devices[0])
        return tree

    def bcast(x):
        if isinstance(x, torch.Tensor):
            distributed.broadcast_(x, mesh.devices[0])
        return x

    _map_leaves(bcast, tree)
    return tree


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    n = mesh.shape[DATA_AXIS]
    if global_batch % n:
        raise ValueError(f"batch {global_batch} not divisible by {n} devices")
    return global_batch // n
