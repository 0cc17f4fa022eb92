"""The device mesh, batch sharding and the batch-global reductions (port of
``recondet3d/parallel/mesh.py``).

The JAX package trains one program over a ``('data', 'model')`` mesh:
GSPMD shards the batch over ``data`` and computes every statistic that
reduces over the batch (batch norms, the CenterHead's positive count, the
nested net's alignment) over the whole global batch. In PyTorch each rank
runs its own shard in its own process, so those statistics are made
global here, explicitly: ``global_sum`` (an all-reduce) and ``global_cat``
(an all-gather) over the active mesh's ``data`` axis, both differentiable
(the gradient of an all-reduce is an all-reduce of the gradients, which is
how SyncBatchNorm reaches every rank's rows). With no active mesh, or a
mesh of one process without a process group, both are the identity, so
one-process code is unchanged; in a process group of one rank (``torchrun
--nproc_per_node 1``) they run the collectives, which then change nothing.

``DistributedDataParallel`` averages the ranks' gradients, so a rank's
loss must be its share of the global loss times the number of ranks. A
mean over equal per-rank shares (the occupancy loss's ``mean``, the point
losses) already is; a sum, or a sum over a global count, is multiplied by
``data_parallel_size()`` where it is formed.

A ``model`` extent > 1 is tensor parallelism (``parallel/tp.py``): the
ranks of one ``model`` group hold the same samples and shards of the DA3
blocks' weights. The batch-global reductions run over the ``data`` group
only, so a sample is counted once however many model ranks hold it. Rank
``d * model + m`` sits at data index ``d``, model index ``m``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

__all__ = [
    "Mesh",
    "make_mesh",
    "data_sharding",
    "replicated",
    "shard_batch",
    "local_mesh_context",
    "get_active_mesh",
    "world_size",
    "autoscale_lr",
    "data_parallel_size",
    "global_sum",
    "global_cat",
    "DATA_AXIS",
    "MODEL_AXIS",
]

DATA_AXIS = "data"
MODEL_AXIS = "model"

_ACTIVE_MESH: Optional["Mesh"] = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``('data', 'model')`` mesh. ``device_mesh`` is the
    ``torch.distributed`` ``DeviceMesh`` over the process group; a mesh of
    one process has none (a ``DeviceMesh`` needs a process group even at
    1x1). ``shape`` reads as the JAX mesh's does."""

    data: int
    model: int = 1
    device_mesh: object = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def group(self):
        """The process group of the data axis (None with one process)."""
        return None if self.device_mesh is None else self.device_mesh.get_group(DATA_AXIS)

    @property
    def data_index(self) -> int:
        """This rank's position along the data axis."""
        return 0 if self.device_mesh is None else self.device_mesh.get_local_rank(DATA_AXIS)

    @property
    def model_group(self):
        """The process group of the model axis (None with one process)."""
        return None if self.device_mesh is None else self.device_mesh.get_group(MODEL_AXIS)

    @property
    def model_index(self) -> int:
        """This rank's position along the model axis."""
        return 0 if self.device_mesh is None else self.device_mesh.get_local_rank(MODEL_AXIS)


def make_mesh(data: Optional[int] = None, model: int = 1, device_type: Optional[str] = None) -> Mesh:
    """A ``(data, model)`` mesh over the ranks of the process group (one
    process without a group: 1x1). ``data`` defaults to the world size over
    ``model``; ``device_type`` to ``cuda`` where the group's backend is NCCL.
    ``Mesh(data, model)`` itself, without processes, is a layout for
    ``tp.da3_param_shardings`` to read."""
    n = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if data is None:
        if n % model:
            raise ValueError(f"{n} processes not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} processes")
    if n == 1 and not (dist.is_available() and dist.is_initialized()):
        return Mesh(data, model)
    from torch.distributed.device_mesh import init_device_mesh

    device_type = device_type or ("cuda" if dist.get_backend() == "nccl" else "cpu")
    return Mesh(data, model, init_device_mesh(device_type, (data, model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS)))


def data_sharding(mesh: Mesh, ndim: int = 1):
    """The placements of a batch on ``mesh``: dim 0 sharded over ``data``,
    replicated over ``model`` (``torch.distributed.tensor`` placements)."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0), Replicate())


def replicated(mesh: Mesh):
    from torch.distributed.tensor import Replicate

    return (Replicate(), Replicate())


def shard_batch(mesh: Mesh, batch):
    """This rank's share of a global batch: dim 0 of every tensor (and numpy
    array) in the dict / list / tuple cut into ``data`` equal parts, part
    ``data_index`` kept (rank r takes samples r*b .. (r+1)*b - 1)."""
    n, i = mesh.data, mesh.data_index

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(take(v) for v in x)
        if not hasattr(x, "shape") or len(x.shape) == 0:
            return x
        if x.shape[0] % n:
            raise ValueError(f"a global batch of {x.shape[0]} does not split over {n} ranks")
        b = x.shape[0] // n
        return x[i * b:(i + 1) * b]

    return take(batch)


@contextlib.contextmanager
def local_mesh_context(mesh: Mesh):
    """Make ``mesh`` the process-wide active mesh that the batch-global
    reductions (``global_sum``, ``global_cat``) read."""
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    try:
        yield mesh
    finally:
        _ACTIVE_MESH = prev


def get_active_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH


def world_size(mesh: Optional[Mesh] = None) -> int:
    if mesh is None:
        return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    return mesh.data * mesh.model


def autoscale_lr(base_lr: float, samples_per_device: int, mesh: Optional[Mesh] = None,
                 base_total_batch: int = 8) -> float:
    """Linear LR scaling rule (reference: tools/train_mmdet3d.py:190-192
    ``--autoscale-lr``: lr = base_lr * total_batch / 8)."""
    return base_lr * samples_per_device * world_size(mesh) / base_total_batch


def data_parallel_size() -> int:
    """The active mesh's data extent (1 without one)."""
    return 1 if _ACTIVE_MESH is None else _ACTIVE_MESH.data


def _data_group():
    return None if _ACTIVE_MESH is None else _ACTIVE_MESH.group


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        ctx.group, ctx.n, ctx.index = group, n, dist.get_rank(group)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, g):
        # every rank's loss may read this rank's rows: their gradients summed over the ranks, this rank's part kept
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.chunk(ctx.n, dim=0)[ctx.index], None


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks of the active mesh's data axis
    (differentiable); ``x`` itself without data parallelism."""
    group = _data_group()
    return x if group is None else _AllReduceSum.apply(x, group)


def global_cat(x: torch.Tensor) -> torch.Tensor:
    """The ranks' ``x`` (equal shapes) concatenated along dim 0 in rank
    order, which is the global batch's order (differentiable); ``x`` itself
    without data parallelism."""
    group = _data_group()
    return x if group is None else _AllGather.apply(x, group)
