"""Tensor parallelism for the DA3 ViT blocks over the mesh's ``model`` axis
(port of ``recondet3d/parallel/tp.py``).

The JAX package annotates the kernels and lets GSPMD place the
collectives. The same Megatron-style layout is written out here:

- attention ``qkv`` (3C, C): column-parallel, each rank holds whole heads:
  heads ``[r*H/t, (r+1)*H/t)`` of q, of k and of v;
- attention ``proj`` (C, C): row-parallel over the same heads;
- ``mlp.fc1`` (hidden, C) / ``mlp.w12`` (2 * hidden, C): column-parallel,
  ``w12`` split within each of its two halves (``chunk(2)`` in the forward
  then gives each rank its slice of each);
- ``mlp.fc2`` / ``mlp.w3`` (C, hidden): row-parallel;
- everything else replicated.

Weights are ``(out, in)`` here where flax kernels are ``(in, out)``, so
JAX's ``P(None, 'model')`` reads ``('model', None)``. A column-parallel
bias is split with its weight; a row-parallel bias is added once, after the
all-reduce; the QK-norms, which every head shares, sum their gradients
over the group. A block enters its parallel region through ``copy_to_model``
(identity forward, all-reduce of the gradient backward) and leaves it
through ``reduce_from_model`` (all-reduce forward, identity backward), so
the activations between blocks, and every replicated parameter's
gradient, are the same on every rank of the ``model`` group.

Rules of the layout (``da3_param_shardings``): a layer is sharded when its
name ends in JAX's suffixes (``attn.qkv``, ``mlp.fc1``, ...), it is one of
the DA3 layer classes that run the collectives (``Attention``, ``Mlp``,
``SwiGLUFFNFused`` of ``models/da3/layers.py``) and each rank gets whole
heads (attention: ``num_heads % t == 0``) or an equal slice of the hidden
width (FFN: ``hidden % t == 0``); both layers of a pair are sharded or
neither is. JAX shards any kernel whose dimension divides by ``t``; where
the two rules differ (ViT-S's 6 heads at ``t = 4``) the port replicates the
layer, which computes the same function.

Sharded parameters keep their names; ``param_layouts`` says how each is cut,
``gather_full`` / ``shard_full`` convert between a full tensor and a
rank's shard (checkpoints hold full tensors, any ``(data, model)`` loads
them).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from recondet3d_torch.parallel.mesh import MODEL_AXIS, Mesh

__all__ = ["da3_param_shardings", "shard_params", "param_layouts", "Layout", "ModelParallel", "copy_to_model",
           "reduce_from_model", "gather_full", "shard_full"]


@dataclasses.dataclass(frozen=True)
class Layout:
    """How a parameter is cut over the ``model`` group: along ``dim``, in
    ``parts`` fused chunks (qkv 3, w12 2, else 1), each split into ``size``
    equal pieces of which rank ``rank`` holds piece ``rank`` of every chunk."""

    dim: int
    parts: int
    size: int
    rank: int

    def full_shape(self, local_shape) -> Tuple[int, ...]:
        s = list(local_shape)
        s[self.dim] *= self.size
        return tuple(s)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Entry of a parallel region: ``x`` (replicated) as it is; the gradient summed over ``group``."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Exit of a parallel region: the ranks' partial sums ``x`` summed over ``group`` (gloo and NCCL both sum bf16
    natively: one rounding of the two values' sum, as a bf16 addition); the gradient as it is."""
    return _ReduceFromModel.apply(x, group)


@dataclasses.dataclass(frozen=True, eq=False)
class ModelParallel:
    """What a sharded layer needs at run time: the ``model`` group, its size and this rank's index in it."""

    group: object
    size: int
    rank: int

    def enter(self, x):
        return copy_to_model(x, self.group)

    def exit(self, linear, x):
        """A row-parallel ``layers.Linear`` on this rank's slice ``x``: the partial products summed over the
        group, then the bias, once."""
        dt = linear.compute_dtype
        y = reduce_from_model(F.linear(x, linear.weight.to(dt)), self.group)
        return y if linear.bias is None else y + linear.bias.to(dt)


def _tp_pairs(model: nn.Module, t: int):
    """(module name, module, column layer name, row layer name, parts) of every layer ``t`` ranks can shard."""
    from recondet3d_torch.models.da3.layers import Attention, Mlp, SwiGLUFFNFused

    for name, m in model.named_modules():
        if isinstance(m, Attention) and (name == "attn" or name.endswith(".attn")):
            if m.num_heads % t == 0:
                yield name, m, "qkv", "proj", 3
        elif isinstance(m, Mlp) and (name == "mlp" or name.endswith(".mlp")):
            if m.fc1.out_features % t == 0:
                yield name, m, "fc1", "fc2", 1
        elif isinstance(m, SwiGLUFFNFused) and (name == "mlp" or name.endswith(".mlp")):
            if m.w3.in_features % t == 0:
                yield name, m, "w12", "w3", 2


def da3_param_shardings(model: nn.Module, mesh: Mesh) -> Dict[str, Tuple]:
    """Every parameter name of ``model`` -> its placement over ``(out, in)``:
    ``('model', None)`` column-parallel (its bias ``('model',)``),
    ``(None, 'model')`` row-parallel, ``()`` replicated; all ``()`` when the
    mesh has no ``model`` extent. Reads the module tree only, so a mesh
    without processes (``Mesh(data, model)``) serves."""
    t = mesh.model
    specs = {n: () for n, _ in model.named_parameters()}
    if t == 1:
        return specs
    for name, m, col, row, _ in _tp_pairs(model, t):
        specs[f"{name}.{col}.weight"] = (MODEL_AXIS, None)
        if getattr(m, col).bias is not None:
            specs[f"{name}.{col}.bias"] = (MODEL_AXIS,)
        specs[f"{name}.{row}.weight"] = (None, MODEL_AXIS)
    return specs


def shard_full(full: torch.Tensor, layout: Layout) -> torch.Tensor:
    """This rank's shard of the full tensor ``full``."""
    chunks = full.chunk(layout.parts, layout.dim)
    return torch.cat([c.chunk(layout.size, layout.dim)[layout.rank] for c in chunks], layout.dim).contiguous()


_BITS = {4: torch.int32, 8: torch.int64}


def gather_full(local: torch.Tensor, layout: Layout, group) -> torch.Tensor:
    """The full tensor from every rank's ``local`` shard (a collective over ``group``: every rank calls it and gets
    the full tensor). Each rank writes its pieces into zeros and the ranks' integer bit patterns are summed, an
    all-reduce that moves every bit as it is (``all_gather`` of CUDA tensors is missing from some gloo builds);
    2-byte types travel as fp32, which holds them exactly."""
    work = local.float() if local.element_size() < 4 else local
    full = torch.zeros(layout.full_shape(local.shape), dtype=work.dtype, device=local.device)
    for dst, src in zip(full.chunk(layout.parts, layout.dim), work.chunk(layout.parts, layout.dim)):
        dst.chunk(layout.size, layout.dim)[layout.rank].copy_(src)
    dist.all_reduce(full.view(_BITS[full.element_size()]), group=group)
    return full.to(local.dtype)


def param_layouts(model: nn.Module) -> Dict[str, Layout]:
    """Name -> ``Layout`` of every sharded parameter of ``model`` (empty before ``shard_params``)."""
    out = {}
    for name, m in model.named_modules():
        tp: Optional[ModelParallel] = getattr(m, "tp", None)
        if tp is None:
            continue
        col, row, parts = m.tp_layers
        out[f"{name}.{col}.weight"] = Layout(0, parts, tp.size, tp.rank)
        if getattr(m, col).bias is not None:
            out[f"{name}.{col}.bias"] = Layout(0, parts, tp.size, tp.rank)
        out[f"{name}.{row}.weight"] = Layout(1, 1, tp.size, tp.rank)
    return out


@torch.no_grad()
def shard_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Lay ``model``'s parameters out for ``mesh`` in place (the JAX
    package's ``device_put`` with ``da3_param_shardings``): every layer
    ``da3_param_shardings`` shards keeps only this rank's shard and runs
    its forward on it, with the collectives over ``mesh``'s ``model`` group.
    A no-op at ``model = 1``; returns ``model``."""
    t = mesh.model
    if t == 1:
        return model
    if mesh.model_group is None:
        raise ValueError(f"a mesh of model extent {t} needs a process group (init_distributed first)")
    par = ModelParallel(mesh.model_group, t, mesh.model_index)
    for _, m, col, row, parts in list(_tp_pairs(model, t)):
        if getattr(m, "tp", None) is not None:
            raise ValueError("shard_params: the model is sharded already")
        c, r = getattr(m, col), getattr(m, row)
        for p, lay in ((c.weight, Layout(0, parts, t, par.rank)), (c.bias, Layout(0, parts, t, par.rank)),
                       (r.weight, Layout(1, 1, t, par.rank))):
            if p is not None:
                p.data = shard_full(p.data, lay)
        m.tp, m.tp_layers = par, (col, row, parts)
    return model
