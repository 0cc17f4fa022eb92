"""Point-cloud refinement losses: EMD, smoothness, color, simple L2 (port of
``recondet3d/models/losses/point_losses.py``, the same arithmetic).

- ``EMDLoss``: soft-assignment EMD, per predicted point the softmin-weighted
  distance to the GT points, softmin over the full target set, computed
  ``chunk_size`` predicted rows at a time as the JAX package maps its chunks.
  Each chunk runs under ``torch.utils.checkpoint`` while a graph is
  recorded: its (B, chunk, N) distances are recomputed in the backward pass
  instead of being kept, so a backward holds one chunk's at a time (40,000
  x 40,000 points: 164 MB of fp32 distances a 1,024-row chunk, against
  6.6 GB for all of them).
- ``SmoothnessLoss``: the (biased) variance of the residuals over the points.
- ``ColorLoss``: per predicted color the distance to the nearest GT color,
  chunked and checkpointed like EMD.
- ``SimpleL2Loss``: aligned point-wise squared L2.

Validity masks (``gt_valid``) stand for the reference's variable point
counts. Under data parallelism (``parallel/mesh.py``) a ``mean`` over a
rank's equal share of the batch is what ``DistributedDataParallel``
averages into the global mean; ``sum`` is multiplied by the number of ranks.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from recondet3d_torch.core.registry import LOSSES
from recondet3d_torch.parallel.mesh import data_parallel_size

__all__ = ["EMDLoss", "SmoothnessLoss", "ColorLoss", "SimpleL2Loss", "emd_loss"]


def _reduce(x, reduction):
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum() * data_parallel_size()
    return x


def _distances(p, gt, gt_valid):
    """(B, c, C), (B, N, C) -> (B, c, N) Euclidean distances, inf at invalid GT points (the squared differences
    summed over C in order, as the JAX package's sum over the last axis)."""
    d2 = sum((p[..., k, None] - gt[:, None, :, k]) ** 2 for k in range(p.shape[-1]))
    d = torch.sqrt(torch.clamp(d2, min=1e-12))
    if gt_valid is not None:
        d = torch.where(gt_valid[:, None, :], d, torch.full_like(d, float("inf")))
    return d


def _emd_chunk(p, gt, gt_valid, temperature):
    d = _distances(p, gt, gt_valid)
    w = torch.softmax(-d / temperature, dim=-1)
    return torch.sum(w * torch.where(torch.isfinite(d), d, torch.zeros_like(d)), dim=-1)


def _nearest_chunk(p, gt, gt_valid):
    return torch.amin(_distances(p, gt, gt_valid), dim=-1)


def _chunked(fn, pred, chunk, *args):
    """``fn`` over ``chunk`` rows of ``pred`` (B, M, C) at a time -> (B, M); each chunk checkpointed while a graph
    is recorded."""
    parts = []
    for start in range(0, pred.shape[1], chunk):
        p = pred[:, start:start + chunk]
        if torch.is_grad_enabled() and (p.requires_grad or any(torch.is_tensor(a) and a.requires_grad for a in args)):
            parts.append(checkpoint(fn, p, *args, use_reentrant=False))
        else:
            parts.append(fn(p, *args))
    return torch.cat(parts, dim=1)


def emd_loss(pred, gt, gt_valid=None, temperature: float = 0.1, chunk: int = 1024):
    """Soft-assignment EMD: per pred point, softmin-weighted distance to GT.

    pred (B, M, C), gt (B, N, C) -> (B,)."""
    return _chunked(_emd_chunk, pred, chunk, gt, gt_valid, temperature).mean(dim=1)


@LOSSES.register()
class EMDLoss:
    def __init__(self, temperature=0.1, reduction="mean", loss_weight=1.0, chunk_size=1024):
        self.temperature = temperature
        self.reduction = reduction
        self.loss_weight = loss_weight
        self.chunk_size = chunk_size

    def __call__(self, pred_points, gt_points, gt_valid=None, reduction_override=None):
        loss = emd_loss(pred_points, gt_points, gt_valid, self.temperature, self.chunk_size)
        return _reduce(loss, reduction_override or self.reduction) * self.loss_weight


@LOSSES.register()
class SmoothnessLoss:
    def __init__(self, reduction="mean", loss_weight=1.0):
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, refined_points, pseudo_points, reduction_override=None):
        var = torch.var(refined_points - pseudo_points, dim=1, unbiased=False)  # (B, C)
        return _reduce(var, reduction_override or self.reduction) * self.loss_weight


@LOSSES.register()
class ColorLoss:
    def __init__(self, mode="l1", reduction="mean", loss_weight=1.0, chunk_size=1024):
        self.mode = mode
        self.reduction = reduction
        self.loss_weight = loss_weight
        self.chunk_size = chunk_size

    def __call__(self, pred_colors, gt_colors, gt_valid: Optional[torch.Tensor] = None, reduction_override=None):
        md = _chunked(_nearest_chunk, pred_colors, self.chunk_size, gt_colors, gt_valid)
        return _reduce(md, reduction_override or self.reduction) * self.loss_weight


@LOSSES.register()
class SimpleL2Loss:
    def __init__(self, reduction="mean", loss_weight=1.0):
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred_points, gt_points, reduction_override=None):
        l2 = torch.sum((pred_points - gt_points) ** 2, dim=2)
        return _reduce(l2, reduction_override or self.reduction) * self.loss_weight
