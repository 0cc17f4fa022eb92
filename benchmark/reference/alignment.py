"""Depth alignment / sky handling (port of ``recondet3d/utils/alignment.py``).

Behaviour mirrors the JAX package exactly, including that
``masked_quantile`` takes one quantile over the WHOLE tensor: with B > 1
scenes the nested net's alignment scale is one number for the batch, not
one per scene.
"""

from __future__ import annotations

import torch

__all__ = [
    "least_squares_scale_scalar",
    "compute_sky_mask",
    "compute_alignment_mask",
    "apply_metric_scaling",
    "set_sky_regions_to_max_depth",
    "masked_quantile",
]


def masked_quantile(x: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """torch.quantile (linear interpolation) over x[mask] with static shapes:
    invalid entries sort to +inf, the index comes from the valid count, and
    an empty mask gives 0. No host synchronisation."""
    xf = torch.where(mask, x, torch.full_like(x, float("inf"))).reshape(-1).float()
    xs, _ = torch.sort(xf)
    n = mask.sum().float()
    pos = q * torch.clamp(n - 1.0, min=0.0)
    lo = torch.floor(pos).long()
    hi = torch.ceil(pos).long()
    w = pos - lo.float()
    val = xs[lo] * (1 - w) + xs[hi] * w
    return torch.where(n > 0, val, torch.zeros_like(val))


def least_squares_scale_scalar(a, b, mask=None, eps: float = 1e-12):
    """Scale s minimizing ||a - s*b|| (optionally masked)."""
    a = a.float()
    b = b.float()
    if mask is not None:
        m = mask.float()
        num = torch.sum(a * b * m)
        den = torch.clamp(torch.sum(b * b * m), min=eps)
    else:
        num = torch.sum(a * b)
        den = torch.clamp(torch.sum(b * b), min=eps)
    return num / den


def compute_sky_mask(sky_prediction, threshold: float = 0.3):
    """True where NOT sky."""
    return sky_prediction < threshold


def compute_alignment_mask(
    depth_conf,
    non_sky_mask,
    depth,
    metric_depth,
    median_conf,
    min_depth_threshold: float = 1e-3,
    min_metric_depth_threshold: float = 1e-2,
):
    return (
        (depth_conf >= median_conf)
        & non_sky_mask
        & (metric_depth > min_metric_depth_threshold)
        & (depth > min_depth_threshold)
    )


def apply_metric_scaling(depth, intrinsics, scale_factor: float = 300.0):
    """depth (B,S,H,W), intrinsics (B,S,3,3)."""
    focal = (intrinsics[..., 0, 0] + intrinsics[..., 1, 1]) / 2
    return depth * (focal[..., None, None] / scale_factor)


def set_sky_regions_to_max_depth(depth, depth_conf, non_sky_mask, max_depth):
    depth = torch.where(non_sky_mask, depth, max_depth)
    if depth_conf is not None:
        depth_conf = torch.where(non_sky_mask, depth_conf, torch.ones_like(depth_conf))
    return depth, depth_conf
