"""Point gather / group / feature interpolation (port of
``recondet3d/ops/grouping.py``).

Plain index and gather compositions, differentiable through autograd.
Layouts as in the JAX package: features (C, N), indices along the point
axis.
"""

from __future__ import annotations

import torch

__all__ = ["gather_points", "group_points", "three_nn", "three_interpolate", "sq_dist"]


def sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances of broadcast (.., 3) points, written out column by
    column, (dx*dx + dy*dy) + dz*dz: each product and sum is rounded on its
    own, so the CPU and the card give the same bits (a reduction over the
    last axis may sum in another order on each). The one distance form of
    the port's index-picking ops: ball query, knn, ``three_nn`` and the
    plain FPS (which the FPS kernel rounds alike)."""
    d = a - b
    sq = d * d
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def gather_points(features: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """features (C, N) gathered at indices (M,) along the last axis -> (C, M)."""
    return features[..., indices.long()]


def group_points(features: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """features (C, N), indices (M, nsample) -> grouped (C, M, nsample)."""
    return features[..., indices.long()]


def three_nn(queries: torch.Tensor, points: torch.Tensor):
    """For each query (M, 3) the 3 nearest of points (N, 3): (dist (M, 3),
    idx (M, 3) int64), euclidean distances sqrt(max(d2, 0)), nearest first.

    Among equal squared distances the lower index comes first, as
    ``jax.lax.top_k`` orders them: a stable sort of each row."""
    d2 = sq_dist(queries[:, None, :3], points[None, :, :3])
    d2_sorted, idx = torch.sort(d2, dim=1, stable=True)
    return torch.sqrt(d2_sorted[:, :3].clamp(min=0.0)), idx[:, :3]


def three_interpolate(features: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Inverse-distance-weighted propagation: features (C, N), idx (M, 3),
    weight (M, 3) -> (C, M)."""
    return (features[:, idx.long()] * weight[None]).sum(-1)
