"""k-nearest-neighbour search (port of ``recondet3d/ops/knn.py``).

Queries in chunks and points in blocks with a running top-k: the (M, N)
distance matrix is never built whole. Order: ascending (squared distance,
index), as the JAX scan's ``top_k`` over [carried best, new block] gives
it. Padding and invalid points have an infinite distance; with fewer than k
valid points the remaining slots hold index 0 (the scan's initial entries,
which precede every infinite candidate).
"""

from __future__ import annotations

from typing import Optional

import torch

from recondet3d_torch.ops.grouping import sq_dist

__all__ = ["knn"]


def _keys(d2: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """One int64 key a candidate that orders by (d2, index): the bits of a
    non-negative fp32 (inf included) rise with its value."""
    return (d2.contiguous().view(torch.int32).long() << 32) | idx


@torch.no_grad()
def knn(k: int, points: torch.Tensor, queries: torch.Tensor, points_valid: Optional[torch.Tensor] = None,
        chunk: int = 256, block: int = 32768) -> torch.Tensor:
    """For each query (M, 3) the indices (M, k) int64 of the k nearest of
    points (N, 3) by squared euclidean distance. ``chunk`` and ``block``
    move the cost only."""
    N, M = points.shape[0], queries.shape[0]
    dev = points.device
    pts = points[:, :3].float()
    q = queries[:, :3].float()
    valid = points_valid.bool() if points_valid is not None else torch.ones(N, dtype=torch.bool, device=dev)
    idx_all = torch.arange(N, device=dev)
    out = torch.zeros((M, k), dtype=torch.long, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    for c0 in range(0, M, chunk):
        c = q[c0:c0 + chunk]
        best = _keys(torch.full((c.shape[0], k), float("inf"), device=dev),
                     torch.zeros((c.shape[0], k), dtype=torch.long, device=dev))
        for b0 in range(0, N, block):
            p = pts[b0:b0 + block]
            d2 = sq_dist(c[:, None, :], p[None, :, :])
            d2 = torch.where(valid[b0:b0 + block][None, :], d2, inf)
            keys = _keys(d2, idx_all[b0:b0 + block].expand_as(d2))
            merged = torch.cat([best, keys], dim=1)
            best = torch.topk(merged, k, dim=1, largest=False, sorted=True).values
        out[c0:c0 + chunk] = best & 0xFFFFFFFF
    return out
