"""RoI-aware 3D pooling (port of ``recondet3d/ops/roiaware_pool3d.py``).

Point features pooled into a fixed (out_x, out_y, out_z) grid per rotated
RoI, max or avg. A point's cell in a RoI is ``int32(l / d * o)`` per axis
(the division first, truncated, clipped into the grid), with l its
coordinate in the box frame from the box's corner; it counts where
0 <= l < d on every axis (z from the box's bottom). Empty cells read 0 in
both modes; every point of a cell counts (no per-cell cap). RoIs go in
groups whose (RoI, point) pairs fit a bound: only the pairs inside a RoI
are gathered, never an (M, N, C) tensor.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["roiaware_pool3d"]

_PAIRS_PER_GROUP = 1 << 24  # (RoI, point) pairs tested at a time


def roiaware_pool3d(
    rois: torch.Tensor,  # (M, 7) [x y z dx dy dz yaw], z = bottom center
    points: torch.Tensor,  # (N, 3)
    point_features: torch.Tensor,  # (N, C)
    out_size: Tuple[int, int, int] = (14, 14, 14),
    mode: str = "max",
) -> torch.Tensor:
    """Returns (M, out_x, out_y, out_z, C) pooled features."""
    if mode not in ("max", "avg"):
        raise ValueError(mode)
    ox, oy, oz = (int(v) for v in out_size)
    n_cells = ox * oy * oz
    M = rois.shape[0]
    N, C = point_features.shape
    dev, dt = point_features.device, point_features.dtype
    out = []
    group = max(1, _PAIRS_PER_GROUP // max(N, 1))
    for r0 in range(0, M, group):
        roi = rois[r0:r0 + group]
        G = roi.shape[0]
        cx, cy, cz, dx, dy, dz, yaw = (v[:, None] for v in roi[:, :7].unbind(-1))
        cos, sin = torch.cos(yaw), torch.sin(yaw)
        px = points[None, :, 0] - cx
        py = points[None, :, 1] - cy
        pz = points[None, :, 2] - cz
        lx = px * cos + py * sin + dx / 2
        ly = -px * sin + py * cos + dy / 2
        inside = (lx >= 0) & (lx < dx) & (ly >= 0) & (ly < dy) & (pz >= 0) & (pz < dz)
        gx = (lx / dx * ox).to(torch.int32).clamp(0, ox - 1)
        gy = (ly / dy * oy).to(torch.int32).clamp(0, oy - 1)
        gz = (pz / dz * oz).to(torch.int32).clamp(0, oz - 1)
        g_idx, p_idx = inside.nonzero(as_tuple=True)
        slot = g_idx * n_cells + ((gx * oy + gy) * oz + gz)[g_idx, p_idx].long()
        feats = point_features[p_idx]
        if mode == "max":
            grid = torch.full((G * n_cells, C), float("-inf"), dtype=dt, device=dev)
            grid.scatter_reduce_(0, slot[:, None].expand(-1, C), feats, reduce="amax")
            grid = torch.where(torch.isfinite(grid), grid, torch.zeros_like(grid))
        else:
            grid = torch.zeros((G * n_cells, C), dtype=dt, device=dev).index_add(0, slot, feats)
            cnt = torch.zeros(G * n_cells, dtype=dt, device=dev).index_add(0, slot, torch.ones_like(slot, dtype=dt))
            grid = grid / cnt.clamp(min=1.0)[:, None]
        out.append(grid.reshape(G, ox, oy, oz, C))
    if not out:
        return point_features.new_zeros((0, ox, oy, oz, C))
    return torch.cat(out, dim=0)
