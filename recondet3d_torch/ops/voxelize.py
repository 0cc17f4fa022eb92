"""Hard / dynamic voxelization (port of ``recondet3d/ops/voxelize.py``).

Same contract as the JAX functions, static capacities included:

- points (N, C) -> voxels (max_voxels, max_points, C), coors (max_voxels, 3)
  int32 in **zyx** order (-1 for empty slots), num_points (max_voxels,),
  num_voxels scalar tensor;
- voxels come in **appearance order** (a voxel's rank is the original index
  of its first point), points keep input order inside a voxel, points
  beyond ``max_points`` and voxels beyond ``max_voxels`` are dropped.

One stable sort over linear voxel ids plus segment arithmetic; no
``nonzero`` / ``.item()``, so nothing here waits for the device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["compute_grid_size", "voxelize", "dynamic_voxelize"]


def compute_grid_size(point_cloud_range: Sequence[float], voxel_size: Sequence[float]) -> Tuple[int, int, int]:
    """Grid size (X, Y, Z) = round((max - min) / voxel_size)."""
    pcr = np.asarray(point_cloud_range, dtype=np.float64)
    vs = np.asarray(voxel_size, dtype=np.float64)
    gs = np.round((pcr[3:] - pcr[:3]) / vs).astype(np.int64)
    return int(gs[0]), int(gs[1]), int(gs[2])


def _point_coors(points_xyz: torch.Tensor, pcr, vs, grid) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point integer voxel coords (zyx, int64) + validity mask."""
    mins = torch.tensor(tuple(pcr[:3]), dtype=points_xyz.dtype, device=points_xyz.device)
    sizes = torch.tensor(tuple(vs), dtype=points_xyz.dtype, device=points_xyz.device)
    finite = torch.isfinite(points_xyz).all(dim=-1)
    # non-finite rows are invalid anyway; zero them so the float -> int cast is defined
    xyz = torch.where(finite[:, None], points_xyz, torch.zeros_like(points_xyz))
    c = torch.floor((xyz - mins) / sizes).long()  # (N, 3) xyz
    limits = torch.tensor(tuple(grid), dtype=torch.long, device=points_xyz.device)
    valid = ((c >= 0) & (c < limits)).all(dim=-1) & finite
    return c.flip(-1), valid


def _appearance_slots(ids: torch.Tensor, sentinel: int):
    """Stable sort of ``ids`` and, per sorted row: validity, first-of-segment
    flag, rank inside its segment, and the segment's appearance-order slot."""
    N = ids.shape[0]
    sids, order = torch.sort(ids, stable=True)
    svalid = sids != sentinel
    arange = torch.arange(N, device=ids.device)
    is_first = torch.ones(N, dtype=torch.bool, device=ids.device)
    is_first[1:] = sids[1:] != sids[:-1]
    seg_start = torch.cummax(torch.where(is_first, arange, torch.zeros_like(arange)), dim=0).values
    # a segment's key is the original index of its first point (stable sort: the smallest)
    app_key = torch.where(is_first & svalid, order, torch.full_like(order, N))
    app_order = torch.argsort(app_key, stable=True)
    app_rank_at_pos = torch.empty_like(arange)
    app_rank_at_pos[app_order] = arange
    voxel_slot = app_rank_at_pos[seg_start]
    return order, svalid, is_first, arange - seg_start, voxel_slot


def voxelize(
    points: torch.Tensor,
    valid_mask: Optional[torch.Tensor] = None,
    *,
    point_cloud_range: Sequence[float],
    voxel_size: Sequence[float],
    max_points: int,
    max_voxels: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Hard voxelization of one sample; see the module docstring."""
    N, C = points.shape
    grid = compute_grid_size(point_cloud_range, voxel_size)
    gx, gy, gz = grid
    sentinel = gx * gy * gz

    coors_zyx, valid = _point_coors(points[:, :3], point_cloud_range, voxel_size, grid)
    if valid_mask is not None:
        valid = valid & valid_mask.bool()
    z, y, x = coors_zyx.unbind(-1)
    ids = torch.where(valid, (z * gy + y) * gx + x, torch.full_like(z, sentinel))

    order, svalid, is_first, rank_in_voxel, voxel_slot = _appearance_slots(ids, sentinel)
    keep = svalid & (rank_in_voxel < max_points) & (voxel_slot < max_voxels)
    slot = torch.where(keep, voxel_slot, torch.full_like(voxel_slot, max_voxels))  # row max_voxels is cut off

    voxels = points.new_zeros((max_voxels + 1, max_points, C))
    voxels[slot, torch.where(keep, rank_in_voxel, torch.zeros_like(rank_in_voxel))] = points[order]
    num_points = torch.zeros(max_voxels + 1, dtype=torch.int32, device=points.device)
    num_points.index_add_(0, slot, keep.to(torch.int32))
    coors = torch.full((max_voxels + 1, 3), -1, dtype=torch.int32, device=points.device)
    first_keep = keep & is_first
    coors[torch.where(first_keep, slot, torch.full_like(slot, max_voxels))] = coors_zyx[order].to(torch.int32)
    num_voxels = (is_first & svalid).sum().clamp(max=max_voxels).to(torch.int32)
    return voxels[:max_voxels], coors[:max_voxels], num_points[:max_voxels], num_voxels


def dynamic_voxelize(points: torch.Tensor, *, point_cloud_range: Sequence[float],
                     voxel_size: Sequence[float]) -> torch.Tensor:
    """Per-point voxel coords (N, 3) int32 zyx; -1 rows for out-of-range points."""
    grid = compute_grid_size(point_cloud_range, voxel_size)
    coors_zyx, valid = _point_coors(points[:, :3], point_cloud_range, voxel_size, grid)
    return torch.where(valid[:, None], coors_zyx, torch.full_like(coors_zyx, -1)).to(torch.int32)
