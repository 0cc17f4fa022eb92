"""Dynamic point -> voxel scatter (port of ``recondet3d/ops/scatter.py``).

Reduces per-point features into per-voxel features with a static output
capacity. Voxel slots follow appearance order, as in ``voxelize``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from benchmark.reference.voxelize import _appearance_slots, compute_grid_size

__all__ = ["dynamic_scatter", "DynamicScatter"]


def dynamic_scatter(
    feats: torch.Tensor,
    coors_zyx: torch.Tensor,
    *,
    grid: Tuple[int, int, int],
    max_voxels: int,
    reduce: str = "mean",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """feats (N, C), coors_zyx (N, 3) int (rows with any -1 are ignored),
    grid (X, Y, Z), reduce 'mean' | 'max' | 'sum'.

    Returns voxel_feats (max_voxels, C), voxel_coors (max_voxels, 3) int32
    (-1 pads), point2voxel (N,) int32 (slot per point, max_voxels for a
    dropped point), num_voxels scalar int32 tensor.
    """
    if reduce not in ("mean", "max", "sum"):
        raise ValueError(reduce)
    N, C = feats.shape
    gx, gy, gz = grid
    sentinel = gx * gy * gz
    dev = feats.device

    coors = coors_zyx.long()
    valid = (coors >= 0).all(dim=-1)
    z, y, x = coors.unbind(-1)
    ids = torch.where(valid, (z * gy + y) * gx + x, torch.full_like(z, sentinel))

    order, svalid, is_first, _, voxel_slot = _appearance_slots(ids, sentinel)
    keep = svalid & (voxel_slot < max_voxels)
    slot = torch.where(keep, voxel_slot, torch.full_like(voxel_slot, max_voxels))

    sfeats = feats[order]
    if reduce == "max":
        neg = torch.full_like(sfeats, float("-inf"))
        voxel_feats = feats.new_full((max_voxels + 1, C), float("-inf"))
        voxel_feats.scatter_reduce_(0, slot[:, None].expand(-1, C), torch.where(keep[:, None], sfeats, neg),
                                    reduce="amax")
        voxel_feats = torch.where(torch.isfinite(voxel_feats), voxel_feats, torch.zeros_like(voxel_feats))
    else:
        voxel_feats = feats.new_zeros((max_voxels + 1, C))
        voxel_feats.index_add_(0, slot, torch.where(keep[:, None], sfeats, torch.zeros_like(sfeats)))
        if reduce == "mean":
            counts = feats.new_zeros(max_voxels + 1)
            counts.index_add_(0, slot, keep.to(feats.dtype))
            voxel_feats = voxel_feats / counts.clamp(min=1.0)[:, None]

    voxel_coors = torch.full((max_voxels + 1, 3), -1, dtype=torch.int32, device=dev)
    voxel_coors[torch.where(keep & is_first, slot, torch.full_like(slot, max_voxels))] = coors[order].to(torch.int32)

    point2voxel = torch.empty(N, dtype=torch.int32, device=dev)
    point2voxel[order] = slot.to(torch.int32)
    num_voxels = (is_first & svalid).sum().clamp(max=max_voxels).to(torch.int32)
    return voxel_feats[:max_voxels], voxel_coors[:max_voxels], point2voxel, num_voxels


class DynamicScatter:
    """Config wrapper of ``dynamic_scatter``: the grid from the range and
    the voxel size, 'mean' when ``average_points`` else 'max'."""

    def __init__(self, voxel_size, point_cloud_range, average_points: bool = True, max_voxels: int = 200000):
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.average_points = average_points
        self.max_voxels = max_voxels
        self.grid = compute_grid_size(self.point_cloud_range, self.voxel_size)

    def __call__(self, feats, coors_zyx):
        return dynamic_scatter(feats, coors_zyx, grid=self.grid, max_voxels=self.max_voxels,
                               reduce="mean" if self.average_points else "max")
