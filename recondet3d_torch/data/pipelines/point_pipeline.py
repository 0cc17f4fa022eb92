"""Pseudo-LiDAR point post-processing (port of
``recondet3d/data/pipelines/point_pipeline.py``).

Every stage maps (points (N, C), valid (N,)) to the same pair with static
buffer sizes: selection is a mask, compaction one stable sort, and the
"already small enough" branches are ``torch.where`` selects, so no stage
reads a count back from the device. ``points`` may carry extra channels
(xyzrgb); geometry uses the first three.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from recondet3d_torch.ops.ball_query import ball_query
from recondet3d_torch.ops.cell_sort import cell_sort
from recondet3d_torch.ops.sampling import furthest_point_sample
from recondet3d_torch.utils.stage_timer import stage

__all__ = [
    "filter_point_by_range",
    "compact_points",
    "voxel_pre_reduce",
    "ball_query_downsample",
    "fps_downsample",
]


def filter_point_by_range(points, valid, point_cloud_range):
    """Mask points outside [xmin .. zmax] (bounds inclusive)."""
    x0, y0, z0, x1, y1, z1 = point_cloud_range
    m = ((points[:, 0] >= x0) & (points[:, 0] <= x1)
         & (points[:, 1] >= y0) & (points[:, 1] <= y1)
         & (points[:, 2] >= z0) & (points[:, 2] <= z1))
    return points, valid & m


def compact_points(points, valid, out_size: int):
    """Stable-compact valid rows to the front, cut to ``out_size`` rows."""
    order = torch.sort((~valid).to(torch.uint8), stable=True).indices[:out_size]
    return points[order], valid[order]


def voxel_pre_reduce(points, valid, *, voxel_size, point_cloud_range: Sequence[float], max_out: int):
    """Keep the FIRST valid point (input order) of each occupied voxel,
    compacted to a static (max_out, C) buffer: leaders come in ascending
    voxel-id order ((z * gy + y) * gx + x), those beyond ``max_out`` are
    dropped. Points outside the range are dropped too, so this subsumes
    ``filter_point_by_range`` over the same range."""
    N = points.shape[0]
    dev = points.device
    vs = np.broadcast_to(np.asarray(voxel_size, np.float32), (3,))
    lo = np.asarray(point_cloud_range[:3], np.float32)
    hi = np.asarray(point_cloud_range[3:], np.float32)
    grid = np.floor((hi - lo) / vs + np.float32(1e-4)).astype(np.int64)  # (gx, gy, gz), fp32 like the reference
    gx, gy, gz = (int(g) for g in grid)
    ncell = gx * gy * gz

    xyz = points[:, :3].float()
    finite = torch.isfinite(xyz).all(dim=1)
    xyz = torch.where(finite[:, None], xyz, torch.zeros_like(xyz))
    c = torch.floor((xyz - torch.from_numpy(lo).to(dev)) / torch.from_numpy(vs.copy()).to(dev)).long()
    limits = torch.tensor([gx, gy, gz], device=dev)
    ok = valid & finite & ((c >= 0) & (c < limits)).all(dim=1)
    ids = torch.where(ok, (c[:, 2] * gy + c[:, 1]) * gx + c[:, 0], torch.full_like(c[:, 0], ncell))
    sid, perm = torch.sort(ids, stable=True)
    lead = sid < ncell
    lead[1:] &= sid[1:] != sid[:-1]
    # stable partition: leaders to the front, id order kept
    perm2 = torch.sort((~lead).to(torch.uint8), stable=True).indices
    sel = perm[perm2[:max_out]]
    out_valid = torch.arange(sel.shape[0], device=dev) < lead.sum()
    return points[sel], out_valid


def ball_query_downsample(
    points,
    valid,
    *,
    anchor_points: int,
    min_radius: float = 0.0,
    max_radius: float = 0.5,
    sample_num: int = 16,
    compact: bool = False,
    grid_dim: int = 64,
    share_sort: bool = False,
    fps_impl: str = "auto",
):
    """Density-aware downsample: FPS anchors + the union of their ball-query
    neighbours, as a mask over the input. With ``n_valid <= anchor_points``
    the input passes through unchanged.

    ``compact=True`` shrinks the buffer to the static bound
    ``anchor_points * (sample_num + 1)`` (rounded up to 128, at most N).
    ``share_sort=True`` builds ONE ``CellSort`` for the anchor FPS, the ball
    query and the compaction: the compacted rows then come in spatial
    order, except that the original-order-first selected point is hoisted
    to row 0, so that a following FPS seeds where the input-order path
    would. ``fps_impl`` is passed to ``furthest_point_sample``.
    """
    N = points.shape[0]
    xyz = points[:, :3]
    with stage("cell_sort"):
        structure = cell_sort(xyz, valid, grid_dim=grid_dim, min_cell=max_radius) if share_sort else None
    with stage("fps_anchors"):
        anchor_idx = furthest_point_sample(xyz, anchor_points, valid, impl=fps_impl, presorted=structure)
    with stage("ball_query"):
        nbr = ball_query(min_radius, max_radius, sample_num, xyz, xyz[anchor_idx], points_valid=valid,
                         grid_dim=grid_dim, structure=structure)
    sel = torch.zeros(N, dtype=torch.bool, device=points.device)
    sel[nbr.reshape(-1)] = True
    sel[anchor_idx] = True
    sel &= valid
    passthrough = valid.sum() <= anchor_points
    out_valid = torch.where(passthrough, valid, sel)
    if not compact:
        return points, out_valid
    cap = min(N, anchor_points * (sample_num + 1))
    cap = ((cap + 127) // 128) * 128
    if not share_sort:
        return compact_points(points, out_valid, cap)
    sel_sorted = out_valid[structure.sorig]
    first_orig = torch.argmax(out_valid.to(torch.uint8))
    key = torch.where(sel_sorted & (structure.sorig == first_orig), 0, torch.where(sel_sorted, 1, 2))
    perm = torch.sort(key.to(torch.uint8), stable=True).indices[:cap]
    return points[structure.sorig[perm]], sel_sorted[perm]


def fps_downsample(points, valid, *, num_points: int, input_spatially_sorted: bool = False,
                   fps_impl: str = "auto"):
    """FPS cap to ``num_points`` rows (<= N) + mask; with ``n_valid <=
    num_points`` the valid rows are compacted to the front instead.
    ``input_spatially_sorted``: the rows already come in the order the
    sampler should scan (ties then go to the lowest row)."""
    presorted = None
    if input_spatially_sorted:
        presorted = (points[:, :3].float(), valid, torch.arange(points.shape[0], device=points.device))
    with stage("fps_final"):
        idx = furthest_point_sample(points[:, :3], num_points, valid, impl=fps_impl, presorted=presorted)
    fps_pts = points[idx]
    comp_pts, comp_valid = compact_points(points, valid, num_points)
    big = valid.sum() > num_points
    out = torch.where(big, fps_pts, comp_pts)
    out_valid = torch.where(big, torch.ones_like(comp_valid), comp_valid)
    return out, out_valid
