"""Points in rotated boxes (port of ``recondet3d/ops/points_in_boxes.py``).

Boxes are (M, 7) [x, y, z, dx, dy, dz, yaw] with z the box's **bottom**
center (the LiDAR convention). The host-side numpy test of the ground-truth
database (``data/nuscenes/gt_database.py``) is a separate path.
"""

from __future__ import annotations

import torch

__all__ = ["points_in_boxes", "points_in_boxes_batch"]


def points_in_boxes(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """points (N, 3), boxes (M, 7) -> (N,) int64 index of the FIRST box
    that holds each point, -1 where none does."""
    inside = points_in_boxes_batch(points, boxes)
    first = torch.argmax(inside.to(torch.uint8), dim=1)
    return torch.where(inside.any(dim=1), first, torch.full_like(first, -1))


def points_in_boxes_batch(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """(N, M) bool membership: |lx| <= dx / 2, |ly| <= dy / 2 and
    0 <= pz <= dz in the box's frame."""
    cx, cy, cz, dx, dy, dz, yaw = boxes[:, :7].unbind(-1)
    px = points[:, None, 0] - cx[None]
    py = points[:, None, 1] - cy[None]
    pz = points[:, None, 2] - cz[None]
    cos, sin = torch.cos(yaw)[None], torch.sin(yaw)[None]
    lx = px * cos + py * sin
    ly = -px * sin + py * cos
    return (lx.abs() <= dx[None] / 2) & (ly.abs() <= dy[None] / 2) & (pz >= 0) & (pz <= dz[None])
