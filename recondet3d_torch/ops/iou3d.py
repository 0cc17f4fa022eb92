"""Rotated BEV IoU + NMS, and 3D IoU (port of ``recondet3d/ops/iou3d.py``).

The JAX package computes these as vectorised XLA programs, not Pallas
kernels, so the port is plain PyTorch with the same algorithm: the exact
rotated-rectangle overlap from the 16 edge intersections and the 8
contained corners of each box pair (24 candidate vertices), angle-sorted
around their centroid and summed by the shoelace formula, as one (N, M)
tensor program. Greedy NMS walks the boxes in descending score order over
the pairwise IoU matrix (a stable sort, as ``jnp.argsort``); the walk runs
on the host, as the JAX package's decode does, and returns a keep mask in
the boxes' own order. Functions take tensors (or numpy arrays) on any
device and compute in their dtype (fp32 in every caller).
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "boxes_iou_bev",
    "boxes_overlap_bev",
    "nms_bev",
    "nms_normal_bev",
    "boxes_iou_3d",
    "nearest_bev_iou",
    "circle_nms",
    "aligned_3d_nms",
]


def _t(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def _corners_bev(boxes: torch.Tensor) -> torch.Tensor:
    """(N, 5) [cx, cy, dx, dy, yaw] -> (N, 4, 2) corners (ccw)."""
    cx, cy, dx, dy, yaw = boxes.unbind(1)
    cos, sin = torch.cos(yaw), torch.sin(yaw)
    ox = torch.stack([dx, dx, -dx, -dx], dim=1) / 2
    oy = torch.stack([-dy, dy, dy, -dy], dim=1) / 2
    x = cx[:, None] + ox * cos[:, None] - oy * sin[:, None]
    y = cy[:, None] + ox * sin[:, None] + oy * cos[:, None]
    return torch.stack([x, y], dim=-1)


def _point_in_rect(pts, boxes, eps=1e-6):
    """pts (..., 2) vs boxes (..., 5): inside test in the box local frame."""
    cx, cy, dx, dy, yaw = boxes.unbind(-1)
    cos, sin = torch.cos(yaw), torch.sin(yaw)
    rx = (pts[..., 0] - cx) * cos + (pts[..., 1] - cy) * sin
    ry = -(pts[..., 0] - cx) * sin + (pts[..., 1] - cy) * cos
    return (rx.abs() <= dx / 2 + eps) & (ry.abs() <= dy / 2 + eps)


def boxes_overlap_bev(boxes_a, boxes_b) -> torch.Tensor:
    """Exact rotated-rectangle intersection areas, (N, M); boxes (N, 5)
    [cx, cy, dx, dy, yaw]."""
    boxes_a, boxes_b = _t(boxes_a), _t(boxes_b)
    N, M = boxes_a.shape[0], boxes_b.shape[0]
    ca, cb = _corners_bev(boxes_a), _corners_bev(boxes_b)

    # 1) all 16 edge-pair intersections
    a0 = ca[:, None, :, None, :]
    a1 = torch.roll(ca, -1, dims=1)[:, None, :, None, :]
    b0 = cb[None, :, None, :, :]
    b1 = torch.roll(cb, -1, dims=1)[None, :, None, :, :]
    d1, d2 = a1 - a0, b1 - b0
    denom = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]
    db = b0 - a0
    safe = torch.where(denom.abs() < 1e-12, torch.ones_like(denom), denom)
    t = (db[..., 0] * d2[..., 1] - db[..., 1] * d2[..., 0]) / safe
    s = (db[..., 0] * d1[..., 1] - db[..., 1] * d1[..., 0]) / safe
    valid_int = (denom.abs() >= 1e-12) & (t >= 0) & (t <= 1) & (s >= 0) & (s <= 1)
    inter_pts = (a0 + t[..., None] * d1).reshape(N, M, 16, 2)
    valid_int = valid_int.reshape(N, M, 16)

    # 2) corners of A inside B, corners of B inside A
    a_in_b = _point_in_rect(ca[:, None, :, :], boxes_b[None, :, None, :])
    b_in_a = _point_in_rect(cb[None, :, :, :], boxes_a[:, None, None, :])
    pts = torch.cat([inter_pts, ca[:, None].expand(N, M, 4, 2), cb[None, :].expand(N, M, 4, 2)], dim=2)
    mask = torch.cat([valid_int, a_in_b, b_in_a], dim=2)

    # 3) angle-sort the valid candidates around their centroid, shoelace
    cnt = mask.sum(dim=2, keepdim=True)
    zero = torch.zeros((), dtype=pts.dtype, device=pts.device)
    centroid = torch.where(mask[..., None], pts, zero).sum(dim=2, keepdim=True) / cnt[..., None].clamp(min=1)
    ang = torch.atan2(pts[..., 1] - centroid[..., 1], pts[..., 0] - centroid[..., 0])
    ang = torch.where(mask, ang, torch.full_like(ang, math.inf))
    order = torch.argsort(ang, dim=2, stable=True)
    pts_s = torch.take_along_dim(pts, order[..., None], dim=2)
    mask_s = torch.take_along_dim(mask, order, dim=2)
    idx = torch.arange(24, device=pts.device)
    nxt = torch.where(idx[None, None, :] + 1 >= cnt, torch.zeros_like(idx), idx[None, None, :] + 1)
    pts_n = torch.take_along_dim(pts_s, nxt[..., None], dim=2)
    cross = pts_s[..., 0] * pts_n[..., 1] - pts_n[..., 0] * pts_s[..., 1]
    area = 0.5 * torch.where(mask_s, cross, zero).sum(dim=2).abs()
    return torch.where(cnt[..., 0] >= 3, area, zero)


def boxes_iou_bev(boxes_a, boxes_b) -> torch.Tensor:
    """Rotated BEV IoU matrix."""
    boxes_a, boxes_b = _t(boxes_a), _t(boxes_b)
    inter = boxes_overlap_bev(boxes_a, boxes_b)
    area_a = (boxes_a[:, 2] * boxes_a[:, 3])[:, None]
    area_b = (boxes_b[:, 2] * boxes_b[:, 3])[None, :]
    return inter / (area_a + area_b - inter).clamp(min=1e-8)


def boxes_iou_3d(boxes_a, boxes_b) -> torch.Tensor:
    """3D IoU for (N, 7) [x y z dx dy dz yaw] boxes (z = bottom center)."""
    boxes_a, boxes_b = _t(boxes_a), _t(boxes_b)
    cols = [0, 1, 3, 4, 6]
    inter_bev = boxes_overlap_bev(boxes_a[:, cols], boxes_b[:, cols])
    za0, za1 = boxes_a[:, 2], boxes_a[:, 2] + boxes_a[:, 5]
    zb0, zb1 = boxes_b[:, 2], boxes_b[:, 2] + boxes_b[:, 5]
    zh = (torch.minimum(za1[:, None], zb1[None, :]) - torch.maximum(za0[:, None], zb0[None, :])).clamp(min=0)
    inter = inter_bev * zh
    vol_a = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vol_b = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None, :]
    return inter / (vol_a + vol_b - inter).clamp(min=1e-8)


def _greedy_nms_from_iou(iou: torch.Tensor, scores: torch.Tensor, thresh: float) -> torch.Tensor:
    """Greedy suppression over a pairwise IoU matrix, in descending score
    order (stable on ties). Returns the keep mask in the original order, on
    the scores' device."""
    order = torch.argsort(-scores, stable=True)
    sup = (iou[order][:, order] > thresh).cpu().numpy()
    n = scores.shape[0]
    keep_sorted = np.ones(n, bool)
    for i in range(n):
        if keep_sorted[i]:
            keep_sorted[i + 1:] &= ~sup[i, i + 1:]
    keep = torch.zeros(n, dtype=torch.bool, device=scores.device)
    keep[order] = torch.from_numpy(keep_sorted).to(scores.device)
    return keep


def nms_bev(boxes, scores, thresh: float) -> torch.Tensor:
    """Rotated NMS: boxes (N, 5), returns the (N,) keep mask."""
    boxes, scores = _t(boxes), _t(scores)
    return _greedy_nms_from_iou(boxes_iou_bev(boxes, boxes), scores, thresh)


def nms_normal_bev(boxes, scores, thresh: float) -> torch.Tensor:
    """Axis-aligned NMS on the boxes' AABBs."""
    boxes, scores = _t(boxes), _t(scores)
    c = _corners_bev(boxes)
    x0, y0 = c[..., 0].amin(1), c[..., 1].amin(1)
    x1, y1 = c[..., 0].amax(1), c[..., 1].amax(1)
    ix0 = torch.maximum(x0[:, None], x0[None, :])
    iy0 = torch.maximum(y0[:, None], y0[None, :])
    ix1 = torch.minimum(x1[:, None], x1[None, :])
    iy1 = torch.minimum(y1[:, None], y1[None, :])
    inter = (ix1 - ix0).clamp(min=0) * (iy1 - iy0).clamp(min=0)
    area = (x1 - x0) * (y1 - y0)
    iou = inter / (area[:, None] + area[None, :] - inter).clamp(min=1e-8)
    return _greedy_nms_from_iou(iou, scores, thresh)


def nearest_bev_iou(boxes_a, boxes_b) -> torch.Tensor:
    """Axis-aligned IoU on rotation-snapped BEV boxes, (N, M): a box's
    (dx, dy) are swapped when its yaw is nearer +-pi/2 than 0."""
    boxes_a, boxes_b = _t(boxes_a), _t(boxes_b)

    def _aabb(b):
        yaw = b[:, 6]
        rot = (yaw - torch.floor(yaw / math.pi + 0.5) * math.pi).abs()
        swap = rot > math.pi / 4
        dx = torch.where(swap, b[:, 4], b[:, 3])
        dy = torch.where(swap, b[:, 3], b[:, 4])
        return b[:, 0] - dx / 2, b[:, 1] - dy / 2, b[:, 0] + dx / 2, b[:, 1] + dy / 2

    ax0, ay0, ax1, ay1 = _aabb(boxes_a)
    bx0, by0, bx1, by1 = _aabb(boxes_b)
    ix = (torch.minimum(ax1[:, None], bx1[None, :]) - torch.maximum(ax0[:, None], bx0[None, :])).clamp(min=0)
    iy = (torch.minimum(ay1[:, None], by1[None, :]) - torch.maximum(ay0[:, None], by0[None, :])).clamp(min=0)
    inter = ix * iy
    area_a = (ax1 - ax0) * (ay1 - ay0)
    area_b = (bx1 - bx0) * (by1 - by0)
    return inter / (area_a[:, None] + area_b[None, :] - inter).clamp(min=1e-8)


def circle_nms(boxes_xy, scores, thresh: float, post_max_size: int = 83) -> torch.Tensor:
    """Center-distance NMS: suppress boxes whose squared center distance to
    a kept higher-score box is below ``thresh``; keep at most
    ``post_max_size``. Returns the keep mask."""
    boxes_xy, scores = _t(boxes_xy), _t(scores)
    d2 = ((boxes_xy[:, None, :2] - boxes_xy[None, :, :2]) ** 2).sum(-1)
    keep = _greedy_nms_from_iou((d2 < thresh).to(scores.dtype), scores, 0.5)
    order = torch.argsort(-torch.where(keep, scores, torch.full_like(scores, -math.inf)), stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(len(order), device=order.device)
    return keep & (rank < post_max_size)


def aligned_3d_nms(boxes, scores, classes, thresh: float) -> torch.Tensor:
    """Axis-aligned 3D NMS, class-aware; boxes (N, 6) [x0 y0 z0 x1 y1 z1]."""
    boxes, scores, classes = _t(boxes), _t(scores), _t(classes)
    mn, mx = boxes[:, :3], boxes[:, 3:6]
    inter = (torch.minimum(mx[:, None], mx[None, :]) - torch.maximum(mn[:, None], mn[None, :])).clamp(min=0).prod(-1)
    vol = (mx - mn).prod(-1)
    iou = inter / (vol[:, None] + vol[None, :] - inter).clamp(min=1e-8)
    iou = torch.where(classes[:, None] == classes[None, :], iou, torch.zeros_like(iou))
    return _greedy_nms_from_iou(iou, scores, thresh)
