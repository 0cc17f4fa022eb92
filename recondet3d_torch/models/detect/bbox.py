"""Detection bbox machinery: TransFusion box coder, match costs,
Hungarian/heuristic assigners.

Re-implementation of (reference):
- TransFusionBBoxCoder (projects/mmdet3d_plugin/core/bbox/coders/
  transfusion_bbox_coder.py:8-170): grid-normalized centers, log dims,
  gravity-center z, sin/cos yaw, optional velocity (code_size 8/10).
- match costs (core/bbox/assigners/hungarian_assigner.py:15-47):
  BBox3DL1Cost, BBoxBEVL1Cost, IoU3DCost, FocalLossCost.
- HungarianAssigner3D (:93-160) via scipy linear_sum_assignment and
  HeuristicAssigner3D (:50-90).

The port of ``recondet3d/models/detect/bbox.py``. Assignment runs on the
host in numpy with scipy's Hungarian solver, as in the JAX package; the
coder takes numpy arrays or torch tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

import torch

from recondet3d_torch.core.registry import ASSIGNERS, BBOX_CODERS, MATCH_COSTS

__all__ = [
    "TransFusionBBoxCoder",
    "BBox3DL1Cost",
    "BBoxBEVL1Cost",
    "IoU3DCost",
    "FocalLossCost",
    "HungarianAssigner3D",
    "HeuristicAssigner3D",
    "AssignResult",
]


@BBOX_CODERS.register()
class TransFusionBBoxCoder:
    def __init__(self, pc_range, out_size_factor, voxel_size,
                 post_center_range=None, score_threshold=None, code_size=8):
        self.pc_range = pc_range
        self.out_size_factor = out_size_factor
        self.voxel_size = voxel_size
        self.post_center_range = post_center_range
        self.score_threshold = score_threshold
        self.code_size = code_size

    def encode(self, boxes):
        """boxes (N, 7 or 9) [x y z dx dy dz yaw (vx vy)] -> (N, code_size)."""
        xp = np if isinstance(boxes, np.ndarray) else torch
        t = []
        t.append((boxes[:, 0] - self.pc_range[0]) / (self.out_size_factor * self.voxel_size[0]))
        t.append((boxes[:, 1] - self.pc_range[1]) / (self.out_size_factor * self.voxel_size[1]))
        t.append(boxes[:, 2] + boxes[:, 5] * 0.5)  # bottom -> gravity center
        t.append(xp.log(boxes[:, 3] + 1e-6))
        t.append(xp.log(boxes[:, 4] + 1e-6))
        t.append(xp.log(boxes[:, 5] + 1e-6))
        t.append(xp.sin(boxes[:, 6]))
        t.append(xp.cos(boxes[:, 6]))
        if self.code_size == 10:
            t.append(boxes[:, 7])
            t.append(boxes[:, 8])
        return xp.stack(t, axis=1)

    def decode_box(self, rot_sincos, dim_log, center_grid, height_gravity, vel=None):
        """Inverse of encode for flat (N, ...) arrays -> (N, 7 or 9)."""
        xp = np if isinstance(dim_log, np.ndarray) else torch
        x = center_grid[:, 0] * self.out_size_factor * self.voxel_size[0] + self.pc_range[0]
        y = center_grid[:, 1] * self.out_size_factor * self.voxel_size[1] + self.pc_range[1]
        dims = xp.exp(dim_log)
        z = height_gravity[:, 0] - dims[:, 2] * 0.5  # gravity -> bottom
        yaw = xp.arctan2(rot_sincos[:, 0], rot_sincos[:, 1])
        cols = [x, y, z, dims[:, 0], dims[:, 1], dims[:, 2], yaw]
        out = xp.stack(cols, axis=1)
        if vel is not None:
            out = xp.concatenate([out, vel], axis=1)
        return out

    def filter_decoded(self, boxes, scores):
        """Apply score threshold + post_center_range (decode(filter=True))."""
        mask = np.ones(len(boxes), bool)
        if self.score_threshold is not None:
            mask &= scores > self.score_threshold
        if self.post_center_range is not None:
            pcr = np.asarray(self.post_center_range)
            mask &= np.all(boxes[:, :3] >= pcr[:3], axis=1)
            mask &= np.all(boxes[:, :3] <= pcr[3:], axis=1)
        return mask


@MATCH_COSTS.register()
class BBox3DL1Cost:
    def __init__(self, weight=1.0):
        self.weight = weight

    def __call__(self, bboxes, gt_bboxes, train_cfg=None):
        d = np.abs(bboxes[:, None] - gt_bboxes[None]).sum(-1)
        return d * self.weight


@MATCH_COSTS.register()
class BBoxBEVL1Cost:
    def __init__(self, weight=1.0):
        self.weight = weight

    def __call__(self, bboxes, gt_bboxes, train_cfg):
        pcr = np.asarray(train_cfg["point_cloud_range"])
        start, rng = pcr[0:2], pcr[3:5] - pcr[0:2]
        a = (bboxes[:, :2] - start) / rng
        b = (gt_bboxes[:, :2] - start) / rng
        return np.abs(a[:, None] - b[None]).sum(-1) * self.weight


@MATCH_COSTS.register()
class IoU3DCost:
    def __init__(self, weight=1.0):
        self.weight = weight

    def __call__(self, iou):
        return -iou * self.weight


@MATCH_COSTS.register()
class FocalLossCost:
    """Classification cost from focal-loss pos/neg terms (the mmdet form)."""

    def __init__(self, weight=1.0, alpha=0.25, gamma=2.0, eps=1e-12):
        self.weight = weight
        self.alpha = alpha
        self.gamma = gamma
        self.eps = eps

    def __call__(self, cls_prob, gt_labels):
        """cls_prob (num_query, num_class) sigmoid scores; gt (num_gt,)."""
        p = np.clip(cls_prob, self.eps, 1 - self.eps)
        neg_cost = -np.log(1 - p) * (1 - self.alpha) * p ** self.gamma
        pos_cost = -np.log(p) * self.alpha * (1 - p) ** self.gamma
        cost = pos_cost[:, gt_labels] - neg_cost[:, gt_labels]
        return cost * self.weight


@dataclasses.dataclass
class AssignResult:
    num_gts: int
    gt_inds: np.ndarray  # (num_query,) 0 = background, 1-based positives
    max_overlaps: Optional[np.ndarray]
    labels: np.ndarray


def _boxes_iou_3d_np(a, b):
    from recondet3d_torch.ops.iou3d import boxes_iou_3d

    return boxes_iou_3d(torch.as_tensor(np.asarray(a[:, :7])), torch.as_tensor(np.asarray(b[:, :7]))).numpy()


@ASSIGNERS.register()
class HungarianAssigner3D:
    def __init__(self, cls_cost=None, reg_cost=None, iou_cost=None,
                 iou_calculator=None):
        self.cls_cost = MATCH_COSTS.build(cls_cost) if cls_cost else FocalLossCost()
        self.reg_cost = MATCH_COSTS.build(reg_cost) if reg_cost else BBoxBEVL1Cost()
        self.iou_cost = MATCH_COSTS.build(iou_cost) if iou_cost else IoU3DCost()

    def assign(self, bboxes, gt_bboxes, gt_labels, cls_pred, train_cfg):
        """bboxes (Q, 7+), gt (G, 7+), cls_pred (Q, C) sigmoid scores."""
        from scipy.optimize import linear_sum_assignment

        bboxes = np.asarray(bboxes)
        gt_bboxes = np.asarray(gt_bboxes)
        Q, G = len(bboxes), len(gt_bboxes)
        gt_inds = np.full((Q,), -1, np.int64)
        labels = np.full((Q,), -1, np.int64)
        if G == 0 or Q == 0:
            if G == 0:
                gt_inds[:] = 0
            return AssignResult(G, gt_inds, None, labels)

        cost = (
            self.cls_cost(np.asarray(cls_pred), np.asarray(gt_labels))
            + self.reg_cost(bboxes, gt_bboxes, train_cfg)
        )
        iou = _boxes_iou_3d_np(bboxes, gt_bboxes)
        cost = cost + self.iou_cost(iou)

        rows, cols = linear_sum_assignment(cost)
        gt_inds[:] = 0
        gt_inds[rows] = cols + 1
        labels[rows] = np.asarray(gt_labels)[cols]
        max_overlaps = np.zeros((Q,))
        max_overlaps[rows] = iou[rows, cols]
        return AssignResult(G, gt_inds, max_overlaps, labels)


@ASSIGNERS.register()
class HeuristicAssigner3D:
    def __init__(self, dist_thre=100.0, iou_calculator=None):
        self.dist_thre = dist_thre

    def assign(self, bboxes, gt_bboxes, gt_bboxes_ignore=None, gt_labels=None,
               query_labels=None):
        bboxes = np.asarray(bboxes)
        gt_bboxes = np.asarray(gt_bboxes)
        G, Q = len(gt_bboxes), len(bboxes)
        dist = np.linalg.norm(
            bboxes[None, :, :2] - gt_bboxes[:, None, :2], axis=-1
        )
        if query_labels is not None:
            dist = dist + (np.asarray(query_labels)[None] != np.asarray(gt_labels)[:, None]) * self.dist_thre
        gt_inds = np.zeros((Q,), np.int64)
        vals = np.full((Q,), 1e4)
        labels = np.full((Q,), -1, np.int64)
        nearest = dist.argmin(1)
        for g in range(G):
            q = nearest[g]
            if dist[g, q] <= self.dist_thre and dist[g, q] < vals[q]:
                vals[q] = dist[g, q]
                gt_inds[q] = g + 1
                labels[q] = gt_labels[g] if gt_labels is not None else -1
        max_overlaps = np.zeros((Q,))
        matched = np.where(gt_inds > 0)[0]
        if len(matched):
            iou = _boxes_iou_3d_np(gt_bboxes[gt_inds[matched] - 1], bboxes[matched])
            max_overlaps[matched] = np.diag(iou)
        return AssignResult(G, gt_inds, max_overlaps, labels)
