"""Multi-class 3D box NMS post-processing.

Re-implementation of the reference box3d_multiclass_nms
(reference: mmdetection3d/mmdet3d/core/post_processing/box3d_nms.py:9-129)
used by anchor-based heads. The port of
``recondet3d/core/post_processing.py``: host-side numpy orchestration over
the rotated NMS of ``recondet3d_torch.ops.iou3d`` (the per-class loop and
the dynamic-size gathers belong on the host, as in the JAX package).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

import torch

from recondet3d_torch.ops.iou3d import nms_bev, nms_normal_bev

__all__ = ["box3d_multiclass_nms", "xywhr2xyxyr"]


def xywhr2xyxyr(boxes_xywhr: np.ndarray) -> np.ndarray:
    """(N, 5) [cx, cy, w, h, r] -> [x1, y1, x2, y2, r] (reference:
    mmdet3d/core/bbox/structures/utils.py xywhr2xyxyr). Provided for API
    parity; the NMS kernels here take center-form directly."""
    b = np.asarray(boxes_xywhr)
    half_w = b[:, 2] / 2
    half_h = b[:, 3] / 2
    return np.stack(
        [b[:, 0] - half_w, b[:, 1] - half_h,
         b[:, 0] + half_w, b[:, 1] + half_h, b[:, 4]], axis=-1,
    )


def box3d_multiclass_nms(
    mlvl_bboxes: np.ndarray,        # (N, M) full boxes
    mlvl_bboxes_for_nms: np.ndarray,  # (N, 5) BEV center-form [cx,cy,dx,dy,r]
    mlvl_scores: np.ndarray,        # (N, C + 1) — last column is background
    score_thr: float,
    max_num: int,
    cfg: Optional[Dict] = None,
    mlvl_dir_scores: Optional[np.ndarray] = None,
    mlvl_attr_scores: Optional[np.ndarray] = None,
    mlvl_bboxes2d: Optional[np.ndarray] = None,
):
    """Per-class rotated NMS then global top-max_num by score
    (reference: box3d_nms.py:9-129). Unlike the reference, the BEV boxes
    are center-form [cx, cy, dx, dy, r] (no xyxyr conversion step — the
    exact-overlap kernel consumes centers directly).

    Returns (bboxes, scores, labels[, dir_scores][, attr_scores][, bboxes2d]).
    """
    cfg = dict(cfg or {})
    use_rotate = cfg.get("use_rotate_nms", True)
    nms_thr = cfg.get("nms_thr", 0.2)
    num_classes = mlvl_scores.shape[1] - 1

    bboxes, scores, labels = [], [], []
    dir_scores, attr_scores, bboxes2d = [], [], []
    for i in range(num_classes):
        cls_inds = mlvl_scores[:, i] > score_thr
        if not cls_inds.any():
            continue
        _scores = mlvl_scores[cls_inds, i]
        _for_nms = mlvl_bboxes_for_nms[cls_inds]
        nms_fn = nms_bev if use_rotate else nms_normal_bev
        keep = nms_fn(torch.from_numpy(_for_nms.astype(np.float32)),
                      torch.from_numpy(_scores.astype(np.float32)), float(nms_thr)).numpy()
        bboxes.append(mlvl_bboxes[cls_inds][keep])
        scores.append(_scores[keep])
        labels.append(np.full(int(keep.sum()), i, np.int64))
        if mlvl_dir_scores is not None:
            dir_scores.append(mlvl_dir_scores[cls_inds][keep])
        if mlvl_attr_scores is not None:
            attr_scores.append(mlvl_attr_scores[cls_inds][keep])
        if mlvl_bboxes2d is not None:
            bboxes2d.append(mlvl_bboxes2d[cls_inds][keep])

    if bboxes:
        bboxes = np.concatenate(bboxes)
        scores = np.concatenate(scores)
        labels = np.concatenate(labels)
        dir_scores = np.concatenate(dir_scores) if dir_scores else None
        attr_scores = np.concatenate(attr_scores) if attr_scores else None
        bboxes2d = np.concatenate(bboxes2d) if bboxes2d else None
        if len(bboxes) > max_num:
            inds = np.argsort(-scores)[:max_num]
            bboxes, scores, labels = bboxes[inds], scores[inds], labels[inds]
            if dir_scores is not None:
                dir_scores = dir_scores[inds]
            if attr_scores is not None:
                attr_scores = attr_scores[inds]
            if bboxes2d is not None:
                bboxes2d = bboxes2d[inds]
    else:
        M = mlvl_bboxes.shape[-1]
        bboxes = np.zeros((0, M), mlvl_bboxes.dtype)
        scores = np.zeros((0,), mlvl_scores.dtype)
        labels = np.zeros((0,), np.int64)
        dir_scores = np.zeros((0,)) if mlvl_dir_scores is not None else None
        attr_scores = np.zeros((0,)) if mlvl_attr_scores is not None else None
        bboxes2d = np.zeros((0, 4)) if mlvl_bboxes2d is not None else None

    results = (bboxes, scores, labels)
    if mlvl_dir_scores is not None:
        results = results + (dir_scores,)
    if mlvl_attr_scores is not None:
        results = results + (attr_scores,)
    if mlvl_bboxes2d is not None:
        results = results + (bboxes2d,)
    return results
