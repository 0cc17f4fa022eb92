"""Test-time-augmentation box merging.

Re-implementation of the reference merge
(reference: projects/mmdet3d_plugin/core/post_processing/merge_augs.py:14
— undo per-aug flips/rotation/scale on predicted boxes, concatenate, and
rotated-NMS the union). The port of
``recondet3d/models/detect/merge_augs.py``: numpy on the host, with the
port's rotated NMS.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

import torch

from recondet3d_torch.core.box3d import LiDARBoxes3D
from recondet3d_torch.ops.iou3d import nms_bev

__all__ = ["merge_aug_bboxes_3d"]


def merge_aug_bboxes_3d(
    aug_results: Sequence[Dict],
    img_metas: Sequence[Dict],
    nms_thresh: float = 0.2,
    max_num: int = 500,
) -> Dict:
    """aug_results: list of dicts with boxes_3d (N, 7+), scores_3d,
    labels_3d; img_metas: matching dicts with pcd_horizontal_flip /
    pcd_vertical_flip / pcd_scale_factor / pcd_rotation."""
    boxes_all, scores_all, labels_all = [], [], []
    for res, meta in zip(aug_results, img_metas):
        boxes = LiDARBoxes3D(np.asarray(res["boxes_3d"], np.float64).copy())
        if meta.get("pcd_scale_factor"):
            boxes.scale(1.0 / meta["pcd_scale_factor"])
        if meta.get("pcd_rotation") is not None:
            R = np.asarray(meta["pcd_rotation"])
            angle = np.arctan2(R[1, 0], R[0, 0])
            boxes.rotate(-angle)
        if meta.get("pcd_horizontal_flip"):
            boxes.flip("horizontal")
        if meta.get("pcd_vertical_flip"):
            boxes.flip("vertical")
        boxes_all.append(boxes.tensor)
        scores_all.append(np.asarray(res["scores_3d"]))
        labels_all.append(np.asarray(res["labels_3d"]))

    boxes = np.concatenate(boxes_all)
    scores = np.concatenate(scores_all)
    labels = np.concatenate(labels_all)
    if len(boxes) == 0:
        return dict(boxes_3d=boxes, scores_3d=scores, labels_3d=labels)

    bev = boxes[:, [0, 1, 3, 4, 6]]
    keep = nms_bev(torch.from_numpy(bev.astype(np.float32)), torch.from_numpy(scores.astype(np.float32)),
                   nms_thresh).numpy()
    boxes, scores, labels = boxes[keep], scores[keep], labels[keep]
    order = np.argsort(-scores)[:max_num]
    return dict(boxes_3d=boxes[order], scores_3d=scores[order], labels_3d=labels[order])
