"""Indoor datasets (ScanNet / SUN RGB-D / S3DIS) + indoor AP evaluation
(the port's copy of ``recondet3d/data/indoor/dataset.py``).

Re-implementation of the reference indoor dataset stack
(reference: mmdetection3d/mmdet3d/datasets/{scannet,sunrgbd,s3dis}_dataset.py
+ core/evaluation/indoor_eval.py:8-260 — per-class score-ordered greedy
matching at IoU thresholds (default 0.25/0.5), 'area'-mode AP). Boxes are
the depth-frame (N, 6|7) ``gt_boxes_upright_depth`` arrays the converters
emit. The JAX package's dispatch is kept pair by pair: within a class, a
pair goes through the exact rotated IoU (``ops/iou3d.py`` ``boxes_iou_3d``,
on ``device``, default the card, in fp64) where the class's ground truth or
the prediction is yawed (|yaw| > 1e-6), through a pure-numpy axis-aligned
IoU otherwise. A sample's rotated IoUs come from one device call over all
its boxes, cut by class and used for every threshold, where the JAX
package makes one call a prediction, class and threshold.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from recondet3d_torch.utils.device import resolve_device
from recondet3d_torch.data.indoor.converter import (
    S3DIS_CLASSES,
    SCANNET_CLASSES,
    SUNRGBD_CLASSES,
)

__all__ = [
    "indoor_eval", "average_precision", "iou_3d",
    "ScanNetDataset", "SUNRGBDDataset", "S3DISDataset",
]


def average_precision(recalls: np.ndarray, precisions: np.ndarray) -> float:
    """'area' mode AP (reference: indoor_eval.py:8-44)."""
    mrec = np.concatenate([[0.0], recalls, [1.0]])
    mpre = np.concatenate([[0.0], precisions, [0.0]])
    for i in range(len(mpre) - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _with_yaw(b: np.ndarray) -> np.ndarray:
    b = np.asarray(b, np.float32)
    return np.concatenate([b, np.zeros((len(b), 1), np.float32)], -1) if b.shape[1] == 6 else b


def _iou_axis_aligned(g: np.ndarray, p: np.ndarray) -> np.ndarray:
    gmin = g[:, :3] - g[:, 3:6] / 2
    gmax = g[:, :3] + g[:, 3:6] / 2
    gmin[:, 2], gmax[:, 2] = g[:, 2], g[:, 2] + g[:, 5]
    pmin = p[:, :3] - p[:, 3:6] / 2
    pmax = p[:, :3] + p[:, 3:6] / 2
    pmin[:, 2], pmax[:, 2] = p[:, 2], p[:, 2] + p[:, 5]
    lo = np.maximum(gmin[:, None], pmin[None])
    hi = np.minimum(gmax[:, None], pmax[None])
    inter = np.clip(hi - lo, 0, None).prod(-1)
    vg = (gmax - gmin).prod(-1)
    vp = (pmax - pmin).prod(-1)
    return inter / np.clip(vg[:, None] + vp[None] - inter, 1e-8, None)


def _rotated_iou(g: np.ndarray, p: np.ndarray, device) -> np.ndarray:
    """The rotated 3D IoU of the boxes' fp32 values, computed in fp64 on ``device``, returned in fp32 (the JAX
    package computes in fp32, whose errors on near-parallel edges differ between the card and the CPU; see
    ``lyft/dataset.py`` ``iou3d``)."""
    from recondet3d_torch.ops.iou3d import boxes_iou_3d

    dev = resolve_device(device)
    g, p = (torch.as_tensor(b.astype(np.float64), device=dev) for b in (g, p))
    return boxes_iou_3d(g, p).float().cpu().numpy()


def _yawed(b: np.ndarray) -> np.ndarray:
    return np.abs(b[:, 6]) > 1e-6


def iou_3d(gts: np.ndarray, preds: np.ndarray, device="cuda") -> np.ndarray:
    """(G, 6|7) x (P, 6|7) -> (G, P) 3D IoU; bottom-center z boxes. Column
    j is what the JAX package's ``_iou_3d(gts, preds[j:j + 1])`` gives: the
    rotated IoU on ``device`` where a ground-truth box or prediction j is
    yawed, the numpy axis-aligned IoU elsewhere."""
    if len(gts) == 0 or len(preds) == 0:
        return np.zeros((len(gts), len(preds)), np.float32)
    g, p = _with_yaw(gts), _with_yaw(preds)
    rotated = _yawed(p) | _yawed(g).any()
    out = np.zeros((len(g), len(p)), np.float32)
    if rotated.any():
        out[:, rotated] = _rotated_iou(g, p[rotated], device)
    if not rotated.all():
        out[:, ~rotated] = _iou_axis_aligned(g, p[~rotated])
    return out


class _SampleIoU:
    """One sample's IoUs for every class at once: the rotated matrix of all its ground truth against all its
    predictions (one device call, made only when a box is yawed) and the axis-aligned one; ``of(gm, pm)`` picks a
    class's pairs from them by ``iou_3d``'s rule, applied to that class's boxes."""

    def __init__(self, gb, db, device):
        self.g, self.p = _with_yaw(gb), _with_yaw(db)
        any_yaw = _yawed(self.g).any() or _yawed(self.p).any()
        self.rot = _rotated_iou(self.g, self.p, device) if any_yaw else None
        self.al = _iou_axis_aligned(self.g, self.p)

    def of(self, gm, pm) -> np.ndarray:
        al = self.al[gm][:, pm]
        if self.rot is None:
            return al
        rotated = _yawed(self.p[pm]) | _yawed(self.g[gm]).any()
        return np.where(rotated[None], self.rot[gm][:, pm], al)


def indoor_eval(
    gt_annos: List[dict],
    dt_annos: List[dict],
    metric: Sequence[float] = (0.25, 0.5),
    label2cat: Optional[Dict[int, str]] = None,
    device="cuda",
):
    """gt_annos[i]: {'gt_boxes_upright_depth' (N, 6|7), 'class' (N,)};
    dt_annos[i]: {'boxes_3d' (M, 6|7), 'labels_3d' (M,), 'scores_3d' (M,)}.
    Returns {f'{cls}_AP_{thr}': v, f'mAP_{thr}': v, ...}
    (reference: indoor_eval.py indoor_eval:204-260 + eval_det_cls:56-161).
    Rotated IoUs are computed on ``device``."""
    classes = sorted(
        {int(c) for a in gt_annos for c in np.asarray(a.get("class", [])).reshape(-1)}
        | {int(c) for a in dt_annos for c in np.asarray(a.get("labels_3d", [])).reshape(-1)}
    )
    out = {}
    aps = {t: [] for t in metric}
    sample_ious = []
    for g, d in zip(gt_annos, dt_annos):
        gb = np.asarray(g.get("gt_boxes_upright_depth", np.zeros((0, 7))))
        db = np.asarray(d.get("boxes_3d", np.zeros((0, 7))))
        sample_ious.append(_SampleIoU(gb, db, device) if len(gb) and len(db) else None)
    for cls in classes:
        # gather per-sample gt/pred of this class
        n_gt = 0
        preds = []  # (score, sample, column of the sample's IoU matrix)
        gts = []
        ious_by = []  # per sample: this class's (G, P) IoU matrix, cut from the sample's
        for i, (g, d) in enumerate(zip(gt_annos, dt_annos)):
            gb = np.asarray(g.get("gt_boxes_upright_depth", np.zeros((0, 7))))
            gc = np.asarray(g.get("class", np.zeros((0,), int)))
            gts.append(gb[gc == cls] if len(gb) else gb.reshape(0, gb.shape[-1] if gb.size else 7))
            n_gt += len(gts[-1])
            db = np.asarray(d.get("boxes_3d", np.zeros((0, 7))))
            dl = np.asarray(d.get("labels_3d", np.zeros((0,), int)))
            ds = np.asarray(d.get("scores_3d", np.zeros((0,))))
            gm, pm = gc == cls, dl == cls
            ious_by.append(sample_ious[i].of(gm, pm) if len(gts[-1]) and pm.any() else None)
            for c, s in enumerate(ds[dl == cls]):
                preds.append((float(s), i, c))
        preds.sort(key=lambda x: -x[0])
        name = label2cat[cls] if label2cat else str(cls)
        for thr in metric:
            matched = [np.zeros(len(g), bool) for g in gts]
            tp = np.zeros(len(preds))
            fp = np.zeros(len(preds))
            for r, (s, i, c) in enumerate(preds):
                ious = ious_by[i][:, c] if len(gts[i]) else np.zeros(0)
                j = int(np.argmax(ious)) if len(ious) else -1
                if j >= 0 and ious[j] >= thr and not matched[i][j]:
                    matched[i][j] = True
                    tp[r] = 1
                else:
                    fp[r] = 1
            if n_gt == 0 or not preds:
                ap = 0.0
                rec = 0.0
            else:
                ctp, cfp = np.cumsum(tp), np.cumsum(fp)
                recalls = ctp / n_gt
                precisions = ctp / np.maximum(ctp + cfp, 1e-9)
                ap = average_precision(recalls, precisions)
                rec = float(recalls[-1])
            out[f"{name}_AP_{thr:.2f}"] = ap
            out[f"{name}_rec_{thr:.2f}"] = rec
            aps[thr].append(ap)
    for thr in metric:
        out[f"mAP_{thr:.2f}"] = float(np.mean(aps[thr])) if aps[thr] else 0.0
    return out


class _IndoorDataset:
    CLASSES: Sequence[str] = ()

    def __init__(self, ann_file: str, data_root: str = "",
                 pipeline: Optional[Sequence] = None, test_mode: bool = False,
                 **kwargs):
        self.data_root = data_root or os.path.dirname(ann_file)
        self.test_mode = test_mode
        self.pipeline = pipeline
        with open(ann_file, "rb") as f:
            self.data_infos = pickle.load(f)

    def __len__(self):
        return len(self.data_infos)

    def get_data_info(self, index: int) -> dict:
        info = self.data_infos[index]
        return dict(
            sample_idx=info["point_cloud"]["lidar_idx"],
            pts_filename=os.path.join(self.data_root, info["pts_path"]),
            ann_info=self.get_ann_info(index),
        )

    def get_ann_info(self, index: int) -> dict:
        a = self.data_infos[index].get("annos", {})
        n = a.get("gt_num", 0)
        if not n:
            return dict(
                gt_bboxes_3d=np.zeros((0, 7)), gt_labels_3d=np.zeros((0,), int)
            )
        boxes = np.asarray(a["gt_boxes_upright_depth"])
        return dict(gt_bboxes_3d=boxes, gt_labels_3d=np.asarray(a["class"]))

    def evaluate(self, results: List[dict], metric=(0.25, 0.5), device="cuda", **kwargs):
        """results[i]: {'boxes_3d', 'labels_3d', 'scores_3d'}
        (reference: scannet_dataset.py evaluate -> indoor_eval); rotated
        IoUs on ``device``."""
        gt = [i.get("annos", {}) for i in self.data_infos]
        label2cat = dict(enumerate(self.CLASSES))
        return indoor_eval(gt, results, metric=metric, label2cat=label2cat, device=device)


class ScanNetDataset(_IndoorDataset):
    CLASSES = SCANNET_CLASSES


class SUNRGBDDataset(_IndoorDataset):
    CLASSES = SUNRGBD_CLASSES


class S3DISDataset(_IndoorDataset):
    CLASSES = S3DIS_CLASSES
