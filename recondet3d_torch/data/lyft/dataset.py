"""Lyft dataset: nuScenes-schema info pkls + kaggle-style IoU mAP (the
port's copy of ``recondet3d/data/lyft/dataset.py``).

Re-implementation of the reference LyftDataset
(reference: mmdetection3d/mmdet3d/datasets/lyft_dataset.py +
core/evaluation/lyft_eval.py:90-290 — mAP averaged over 3D-IoU thresholds
0.5:0.05:0.95, greedy score-ordered matching per class). The data side
subclasses NuScenesDataset (same info schema, no velocity, 9 classes).
The IoU runs through ``ops/iou3d.py`` ``boxes_iou_3d`` on ``device``
(default the card), in fp64 (``iou3d``): one (G, P) matrix a sample over all its ground truth
and predictions, where the JAX package makes one call a prediction; the
matching reads its columns in the JAX package's order, so the APs are the
same.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from recondet3d_torch.data.lyft.converter import LYFT_CLASSES
from recondet3d_torch.data.nuscenes.dataset import NuScenesDataset
from recondet3d_torch.utils.device import resolve_device

__all__ = ["LyftDataset", "lyft_map", "iou3d"]

IOU_THRESHOLDS = tuple(np.round(np.arange(0.5, 1.0, 0.05), 2))


def iou3d(gts: np.ndarray, preds: np.ndarray, device="cuda") -> np.ndarray:
    """(G, 7) x (P, 7) -> (G, P) 3D IoU of the boxes' fp32 values, computed in fp64 on ``device`` and returned in
    fp32. The JAX package computes in fp32, where the edge intersections of near-parallel sides carry errors of
    ~1e-5 that differ between the card's and the CPU's arithmetic; in fp64 the two agree to fp32's last bit."""
    if len(gts) == 0 or len(preds) == 0:
        return np.zeros((len(gts), len(preds)), np.float32)
    from recondet3d_torch.ops.iou3d import boxes_iou_3d

    dev = resolve_device(device)
    g, p = (torch.as_tensor(np.asarray(b, np.float32).reshape(-1, 7).astype(np.float64), device=dev)
            for b in (gts, preds))
    return boxes_iou_3d(g, p).float().cpu().numpy()


def _single_class_aps(
    gt_by_sample: Dict[str, np.ndarray],
    pred_by_sample: Dict[str, List],
    iou_by_sample: Dict[str, np.ndarray],
    thresholds=IOU_THRESHOLDS,
) -> np.ndarray:
    """AP per IoU threshold (reference: lyft_eval.py get_single_class_aps:
    199-290 — global score-ordered greedy matching, 1-point-interp-free
    precision/recall integration via np.trapz-style all-point interp).
    ``pred_by_sample[token]``: (column, score) pairs, the column of
    ``iou_by_sample[token]`` (this class's ground truth x the sample's
    predictions) that holds the prediction's IoUs."""
    n_gt = sum(len(v) for v in gt_by_sample.values())
    all_preds = []
    for token, items in pred_by_sample.items():
        for col, score in items:
            all_preds.append((score, token, col))
    all_preds.sort(key=lambda x: -x[0])
    T = len(thresholds)
    tps = np.zeros((len(all_preds), T))
    fps = np.zeros((len(all_preds), T))
    matched = {
        tok: np.zeros((len(v), T), bool) for tok, v in gt_by_sample.items()
    }
    for rank, (score, token, col) in enumerate(all_preds):
        gts = gt_by_sample.get(token, np.zeros((0, 7)))
        if len(gts) == 0:
            fps[rank] = 1
            continue
        ious = iou_by_sample[token][:, col]
        order = np.argsort(-ious)
        for t, thr in enumerate(thresholds):
            hit = False
            for g in order:
                if ious[g] <= thr:
                    break
                if not matched[token][g, t]:
                    matched[token][g, t] = True
                    hit = True
                    break
            tps[rank, t] = hit
            fps[rank, t] = not hit
    aps = np.zeros(T)
    if n_gt == 0 or not all_preds:
        return aps
    ctp = np.cumsum(tps, axis=0)
    cfp = np.cumsum(fps, axis=0)
    recall = ctp / n_gt
    precision = ctp / np.maximum(ctp + cfp, 1e-9)
    for t in range(T):
        r = np.concatenate([[0], recall[:, t], [1]])
        p = np.concatenate([[0], precision[:, t], [0]])
        for i in range(len(p) - 1, 0, -1):
            p[i - 1] = max(p[i - 1], p[i])
        idx = np.where(r[1:] != r[:-1])[0]
        aps[t] = float(np.sum((r[idx + 1] - r[idx]) * p[idx + 1]))
    return aps


def lyft_map(
    gt_annos: Dict[str, Dict[str, np.ndarray]],
    results: Dict[str, List],
    class_names: Sequence[str] = LYFT_CLASSES,
    device="cuda",
):
    """gt_annos: token -> {'boxes' (N, 7), 'names' (N,)};
    results: token -> list of (box (7,), score, name).
    Returns (mAPs per class, overall mAP) at IoU 0.5:0.05:0.95. The IoU
    matrices are computed on ``device``."""
    iou_all = {}
    for tok, items in results.items():
        a = gt_annos.get(tok)
        gts = np.zeros((0, 7)) if a is None or not len(a["boxes"]) else np.asarray(a["boxes"]).reshape(-1, 7)
        preds = np.asarray([np.asarray(b, np.float32)[:7] for b, _, _ in items]).reshape(-1, 7)
        iou_all[tok] = iou3d(gts, preds, device)
    class_aps = {}
    for cls in class_names:
        gt_by, pred_by, iou_by = {}, {}, {}
        for tok, a in gt_annos.items():
            keep = np.asarray(a["names"]) == cls if len(a["boxes"]) else np.zeros(0, bool)
            gt_by[tok] = a["boxes"][keep] if len(a["boxes"]) else np.zeros((0, 7))
        for tok, items in results.items():
            pred_by[tok] = [(j, s) for j, (b, s, n) in enumerate(items) if n == cls]
            if tok in gt_annos and len(gt_annos[tok]["boxes"]):
                iou_by[tok] = iou_all[tok][np.asarray(gt_annos[tok]["names"]) == cls]
        class_aps[cls] = float(np.mean(_single_class_aps(gt_by, pred_by, iou_by)))
    return class_aps, float(np.mean(list(class_aps.values())))


class LyftDataset(NuScenesDataset):
    CLASSES = LYFT_CLASSES

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("with_velocity", False)
        kwargs.setdefault("classes", LYFT_CLASSES)
        super().__init__(*args, **kwargs)

    def evaluate(self, results, device="cuda", **kwargs):
        """results: token -> list of (box (7+,), score, name). Returns the
        kaggle metric dict (reference: lyft_dataset.py evaluate ->
        lyft_eval); the IoUs are computed on ``device``."""
        gt_annos = {}
        for info in self.data_infos:
            gt_annos[info["token"]] = {
                "boxes": np.asarray(info["gt_boxes"]).reshape(-1, 7),
                "names": np.asarray(info["gt_names"]),
            }
        class_aps, overall = lyft_map(gt_annos, results, self.CLASSES, device=device)
        out = {f"mAP/{k}": v for k, v in class_aps.items()}
        out["mAP"] = overall
        return out
