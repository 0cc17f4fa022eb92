"""GT database creation + ObjectSample augmentation (the port's copy of
``recondet3d/data/nuscenes/gt_database.py``).

Re-implementations of (reference):
- tools/data_converter/create_gt_database.py (490 LoC, uses CUDA
  points_in_boxes) — crop per-annotation point clouds into a database of
  .bin files + a dbinfos pkl;
- the ObjectSample pipeline transform (mmdet3d transforms_3d.py) that
  pastes database objects into training scenes (the augmentation the
  Fading hook disables after epoch N).

Points-in-boxes is the numpy loop below: the C++ library the JAX package
binds for it (``recondet3d/native.py``) is not part of the port. Both
compute the same double-precision test in the same order.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from recondet3d_torch.core.box3d import LiDARBoxes3D
from recondet3d_torch.core.registry import PIPELINES

__all__ = ["create_groundtruth_database", "ObjectSample"]


def _points_in_boxes_host(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(P,) index of the first box of ``boxes`` (M, 7) that holds each point
    (z spans [z, z + h] from the bottom centre), -1 for none."""
    out = np.full(len(points), -1, np.int32)
    for j, b in enumerate(boxes):
        c, s = np.cos(b[6]), np.sin(b[6])
        px, py, pz = (points[:, 0] - b[0], points[:, 1] - b[1], points[:, 2] - b[2])
        lx = px * c + py * s
        ly = -px * s + py * c
        m = (np.abs(lx) <= b[3] / 2) & (np.abs(ly) <= b[4] / 2) & (pz >= 0) & (pz <= b[5])
        out[(out == -1) & m] = j
    return out


def create_groundtruth_database(dataset, out_dir: str,
                                info_prefix: str = "nuscenes") -> str:
    """Crop GT-box point clouds into {out_dir}/{prefix}_gt_database/*.bin
    plus {prefix}_dbinfos_train.pkl (reference: create_gt_database.py)."""
    db_dir = os.path.join(out_dir, f"{info_prefix}_gt_database")
    os.makedirs(db_dir, exist_ok=True)
    db_infos: Dict[str, List[dict]] = {}
    for idx in range(len(dataset)):
        info = dataset.get_data_info(idx)
        ann = info.get("ann_info") or dataset.get_ann_info(idx)
        pts = np.fromfile(info["pts_filename"], np.float32).reshape(-1, 5)[:, :4]
        boxes = np.asarray(ann["gt_bboxes_3d"], np.float64)
        if len(boxes) == 0:
            continue
        box_idx = _points_in_boxes_host(pts[:, :3].astype(np.float64), boxes[:, :7])
        for j, (box, name) in enumerate(zip(boxes, ann["gt_names"])):
            obj_pts = pts[box_idx == j].copy()
            obj_pts[:, :3] -= box[:3]
            fname = f"{idx}_{name}_{j}.bin"
            obj_pts.astype(np.float32).tofile(os.path.join(db_dir, fname))
            db_infos.setdefault(str(name), []).append(dict(
                name=str(name), path=os.path.join(db_dir, fname),
                image_idx=idx, gt_idx=j, box3d_lidar=box[:7],
                num_points_in_gt=int((box_idx == j).sum()),
            ))
    pkl = os.path.join(out_dir, f"{info_prefix}_dbinfos_train.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(db_infos, f)
    return pkl


@PIPELINES.register()
class ObjectSample:
    """Paste database objects into the scene (collision-free in BEV)
    (reference: mmdet3d transforms_3d.py ObjectSample + DataBaseSampler).
    The Fading hook flips ``enabled`` off after epoch N."""

    def __init__(self, db_info_path: str, rate: float = 1.0,
                 sample_groups: Optional[Dict[str, int]] = None,
                 classes: Optional[Sequence[str]] = None, seed: int = 0):
        with open(db_info_path, "rb") as f:
            self.db_infos = pickle.load(f)
        self.rate = rate
        self.sample_groups = sample_groups or {k: 2 for k in self.db_infos}
        self.classes = list(classes) if classes else sorted(self.db_infos)
        self.rng = np.random.default_rng(seed)
        self.enabled = True

    def __call__(self, results):
        if not self.enabled:
            return results
        gt_boxes = np.asarray(results["gt_bboxes_3d"].tensor, np.float64)
        gt_labels = np.asarray(results["gt_labels_3d"])
        points = results["points"]
        new_boxes, new_labels, new_points = [], [], []
        for name, max_n in self.sample_groups.items():
            infos = self.db_infos.get(name, [])
            if not infos or name not in self.classes:
                continue
            n = self.rng.integers(0, max_n + 1)
            for pick in self.rng.choice(len(infos), size=min(n, len(infos)),
                                        replace=False):
                info = infos[int(pick)]
                box = np.asarray(info["box3d_lidar"], np.float64)
                # BEV collision check vs existing + already-sampled boxes
                all_b = np.concatenate(
                    [gt_boxes[:, :7]] + [b[None, :7] for b in new_boxes]
                ) if len(gt_boxes) or new_boxes else np.zeros((0, 7))
                if len(all_b):
                    d = np.linalg.norm(all_b[:, :2] - box[:2], axis=1)
                    r = (np.linalg.norm(all_b[:, 3:5], axis=1)
                         + np.linalg.norm(box[3:5])) / 2
                    if np.any(d < r):
                        continue
                obj = np.fromfile(info["path"], np.float32).reshape(-1, 4)
                if len(obj) == 0:
                    continue
                obj = obj[:, : points.shape[1]].copy()
                obj[:, :3] += box[:3]
                new_boxes.append(np.concatenate([box, np.zeros(2)])[: gt_boxes.shape[1]]
                                 if gt_boxes.shape[1] > 7 else box)
                new_labels.append(self.classes.index(name))
                new_points.append(obj)
        if new_boxes:
            results["gt_bboxes_3d"] = LiDARBoxes3D(
                np.concatenate([gt_boxes, np.stack(new_boxes)])
            )
            results["gt_labels_3d"] = np.concatenate(
                [gt_labels, np.asarray(new_labels, np.int64)]
            )
            results["points"] = np.concatenate([points, *new_points])
        return results
