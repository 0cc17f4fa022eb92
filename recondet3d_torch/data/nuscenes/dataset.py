"""nuScenes dataset over info pkls (the port's copy of
``recondet3d/data/nuscenes/dataset.py``; host numpy, as there).

Re-implementation of the reference NuScenesDataset
(reference: mmdetection3d/mmdet3d/datasets/nuscenes_dataset.py): info-pkl
loading sorted by timestamp with load_interval, ``get_data_info`` deriving
``lidar2img`` and ``cam2lidar_rts`` per camera (:255-291), CBGS class-
balanced resampling (dataset_wrappers.py), and the boxes/labels filtering
of get_ann_info.

Convention note: the reference builds ``cam2lidar_rt[3, :3] = -t``
(nuscenes_dataset.py:277-280) which its backbone then ADDS
(reconstruction_backbone.py:371-373) — a sign error that shifts each
camera's points by ~2x the camera offset. This implementation stores
``+t`` so ``p_lidar = p_cam @ M[:3,:3].T + M[3,:3]`` is the correct
rigid transform; set ``bug_compatible_cam2lidar=True`` to reproduce the
reference numerics exactly.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from recondet3d_torch.core.registry import DATASETS
from recondet3d_torch.data.nuscenes.converter import CAM_TYPES

__all__ = ["NuScenesDataset", "CBGSDataset"]

DEFAULT_CLASSES = (
    "car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
    "motorcycle", "bicycle", "pedestrian", "traffic_cone",
)


@DATASETS.register()
class NuScenesDataset:
    CLASSES = DEFAULT_CLASSES

    def __init__(
        self,
        ann_file: str,
        data_root: str = "",
        pipeline: Optional[Sequence] = None,
        classes: Optional[Sequence[str]] = None,
        load_interval: int = 1,
        modality: Optional[dict] = None,
        test_mode: bool = False,
        box_type_3d: str = "LiDAR",
        with_velocity: bool = True,
        bug_compatible_cam2lidar: bool = False,
        custom_eval_set: Optional[str] = None,
        **kwargs,
    ):
        self.data_root = data_root
        self.ann_file = ann_file
        self.test_mode = test_mode
        self.load_interval = load_interval
        self.with_velocity = with_velocity
        self.modality = modality or dict(use_lidar=True, use_camera=True)
        self.CLASSES = tuple(classes) if classes else DEFAULT_CLASSES
        self.cat2id = {c: i for i, c in enumerate(self.CLASSES)}
        self.bug_compatible_cam2lidar = bug_compatible_cam2lidar
        self.custom_eval_set = custom_eval_set
        self.pipeline = pipeline
        self.data_infos = self.load_annotations(ann_file)

    def load_annotations(self, ann_file: str) -> List[dict]:
        with open(ann_file, "rb") as f:
            data = pickle.load(f)
        infos = sorted(data["infos"], key=lambda e: e["timestamp"])
        self.metadata = data.get("metadata", {})
        self.version = self.metadata.get("version", "unknown")
        return infos[:: self.load_interval]

    def __len__(self) -> int:
        return len(self.data_infos)

    def get_data_info(self, index: int) -> dict:
        info = self.data_infos[index]
        input_dict = dict(
            sample_idx=info["token"],
            pts_filename=self._path(info["lidar_path"]),
            sweeps=info["sweeps"],
            timestamp=info["timestamp"] / 1e6,
        )
        if self.modality.get("use_camera"):
            image_paths, lidar2img_rts, cam2lidar_rts = [], [], []
            for cam_type in CAM_TYPES:
                if cam_type not in info["cams"]:
                    continue
                cam = info["cams"][cam_type]
                image_paths.append(self._path(cam["data_path"]))
                A = np.asarray(cam["sensor2lidar_rotation"])  # cam->lidar
                t = np.asarray(cam["sensor2lidar_translation"])
                # lidar->cam for projection
                lidar2cam = np.eye(4)
                lidar2cam[:3, :3] = A.T
                lidar2cam[:3, 3] = -A.T @ t
                viewpad = np.eye(4)
                K = np.asarray(cam["cam_intrinsic"])
                viewpad[: K.shape[0], : K.shape[1]] = K
                lidar2img_rts.append(viewpad @ lidar2cam)
                # row-vector cam->lidar: p @ M[:3,:3].T + M[3,:3]
                M = np.eye(4)
                M[:3, :3] = A
                M[3, :3] = -t if self.bug_compatible_cam2lidar else t
                cam2lidar_rts.append(M)
            input_dict.update(
                img_filename=image_paths,
                lidar2img=lidar2img_rts,
                cam2lidar_rts=cam2lidar_rts,
            )
        if not self.test_mode:
            input_dict["ann_info"] = self.get_ann_info(index)
        return input_dict

    def get_ann_info(self, index: int) -> dict:
        info = self.data_infos[index]
        mask = info["valid_flag"] if "valid_flag" in info else info["num_lidar_pts"] > 0
        gt_boxes = np.asarray(info["gt_boxes"])[mask]
        names = np.asarray(info["gt_names"])[mask]
        labels = np.array(
            [self.cat2id.get(n, -1) for n in names], dtype=np.int64
        ).reshape(-1)
        if self.with_velocity and len(gt_boxes):
            vel = np.asarray(info["gt_velocity"])[mask]
            vel = np.nan_to_num(vel)
            gt_boxes = np.concatenate([gt_boxes, vel], axis=-1)
        return dict(gt_bboxes_3d=gt_boxes, gt_labels_3d=labels, gt_names=names)

    # class-distance filter ranges (devkit eval config, meters from ego)
    CLS_RANGE = {
        "car": 50, "truck": 50, "bus": 50, "trailer": 50,
        "construction_vehicle": 50, "pedestrian": 40, "motorcycle": 40,
        "bicycle": 40, "traffic_cone": 30, "barrier": 30,
    }

    def evaluate(self, results, metric: str = "bbox", **kwargs):
        """nuScenes mAP/NDS over per-sample detection results
        (reference: nuscenes_dataset.py:424-489 evaluate -> devkit
        NuScenesEval; here via the self-contained evaluator, matching in
        the LiDAR frame — center-distance metrics are invariant to the
        per-sample rigid transform the devkit applies).

        results: list (len == len(self)) of dicts with 'boxes_3d' (N, 7/9),
        'scores_3d' (N,), 'labels_3d' (N,).

        ``custom_eval_set`` (ctor arg) restricts scoring to the sample
        tokens / scene names listed in
        ``{data_root}/splits/{custom_eval_set}.json``.

        DIVERGENCE from the reference (nuscenes_dataset.py:449-461): there
        ``custom_eval_set`` names a nuScenes *devkit* eval split
        ('{name}_val'/'{name}_mini_val' registered with the devkit); this
        rebuild is devkit-free, so the same key takes a JSON list of
        sample tokens or scene names instead. A reference config passing a
        devkit split name (e.g. the katech one) needs that split exported
        to ``splits/{name}.json`` first — a missing file raises
        FileNotFoundError with that path rather than silently scoring the
        full set.
        """
        from recondet3d_torch.train.eval.nuscenes_eval import DetectionBox, evaluate_nuscenes

        keep = None
        if self.custom_eval_set is not None:
            import json

            split_path = os.path.join(
                self.data_root, "splits", f"{self.custom_eval_set}.json"
            )
            with open(split_path) as f:
                keep = set(json.load(f))

        gt_list, pred_list = [], []
        for idx in range(len(self)):
            token = self.data_infos[idx]["token"]
            if keep is not None and token not in keep and \
                    self.data_infos[idx].get("scene_name") not in keep:
                continue
            ann = self.get_ann_info(idx)
            for box, lbl in zip(ann["gt_bboxes_3d"], ann["gt_labels_3d"]):
                if lbl < 0:
                    continue
                name = self.CLASSES[lbl]
                if np.linalg.norm(box[:2]) > self.CLS_RANGE.get(name, 50):
                    continue
                vel = box[7:9] if len(box) >= 9 else np.zeros(2)
                gt_list.append(DetectionBox(
                    token, box[:3], box[3:6], box[6], vel, name,
                ))
            res = results[idx]
            boxes = np.asarray(res["boxes_3d"])
            scores = np.asarray(res["scores_3d"])
            labels = np.asarray(res["labels_3d"])
            for box, score, lbl in zip(boxes, scores, labels):
                name = self.CLASSES[int(lbl)]
                if np.linalg.norm(box[:2]) > self.CLS_RANGE.get(name, 50):
                    continue
                vel = box[7:9] if len(box) >= 9 else np.zeros(2)
                pred_list.append(DetectionBox(
                    token, box[:3], box[3:6], box[6], vel, name, float(score),
                ))
        metrics = evaluate_nuscenes(gt_list, pred_list, self.CLASSES)
        out = {f"pts_bbox_NuScenes/{k}_AP": v for k, v in metrics["class_aps"].items()}
        out["pts_bbox_NuScenes/mAP"] = metrics["mAP"]
        out["pts_bbox_NuScenes/NDS"] = metrics["NDS"]
        for k, v in metrics["tp_errors"].items():
            out[f"pts_bbox_NuScenes/{k}"] = v
        return out

    def _path(self, p: str) -> str:
        if os.path.isabs(p) or not self.data_root:
            return p
        return os.path.join(self.data_root, p)

    def __getitem__(self, index: int) -> dict:
        data = self.get_data_info(index)
        if self.pipeline is not None:
            data = self.pipeline(data)
        return data


@DATASETS.register()
class CBGSDataset:
    """Class-balanced grouping & sampling wrapper
    (reference: mmdet3d/datasets/dataset_wrappers.py — resample indices so
    every class contributes ~1/n_classes of the epoch)."""

    def __init__(self, dataset):
        self.dataset = dataset if not isinstance(dataset, dict) else DATASETS.build(dataset)
        self.CLASSES = self.dataset.CLASSES
        self.sample_indices = self._get_sample_indices()

    def _get_sample_indices(self) -> List[int]:
        class_sample_idxs: Dict[int, List[int]] = {
            i: [] for i in range(len(self.CLASSES))
        }
        for idx in range(len(self.dataset)):
            ann = self.dataset.get_ann_info(idx)
            for lbl in set(int(l) for l in ann["gt_labels_3d"] if l >= 0):
                class_sample_idxs[lbl].append(idx)
        duplicated = sum(len(v) for v in class_sample_idxs.values())
        if duplicated == 0:
            return list(range(len(self.dataset)))
        frac = 1.0 / len(self.CLASSES)
        ratios = [frac * duplicated / max(len(v), 1) for v in class_sample_idxs.values()]
        indices: List[int] = []
        rng = np.random.default_rng(0)
        for (cls, idxs), ratio in zip(class_sample_idxs.items(), ratios):
            if not idxs:
                continue
            n = int(len(idxs) * ratio)
            indices += list(rng.choice(idxs, n, replace=True))
        return indices or list(range(len(self.dataset)))

    def __len__(self):
        return len(self.sample_indices)

    def __getitem__(self, idx):
        return self.dataset[self.sample_indices[idx]]

    def get_ann_info(self, idx):
        return self.dataset.get_ann_info(self.sample_indices[idx])
