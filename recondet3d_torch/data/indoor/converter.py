"""Indoor dataset -> info-pkl converters (ScanNet / SUN RGB-D / S3DIS; the
port's copy of ``recondet3d/data/indoor/converter.py``: host numpy, as there).

Re-implementation of the reference indoor converters
(reference: mmdetection3d/tools/data_converter/indoor_converter.py:11-80,
scannet_data_utils.py ScanNetData:9-196, sunrgbd_data_utils.py
SUNRGBDData/SUNRGBDInstance:33-221, s3dis_data_utils.py S3DISData:9-170).
Same on-disk contracts: ScanNet reads the extracted
``scannet_instance_data/*_{vert,ins_label,sem_label,aligned_bbox,
unaligned_bbox,axis_align_matrix}.npy`` + ``meta_data/scannetv2_*.txt``;
SUN RGB-D reads ``sunrgbd_trainval/{depth,label,calib,image}``; S3DIS
reads ``s3dis_data/{split}_{room}_{point,ins_label,sem_label}.npy``. All
emit the mmdet3d info schema (``gt_boxes_upright_depth`` etc.) and write
the raw ``points/*.bin`` files consumed by LoadPointsFromFile.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "ScanNetData", "SUNRGBDData", "S3DISData", "create_indoor_infos",
    "SCANNET_CLASSES", "SUNRGBD_CLASSES", "S3DIS_CLASSES",
]

SCANNET_CLASSES = (
    "cabinet", "bed", "chair", "sofa", "table", "door", "window",
    "bookshelf", "picture", "counter", "desk", "curtain", "refrigerator",
    "showercurtrain", "toilet", "sink", "bathtub", "garbagebin",
)
SCANNET_NYU40_IDS = (3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33,
                     34, 36, 39)
SUNRGBD_CLASSES = (
    "bed", "table", "sofa", "chair", "toilet", "desk", "dresser",
    "night_stand", "bookshelf", "bathtub",
)
S3DIS_CLASSES = ("table", "chair", "sofa", "bookcase", "board")
S3DIS_CAT_IDS = (7, 8, 9, 10, 11)


def _list_from_file(path: str) -> List[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


class ScanNetData:
    """(reference: scannet_data_utils.py:9-196)."""

    def __init__(self, root_path: str, split: str = "train"):
        self.root_dir = root_path
        self.split = split
        self.test_mode = split == "test"
        self.cat_ids2class = {c: i for i, c in enumerate(SCANNET_NYU40_IDS)}
        split_file = os.path.join(root_path, "meta_data", f"scannetv2_{split}.txt")
        self.sample_id_list = _list_from_file(split_file)

    def _inst(self, idx: str, suffix: str) -> str:
        return os.path.join(
            self.root_dir, "scannet_instance_data", f"{idx}_{suffix}.npy"
        )

    def get_infos(self, has_label: bool = True) -> List[dict]:
        infos = []
        os.makedirs(os.path.join(self.root_dir, "points"), exist_ok=True)
        for idx in self.sample_id_list:
            info = {"point_cloud": {"num_features": 6, "lidar_idx": idx}}
            points = np.load(self._inst(idx, "vert"))
            points.astype(np.float32).tofile(
                os.path.join(self.root_dir, "points", f"{idx}.bin")
            )
            info["pts_path"] = os.path.join("points", f"{idx}.bin")

            if not self.test_mode:
                for kind in ("instance", "semantic"):
                    d = os.path.join(self.root_dir, f"{kind}_mask")
                    os.makedirs(d, exist_ok=True)
                    short = "ins" if kind == "instance" else "sem"
                    mask = np.load(self._inst(idx, f"{short}_label"))
                    mask.astype(np.int64).tofile(os.path.join(d, f"{idx}.bin"))
                    info[f"pts_{kind}_mask_path"] = os.path.join(
                        f"{kind}_mask", f"{idx}.bin"
                    )

            if has_label and not self.test_mode:
                annos = {}
                aligned = np.load(self._inst(idx, "aligned_bbox"))
                unaligned = np.load(self._inst(idx, "unaligned_bbox"))
                annos["gt_num"] = aligned.shape[0]
                if annos["gt_num"]:
                    classes = aligned[:, -1].astype(int)
                    cls = np.array(
                        [self.cat_ids2class[c] for c in classes], np.int64
                    )
                    annos["name"] = np.array([SCANNET_CLASSES[c] for c in cls])
                    annos["location"] = aligned[:, :3]
                    annos["dimensions"] = aligned[:, 3:6]
                    annos["gt_boxes_upright_depth"] = aligned[:, :-1]
                    annos["unaligned_location"] = unaligned[:, :3]
                    annos["unaligned_dimensions"] = unaligned[:, 3:6]
                    annos["unaligned_gt_boxes_upright_depth"] = unaligned[:, :-1]
                    annos["index"] = np.arange(annos["gt_num"], dtype=np.int32)
                    annos["class"] = cls
                annos["axis_align_matrix"] = np.load(
                    self._inst(idx, "axis_align_matrix")
                )
                info["annos"] = annos
            infos.append(info)
        return infos


class SUNRGBDInstance:
    """One line of a SUN RGB-D label file (reference:
    sunrgbd_data_utils.py:33-56 — 2x half-dims, yaw from orientation
    vector as -atan2(oy, ox))."""

    def __init__(self, line: str):
        data = line.split(" ")
        vals = [float(x) for x in data[1:]]
        self.classname = data[0]
        self.box2d = np.array(
            [vals[0], vals[1], vals[0] + vals[2], vals[1] + vals[3]]
        )
        self.centroid = np.array(vals[4:7])
        self.w, self.l, self.h = vals[7], vals[8], vals[9]
        self.heading_angle = -np.arctan2(vals[11], vals[10])
        self.box3d = np.concatenate(
            [self.centroid,
             np.array([self.l * 2, self.w * 2, self.h * 2, self.heading_angle])]
        )


class SUNRGBDData:
    """(reference: sunrgbd_data_utils.py:59-221). Depth ``.mat`` files
    need scipy; plain ``.npy`` with the same stem also accepted."""

    def __init__(self, root_path: str, split: str = "train", use_v1: bool = False):
        self.root_dir = root_path
        self.split = split
        self.split_dir = os.path.join(root_path, "sunrgbd_trainval")
        self.cat2label = {c: i for i, c in enumerate(SUNRGBD_CLASSES)}
        self.sample_id_list = [
            int(x) for x in _list_from_file(
                os.path.join(self.split_dir, f"{split}_data_idx.txt")
            )
        ]
        self.label_dir = os.path.join(
            self.split_dir, "label_v1" if use_v1 else "label"
        )

    def _depth(self, idx: int) -> np.ndarray:
        mat = os.path.join(self.split_dir, "depth", f"{idx:06d}.mat")
        npy = os.path.join(self.split_dir, "depth", f"{idx:06d}.npy")
        if os.path.exists(npy):
            return np.load(npy)
        from scipy import io as sio

        return sio.loadmat(mat)["instance"]

    def get_infos(self, has_label: bool = True, num_points: int = 50000,
                  seed: int = 0) -> List[dict]:
        rng = np.random.default_rng(seed)
        infos = []
        os.makedirs(os.path.join(self.root_dir, "points"), exist_ok=True)
        for idx in self.sample_id_list:
            pts = self._depth(idx).astype(np.float32)
            if len(pts) > 0:
                choice = rng.choice(
                    len(pts), num_points, replace=len(pts) < num_points
                )
                pts = pts[choice]
            pts.tofile(
                os.path.join(self.root_dir, "points", f"{idx:06d}.bin")
            )
            info = {
                "point_cloud": {"num_features": 6, "lidar_idx": idx},
                "pts_path": os.path.join("points", f"{idx:06d}.bin"),
            }
            calib_file = os.path.join(self.split_dir, "calib", f"{idx:06d}.txt")
            if os.path.exists(calib_file):
                lines = _list_from_file(calib_file)
                Rt = np.array(lines[0].split(" "), np.float32).reshape(
                    (3, 3), order="F"
                )
                K = np.array(lines[1].split(" "), np.float32).reshape(
                    (3, 3), order="F"
                )
                info["calib"] = {"K": K, "Rt": Rt}
            img = os.path.join("image", f"{idx:06d}.jpg")
            info["image"] = {"image_idx": idx, "image_path": img}

            if has_label:
                objs = [
                    SUNRGBDInstance(ln)
                    for ln in _list_from_file(
                        os.path.join(self.label_dir, f"{idx:06d}.txt")
                    )
                ]
                kept = [o for o in objs if o.classname in self.cat2label]
                annos = {"gt_num": len(kept)}
                if kept:
                    annos["name"] = np.array([o.classname for o in kept])
                    annos["bbox"] = np.stack([o.box2d for o in kept])
                    annos["location"] = np.stack([o.centroid for o in kept])
                    annos["dimensions"] = 2 * np.array(
                        [[o.l, o.w, o.h] for o in kept]
                    )
                    annos["rotation_y"] = np.array(
                        [o.heading_angle for o in kept]
                    )
                    annos["index"] = np.arange(len(objs), dtype=np.int32)
                    annos["class"] = np.array(
                        [self.cat2label[o.classname] for o in kept], np.int64
                    )
                    annos["gt_boxes_upright_depth"] = np.stack(
                        [o.box3d for o in kept]
                    )
                info["annos"] = annos
            infos.append(info)
        return infos


class S3DISData:
    """(reference: s3dis_data_utils.py:9-170 — GSDN 5 furniture classes;
    boxes are instance AABBs)."""

    def __init__(self, root_path: str, split: str = "Area_1"):
        self.root_dir = root_path
        self.split = split
        self.cat_ids2class = {c: i for i, c in enumerate(S3DIS_CAT_IDS)}
        data_dir = os.path.join(root_path, "s3dis_data")
        prefix = f"{split}_"
        self.sample_id_list = sorted(
            {
                f[len(prefix):-len("_point.npy")]
                for f in os.listdir(data_dir)
                if f.startswith(prefix) and f.endswith("_point.npy")
            }
        )

    def get_infos(self, has_label: bool = True) -> List[dict]:
        infos = []
        for d in ("points", "instance_mask", "semantic_mask"):
            os.makedirs(os.path.join(self.root_dir, d), exist_ok=True)
        for room in self.sample_id_list:
            stem = f"{self.split}_{room}"
            base = os.path.join(self.root_dir, "s3dis_data", stem)
            points = np.load(f"{base}_point.npy").astype(np.float32)
            ins = np.load(f"{base}_ins_label.npy").astype(np.int64)
            sem = np.load(f"{base}_sem_label.npy").astype(np.int64)
            points.tofile(os.path.join(self.root_dir, "points", f"{stem}.bin"))
            ins.tofile(
                os.path.join(self.root_dir, "instance_mask", f"{stem}.bin")
            )
            sem.tofile(
                os.path.join(self.root_dir, "semantic_mask", f"{stem}.bin")
            )
            info = {
                "point_cloud": {"num_features": 6, "lidar_idx": stem},
                "pts_path": os.path.join("points", f"{stem}.bin"),
                "pts_instance_mask_path": os.path.join(
                    "instance_mask", f"{stem}.bin"
                ),
                "pts_semantic_mask_path": os.path.join(
                    "semantic_mask", f"{stem}.bin"
                ),
            }
            if has_label:
                info["annos"] = self._get_bboxes(points, ins, sem)
            infos.append(info)
        return infos

    def _get_bboxes(self, points, ins, sem) -> dict:
        bboxes, labels = [], []
        for i in range(1, int(ins.max()) + 1):
            ids = ins == i
            if not ids.any():
                continue
            label = int(sem[ids][0])
            if label in self.cat_ids2class:
                pts = points[ids, :3]
                mn, mx = pts.min(0), pts.max(0)
                bboxes.append(np.concatenate([(mn + mx) / 2, mx - mn]))
                labels.append(self.cat_ids2class[label])
        annos = {"gt_num": len(bboxes)}
        if bboxes:
            annos["gt_boxes_upright_depth"] = np.stack(bboxes)
            annos["class"] = np.array(labels, np.int64)
            annos["name"] = np.array([S3DIS_CLASSES[c] for c in labels])
        return annos


def create_indoor_infos(
    dataset: str,
    root_path: str,
    info_prefix: Optional[str] = None,
    save_path: Optional[str] = None,
    use_v1: bool = False,
) -> List[str]:
    """Dispatch (reference: indoor_converter.py create_indoor_info_file:
    11-80). Returns written pkl paths."""
    info_prefix = info_prefix or dataset
    save_path = save_path or root_path
    written = []

    def dump(infos, name):
        path = os.path.join(save_path, f"{info_prefix}_infos_{name}.pkl")
        with open(path, "wb") as f:
            pickle.dump(infos, f)
        written.append(path)

    if dataset == "scannet":
        for split in ("train", "val", "test"):
            ds = ScanNetData(root_path, split=split)
            dump(ds.get_infos(has_label=split != "test"), split)
    elif dataset == "sunrgbd":
        for split in ("train", "val"):
            ds = SUNRGBDData(root_path, split=split, use_v1=use_v1)
            dump(ds.get_infos(), split)
    elif dataset == "s3dis":
        splits = [
            f"Area_{i}" for i in range(1, 7)
            if os.path.exists(os.path.join(root_path, "s3dis_data"))
            and any(
                f.startswith(f"Area_{i}_")
                for f in os.listdir(os.path.join(root_path, "s3dis_data"))
            )
        ]
        for split in splits:
            dump(S3DISData(root_path, split=split).get_infos(), split)
    else:
        raise ValueError(f"unknown indoor dataset {dataset!r}")
    return written
