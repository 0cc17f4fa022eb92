"""KITTI 3D detection -> info-pkl converter (the port's copy of
``recondet3d/data/kitti/converter.py``: host numpy, float64 as there).

Re-implementation of the reference converter capability
(reference: tools/data_converter/kitti_converter.py (544 LoC) +
kitti_data_utils.py — parse calib (P2 / R0_rect / Tr_velo_to_cam), label
files, produce per-sample infos with boxes in both camera and LiDAR
frames). KITTI camera-frame boxes [x y z h w l ry] convert to the LiDAR
frame [x y z dx dy dz yaw] via rect/velo transforms.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np

__all__ = ["create_kitti_infos", "parse_calib", "parse_label", "camera_to_lidar_boxes"]


def parse_calib(path: str) -> Dict[str, np.ndarray]:
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, vals = line.split(":", 1)
            out[key.strip()] = np.array([float(v) for v in vals.split()])
    calib = {}
    for k in ("P0", "P1", "P2", "P3"):
        if k in out:
            calib[k] = out[k].reshape(3, 4)
    if "R0_rect" in out:
        R0 = np.eye(4)
        R0[:3, :3] = out["R0_rect"].reshape(3, 3)
        calib["R0_rect"] = R0
    if "Tr_velo_to_cam" in out:
        T = np.eye(4)
        T[:3, :4] = out["Tr_velo_to_cam"].reshape(3, 4)
        calib["Tr_velo_to_cam"] = T
    return calib


def parse_label(path: str) -> List[dict]:
    objs = []
    with open(path) as f:
        for line in f:
            p = line.split()
            if len(p) < 15:
                continue
            objs.append(dict(
                name=p[0],
                truncated=float(p[1]),
                occluded=int(p[2]),
                alpha=float(p[3]),
                bbox=np.array([float(v) for v in p[4:8]]),
                dimensions=np.array([float(p[10]), float(p[9]), float(p[8])]),  # label h,w,l -> stored (l, w, h)
                location=np.array([float(v) for v in p[11:14]]),
                rotation_y=float(p[14]),
                score=float(p[15]) if len(p) > 15 else 0.0,
            ))
    return objs


def camera_to_lidar_boxes(objs: List[dict], calib: Dict[str, np.ndarray]) -> np.ndarray:
    """KITTI camera boxes (bottom-center location, dims h/w/l, ry) ->
    LiDAR [x y z dx dy dz yaw] (bottom center, yaw around +z)."""
    if not objs:
        return np.zeros((0, 7))
    rect_to_velo = np.linalg.inv(calib["Tr_velo_to_cam"]) @ np.linalg.inv(calib["R0_rect"])
    boxes = []
    for o in objs:
        loc_cam = np.append(o["location"], 1.0)
        loc_velo = (rect_to_velo @ loc_cam)[:3]
        l, w, h = o["dimensions"]  # stored (l, w, h)
        yaw = -o["rotation_y"] - np.pi / 2
        boxes.append([*loc_velo, l, w, h, yaw])
    return np.asarray(boxes)


def create_kitti_infos(root_path: str, info_prefix: str = "kitti",
                       splits=("train", "val")) -> List[str]:
    """Expects the standard layout root/training/{velodyne,label_2,calib,
    image_2} with ImageSets/{split}.txt index files."""
    out_paths = []
    for split in splits:
        idx_file = os.path.join(root_path, "ImageSets", f"{split}.txt")
        if os.path.exists(idx_file):
            with open(idx_file) as f:
                ids = [l.strip() for l in f if l.strip()]
        else:
            velo = os.path.join(root_path, "training", "velodyne")
            ids = sorted(os.path.splitext(p)[0] for p in os.listdir(velo))
        infos = []
        for sid in ids:
            calib = parse_calib(
                os.path.join(root_path, "training", "calib", f"{sid}.txt")
            )
            label_path = os.path.join(root_path, "training", "label_2", f"{sid}.txt")
            objs = parse_label(label_path) if os.path.exists(label_path) else []
            objs_valid = [o for o in objs if o["name"] != "DontCare"]
            gt_boxes = camera_to_lidar_boxes(objs_valid, calib)
            infos.append(dict(
                token=sid,
                lidar_path=os.path.join(root_path, "training", "velodyne", f"{sid}.bin"),
                image_path=os.path.join(root_path, "training", "image_2", f"{sid}.png"),
                calib={k: v for k, v in calib.items()},
                gt_boxes=gt_boxes,
                gt_names=np.array([o["name"] for o in objs_valid]),
                gt_bboxes_2d=np.stack([o["bbox"] for o in objs_valid])
                if objs_valid else np.zeros((0, 4)),
                num_lidar_pts=np.full(len(objs_valid), -1),
                valid_flag=np.ones(len(objs_valid), bool),
                timestamp=0,
                sweeps=[],
            ))
        path = os.path.join(root_path, f"{info_prefix}_infos_{split}.pkl")
        with open(path, "wb") as f:
            pickle.dump(dict(infos=infos, metadata=dict(version=f"kitti-{split}")), f)
        out_paths.append(path)
    return out_paths
