"""Minimal self-contained nuScenes table reader (the port's copy of
``recondet3d/data/nuscenes/tables.py``).

The reference depends on the nuscenes-devkit (reference:
tools/data_converter/nuscenes_converter.py imports NuScenes); the devkit
is absent from this image, and the tables are plain JSON — this module
loads them directly with the same token-indexed access pattern
(``get(table, token)``) plus the couple of helpers the converter needs.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

__all__ = ["NuScenesTables", "quat_wxyz_to_matrix"]

_TABLES = [
    "category", "attribute", "visibility", "instance", "sensor",
    "calibrated_sensor", "ego_pose", "log", "scene", "sample",
    "sample_data", "sample_annotation", "map",
]


def quat_wxyz_to_matrix(q) -> np.ndarray:
    """nuScenes stores wxyz quaternions (pyquaternion convention)."""
    w, x, y, z = [float(v) for v in q]
    n = w * w + x * x + y * y + z * z
    s = 2.0 / n if n > 0 else 0.0
    return np.array(
        [
            [1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)],
            [s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)],
            [s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)],
        ]
    )


class NuScenesTables:
    """Drop-in subset of the devkit's NuScenes class (token-indexed JSON)."""

    def __init__(self, version: str, dataroot: str, verbose: bool = False):
        self.version = version
        self.dataroot = dataroot
        table_dir = os.path.join(dataroot, version)
        self._tables: Dict[str, Dict[str, dict]] = {}
        self._lists: Dict[str, List[dict]] = {}
        for name in _TABLES:
            path = os.path.join(table_dir, f"{name}.json")
            if not os.path.exists(path):
                self._tables[name] = {}
                self._lists[name] = []
                continue
            with open(path) as f:
                rows = json.load(f)
            self._lists[name] = rows
            self._tables[name] = {r["token"]: r for r in rows}

    def get(self, table: str, token: str) -> dict:
        return self._tables[table][token]

    def __getattr__(self, name: str):
        if name in _TABLES:
            return self._lists[name]
        raise AttributeError(name)

    def get_sample_data_path(self, sample_data_token: str) -> str:
        sd = self.get("sample_data", sample_data_token)
        return os.path.join(self.dataroot, sd["filename"])

    def get_boxes_lidar(self, sample_token: str):
        """GT boxes in the LiDAR frame for a sample: returns
        (locs (N,3), dims wlh (N,3), yaws (N,), velocities (N,2) global xy,
        names, num_lidar_pts, tokens). Mirrors the devkit chain the
        reference converter uses (_fill_trainval_infos, nuscenes_converter
        .py:167-320: box in global -> ego -> lidar, yaw from rotated x-axis,
        velocity rotated into lidar frame)."""
        sample = self.get("sample", sample_token)
        lidar_sd = self.get("sample_data", sample["data"]["LIDAR_TOP"])
        cs = self.get("calibrated_sensor", lidar_sd["calibrated_sensor_token"])
        pose = self.get("ego_pose", lidar_sd["ego_pose_token"])
        l2e_r = quat_wxyz_to_matrix(cs["rotation"])
        l2e_t = np.asarray(cs["translation"])
        e2g_r = quat_wxyz_to_matrix(pose["rotation"])
        e2g_t = np.asarray(pose["translation"])

        locs, dims, yaws, vels, names, npts, tokens = [], [], [], [], [], [], []
        for ann_token in sample["anns"]:
            ann = self.get("sample_annotation", ann_token)
            # category via instance (the raw schema has no category_name)
            if "category_name" in ann:
                cat = ann["category_name"]
            else:
                inst = self.get("instance", ann["instance_token"])
                cat = self.get("category", inst["category_token"])["name"]
            center_g = np.asarray(ann["translation"])
            rot_g = quat_wxyz_to_matrix(ann["rotation"])
            # global -> ego -> lidar
            center_e = e2g_r.T @ (center_g - e2g_t)
            center_l = l2e_r.T @ (center_e - l2e_t)
            rot_l = l2e_r.T @ e2g_r.T @ rot_g
            yaw = float(np.arctan2(rot_l[1, 0], rot_l[0, 0]))
            w, l, h = ann["size"]
            v = self.box_velocity(ann_token)
            v_l = l2e_r.T @ e2g_r.T @ v
            locs.append(center_l)
            dims.append([w, l, h])
            yaws.append(yaw)
            vels.append(v_l[:2])
            names.append(cat)
            npts.append(ann.get("num_lidar_pts", 0))
            tokens.append(ann_token)
        n = len(locs)
        return (
            np.asarray(locs).reshape(n, 3),
            np.asarray(dims).reshape(n, 3),
            np.asarray(yaws).reshape(n),
            np.asarray(vels).reshape(n, 2),
            names,
            np.asarray(npts, np.int64).reshape(n),
            tokens,
        )

    def box_velocity(self, ann_token: str, max_time_diff: float = 1.5) -> np.ndarray:
        """Finite-difference velocity like the devkit (global frame)."""
        ann = self.get("sample_annotation", ann_token)
        prev_t, next_t = ann.get("prev", ""), ann.get("next", "")
        if not prev_t and not next_t:
            return np.zeros(3)
        first = self.get("sample_annotation", prev_t) if prev_t else ann
        last = self.get("sample_annotation", next_t) if next_t else ann
        pos_diff = np.asarray(last["translation"]) - np.asarray(first["translation"])
        t0 = self.get("sample", first["sample_token"])["timestamp"] / 1e6
        t1 = self.get("sample", last["sample_token"])["timestamp"] / 1e6
        dt = t1 - t0
        if dt <= 0 or dt > 2 * max_time_diff:
            return np.full(3, np.nan)
        return pos_diff / dt
