"""Lyft Level-5 -> info-pkl converter (the port's copy of
``recondet3d/data/lyft/converter.py``: host numpy, as there).

Re-implementation of the reference lyft converter
(reference: mmdetection3d/tools/data_converter/lyft_converter.py:18-212 —
``create_lyft_infos`` / ``_fill_trainval_infos``). Lyft ships the same
token-indexed JSON schema as nuScenes, so this reuses the devkit-free
``NuScenesTables`` reader; differences from nuScenes: tables live under
``{root}/{version}/{version}``, GT boxes are 7-dim (no velocity), the
train/val split comes from name lists instead of the official splits, and
the category set is the 9 lyft classes.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional, Tuple

import numpy as np

from recondet3d_torch.data.nuscenes.converter import CAM_TYPES, obtain_sensor2top
from recondet3d_torch.data.nuscenes.tables import NuScenesTables, quat_wxyz_to_matrix

__all__ = ["create_lyft_infos", "LYFT_CLASSES"]

LYFT_CLASSES = (
    "car", "truck", "bus", "emergency_vehicle", "other_vehicle",
    "motorcycle", "bicycle", "pedestrian", "animal",
)


def _load_split(root_path: str, name: str) -> Optional[List[str]]:
    path = os.path.join(root_path, f"{name}.txt")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def create_lyft_infos(
    root_path: str,
    info_prefix: str = "lyft",
    version: str = "v1.01-train",
    max_sweeps: int = 10,
    val_scene_names: Optional[List[str]] = None,
) -> Tuple[str, str]:
    """Write {prefix}_infos_train.pkl / _infos_val.pkl
    (reference: lyft_converter.py:18-91). The split comes from
    ``{root}/train.txt`` / ``{root}/val.txt`` when present (the reference
    reads data/lyft/{train,val}.txt), else from ``val_scene_names``, else
    the trailing quarter of scenes."""
    data_root = os.path.join(root_path, version)
    table_dir = os.path.join(data_root, version)
    if not os.path.isdir(table_dir):
        raise FileNotFoundError(
            f"lyft tables not found at {table_dir} (expected the "
            "v1.01-train/v1.01-train JSON-table layout)"
        )
    lyft = NuScenesTables(version, data_root)  # tables at root/version/version
    scene_names = [s["name"] for s in lyft.scene]

    test = "test" in version
    if val_scene_names is None:
        val_scene_names = _load_split(root_path, "val") or []
        if not val_scene_names and not test:
            val_scene_names = scene_names[
                max(len(scene_names) - len(scene_names) // 4, 1):
            ]
    val_scenes = set(val_scene_names) & set(scene_names)

    train_infos, val_infos = [], []
    for sample in lyft.sample:
        lidar_token = sample["data"]["LIDAR_TOP"]
        sd = lyft.get("sample_data", lidar_token)
        cs = lyft.get("calibrated_sensor", sd["calibrated_sensor_token"])
        pose = lyft.get("ego_pose", sd["ego_pose_token"])
        l2e_r_mat = quat_wxyz_to_matrix(cs["rotation"])
        l2e_t = np.asarray(cs["translation"])
        e2g_r_mat = quat_wxyz_to_matrix(pose["rotation"])
        e2g_t = np.asarray(pose["translation"])

        info = {
            "lidar_path": lyft.get_sample_data_path(lidar_token),
            "token": sample["token"],
            "sweeps": [],
            "cams": {},
            "lidar2ego_translation": cs["translation"],
            "lidar2ego_rotation": cs["rotation"],
            "ego2global_translation": pose["translation"],
            "ego2global_rotation": pose["rotation"],
            "timestamp": sample["timestamp"],
        }
        for cam in CAM_TYPES:
            if cam not in sample["data"]:
                continue
            cam_info = obtain_sensor2top(
                lyft, sample["data"][cam], l2e_t, l2e_r_mat, e2g_t, e2g_r_mat, cam
            )
            cam_cs = lyft.get(
                "calibrated_sensor",
                lyft.get("sample_data", sample["data"][cam])[
                    "calibrated_sensor_token"
                ],
            )
            cam_info["cam_intrinsic"] = np.asarray(cam_cs["camera_intrinsic"])
            info["cams"][cam] = cam_info

        sweep_sd = sd
        for _ in range(max_sweeps):
            if not sweep_sd.get("prev"):
                break
            info["sweeps"].append(
                obtain_sensor2top(
                    lyft, sweep_sd["prev"], l2e_t, l2e_r_mat, e2g_t,
                    e2g_r_mat, "lidar",
                )
            )
            sweep_sd = lyft.get("sample_data", sweep_sd["prev"])

        if not test:
            locs, dims, yaws, _, names_raw, npts, _ = lyft.get_boxes_lidar(
                sample["token"]
            )
            # lyft categories are already flat names (reference
            # LyftDataset.NameMapping is identity on its 9 classes)
            gt_boxes = (
                np.concatenate([locs, dims, yaws[:, None]], axis=1)
                if len(locs) else np.zeros((0, 7))
            )
            info["gt_boxes"] = gt_boxes
            info["gt_names"] = np.array(list(names_raw))
            info["num_lidar_pts"] = npts
            info["valid_flag"] = np.ones(len(gt_boxes), bool)  # lyft has no
            # per-annotation point counts in most exports; keep all

        scene = lyft.get("scene", sample["scene_token"])
        if scene["name"] in val_scenes:
            val_infos.append(info)
        else:
            train_infos.append(info)

    metadata = dict(version=version)
    suffix = "test" if test else "train"
    train_path = os.path.join(root_path, f"{info_prefix}_infos_{suffix}.pkl")
    val_path = os.path.join(root_path, f"{info_prefix}_infos_val.pkl")
    with open(train_path, "wb") as f:
        pickle.dump(dict(infos=train_infos, metadata=metadata), f)
    if not test:
        with open(val_path, "wb") as f:
            pickle.dump(dict(infos=val_infos, metadata=metadata), f)
    return train_path, val_path
