"""nuScenes -> info-pkl converter (the port's copy of
``recondet3d/data/nuscenes/converter.py``).

Re-implementation of the reference converter
(reference: tools/data_converter/nuscenes_converter.py:27-380 —
``create_nuscenes_infos`` / ``_fill_trainval_infos`` / ``obtain_sensor2top``)
on the self-contained table reader (no devkit). Produces the same info
schema the dataset consumes: per-sample lidar path, per-camera
sensor2lidar rotation/translation + intrinsics, ego/global transforms,
sweeps, GT boxes (x y z w l h yaw vx vy), names, valid flags.

Conventions: ``sensor2lidar_rotation`` is the column-form cam->lidar
rotation A with points transforming as ``p_lidar = p_cam @ A.T + t``
(identical numbers to the reference's obtain_sensor2top chain,
nuscenes_converter.py:362-380).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

from recondet3d_torch.data.nuscenes.tables import NuScenesTables, quat_wxyz_to_matrix

__all__ = ["create_nuscenes_infos", "obtain_sensor2top", "CAM_TYPES"]

CAM_TYPES = [
    "CAM_FRONT",
    "CAM_FRONT_RIGHT",
    "CAM_FRONT_LEFT",
    "CAM_BACK",
    "CAM_BACK_LEFT",
    "CAM_BACK_RIGHT",
]

# official mini/trainval split scene names are resolved from scene.json

DEFAULT_CLASS_MAP = {
    "vehicle.car": "car",
    "vehicle.truck": "truck",
    "vehicle.construction": "construction_vehicle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.trailer": "trailer",
    "movable_object.barrier": "barrier",
    "vehicle.motorcycle": "motorcycle",
    "vehicle.bicycle": "bicycle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "movable_object.trafficcone": "traffic_cone",
}


def obtain_sensor2top(
    nusc: NuScenesTables,
    sensor_token: str,
    l2e_t: np.ndarray,
    l2e_r_mat: np.ndarray,
    e2g_t: np.ndarray,
    e2g_r_mat: np.ndarray,
    sensor_type: str = "lidar",
) -> dict:
    """Sensor->TopLiDAR transform via sensor->ego->global->ego'->lidar.

    Returns the reference schema with ``sensor2lidar_rotation`` = A
    (column cam->lidar) and ``sensor2lidar_translation`` = t such that
    ``p_lidar = p_sensor @ A.T + t``."""
    sd = nusc.get("sample_data", sensor_token)
    cs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
    pose = nusc.get("ego_pose", sd["ego_pose_token"])

    s2e_r = quat_wxyz_to_matrix(cs["rotation"])
    s2e_t = np.asarray(cs["translation"])
    e2g_r_s = quat_wxyz_to_matrix(pose["rotation"])
    e2g_t_s = np.asarray(pose["translation"])

    # column-form composition: A = L^T E^T E_s C ; t = L^T(E^T(E_s c + g_s - g) - l)
    A = l2e_r_mat.T @ e2g_r_mat.T @ e2g_r_s @ s2e_r
    t = l2e_r_mat.T @ (e2g_r_mat.T @ (e2g_r_s @ s2e_t + e2g_t_s - e2g_t) - l2e_t)

    return {
        "data_path": nusc.get_sample_data_path(sd["token"]),
        "type": sensor_type,
        "sample_data_token": sd["token"],
        "sensor2ego_translation": cs["translation"],
        "sensor2ego_rotation": cs["rotation"],
        "ego2global_translation": pose["translation"],
        "ego2global_rotation": pose["rotation"],
        "timestamp": sd["timestamp"],
        "sensor2lidar_rotation": A,
        "sensor2lidar_translation": t,
    }


def _fill_trainval_infos(
    nusc: NuScenesTables,
    train_scenes: set,
    val_scenes: set,
    max_sweeps: int = 10,
) -> Tuple[List[dict], List[dict]]:
    train_infos, val_infos = [], []
    for sample in nusc.sample:
        lidar_token = sample["data"]["LIDAR_TOP"]
        sd = nusc.get("sample_data", lidar_token)
        cs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
        pose = nusc.get("ego_pose", sd["ego_pose_token"])
        l2e_r_mat = quat_wxyz_to_matrix(cs["rotation"])
        l2e_t = np.asarray(cs["translation"])
        e2g_r_mat = quat_wxyz_to_matrix(pose["rotation"])
        e2g_t = np.asarray(pose["translation"])

        info = {
            "lidar_path": nusc.get_sample_data_path(lidar_token),
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
                nusc, sample["data"][cam], l2e_t, l2e_r_mat, e2g_t, e2g_r_mat, cam
            )
            cam_cs = nusc.get(
                "calibrated_sensor",
                nusc.get("sample_data", sample["data"][cam])["calibrated_sensor_token"],
            )
            cam_info["cam_intrinsic"] = np.asarray(cam_cs["camera_intrinsic"])
            info["cams"][cam] = cam_info

        # lidar sweeps (previous frames)
        sweep_sd = sd
        for _ in range(max_sweeps):
            if not sweep_sd.get("prev"):
                break
            sweep = obtain_sensor2top(
                nusc, sweep_sd["prev"], l2e_t, l2e_r_mat, e2g_t, e2g_r_mat, "lidar"
            )
            info["sweeps"].append(sweep)
            sweep_sd = nusc.get("sample_data", sweep_sd["prev"])

        # annotations
        locs, dims, yaws, vels, names_raw, npts, _ = nusc.get_boxes_lidar(sample["token"])
        names = np.array([DEFAULT_CLASS_MAP.get(n, n) for n in names_raw])
        # gt box: x y z w l h yaw (+vx vy)
        gt_boxes = np.concatenate([locs, dims, yaws[:, None]], axis=1) if len(locs) else \
            np.zeros((0, 7))
        info["gt_boxes"] = gt_boxes
        info["gt_names"] = names
        info["gt_velocity"] = vels.reshape(-1, 2)
        info["num_lidar_pts"] = npts
        info["valid_flag"] = npts > 0

        scene = nusc.get("scene", sample["scene_token"])
        info["scene_name"] = scene["name"]
        if scene["name"] in train_scenes:
            train_infos.append(info)
        elif scene["name"] in val_scenes:
            val_infos.append(info)
        else:  # unknown scene -> train (mini splits cover all)
            train_infos.append(info)
    return train_infos, val_infos


def create_nuscenes_infos(
    root_path: str,
    info_prefix: str = "nuscenes",
    version: str = "v1.0-mini",
    max_sweeps: int = 10,
    val_scene_names: Optional[List[str]] = None,
) -> Tuple[str, str]:
    """Write {prefix}_infos_train.pkl / _infos_val.pkl
    (reference: nuscenes_converter.py:27 create_nuscenes_infos)."""
    nusc = NuScenesTables(version, root_path)
    scene_names = [s["name"] for s in nusc.scene]
    if val_scene_names is None:
        if version == "v1.0-mini":
            # official mini_val split
            val_scene_names = ["scene-0103", "scene-0916"]
        else:
            val_scene_names = scene_names[max(len(scene_names) - len(scene_names) // 4, 1):]
    val_scenes = set(val_scene_names) & set(scene_names)
    train_scenes = set(scene_names) - val_scenes

    train_infos, val_infos = _fill_trainval_infos(
        nusc, train_scenes, val_scenes, max_sweeps=max_sweeps
    )
    metadata = dict(version=version)
    train_path = os.path.join(root_path, f"{info_prefix}_infos_train.pkl")
    val_path = os.path.join(root_path, f"{info_prefix}_infos_val.pkl")
    with open(train_path, "wb") as f:
        pickle.dump(dict(infos=train_infos, metadata=metadata), f)
    with open(val_path, "wb") as f:
        pickle.dump(dict(infos=val_infos, metadata=metadata), f)
    return train_path, val_path
