"""A realistic synthetic scene for runs without real DA3 weights: the
six-camera rig of a nuScenes-like vehicle and per-view depth maps rendered
from a checked-in LiDAR-frame point cloud.

With random weights DA3's depth says nothing about a street scene, so the
point path would be timed on a meaningless cloud. ``anchor_depth`` renders
depth maps by z-buffering a reference point cloud into every camera; fed
to ``ReconstructionBackbone.predict_points(depth_override=...)`` it gives
the point pipeline the density and extent of a real scene while DA3 still
runs on the images. Host-side numpy; set-up work, not part of a request.
"""

from __future__ import annotations

import numpy as np

__all__ = ["RIG_YAWS", "rig_cam2lidar", "anchor_depth"]

# yaws of FRONT, FRONT_LEFT, FRONT_RIGHT, BACK, BACK_LEFT, BACK_RIGHT
RIG_YAWS = np.deg2rad([0.0, 55.0, -55.0, 180.0, 110.0, -110.0])
# camera optical frame (x right, y down, z forward) -> vehicle / LiDAR frame (x forward, y left, z up)
_R_CAM2VEH = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
_IMG_H, _IMG_W, _FOCAL = 900, 1600, 1266.0  # nominal nuScenes camera


def rig_cam2lidar(batch: int = 1) -> np.ndarray:
    """(batch, 6, 4, 4) fp32 camera -> LiDAR transforms in the row-vector
    convention (p_lidar = p_cam @ M[:3, :3].T + M[3, :3]): each camera 1 m
    out along its yaw, 1.5 m up."""
    c2l = np.tile(np.eye(4, dtype=np.float32), (batch, len(RIG_YAWS), 1, 1))
    for i, th in enumerate(RIG_YAWS):
        rz = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]], np.float32)
        c2l[:, i, :3, :3] = rz @ _R_CAM2VEH
        c2l[:, i, 3, :3] = [np.cos(th), np.sin(th), 1.5]
    return c2l


def anchor_depth(points: np.ndarray, c2l: np.ndarray, ph: int, pw: int, batch: int = 1, seed: int = 0) -> np.ndarray:
    """Z-buffer ``points`` (P, 3; LiDAR frame) into the rig's cameras at
    (ph, pw): (batch, 6, ph, pw) fp32 depth, 0 where no point falls.

    The cloud is first resampled with 3 cm jitter to a quarter of the
    pixel count, so that the maps are about as dense as a real prediction
    after range filtering. Scenes beyond the first get a centimetre-scale
    depth offset each, so that no two are equal; holes stay exactly 0.
    """
    n_cams = c2l.shape[1]
    rng = np.random.default_rng(seed)
    pts = points.astype(np.float32)
    n_target = n_cams * ph * pw // 4
    pts = pts[rng.integers(0, len(pts), n_target)] + rng.normal(0, 0.03, (n_target, 3)).astype(np.float32)
    fx, fy = _FOCAL * pw / _IMG_W, _FOCAL * ph / _IMG_H
    cx, cy = pw / 2.0, ph / 2.0
    depth = np.zeros((1, n_cams, ph, pw), np.float32)
    for n in range(n_cams):
        p_cam = (pts - c2l[0, n, 3, :3]) @ c2l[0, n, :3, :3]  # inverse of the row-vector transform
        z = p_cam[:, 2]
        zs = np.maximum(z, 1e-6)
        uf, vf = fx * p_cam[:, 0] / zs + cx, fy * p_cam[:, 1] / zs + cy
        ok = (z > 0.5) & (uf >= 0) & (uf < pw) & (vf >= 0) & (vf < ph)
        flat = np.full(ph * pw, np.inf, np.float32)
        np.minimum.at(flat, vf[ok].astype(np.int32) * pw + uf[ok].astype(np.int32), z[ok])
        depth[0, n] = np.where(np.isfinite(flat), flat, 0.0).reshape(ph, pw)
    if batch > 1:
        depth = np.tile(depth, (batch, 1, 1, 1))
        offset = rng.normal(0, 0.01, (batch, 1, 1, 1)).astype(np.float32)
        depth = np.where(depth > 0, np.maximum(depth + offset, 0.51), 0.0).astype(np.float32)
    return depth
