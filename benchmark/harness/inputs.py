"""The benchmark's inputs, made from the seed: camera images, the rig's
camera-to-LiDAR transforms, depth maps anchored on a real street cloud, and
GT LiDAR points for training.

``rig_cam2lidar`` and ``anchor_depth`` are copies of
``recondet3d_torch/data/anchor_scene.py``: the six-camera rig of a
nuScenes-like vehicle and per-view depth maps z-buffered from
``benchmark/data/reference_points.npz`` (a copy of
``assets/bench_sample/reference_points.npz``), so that the point path sees
the density and extent of a real scene while DA3 runs on the images.
Images are uniform noise in 0..255, as ``bench.py``'s are.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference.input_processor import compute_process_shape

__all__ = ["rig_cam2lidar", "anchor_depth", "make_pool", "sub_seed"]

REFERENCE_POINTS = Path(__file__).resolve().parents[1] / "data" / "reference_points.npz"
# yaws of FRONT, FRONT_LEFT, FRONT_RIGHT, BACK, BACK_LEFT, BACK_RIGHT
RIG_YAWS = np.deg2rad([0.0, 55.0, -55.0, 180.0, 110.0, -110.0])
# camera optical frame (x right, y down, z forward) -> vehicle / LiDAR frame (x forward, y left, z up)
_R_CAM2VEH = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
_IMG_H, _IMG_W, _FOCAL = 900, 1600, 1266.0  # nominal nuScenes camera


def sub_seed(seed: int, *parts: int) -> int:
    """A seed of its own for each part of a run, within 63 bits."""
    s = int(seed) % 2 ** 61
    for p in parts:
        s = (s * 1000003 + int(p) + 1) % 2 ** 61
    return s


def rig_cam2lidar(batch: int = 1, views: int = 6) -> np.ndarray:
    """(batch, views, 4, 4) fp32 camera -> LiDAR transforms, row-vector
    convention (p_lidar = p_cam @ M[:3, :3].T + M[3, :3]): each camera 1 m
    out along its yaw, 1.5 m up."""
    c2l = np.tile(np.eye(4, dtype=np.float32), (batch, len(RIG_YAWS), 1, 1))
    for i, th in enumerate(RIG_YAWS):
        rz = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]], np.float32)
        c2l[:, i, :3, :3] = rz @ _R_CAM2VEH
        c2l[:, i, 3, :3] = [np.cos(th), np.sin(th), 1.5]
    return c2l[:, :views]


def anchor_depth(points: np.ndarray, c2l: np.ndarray, ph: int, pw: int, seed: int) -> np.ndarray:
    """Z-buffer ``points`` (P, 3; LiDAR frame) into one scene's cameras
    ``c2l`` (views, 4, 4) at (ph, pw): (views, ph, pw) fp32 depth, 0 where no
    point falls. The cloud is resampled with 3 cm jitter to a quarter of the
    pixel count, so the maps are about as dense as a real prediction."""
    n_cams = c2l.shape[0]
    rng = np.random.default_rng(seed)
    pts = points.astype(np.float32)
    n_target = n_cams * ph * pw // 4
    pts = pts[rng.integers(0, len(pts), n_target)] + rng.normal(0, 0.03, (n_target, 3)).astype(np.float32)
    fx, fy = _FOCAL * pw / _IMG_W, _FOCAL * ph / _IMG_H
    cx, cy = pw / 2.0, ph / 2.0
    depth = np.zeros((n_cams, ph, pw), np.float32)
    for n in range(n_cams):
        p_cam = (pts - c2l[n, 3, :3]) @ c2l[n, :3, :3]  # inverse of the row-vector transform
        z = p_cam[:, 2]
        zs = np.maximum(z, 1e-6)
        uf, vf = fx * p_cam[:, 0] / zs + cx, fy * p_cam[:, 1] / zs + cy
        ok = (z > 0.5) & (uf >= 0) & (uf < pw) & (vf >= 0) & (vf < ph)
        flat = np.full(ph * pw, np.inf, np.float32)
        np.minimum.at(flat, vf[ok].astype(np.int32) * pw + uf[ok].astype(np.int32), z[ok])
        depth[n] = np.where(np.isfinite(flat), flat, 0.0).reshape(ph, pw)
    return depth


def make_pool(traffic: Dict, cfg: Dict, seed: int, device, rank: int = 0,
              count: Optional[int] = None) -> List[Dict[str, torch.Tensor]]:
    """``traffic['pool']`` (or the first ``count``) distinct requests or
    training batches of rank ``rank``, each a dict of device tensors: ``img``
    (B, V, H, W, 3) in 0..255, ``cam2lidar_rts`` (B, V, 4, 4), ``depth`` (B, V,
    ph, pw) anchored, and for training ``gt_points`` (B, P, 3) spread over the
    range. Rank 0 draws what a run of one process draws; every other rank
    draws from seeds of its own."""
    B, V = int(traffic["batch"]), int(traffic["views"])
    H, W = traffic["image_hw"]
    rb = cfg["model"]["reconstruction_backbone"]
    cloud = np.load(REFERENCE_POINTS)["points"]
    c2l = rig_cam2lidar(B, V)
    own = (rank,) if rank else ()
    pool = []
    for i in range(int(traffic["pool"]) if count is None else count):
        gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1, i, *own))
        item = {"img": torch.rand((B, V, H, W, 3), generator=gen, device=device) * 255.0,
                "cam2lidar_rts": torch.from_numpy(np.ascontiguousarray(c2l)).to(device)}
        ph, pw = compute_process_shape(H, W, int(rb["process_res"]))[2:]
        depth = np.stack([anchor_depth(cloud, c2l[b], ph, pw, sub_seed(seed, 2, i, b, *own)) for b in range(B)])
        item["depth"] = torch.from_numpy(depth).to(device)
        if traffic["kind"] == "train":
            lo, hi = rb["refinement"]["point_cloud_range"][:3], rb["refinement"]["point_cloud_range"][3:]
            u = torch.rand((B, int(traffic["gt_points"]), 3), generator=gen, device=device)
            lo_t = torch.tensor(lo, device=device) * 0.95
            hi_t = torch.tensor(hi, device=device) * 0.95
            item["gt_points"] = lo_t + u * (hi_t - lo_t)
        pool.append(item)
    return pool
