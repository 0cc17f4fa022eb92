"""Per-sample DA3 inference over raw nuScenes with GT-extrinsics fusion
(port of ``recondet3d/cli/inference_nuscenes.py``).

    python -m recondet3d_torch.cli.inference_nuscenes --dataroot data/nuscenes --max-samples 1 [--device cpu]

For each sample: the six camera images through ``DepthAnything3.inference``,
every view unprojected with the predicted intrinsics (numpy, on the host)
and moved into the LiDAR frame by the GT cam2lidar chain, then the point
pipeline on the model's device: voxel centroids, FPS anchors with their
ball-query union, FPS to ``--num-points``; one PCD a sample. The JAX CLI's
arguments and defaults, plus ``--device`` (default ``cuda``). A cloud whose
buffer holds no more rows than ``--anchor-points`` or ``--num-points``
passes those stages unsampled (the JAX CLI raises there; an empty
cloud, every pixel sky, writes an empty PCD).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from recondet3d_torch.utils.logger import get_logger

logger = get_logger("recondet3d_torch.inference_nuscenes")

__all__ = ["CAM_TYPES", "parse_args", "get_nusc_info", "run_inference_for_frame", "main"]

CAM_TYPES = [
    "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
    "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT",
]
POINT_CLOUD_RANGE = (-54.0, -54.0, -5.0, 54.0, 54.0, 6.0)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DA3 inference over raw nuScenes")
    p.add_argument("--dataroot", required=True)
    p.add_argument("--version", default="v1.0-mini")
    p.add_argument("--model", default="depth-anything/DA3NESTED-GIANT-LARGE")
    p.add_argument("--cache-dir", default="ckpts")
    p.add_argument("--out-dir", default="output")
    p.add_argument("--max-samples", type=int, default=1)
    p.add_argument("--max-depth", type=float, default=100.0)
    p.add_argument("--conf-thresh-percentile", type=float, default=30.0)
    p.add_argument("--num-points", type=int, default=40000)
    p.add_argument("--anchor-points", type=int, default=25000)
    p.add_argument("--voxel-size", type=float, default=0.1)
    p.add_argument("--process-res", type=int, default=504)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def get_nusc_info(nusc, sample):
    """Per-camera cam2lidar R/t via the sensor2top chain
    (reference: inference_nuscenes.py:33-95 get_nusc_info)."""
    from recondet3d_torch.data.nuscenes import obtain_sensor2top, quat_wxyz_to_matrix

    lidar_sd = nusc.get("sample_data", sample["data"]["LIDAR_TOP"])
    cs = nusc.get("calibrated_sensor", lidar_sd["calibrated_sensor_token"])
    pose = nusc.get("ego_pose", lidar_sd["ego_pose_token"])
    l2e_r = quat_wxyz_to_matrix(cs["rotation"])
    l2e_t = np.asarray(cs["translation"])
    e2g_r = quat_wxyz_to_matrix(pose["rotation"])
    e2g_t = np.asarray(pose["translation"])
    info = {}
    for cam in CAM_TYPES:
        if cam not in sample["data"]:
            continue
        info[cam] = obtain_sensor2top(nusc, sample["data"][cam], l2e_t, l2e_r, e2g_t, e2g_r, cam)
    return info


def fuse_views(pred, cam_infos, args) -> np.ndarray:
    """Every view's valid pixels (0 < depth <= max_depth, confidence at or
    above its percentile, not sky) unprojected with the predicted intrinsics
    and moved into the LiDAR frame: (P, 3) float32."""
    all_pts = []
    N, H, W = pred.depth.shape
    uu, vv = np.meshgrid(np.arange(W), np.arange(H))
    for i, cam in enumerate([c for c in CAM_TYPES if c in cam_infos]):
        z = pred.depth[i]
        K = pred.intrinsics[i]
        x = (uu - K[0, 2]) * z / K[0, 0]
        y = (vv - K[1, 2]) * z / K[1, 1]
        pts = np.stack([x, y, z], -1).reshape(-1, 3)
        valid = (z > 0).reshape(-1) & (z <= args.max_depth).reshape(-1)
        if pred.conf is not None:
            thr = np.percentile(pred.conf[i], args.conf_thresh_percentile)
            valid &= (pred.conf[i] >= thr).reshape(-1)
        if pred.sky is not None:
            valid &= ~pred.sky[i].reshape(-1)
        pts = pts[valid]
        A = np.asarray(cam_infos[cam]["sensor2lidar_rotation"])
        t = np.asarray(cam_infos[cam]["sensor2lidar_translation"])
        all_pts.append(pts @ A.T + t)
    return np.concatenate(all_pts).astype(np.float32)


def pad_points(pts: np.ndarray):
    """The cloud in a buffer of the next power of two rows (at least 1) and
    its validity mask: (buf (cap, 3), valid (cap,), cap)."""
    cap = 1 << int(np.ceil(np.log2(max(len(pts), 1))))
    buf = np.zeros((cap, 3), np.float32)
    buf[: len(pts)] = pts
    return buf, np.arange(cap) < len(pts), cap


def point_transforms(args, cap: int):
    """The pipeline's three stages for a ``cap``-row buffer."""
    return [
        dict(type="VoxelDownsample", voxel_size=(args.voxel_size,) * 3, point_cloud_range=POINT_CLOUD_RANGE,
             max_voxels=min(cap, 1 << 18)),
        dict(type="BallQueryDownsample", anchor_points=args.anchor_points, max_radius=0.5, sample_num=16),
        dict(type="FPSDownsample", num_points=args.num_points),
    ]


def run_inference_for_frame(model, cam_infos, args):
    """DA3 on the 6 camera images -> fused LiDAR-frame point cloud
    (reference: inference_nuscenes.py:658-856 run_inference_for_frame +
    load_point_cloud_from_prediction). The pipeline runs on the model's
    device; the cloud comes back as numpy. The valid points after each
    stage are logged."""
    from recondet3d_torch.data.pipelines.point_pipeline import PointPipeline

    paths = [cam_infos[c]["data_path"] for c in CAM_TYPES if c in cam_infos]
    pred = model.inference(paths, process_res=args.process_res)
    pts = fuse_views(pred, cam_infos, args)
    buf, valid, cap = pad_points(pts)
    pipeline = PointPipeline(point_transforms(args, cap))
    out, msk = pipeline(torch.from_numpy(buf).to(model.device), torch.from_numpy(valid).to(model.device))
    out = out[msk].cpu().numpy()
    logger.info("valid points: fused %d of %d rows, " % (len(pts), cap)
                + ", ".join(f"{kind} {int(n)}" for kind, n in pipeline.last_counts))
    return out


def main(argv=None):
    from recondet3d_torch.api import DepthAnything3
    from recondet3d_torch.data.export import write_pcd
    from recondet3d_torch.data.nuscenes import NuScenesTables

    args = parse_args(argv)
    nusc = NuScenesTables(args.version, args.dataroot)
    model = DepthAnything3.from_pretrained(args.model, cache_dir=args.cache_dir, device=args.device)
    os.makedirs(args.out_dir, exist_ok=True)

    for i, sample in enumerate(nusc.sample):
        if i >= args.max_samples:
            break
        cam_infos = get_nusc_info(nusc, sample)
        pts = run_inference_for_frame(model, cam_infos, args)
        path = os.path.join(args.out_dir, f"sample_{i}_points.pcd")
        write_pcd(path, pts)
        print(f"wrote {path} ({len(pts)} points)", flush=True)
    return 0


if __name__ == "__main__":
    main()
