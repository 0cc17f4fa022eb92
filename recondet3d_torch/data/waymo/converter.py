"""Waymo (KITTI-format) -> info-pkl converter (the port's copy of
``recondet3d/data/waymo/converter.py``: host numpy, as there).

The reference converts Waymo in two stages
(reference: tools/data_converter/waymo_converter.py Waymo2KITTI:23-369 —
TFRecords -> KITTI-format files via the waymo-open-dataset + tensorflow
readers; then kitti_converter.create_waymo_info_file:150-240 builds the
info pkls from that layout). The TFRecord stage needs packages absent
from this environment, so it is gated with a clear error; this module
implements the second stage over the extracted layout:

  root/ImageSets/{train,val,test}.txt
  root/training/{velodyne,calib,label_all,pose,image_0..4}/*

Waymo specifics vs KITTI: 6-feature lidar points (x y z intensity
elongation timestamp), per-frame ego pose, 5 cameras, labels already in
the label_all convention, and num_points_in_gt counted from the bins.
"""

from __future__ import annotations

import os
import pickle
from typing import List

import numpy as np

from recondet3d_torch.data.kitti.converter import (
    camera_to_lidar_boxes,
    parse_calib,
    parse_label,
)

__all__ = ["create_waymo_infos", "convert_tfrecords"]

NUM_POINT_FEATURES = 6
N_CAMERAS = 5


# vehicle frame (x fwd, y left, z up) -> KITTI camera frame (x right,
# y down, z fwd); the exact inverse of camera_to_lidar_boxes with R0=I.
_VEH2CAM = np.array(
    [[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]]
)
# waymo label type enum value -> KITTI-style class name
_WAYMO_CLASSES = {1: "Car", 2: "Pedestrian", 3: "Sign", 4: "Cyclist"}


def _default_parse_points(frame) -> np.ndarray:
    """First-return point cloud of one Frame as (N, 6) x y z intensity
    elongation timestamp rows via the waymo-open-dataset range-image
    utilities (reference: waymo_converter.py save_lidar:214-247)."""
    from waymo_open_dataset.utils import frame_utils

    parsed = frame_utils.parse_range_image_and_camera_projection(frame)
    range_images, camera_projections = parsed[0], parsed[1]
    range_image_top_pose = parsed[-1]
    points, _ = frame_utils.convert_range_image_to_point_cloud(
        frame, range_images, camera_projections, range_image_top_pose,
        keep_polar_features=True,
    )
    # rows are (range, intensity, elongation, x, y, z) per return
    feats = np.concatenate(points, axis=0) if points else np.zeros((0, 6))
    out = np.zeros((len(feats), NUM_POINT_FEATURES), np.float32)
    out[:, :3] = feats[:, 3:6]
    out[:, 3] = np.tanh(feats[:, 1])  # intensity, squashed like the devkit
    out[:, 4] = feats[:, 2]
    return out


def _write_frame_kitti(frame, root: str, sid: str, parse_points_fn) -> None:
    """Write ONE Frame proto into the KITTI-format layout consumed by
    create_waymo_infos (velodyne/calib/label_all/pose/image_0..4)."""
    tdir = os.path.join(root, "training")
    for d in ("velodyne", "calib", "label_all", "pose"):
        os.makedirs(os.path.join(tdir, d), exist_ok=True)

    pts = np.asarray(parse_points_fn(frame), np.float32)
    pts.tofile(os.path.join(tdir, "velodyne", f"{sid}.bin"))

    np.savetxt(
        os.path.join(tdir, "pose", f"{sid}.txt"),
        np.array(frame.pose.transform, np.float64).reshape(4, 4),
    )

    # calib: per-camera P matrices from the rig intrinsics; the canonical
    # axis swap as Tr_velo_to_cam so labels below round-trip exactly
    # through parse_calib/camera_to_lidar_boxes.
    cams = sorted(frame.context.camera_calibrations, key=lambda c: c.name)
    lines = []
    for i in range(4):
        if i < len(cams):
            fu, fv, cu, cv = cams[i].intrinsic[:4]
        else:
            fu = fv = 1.0
            cu = cv = 0.0
        P = np.array([[fu, 0, cu, 0], [0, fv, cv, 0], [0, 0, 1, 0]])
        lines.append(f"P{i}: " + " ".join(f"{v:.12e}" for v in P.ravel()))
    lines.append("R0_rect: 1 0 0 0 1 0 0 0 1")
    lines.append(
        "Tr_velo_to_cam: "
        + " ".join(f"{v:g}" for v in np.hstack([_VEH2CAM, np.zeros((3, 1))]).ravel())
    )
    with open(os.path.join(tdir, "calib", f"{sid}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")

    # labels: waymo laser labels are vehicle-frame center boxes with a +z
    # heading; KITTI wants camera-frame BOTTOM-center, dims h w l, and
    # ry = -heading - pi/2 (inverse of camera_to_lidar_boxes).
    with open(os.path.join(tdir, "label_all", f"{sid}.txt"), "w") as f:
        for lab in frame.laser_labels:
            name = _WAYMO_CLASSES.get(lab.type)
            if name is None:
                continue
            b = lab.box
            bottom_veh = np.array(
                [b.center_x, b.center_y, b.center_z - b.height / 2.0]
            )
            loc = _VEH2CAM @ bottom_veh
            ry = -b.heading - np.pi / 2.0
            f.write(
                f"{name} 0 0 -10 0 0 50 50 "
                f"{b.height:.4f} {b.width:.4f} {b.length:.4f} "
                f"{loc[0]:.4f} {loc[1]:.4f} {loc[2]:.4f} {ry:.4f}\n"
            )

    for i, im in enumerate(frame.images):
        try:
            import cv2

            arr = cv2.imdecode(
                np.frombuffer(im.image, np.uint8), cv2.IMREAD_COLOR
            )
            cam_idx = im.name - 1  # proto camera names are 1-based
            d = os.path.join(tdir, f"image_{cam_idx}")
            os.makedirs(d, exist_ok=True)
            cv2.imwrite(os.path.join(d, f"{sid}.png"), arr)
        except Exception:
            pass  # images are optional for the lidar pipeline


def convert_tfrecords(
    tfrecord_paths,
    out_root: str,
    split: str = "train",
    parse_points_fn=None,
) -> List[str]:
    """TFRecords -> KITTI-format layout (reference:
    waymo_converter.py Waymo2KITTI:23-369). Requires the
    waymo-open-dataset and tensorflow packages for the proto parse and
    range-image decode; raises ImportError with guidance when absent.

    ``parse_points_fn(frame) -> (N, 6) float32`` overrides the
    range-image decoder (used by tests to exercise the layout plumbing
    without real range images). Returns the written frame ids.
    """
    try:
        from waymo_open_dataset import dataset_pb2  # before tensorflow, whose import alone takes seconds
        import tensorflow as tf
    except ImportError as e:  # env without the waymo deps
        raise ImportError(
            "Waymo TFRecord extraction requires the waymo-open-dataset and "
            "tensorflow packages (reference: waymo_converter.py Waymo2KITTI). "
            "Extract to the KITTI-format layout elsewhere, then run "
            "create_waymo_infos() on it."
        ) from e

    parse_points_fn = parse_points_fn or _default_parse_points
    ids = []
    for path in (
        [tfrecord_paths] if isinstance(tfrecord_paths, str) else tfrecord_paths
    ):
        for rec in tf.data.TFRecordDataset(path, compression_type=""):
            frame = dataset_pb2.Frame()
            frame.ParseFromString(bytearray(rec.numpy()))
            sid = f"{len(ids):07d}"
            _write_frame_kitti(frame, out_root, sid, parse_points_fn)
            ids.append(sid)
    os.makedirs(os.path.join(out_root, "ImageSets"), exist_ok=True)
    with open(os.path.join(out_root, "ImageSets", f"{split}.txt"), "w") as f:
        f.write("\n".join(ids) + ("\n" if ids else ""))
    return ids


def _count_points_in_boxes(lidar_path: str, gt_boxes: np.ndarray) -> np.ndarray:
    if not os.path.exists(lidar_path) or len(gt_boxes) == 0:
        return np.full(len(gt_boxes), -1)
    pts = np.fromfile(lidar_path, np.float32).reshape(-1, NUM_POINT_FEATURES)[:, :3]
    counts = []
    for b in gt_boxes:
        c, s = np.cos(b[6]), np.sin(b[6])
        px = pts[:, 0] - b[0]
        py = pts[:, 1] - b[1]
        lx = px * c + py * s
        ly = -px * s + py * c
        inside = (
            (np.abs(lx) <= b[3] / 2) & (np.abs(ly) <= b[4] / 2)
            & (pts[:, 2] >= b[2]) & (pts[:, 2] <= b[2] + b[5])
        )
        counts.append(int(inside.sum()))
    return np.asarray(counts)


def create_waymo_infos(
    root_path: str,
    info_prefix: str = "waymo",
    splits=("train", "val"),
    count_points: bool = True,
) -> List[str]:
    """(reference: kitti_converter.create_waymo_info_file:150-240)."""
    out_paths = []
    for split in splits:
        idx_file = os.path.join(root_path, "ImageSets", f"{split}.txt")
        if not os.path.exists(idx_file):
            continue
        with open(idx_file) as f:
            ids = [ln.strip() for ln in f if ln.strip()]
        infos = []
        for sid in ids:
            tdir = os.path.join(root_path, "training")
            calib = parse_calib(os.path.join(tdir, "calib", f"{sid}.txt"))
            label_path = os.path.join(tdir, "label_all", f"{sid}.txt")
            objs = parse_label(label_path) if os.path.exists(label_path) else []
            objs = [o for o in objs if o["name"] != "DontCare"]
            gt_boxes = camera_to_lidar_boxes(objs, calib)
            lidar_path = os.path.join(tdir, "velodyne", f"{sid}.bin")
            pose_path = os.path.join(tdir, "pose", f"{sid}.txt")
            pose = (
                np.loadtxt(pose_path).reshape(4, 4)
                if os.path.exists(pose_path) else np.eye(4)
            )
            npts = (
                _count_points_in_boxes(lidar_path, gt_boxes)
                if count_points else np.full(len(gt_boxes), -1)
            )
            infos.append(dict(
                token=sid,
                lidar_path=lidar_path,
                image_paths=[
                    os.path.join(tdir, f"image_{c}", f"{sid}.png")
                    for c in range(N_CAMERAS)
                ],
                calib=dict(calib),
                pose=pose,
                gt_boxes=gt_boxes,
                gt_names=np.array([o["name"] for o in objs]),
                gt_bboxes_2d=np.stack([o["bbox"] for o in objs])
                if objs else np.zeros((0, 4)),
                num_lidar_pts=npts,
                valid_flag=(npts != 0) if count_points
                else np.ones(len(gt_boxes), bool),
                num_point_features=NUM_POINT_FEATURES,
                timestamp=0,
                sweeps=[],
            ))
        path = os.path.join(root_path, f"{info_prefix}_infos_{split}.pkl")
        with open(path, "wb") as f:
            pickle.dump(
                dict(infos=infos, metadata=dict(version=f"waymo-{split}")), f
            )
        out_paths.append(path)
    return out_paths
