"""Port of ``recondet3d/data/export/colmap_io.py`` (numpy, copied as it is: the
same prediction gives the same bytes in both packages).

COLMAP binary model writer/reader (cameras.bin / images.bin /
points3D.bin), written from the public COLMAP format spec.

The reference vendors COLMAP's read_write_model.py (585 LoC) for its
exporter (reference: utils/export/colmap.py:28). Here only the subset the
exporter needs is implemented: PINHOLE cameras, image poses (w2c quat +
t), and subsampled RGB points.
"""

from __future__ import annotations

import os
import struct
from typing import Optional

import numpy as np

__all__ = ["write_colmap_model", "read_cameras_bin", "read_images_bin"]

_PINHOLE_MODEL_ID = 1  # PINHOLE: fx fy cx cy


def _rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> COLMAP wxyz quaternion."""
    K = (
        np.array(
            [
                [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
                [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
                [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
                [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
                 R[0, 0] + R[1, 1] + R[2, 2]],
            ]
        )
        / 3.0
    )
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def write_colmap_model(prediction, export_dir: str, max_points: int = 200000) -> str:
    out = os.path.join(export_dir, "colmap")
    os.makedirs(out, exist_ok=True)
    extr = np.asarray(prediction.extrinsics)  # (N, 3or4, 4) w2c
    intr = np.asarray(prediction.intrinsics)
    depth = np.asarray(prediction.depth)
    N, H, W = depth.shape

    with open(os.path.join(out, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", N))
        for i in range(N):
            fx, fy = intr[i, 0, 0], intr[i, 1, 1]
            cx, cy = intr[i, 0, 2], intr[i, 1, 2]
            f.write(struct.pack("<iiQQ", i + 1, _PINHOLE_MODEL_ID, W, H))
            f.write(struct.pack("<dddd", fx, fy, cx, cy))

    with open(os.path.join(out, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", N))
        for i in range(N):
            q = _rotmat_to_qvec(extr[i, :3, :3])
            t = extr[i, :3, 3]
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<dddd", *q))
            f.write(struct.pack("<ddd", *t))
            f.write(struct.pack("<i", i + 1))
            f.write(f"view_{i:03d}.png".encode() + b"\x00")
            f.write(struct.pack("<Q", 0))  # no 2D points

    from recondet3d_torch.data.export.glb import depths_to_world_points_with_colors

    pts, cols = depths_to_world_points_with_colors(
        depth, intr, extr, images=prediction.processed_images,
        conf=None if prediction.conf is None else np.asarray(prediction.conf),
        sky=None if prediction.sky is None else np.asarray(prediction.sky),
    )
    if len(pts) > max_points:
        sel = np.random.default_rng(0).choice(len(pts), max_points, replace=False)
        pts = pts[sel]
        cols = None if cols is None else cols[sel]
    if cols is None:
        cols = np.full((len(pts), 3), 0.5, np.float32)
    with open(os.path.join(out, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for j in range(len(pts)):
            f.write(struct.pack("<Q", j + 1))
            f.write(struct.pack("<ddd", *pts[j].astype(np.float64)))
            rgb = np.clip(cols[j] * 255, 0, 255).astype(np.uint8)
            f.write(struct.pack("<BBB", *rgb))
            f.write(struct.pack("<d", 1.0))  # error
            f.write(struct.pack("<Q", 0))  # no track
    return out


def read_cameras_bin(path: str):
    cams = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cid, model, w, h = struct.unpack("<iiQQ", f.read(24))
            params = struct.unpack("<dddd", f.read(32))
            cams[cid] = dict(model=model, width=w, height=h, params=params)
    return cams


def read_images_bin(path: str):
    imgs = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            (iid,) = struct.unpack("<i", f.read(4))
            q = struct.unpack("<dddd", f.read(32))
            t = struct.unpack("<ddd", f.read(24))
            (cam_id,) = struct.unpack("<i", f.read(4))
            name = b""
            while True:
                ch = f.read(1)
                if ch == b"\x00":
                    break
                name += ch
            (npts,) = struct.unpack("<Q", f.read(8))
            f.read(npts * 24)
            imgs[iid] = dict(qvec=q, tvec=t, camera_id=cam_id, name=name.decode())
    return imgs
