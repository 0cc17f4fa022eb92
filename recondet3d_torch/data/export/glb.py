"""Port of ``recondet3d/data/export/glb.py`` (numpy, copied as it is: the
same prediction gives the same bytes in both packages).

GLB (binary glTF 2.0) point-cloud exporter, written from scratch.

The reference exports GLB scenes through trimesh (reference:
depth_anything_3/utils/export/glb.py:52-432 — depth->world points +
colors, confidence-percentile and sky filters, <=1M point cap, camera
frusta). trimesh is not in this image, so the GLB container (JSON chunk +
BIN chunk, POSITION/COLOR_0 accessors, POINTS primitives and LINES
frusta) is emitted directly.
"""

from __future__ import annotations

import json
import struct
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["export_to_glb", "depths_to_world_points_with_colors", "write_glb_pointcloud"]


def _align4(b: bytes, pad: bytes = b"\x00") -> bytes:
    return b + pad * ((4 - len(b) % 4) % 4)


def write_glb_pointcloud(
    path: str,
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    extra_lines: Optional[List[Tuple[np.ndarray, np.ndarray]]] = None,
) -> None:
    """points (N, 3) float32; colors (N, 3) in [0,1]; extra_lines: list of
    (vertices (M,3), segments (K,2) int) polylines (camera frusta). With
    N = 0 the file holds the polylines only."""
    points = np.asarray(points, np.float32)
    buffers = []
    accessors = []
    buffer_views = []
    meshes = []
    nodes = []
    offset = 0

    def add_view(data: bytes, target=None):
        nonlocal offset
        view = dict(buffer=0, byteOffset=offset, byteLength=len(data))
        if target:
            view["target"] = target
        buffer_views.append(view)
        buffers.append(_align4(data))
        offset += len(_align4(data))
        return len(buffer_views) - 1

    def add_accessor(view, comp_type, count, type_, mn=None, mx=None):
        acc = dict(bufferView=view, componentType=comp_type, count=count, type=type_)
        if mn is not None:
            acc["min"] = mn
            acc["max"] = mx
        accessors.append(acc)
        return len(accessors) - 1

    # main point cloud; none where the filters kept no point (glTF has no empty accessor): the cameras alone
    if len(points):
        pview = add_view(points.tobytes(), target=34962)
        pacc = add_accessor(
            pview, 5126, len(points), "VEC3",
            points.min(0).tolist(), points.max(0).tolist(),
        )
        attrs = {"POSITION": pacc}
        if colors is not None:
            c = np.clip(np.asarray(colors, np.float32), 0, 1)
            cview = add_view(c.tobytes(), target=34962)
            attrs["COLOR_0"] = add_accessor(cview, 5126, len(c), "VEC3")
        meshes.append(dict(primitives=[dict(attributes=attrs, mode=0)]))  # POINTS
        nodes.append(dict(mesh=0))

    for verts, segs in extra_lines or []:
        verts = np.asarray(verts, np.float32)
        segs = np.asarray(segs, np.uint32)
        vv = add_view(verts.tobytes(), target=34962)
        va = add_accessor(vv, 5126, len(verts), "VEC3",
                          verts.min(0).tolist(), verts.max(0).tolist())
        iv = add_view(segs.tobytes(), target=34963)
        ia = add_accessor(iv, 5125, segs.size, "SCALAR")
        meshes.append(dict(primitives=[dict(attributes={"POSITION": va},
                                            indices=ia, mode=1)]))  # LINES
        nodes.append(dict(mesh=len(meshes) - 1))

    bin_chunk = b"".join(buffers)
    gltf = dict(
        asset=dict(version="2.0", generator="recondet3d"),
        scene=0,
        scenes=[dict(nodes=list(range(len(nodes))))],
        nodes=nodes,
        meshes=meshes,
        buffers=[dict(byteLength=len(bin_chunk))],
        bufferViews=buffer_views,
        accessors=accessors,
    )
    json_chunk = _align4(json.dumps(gltf).encode(), b" ")
    total = 12 + 8 + len(json_chunk) + 8 + len(bin_chunk)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(json_chunk), 0x4E4F534A))
        f.write(json_chunk)
        f.write(struct.pack("<II", len(bin_chunk), 0x004E4942))
        f.write(bin_chunk)


def _camera_frustum(extr_w2c: np.ndarray, intr: np.ndarray, hw, scale: float = 0.3):
    """Frustum polyline for one camera (reference: glb.py camera frusta)."""
    H, W = hw
    c2w = np.eye(4)
    R = extr_w2c[:3, :3]
    t = extr_w2c[:3, 3]
    c2w[:3, :3] = R.T
    c2w[:3, 3] = -R.T @ t
    fx, fy = intr[0, 0], intr[1, 1]
    cx, cy = intr[0, 2], intr[1, 2]
    corners_px = np.array([[0, 0], [W, 0], [W, H], [0, H]], np.float64)
    rays = np.stack(
        [(corners_px[:, 0] - cx) / fx, (corners_px[:, 1] - cy) / fy,
         np.ones(4)], axis=1
    )
    pts_cam = np.concatenate([np.zeros((1, 3)), rays * scale])
    pts_w = pts_cam @ c2w[:3, :3].T + c2w[:3, 3]
    segs = np.array([[0, 1], [0, 2], [0, 3], [0, 4], [1, 2], [2, 3], [3, 4], [4, 1]])
    return pts_w.astype(np.float32), segs


def depths_to_world_points_with_colors(
    depth: np.ndarray,  # (N, H, W)
    intrinsics: np.ndarray,  # (N, 3, 3)
    extrinsics: np.ndarray,  # (N, 3or4, 4) w2c
    images: Optional[np.ndarray] = None,  # (N, H, W, 3) uint8
    conf: Optional[np.ndarray] = None,
    sky: Optional[np.ndarray] = None,
    conf_thresh_percentile: float = 30.0,
    max_depth: Optional[float] = 100.0,
    filter_sky: bool = True,
):
    """Unproject depths to world points + colors with the reference's
    filters (reference: glb.py:205-320 _depths_to_world_points_with_colors)."""
    N, H, W = depth.shape
    uu, vv = np.meshgrid(np.arange(W), np.arange(H))
    pts_all, col_all = [], []
    for i in range(N):
        z = depth[i]
        fx, fy = intrinsics[i, 0, 0], intrinsics[i, 1, 1]
        cx, cy = intrinsics[i, 0, 2], intrinsics[i, 1, 2]
        x = (uu - cx) * z / fx
        y = (vv - cy) * z / fy
        pts_cam = np.stack([x, y, z], axis=-1).reshape(-1, 3)
        valid = np.isfinite(z).reshape(-1) & (z.reshape(-1) > 0)
        if max_depth is not None:
            valid &= z.reshape(-1) <= max_depth
        if conf is not None and conf_thresh_percentile:
            thr = np.percentile(conf[i], conf_thresh_percentile)
            valid &= conf[i].reshape(-1) >= thr
        if filter_sky and sky is not None:
            valid &= ~sky[i].reshape(-1).astype(bool)
        R = extrinsics[i, :3, :3]
        t = extrinsics[i, :3, 3]
        c2w_R, c2w_t = R.T, -R.T @ t
        pts_w = pts_cam[valid] @ c2w_R.T + c2w_t
        pts_all.append(pts_w.astype(np.float32))
        if images is not None:
            col = images[i].reshape(-1, 3)[valid].astype(np.float32)
            if col.size and col.max() > 1.5:
                col = col / 255.0
            col_all.append(col)
    pts = np.concatenate(pts_all) if pts_all else np.zeros((0, 3), np.float32)
    cols = np.concatenate(col_all) if col_all else None
    return pts, cols


def export_to_glb(
    path: str,
    prediction,
    max_points: int = 1_000_000,
    conf_thresh_percentile: float = 30.0,
    max_depth: Optional[float] = 100.0,
    filter_sky: bool = True,
    show_cameras: bool = True,
    rng_seed: int = 0,
) -> str:
    """Prediction -> .glb scene (reference: glb.py:52-203 export_to_glb)."""
    pts, cols = depths_to_world_points_with_colors(
        np.asarray(prediction.depth),
        np.asarray(prediction.intrinsics),
        np.asarray(prediction.extrinsics),
        images=prediction.processed_images,
        conf=None if prediction.conf is None else np.asarray(prediction.conf),
        sky=None if prediction.sky is None else np.asarray(prediction.sky),
        conf_thresh_percentile=conf_thresh_percentile,
        max_depth=max_depth,
        filter_sky=filter_sky,
    )
    if len(pts) > max_points:
        sel = np.random.default_rng(rng_seed).choice(len(pts), max_points, replace=False)
        pts = pts[sel]
        cols = None if cols is None else cols[sel]
    frusta = []
    if show_cameras and prediction.extrinsics is not None:
        H, W = np.asarray(prediction.depth).shape[-2:]
        for i in range(len(prediction.extrinsics)):
            frusta.append(
                _camera_frustum(
                    np.asarray(prediction.extrinsics[i]),
                    np.asarray(prediction.intrinsics[i]), (H, W),
                )
            )
    write_glb_pointcloud(path, pts, cols, frusta)
    return path
