"""Persisted reconstruction scenes for the web app (port of
``recondet3d/serve/scene_store.py``: the same ``scene.npz`` keys, dtypes and
compression, so a scene saved by either package loads in the other).

The reference gradio app keeps each reconstruction in a workspace dir and
re-reads it for visualization, measurement, and novel-view rendering
(reference: app/gradio_app.py:40-156 workspace/gallery dirs,
app/modules/file_handlers.py, app/modules/visualization.py). Here the
same role is played by one ``scene.npz`` per task dir plus small
stateless functions that turn it into wire payloads:

- ``scene_points_bin``: interleaved float32 [x y z r g b] for the WebGL
  point-cloud viewer (conf-percentile / sky / black-white-background
  filters match the reference's GLB export filters, glb.py:205-320)
- ``depth_png`` / ``image_jpg``: per-view turbo depth maps and inputs
- ``measure``: metric depth at a pixel (the measure tab,
  app/modules/event_handlers.py depth-measurement handlers)
- ``camera_frusta``: line segments for the camera wireframes
"""

from __future__ import annotations

import io
import os
import threading
from typing import Optional

import numpy as np

__all__ = [
    "save_scene", "load_scene", "scene_meta", "scene_points_bin",
    "depth_png", "image_jpg", "measure", "camera_frusta",
]

_CACHE: dict = {}
_CACHE_LOCK = threading.Lock()


def _cv2(what: str):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"scene_store.{what} encodes with OpenCV (cv2), which is not installed") from e
    return cv2


def save_scene(export_dir: str, pred) -> str:
    """Persist the Prediction arrays the app needs (scene.npz)."""
    os.makedirs(export_dir, exist_ok=True)
    path = os.path.join(export_dir, "scene.npz")
    arrays = dict(depth=np.asarray(pred.depth, np.float32))
    if pred.conf is not None:
        arrays["conf"] = np.asarray(pred.conf, np.float32)
    if pred.sky is not None:
        arrays["sky"] = np.asarray(pred.sky).astype(bool)
    if pred.extrinsics is not None:
        arrays["extrinsics"] = np.asarray(pred.extrinsics, np.float32)
    if pred.intrinsics is not None:
        arrays["intrinsics"] = np.asarray(pred.intrinsics, np.float32)
    if pred.processed_images is not None:
        arrays["images"] = np.asarray(pred.processed_images)
    g = getattr(pred, "gaussians", None)
    if g is not None:
        arrays.update(
            gs_means=np.asarray(g.means, np.float32),
            gs_scales=np.asarray(g.scales, np.float32),
            gs_rotations=np.asarray(g.rotations, np.float32),
            gs_harmonics=np.asarray(g.harmonics, np.float32),
            gs_opacities=np.asarray(g.opacities, np.float32),
        )
    np.savez_compressed(path, **arrays)
    return path


def load_scene(export_dir: str) -> Optional[dict]:
    path = os.path.join(export_dir, "scene.npz")
    if not os.path.isfile(path):
        return None
    key = (path, os.path.getmtime(path))
    with _CACHE_LOCK:
        if key in _CACHE:
            return _CACHE[key]
    with np.load(path) as z:
        scene = {k: z[k] for k in z.files}
    with _CACHE_LOCK:
        _CACHE.clear()  # keep at most one scene resident
        _CACHE[key] = scene
    return scene


def scene_meta(scene: dict) -> dict:
    depth = scene["depth"]
    n, h, w = depth.shape
    finite = depth[np.isfinite(depth)]
    c2ws = []
    if "extrinsics" in scene:
        for e in scene["extrinsics"]:
            R, t = e[:3, :3], e[:3, 3]
            c2w = np.eye(4, dtype=np.float32)
            c2w[:3, :3] = R.T
            c2w[:3, 3] = -R.T @ t
            c2ws.append(c2w.tolist())
    return dict(
        num_views=int(n), height=int(h), width=int(w),
        depth_min=float(finite.min()) if finite.size else 0.0,
        depth_max=float(finite.max()) if finite.size else 0.0,
        has_gs="gs_means" in scene,
        has_conf="conf" in scene,
        cameras_c2w=c2ws,
    )


def scene_points_bin(
    scene: dict,
    max_points: int = 300_000,
    conf_percent: float = 30.0,
    filter_sky: bool = True,
    filter_black_bg: bool = False,
    filter_white_bg: bool = False,
    max_depth: float = 200.0,
    seed: int = 0,
) -> bytes:
    """Interleaved float32 [x y z r g b] world-space points."""
    from recondet3d_torch.data.export.glb import depths_to_world_points_with_colors

    images = scene.get("images")
    pts, cols = depths_to_world_points_with_colors(
        scene["depth"], scene["intrinsics"], scene["extrinsics"],
        images=images, conf=scene.get("conf"), sky=scene.get("sky"),
        conf_thresh_percentile=conf_percent, max_depth=max_depth,
        filter_sky=filter_sky,
    )
    if cols is None:
        cols = np.full_like(pts, 0.7)
    if filter_black_bg:
        keep = cols.sum(axis=1) > 0.1
        pts, cols = pts[keep], cols[keep]
    if filter_white_bg:
        keep = cols.sum(axis=1) < 2.9
        pts, cols = pts[keep], cols[keep]
    if len(pts) > max_points:
        idx = np.random.default_rng(seed).choice(len(pts), max_points, replace=False)
        pts, cols = pts[idx], cols[idx]
    return np.concatenate([pts, cols], axis=1).astype("<f4").tobytes()


def camera_frusta(scene: dict, scale: float = 0.3) -> list:
    """Per-camera wireframe line segments [[x,y,z], ...] (8 lines each)."""
    out = []
    if "extrinsics" not in scene or "intrinsics" not in scene:
        return out
    h, w = scene["depth"].shape[1:]
    for e, K in zip(scene["extrinsics"], scene["intrinsics"]):
        R, t = e[:3, :3], e[:3, 3]
        c2w_R, c2w_t = R.T, -R.T @ t
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        corners = np.array([
            [(0 - cx) / fx, (0 - cy) / fy, 1.0],
            [(w - cx) / fx, (0 - cy) / fy, 1.0],
            [(w - cx) / fx, (h - cy) / fy, 1.0],
            [(0 - cx) / fx, (h - cy) / fy, 1.0],
        ], np.float32) * scale
        cam = np.zeros(3, np.float32)
        pts = np.concatenate([cam[None], corners]) @ c2w_R.T + c2w_t
        segs = []
        for i in range(4):
            segs.append([pts[0].tolist(), pts[1 + i].tolist()])
            segs.append([pts[1 + i].tolist(), pts[1 + (i + 1) % 4].tolist()])
        out.append(segs)
    return out


def depth_png(scene: dict, view: int) -> bytes:
    """Turbo-colormapped depth for one view."""
    cv2 = _cv2("depth_png")

    from recondet3d_torch.data.export import _colormap_turbo

    d = scene["depth"][view]
    finite = np.isfinite(d) & (d > 0)
    lo, hi = (np.percentile(d[finite], [2, 98]) if finite.any() else (0, 1))
    norm = np.clip((d - lo) / max(hi - lo, 1e-6), 0, 1)
    img = (_colormap_turbo(norm) * 255).astype(np.uint8)
    img[~finite] = 0
    ok, buf = cv2.imencode(".png", img[..., ::-1])
    return buf.tobytes()


def image_jpg(scene: dict, view: int) -> bytes:
    cv2 = _cv2("image_jpg")

    imgs = scene.get("images")
    if imgs is None:
        return b""
    ok, buf = cv2.imencode(".jpg", np.asarray(imgs[view])[..., ::-1])
    return buf.tobytes()


def measure(scene: dict, view: int, u: float, v: float) -> dict:
    """Metric depth at normalized pixel (u, v) in [0,1] (measure tab)."""
    d = scene["depth"][view]
    h, w = d.shape
    x = int(np.clip(u * w, 0, w - 1))
    y = int(np.clip(v * h, 0, h - 1))
    val = float(d[y, x])
    out = dict(view=int(view), x=x, y=y,
               depth=val if np.isfinite(val) else None)
    if "sky" in scene:
        out["sky"] = bool(scene["sky"][view][y, x])
    return out
