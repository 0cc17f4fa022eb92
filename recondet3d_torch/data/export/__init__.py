"""Export dispatch (port of ``recondet3d/data/export/__init__.py``: a
hyphen-combinable format string -> exporter). The exporters are numpy and
copied as they are, so one prediction gives the same files in both
packages. PNGs are written by ``data/image_io.py`` ``write_png`` (the same
bytes as the JAX package's writer). ``gs_video`` renders with the port's
``models/da3/gs_renderer.py`` and writes its mp4 with OpenCV: without cv2
it raises an ImportError that names it."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from recondet3d_torch.data.image_io import write_png
from recondet3d_torch.data.export.glb import export_to_glb
from recondet3d_torch.data.export.pointcloud_io import (
    read_pcd,
    read_ply,
    write_gs_ply,
    write_pcd,
    write_ply,
)

__all__ = [
    "export",
    "export_to_glb",
    "export_to_npz",
    "export_to_mini_npz",
    "export_to_depth_vis",
    "export_to_gs_ply",
    "export_to_colmap",
    "write_pcd",
    "read_pcd",
    "write_ply",
    "read_ply",
]


def export_to_npz(prediction, export_dir: str) -> str:
    """Full-precision arrays (reference: utils/export/npz.py:23)."""
    os.makedirs(export_dir, exist_ok=True)
    path = os.path.join(export_dir, "prediction.npz")
    arrays = {}
    for k in ("depth", "conf", "sky", "extrinsics", "intrinsics", "processed_images"):
        v = getattr(prediction, k, None)
        if v is not None:
            arrays[k] = np.asarray(v)
    np.savez(path, **arrays)
    return path


def export_to_mini_npz(prediction, export_dir: str) -> str:
    """fp16-compressed variant (reference: utils/export/npz.py:54)."""
    os.makedirs(export_dir, exist_ok=True)
    path = os.path.join(export_dir, "prediction_mini.npz")
    arrays = {"depth": np.asarray(prediction.depth).astype(np.float16)}
    if prediction.conf is not None:
        arrays["conf"] = np.asarray(prediction.conf).astype(np.float16)
    if prediction.sky is not None:
        arrays["sky"] = np.asarray(prediction.sky).astype(bool)
    if prediction.extrinsics is not None:
        arrays["extrinsics"] = np.asarray(prediction.extrinsics).astype(np.float32)
    if prediction.intrinsics is not None:
        arrays["intrinsics"] = np.asarray(prediction.intrinsics).astype(np.float32)
    np.savez_compressed(path, **arrays)
    return path


def _colormap_turbo(x: np.ndarray) -> np.ndarray:
    """Small polynomial turbo colormap approximation (vis only)."""
    x = np.clip(x, 0, 1)
    r = np.clip(1.61 * x ** 2 - 0.4 * x + 0.16 + 1.2 * x, 0, 1)
    g = np.clip(np.sin(np.pi * np.clip(x * 1.05, 0, 1)) ** 1.2, 0, 1)
    b = np.clip(1.0 - 1.9 * x + 0.9 * x ** 2, 0, 1)
    return np.stack([r, g, b], axis=-1)


def export_to_depth_vis(prediction, export_dir: str) -> str:
    """Colormapped inverse-depth PNGs (reference: utils/export/depth_vis.py)."""
    os.makedirs(export_dir, exist_ok=True)
    depth = np.asarray(prediction.depth)
    inv = 1.0 / np.clip(depth, 1e-6, None)
    lo, hi = np.percentile(inv, 2), np.percentile(inv, 98)
    norm = np.clip((inv - lo) / max(hi - lo, 1e-9), 0, 1)
    for i in range(depth.shape[0]):
        img = (_colormap_turbo(norm[i]) * 255).astype(np.uint8)
        write_png(os.path.join(export_dir, f"depth_{i:03d}.png"), img)
    return export_dir


def export_to_gs_ply(prediction, export_dir: str) -> str:
    """World-space gaussians -> 3DGS .ply (reference: utils/export/gs.py:33)."""
    os.makedirs(export_dir, exist_ok=True)
    g = prediction.gaussians
    if g is None:
        raise ValueError("prediction has no gaussians; run with infer_gs=True")
    path = os.path.join(export_dir, "gaussians.ply")
    means = np.asarray(g.means).reshape(-1, 3)
    write_gs_ply(
        path,
        means,
        np.asarray(g.scales).reshape(-1, 3),
        np.asarray(g.rotations).reshape(-1, 4),
        np.asarray(g.harmonics).reshape(len(means), 3, -1),
        np.asarray(g.opacities).reshape(-1),
    )
    return path


def export_to_gs_video(prediction, export_dir: str, render_hw=None,
                       render_exts=None, render_ixts=None, fps: int = 15,
                       device=None, **kw) -> str:
    """Render the gaussians along a camera trajectory to .mp4
    (reference: utils/export/gs.py:61 export_to_gs_video; gsplat + moviepy
    replaced by the port's PyTorch rasterizer + cv2). Renders on ``device``
    (default the card, see ``render_3dgs``)."""
    from recondet3d_torch.models.da3.gs_renderer import render_trajectory_video
    from recondet3d_torch.utils.camera_traj import interpolate_camera_path

    g = prediction.gaussians
    if g is None:
        raise ValueError("prediction has no gaussians; run with infer_gs=True")
    os.makedirs(export_dir, exist_ok=True)
    if render_exts is None:
        render_exts, render_ixts = interpolate_camera_path(
            np.asarray(prediction.extrinsics), np.asarray(prediction.intrinsics),
            n_frames=30,
        )
    if render_hw is None:
        render_hw = np.asarray(prediction.depth).shape[-2:]
    path = os.path.join(export_dir, "gs_video.mp4")
    return render_trajectory_video(g, render_exts, render_ixts, tuple(render_hw),
                                   path, fps=fps, device=device)


def export_to_colmap(prediction, export_dir: str) -> str:
    """cameras/images/points3D binary COLMAP model
    (reference: utils/export/colmap.py:28 + vendored read_write_model.py)."""
    from recondet3d_torch.data.export.colmap_io import write_colmap_model

    return write_colmap_model(prediction, export_dir)


_EXPORTERS = {
    "glb": lambda pred, d, **kw: export_to_glb(os.path.join(d, "scene.glb"), pred, **kw),
    "npz": lambda pred, d, **kw: export_to_npz(pred, d),
    "mini_npz": lambda pred, d, **kw: export_to_mini_npz(pred, d),
    "depth_vis": lambda pred, d, **kw: export_to_depth_vis(pred, d),
    "gs_ply": lambda pred, d, **kw: export_to_gs_ply(pred, d),
    "gs_video": lambda pred, d, **kw: export_to_gs_video(pred, d, **kw),
    "feat_vis": lambda pred, d, **kw: __import__("recondet3d_torch.utils.pca_vis", fromlist=["x"]).export_to_feat_vis(pred, d),
    "colmap": lambda pred, d, **kw: export_to_colmap(pred, d),
}


def export(prediction, export_format: str, export_dir: str, device=None, **kwargs):
    """Dispatch on a hyphen-combinable format string, e.g. 'glb-npz'
    (reference: utils/export/__init__.py:25-54). ``device`` is where
    ``gs_video`` renders (default the card); the other exporters run on the
    host."""
    os.makedirs(export_dir, exist_ok=True)
    results = {}
    for fmt in export_format.split("-"):
        if fmt in ("", "none"):
            continue
        if fmt not in _EXPORTERS:
            raise KeyError(f"unknown export format {fmt!r}; known: {sorted(_EXPORTERS)}")
        extra = dict(device=device) if fmt == "gs_video" else {}
        results[fmt] = _EXPORTERS[fmt](prediction, export_dir, **kwargs, **extra)
    return results
