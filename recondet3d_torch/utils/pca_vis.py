"""PCA feature visualisation (port of ``recondet3d/utils/pca_vis.py``): ViT
features projected to RGB by a 3-component PCA shared across views, written
as PNGs (+ an mp4 when multi-view).

The PNGs go through ``data/image_io.py`` ``write_png``, 8x nearest
upsampling through ``np.repeat``: the pixels of the JAX package's
``cv2.imwrite(cv2.resize(..., INTER_NEAREST))``, without cv2. The mp4 is
written with OpenCV; where cv2 is not installed it is left out, with a
warning that names cv2.
"""

from __future__ import annotations

import importlib.util
import logging
import os

import numpy as np

from recondet3d_torch.data.image_io import write_png

__all__ = ["pca_feature_rgb", "export_to_feat_vis"]

logger = logging.getLogger("recondet3d_torch.pca_vis")


def pca_feature_rgb(feats: np.ndarray, n_components: int = 3) -> np.ndarray:
    """(..., C) features -> (..., 3) in [0, 1] via shared PCA."""
    shape = feats.shape
    flat = feats.reshape(-1, shape[-1]).astype(np.float64)
    flat = flat - flat.mean(0)
    # top-3 principal directions via the C x C covariance eigvecs
    cov = flat.T @ flat / max(len(flat) - 1, 1)
    vals, vecs = np.linalg.eigh(cov)
    comps = vecs[:, ::-1][:, :n_components]
    proj = flat @ comps
    lo = np.percentile(proj, 2, axis=0)
    hi = np.percentile(proj, 98, axis=0)
    rgb = np.clip((proj - lo) / np.maximum(hi - lo, 1e-9), 0, 1)
    return rgb.reshape(shape[:-1] + (n_components,))


def _upsample8(img: np.ndarray) -> np.ndarray:
    return np.repeat(np.repeat(img, 8, axis=0), 8, axis=1)


def export_to_feat_vis(prediction, export_dir: str, fps: int = 15) -> str:
    """Render aux feature layers to PCA-RGB PNGs (+ mp4 when multi-view)."""
    if not prediction.aux:
        raise ValueError("prediction has no aux features; pass export_feat_layers")
    os.makedirs(export_dir, exist_ok=True)
    for name, feat in prediction.aux.items():
        f = np.asarray(feat)  # (S, h, w, C)
        rgb = (pca_feature_rgb(f) * 255).astype(np.uint8)
        for i in range(rgb.shape[0]):
            write_png(os.path.join(export_dir, f"{name}_view{i:02d}.png"), _upsample8(rgb[i]))
        if rgb.shape[0] > 1:
            if importlib.util.find_spec("cv2") is None:
                logger.warning("feat_vis: %s.mp4 not written: the mp4 writer needs OpenCV (cv2)", name)
                continue
            import cv2

            H, W = rgb.shape[1:3]
            vw = cv2.VideoWriter(os.path.join(export_dir, f"{name}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                                 (W * 8, H * 8))
            for i in range(rgb.shape[0]):
                vw.write(np.ascontiguousarray(_upsample8(rgb[i])[..., ::-1]))
            vw.release()
    return export_dir
