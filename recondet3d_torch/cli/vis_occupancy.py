"""Visualize occupancy debug dumps as BEV images (port of
``recondet3d/cli/vis_occupancy.py``; reads the ``debug_iter_*.pkl`` that
``train/hooks.py`` ``OccupancyDebugHook`` writes).

    python -m recondet3d_torch.cli.vis_occupancy <debug dir> [--out-dir DIR]

Re-implementation of the intent of the reference visualizer
(reference: tools/vis_coord_features.py:1-584 — open3d voxel meshes of
the SparseRefinement debug pickles with prob-intensity colormaps and
thresholds GT 0.05 / pseudo 0.5001). The grids render headless as
max-over-height BEV heatmaps (PNG, with OpenCV).
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle

import numpy as np

GT_THRESH = 0.05
PSEUDO_THRESH = 0.5001


def _to_bev(grid):
    """(B, H, W, C) or (B, C, H, W) probabilities -> (H, W) max over height."""
    g = np.asarray(grid)
    if g.ndim == 4:
        g = g[0]
    if g.shape[0] < g.shape[-1]:  # channels-first
        g = np.transpose(g, (1, 2, 0))
    return g.max(-1), g


def _save_heatmap(path, img, thresh=None):
    import cv2

    x = np.clip(img, 0, 1)
    if thresh is not None:
        x = np.where(x >= thresh, x, 0)
    u8 = (x * 255).astype(np.uint8)
    cv2.imwrite(path, cv2.applyColorMap(u8, cv2.COLORMAP_TURBO))


def main(argv=None):
    p = argparse.ArgumentParser(description="visualize occupancy debug dumps")
    p.add_argument("debug_dir")
    p.add_argument("--out-dir", default=None)
    p.add_argument("--gt-thresh", type=float, default=GT_THRESH)
    p.add_argument("--pseudo-thresh", type=float, default=PSEUDO_THRESH)
    args = p.parse_args(argv)
    out_dir = args.out_dir or os.path.join(args.debug_dir, "vis")
    os.makedirs(out_dir, exist_ok=True)

    for path in sorted(glob.glob(os.path.join(args.debug_dir, "debug_iter_*.pkl"))):
        with open(path, "rb") as f:
            data = pickle.load(f)
        tag = os.path.splitext(os.path.basename(path))[0]
        if data.get("pseudo_occupancy_map") is not None:
            bev, _ = _to_bev(data["pseudo_occupancy_map"])
            _save_heatmap(os.path.join(out_dir, f"{tag}_pseudo.png"), bev,
                          args.pseudo_thresh)
        if data.get("gt_occupancy_map") is not None:
            bev, _ = _to_bev(data["gt_occupancy_map"])
            _save_heatmap(os.path.join(out_dir, f"{tag}_gt.png"), bev,
                          args.gt_thresh)
        print(f"rendered {tag}")
    return 0


if __name__ == "__main__":
    main()
