"""Visualize GT point-cloud .bin files / dataset samples (port of
``recondet3d/cli/gt_vis.py``).

    python -m recondet3d_torch.cli.gt_vis <file.bin or folder> [--out-dir DIR] [--show]

Re-implementation of the reference GT visualizer
(reference: tools/gt_vis.py:1-60 — open3d windowed viewer over .bin
files). Headless environments have no open3d/window, so this renders BEV
PNGs (points + GT boxes) with recondet3d_torch.utils.vis instead; pass
``--show`` to attempt an interactive open3d window when available.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def read_bin_file(path: str, feature_dim: int = 5) -> np.ndarray:
    return np.fromfile(path, np.float32).reshape(-1, feature_dim)


def render_bev_png(points, out_path, boxes=None, bev_range=115.0,
                   bev_size=900):
    import cv2

    from recondet3d_torch.utils.vis import draw_bbox3d_on_bev

    bev = draw_bbox3d_on_bev(gt_boxes=boxes, bev_size=bev_size,
                             bev_range=bev_range)
    res = bev_range / bev_size
    xs = (points[:, 0] / res + bev_size / 2).astype(int)
    ys = (-points[:, 1] / res + bev_size / 2).astype(int)
    keep = (xs >= 0) & (xs < bev_size) & (ys >= 0) & (ys < bev_size)
    bev[ys[keep], xs[keep]] = (255, 255, 255)
    cv2.imwrite(out_path, bev)
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser(description="visualize GT .bin point clouds")
    p.add_argument("path", help=".bin file or folder of .bin files")
    p.add_argument("--feature-dim", type=int, default=5)
    p.add_argument("--out-dir", default="gt_vis_out")
    p.add_argument("--min-points", type=int, default=100)
    p.add_argument("--contains", default="",
                   help="only visualize files whose name contains this")
    p.add_argument("--show", action="store_true",
                   help="open an interactive open3d window if available")
    args = p.parse_args(argv)

    files = (
        [args.path] if os.path.isfile(args.path)
        else sorted(
            os.path.join(args.path, f) for f in os.listdir(args.path)
            if f.endswith(".bin") and args.contains in f
        )
    )
    os.makedirs(args.out_dir, exist_ok=True)
    for f in files:
        pts = read_bin_file(f, args.feature_dim)
        if len(pts) <= args.min_points:
            continue
        if args.show:
            try:
                import open3d as o3d

                pcd = o3d.geometry.PointCloud()
                pcd.points = o3d.utility.Vector3dVector(pts[:, :3])
                o3d.visualization.draw_geometries([pcd], window_name=f)
                continue
            except ImportError:
                print("open3d unavailable; writing PNG instead")
        out = os.path.join(
            args.out_dir, os.path.basename(f).replace(".bin", "_bev.png")
        )
        print("wrote", render_bev_png(pts, out))
    return 0


if __name__ == "__main__":
    main()
