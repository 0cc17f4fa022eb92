"""Box/point visualization helpers (BEV canvas + image projection; port of
``recondet3d/utils/vis.py``, on the port's ``core/box3d``).

Re-implementation of the reference visualization utilities
(reference: projects/mmdet3d_plugin/datasets/utils.py —
box3d_to_corners:12, draw_lidar_bbox3d_on_img:122, plot_rect3d_on_img:191,
draw_points_on_img:270, draw_lidar_bbox3d_on_bev:295). All host-side
numpy/cv2; boxes are (N, 7+) [x y z dx dy dz yaw ...] with bottom-center z.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "box3d_to_corners",
    "draw_bbox3d_on_img",
    "draw_points_on_img",
    "draw_bbox3d_on_bev",
]

# edges of the 8-corner box (bottom ring, top ring, pillars)
_EDGES = (
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
)


def box3d_to_corners(boxes: np.ndarray) -> np.ndarray:
    """(N, 7+) -> (N, 8, 3) corners, bottom face first
    (reference: datasets/utils.py box3d_to_corners:12-32)."""
    from recondet3d_torch.core.box3d import LiDARBoxes3D

    return LiDARBoxes3D(np.asarray(boxes)).corners


def draw_bbox3d_on_img(
    boxes: np.ndarray,
    img: np.ndarray,
    lidar2img: np.ndarray,
    color: Tuple[int, int, int] = (0, 255, 0),
    thickness: int = 2,
) -> np.ndarray:
    """Project boxes with lidar2img (4x4) and draw wireframes
    (reference: draw_lidar_bbox3d_on_img:122 + plot_rect3d_on_img:191)."""
    import cv2

    img = np.ascontiguousarray(np.asarray(img).copy())
    if len(boxes) == 0:
        return img
    corners = box3d_to_corners(boxes)  # (N, 8, 3)
    n = len(corners)
    pts = np.concatenate([corners.reshape(-1, 3), np.ones((n * 8, 1))], -1)
    proj = pts @ np.asarray(lidar2img).T
    z = proj[:, 2]
    uv = (proj[:, :2] / np.clip(z[:, None], 1e-5, None)).reshape(n, 8, 2)
    z = z.reshape(n, 8)
    h, w = img.shape[:2]
    for i in range(n):
        if (z[i] <= 0.1).all():
            continue
        for a, b in _EDGES:
            if z[i, a] <= 0.1 or z[i, b] <= 0.1:
                continue
            pa = (int(uv[i, a, 0]), int(uv[i, a, 1]))
            pb = (int(uv[i, b, 0]), int(uv[i, b, 1]))
            if not (-w <= pa[0] <= 2 * w and -h <= pa[1] <= 2 * h):
                continue
            cv2.line(img, pa, pb, color, thickness, cv2.LINE_AA)
    return img


def draw_points_on_img(
    points: np.ndarray,
    img: np.ndarray,
    lidar2img: np.ndarray,
    color: Tuple[int, int, int] = (0, 255, 0),
    radius: int = 4,
) -> np.ndarray:
    """(reference: draw_points_on_img:270-293)."""
    import cv2

    img = np.ascontiguousarray(np.asarray(img).copy())
    pts = np.concatenate(
        [np.asarray(points)[:, :3], np.ones((len(points), 1))], -1
    )
    proj = pts @ np.asarray(lidar2img).T
    z = proj[:, 2]
    keep = z > 0.1
    uv = proj[keep, :2] / z[keep, None]
    h, w = img.shape[:2]
    for u, v in uv:
        if 0 <= u < w and 0 <= v < h:
            cv2.circle(img, (int(u), int(v)), radius, color, -1)
    return img


def draw_bbox3d_on_bev(
    pred_boxes: Optional[np.ndarray] = None,
    gt_boxes: Optional[np.ndarray] = None,
    bev_size: int = 900,
    bev_range: float = 115.0,
    pred_color: Tuple[int, int, int] = (0, 165, 255),
    gt_color: Tuple[int, int, int] = (0, 255, 0),
    thickness: int = 3,
) -> np.ndarray:
    """BEV canvas with range rings + box rectangles
    (reference: draw_lidar_bbox3d_on_bev:295-397 — ego at center, x right,
    y up (negated rows), 10m rings)."""
    import cv2

    bev = np.zeros((bev_size, bev_size, 3), np.uint8)
    res = bev_range / bev_size
    mark = (127, 127, 127)
    for cir in range(int(bev_range / 2 / 10)):
        cv2.circle(bev, (bev_size // 2, bev_size // 2),
                   int((cir + 1) * 10 / res), mark, thickness=thickness)
    cv2.line(bev, (0, bev_size // 2), (bev_size, bev_size // 2), mark)
    cv2.line(bev, (bev_size // 2, 0), (bev_size // 2, bev_size), mark)

    def draw(boxes, color):
        if boxes is None or len(boxes) == 0:
            return
        corners = box3d_to_corners(boxes)[:, :4, :2]  # bottom ring
        xs = corners[..., 0] / res + bev_size / 2
        ys = -corners[..., 1] / res + bev_size / 2
        for x, y in zip(xs, ys):
            for a, b in ((0, 1), (1, 2), (2, 3), (3, 0)):
                cv2.line(bev, (int(x[a]), int(y[a])), (int(x[b]), int(y[b])),
                         color, thickness=thickness)

    draw(pred_boxes, pred_color)
    draw(gt_boxes, gt_color)
    return bev
