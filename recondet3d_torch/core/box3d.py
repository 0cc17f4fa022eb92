"""3D box structures and mode conversions.

Re-implementation of the reference box machinery
(reference: mmdetection3d/mmdet3d/core/bbox/structures/ —
LiDARInstance3DBoxes / CameraInstance3DBoxes / Box3DMode, and the index
constants in projects/mmdet3d_plugin/core/box3d.py:1-3). Boxes are plain
numpy arrays (N, 7+) [x, y, z, dx, dy, dz, yaw, (vx, vy)] with z the
BOTTOM center in the LiDAR frame; the class is a light wrapper providing
the operations the pipeline uses (corners, BEV, rotate/flip/translate,
range filtering, height ops).

The port's own copy of ``recondet3d/core/box3d.py`` (numpy only, as there).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = [
    "LiDARBoxes3D", "CameraBoxes3D", "DepthBoxes3D", "Box3DMode",
    "convert_box_mode", "CEN", "DIM", "YAW", "VEL", "limit_period",
]

# index constants (reference: projects/mmdet3d_plugin/core/box3d.py)
CEN = slice(0, 3)
DIM = slice(3, 6)
YAW = 6
VEL = slice(7, 9)


def limit_period(val, offset: float = 0.5, period: float = np.pi * 2):
    """Wrap angles into [-offset*period, (1-offset)*period)."""
    return val - np.floor(val / period + offset) * period


class LiDARBoxes3D:
    """(N, 7+) boxes in the LiDAR frame, gravity axis z, bottom-center z."""

    def __init__(self, tensor, box_dim: Optional[int] = None):
        arr = np.asarray(tensor, np.float64).reshape(-1, box_dim or np.shape(tensor)[-1])
        self.tensor = arr

    def __len__(self):
        return len(self.tensor)

    @property
    def center(self):
        return self.tensor[:, CEN]

    @property
    def gravity_center(self):
        c = self.tensor[:, CEN].copy()
        c[:, 2] += self.tensor[:, 5] / 2
        return c

    @property
    def dims(self):
        return self.tensor[:, DIM]

    @property
    def yaw(self):
        return self.tensor[:, YAW]

    @property
    def velocity(self):
        return self.tensor[:, VEL] if self.tensor.shape[1] >= 9 else None

    @property
    def bev(self):
        """(N, 5) [cx, cy, dx, dy, yaw]."""
        return self.tensor[:, [0, 1, 3, 4, 6]]

    @property
    def corners(self):
        """(N, 8, 3) corners; bottom face first, ccw."""
        dims = self.dims
        ox = np.array([1, 1, -1, -1, 1, 1, -1, -1]) / 2
        oy = np.array([-1, 1, 1, -1, -1, 1, 1, -1]) / 2
        oz = np.array([0, 0, 0, 0, 1, 1, 1, 1], np.float64)
        local = np.stack(
            [dims[:, 0:1] * ox, dims[:, 1:2] * oy, dims[:, 2:3] * oz], axis=-1
        )
        cos, sin = np.cos(self.yaw), np.sin(self.yaw)
        R = np.zeros((len(self), 3, 3))
        R[:, 0, 0], R[:, 0, 1] = cos, -sin
        R[:, 1, 0], R[:, 1, 1] = sin, cos
        R[:, 2, 2] = 1
        return np.einsum("nij,nkj->nki", R, local) + self.center[:, None]

    def rotate(self, angle: float):
        cos, sin = np.cos(angle), np.sin(angle)
        R = np.array([[cos, -sin], [sin, cos]])
        self.tensor[:, :2] = self.tensor[:, :2] @ R.T
        self.tensor[:, YAW] += angle
        if self.tensor.shape[1] >= 9:
            self.tensor[:, VEL] = self.tensor[:, VEL] @ R.T
        return self

    def flip(self, bev_direction: str = "horizontal"):
        """horizontal = flip y (reference LiDAR convention)."""
        if bev_direction == "horizontal":
            self.tensor[:, 1] = -self.tensor[:, 1]
            self.tensor[:, YAW] = -self.tensor[:, YAW]
            if self.tensor.shape[1] >= 9:
                self.tensor[:, 8] = -self.tensor[:, 8]
        else:
            self.tensor[:, 0] = -self.tensor[:, 0]
            self.tensor[:, YAW] = -self.tensor[:, YAW] + np.pi
            if self.tensor.shape[1] >= 9:
                self.tensor[:, 7] = -self.tensor[:, 7]
        return self

    def translate(self, trans):
        self.tensor[:, CEN] += np.asarray(trans)
        return self

    def scale(self, factor: float):
        self.tensor[:, :6] *= factor
        if self.tensor.shape[1] >= 9:
            self.tensor[:, VEL] *= factor
        return self

    def in_range_bev(self, rng: Sequence[float]):
        x, y = self.tensor[:, 0], self.tensor[:, 1]
        return (x > rng[0]) & (y > rng[1]) & (x < rng[2]) & (y < rng[3])

    def in_range_3d(self, rng: Sequence[float]):
        c = self.gravity_center
        return np.all(c > np.asarray(rng[:3]), 1) & np.all(c < np.asarray(rng[3:]), 1)

    def limit_yaw(self, offset=0.5, period=np.pi * 2):
        self.tensor[:, YAW] = limit_period(self.tensor[:, YAW], offset, period)
        return self

    def __getitem__(self, idx):
        return LiDARBoxes3D(self.tensor[idx].reshape(-1, self.tensor.shape[1]))


class CameraBoxes3D:
    """(N, 7+) boxes in the camera frame: x right, y DOWN, z forward;
    bottom center at relative (0.5, 1.0, 0.5); yaw about the y axis
    (reference: mmdet3d/core/bbox/structures/cam_box3d.py)."""

    def __init__(self, tensor, box_dim: Optional[int] = None):
        arr = np.asarray(tensor, np.float64).reshape(
            -1, box_dim or np.shape(tensor)[-1]
        )
        self.tensor = arr

    def __len__(self):
        return len(self.tensor)

    @property
    def center(self):
        return self.tensor[:, CEN]

    @property
    def gravity_center(self):
        c = self.tensor[:, CEN].copy()
        c[:, 1] -= self.tensor[:, 4] / 2  # y is down; dims are (x, y, z) sizes
        return c

    @property
    def dims(self):
        return self.tensor[:, DIM]

    @property
    def yaw(self):
        return self.tensor[:, YAW]

    @property
    def corners(self):
        """(N, 8, 3) corners, rotation about y (reference: cam_box3d.py:107)."""
        dims = self.dims
        ox = np.array([-1, -1, -1, -1, 1, 1, 1, 1]) / 2
        oy = np.array([0, 0, -1, -1, 0, 0, -1, -1], np.float64)
        oz = np.array([-1, 1, 1, -1, -1, 1, 1, -1]) / 2
        local = np.stack(
            [dims[:, 0:1] * ox, dims[:, 1:2] * oy, dims[:, 2:3] * oz], axis=-1
        )
        cos, sin = np.cos(self.yaw), np.sin(self.yaw)
        R = np.zeros((len(self), 3, 3))
        R[:, 0, 0], R[:, 0, 2] = cos, sin
        R[:, 2, 0], R[:, 2, 2] = -sin, cos
        R[:, 1, 1] = 1
        return np.einsum("nij,nkj->nki", R, local) + self.center[:, None]

    @property
    def bev(self):
        """(N, 5) [cx(x), cy(z), dx, dz, yaw] in the x-z ground plane."""
        return self.tensor[:, [0, 2, 3, 5, 6]]

    def __getitem__(self, idx):
        return CameraBoxes3D(self.tensor[idx].reshape(-1, self.tensor.shape[1]))


class DepthBoxes3D(LiDARBoxes3D):
    """(N, 7+) boxes in the depth frame (x right, y forward, z up) —
    same gravity-z/bottom-center layout as LiDAR
    (reference: mmdet3d/core/bbox/structures/depth_box3d.py)."""

    def __getitem__(self, idx):
        return DepthBoxes3D(self.tensor[idx].reshape(-1, self.tensor.shape[1]))


class Box3DMode:
    """Box coordinate modes (reference: box_3d_mode.py:13-58)."""

    LIDAR = 0
    CAM = 1
    DEPTH = 2


_MODE_DEFAULTS = {
    # (src, dst) -> (default rt_mat rows, dims permutation of (dx, dy, dz))
    (Box3DMode.LIDAR, Box3DMode.CAM): ([[0, -1, 0], [0, 0, -1], [1, 0, 0]], (1, 2, 0)),
    (Box3DMode.CAM, Box3DMode.LIDAR): ([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], (2, 0, 1)),
    (Box3DMode.DEPTH, Box3DMode.CAM): ([[1, 0, 0], [0, 0, 1], [0, -1, 0]], (0, 2, 1)),
    (Box3DMode.CAM, Box3DMode.DEPTH): ([[1, 0, 0], [0, 0, -1], [0, 1, 0]], (0, 2, 1)),
    (Box3DMode.LIDAR, Box3DMode.DEPTH): ([[0, -1, 0], [1, 0, 0], [0, 0, 1]], (1, 0, 2)),
    (Box3DMode.DEPTH, Box3DMode.LIDAR): ([[0, 1, 0], [-1, 0, 0], [0, 0, 1]], (1, 0, 2)),
}

_MODE_CLASSES = {
    Box3DMode.LIDAR: LiDARBoxes3D,
    Box3DMode.CAM: CameraBoxes3D,
    Box3DMode.DEPTH: DepthBoxes3D,
}


def convert_box_mode(box, src: int, dst: int, rt_mat=None):
    """Convert (N, 7+) arrays or box objects between coordinate modes
    (reference: Box3DMode.convert, box_3d_mode.py:61-166 — centers mapped
    through rt_mat (3x3 rotation or 3x4/4x4 RT), dims permuted per mode
    pair, yaw and trailing columns passed through unchanged, matching the
    v0.17 semantics)."""
    if src == dst:
        return box
    is_obj = isinstance(box, (LiDARBoxes3D, CameraBoxes3D, DepthBoxes3D))
    arr = np.array(box.tensor if is_obj else box, np.float64)
    default_rt, perm = _MODE_DEFAULTS[(src, dst)]
    if rt_mat is None:
        rt_mat = np.asarray(default_rt, np.float64)
    else:
        rt_mat = np.asarray(rt_mat, np.float64)
    if rt_mat.shape[-1] == 4:
        xyz1 = np.concatenate([arr[:, :3], np.ones((len(arr), 1))], axis=-1)
        xyz = (xyz1 @ rt_mat.T)[:, :3]
    else:
        xyz = arr[:, :3] @ rt_mat.T
    dims = arr[:, 3:6][:, list(perm)]
    out = np.concatenate([xyz, dims, arr[:, 6:]], axis=-1)
    if is_obj:
        return _MODE_CLASSES[dst](out)
    return out
