"""Pose encodings and quaternion <-> matrix conversions (port of
``recondet3d/utils/transforms.py:26-136``). 9-D encoding: t(3), quat
xyzw(4), fov(2); scalar-last quaternions."""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = [
    "quat_to_mat",
    "mat_to_quat",
    "standardize_quaternion",
    "extri_intri_to_pose_encoding",
    "pose_encoding_to_extri_intri",
    "cam_quat_xyzw_to_world_quat_wxyz",
]


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """xyzw (scalar-last) quaternion -> rotation matrix (..., 3, 3)."""
    i, j, k, r = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    two_s = 2.0 / torch.sum(q * q, dim=-1)
    o = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return o.reshape(q.shape[:-1] + (3, 3))


def standardize_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Non-negative real part (scalar-last layout)."""
    return torch.where(q[..., 3:4] < 0, -q, q)


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> xyzw quaternion (branch-free pytorch3d form)."""
    batch = m.shape[:-2]
    f = m.reshape(batch + (9,))
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = f.unbind(-1)

    q_abs_sq = torch.stack(
        [
            1.0 + m00 + m11 + m22,
            1.0 + m00 - m11 - m22,
            1.0 - m00 + m11 - m22,
            1.0 - m00 - m11 + m22,
        ],
        dim=-1,
    )
    q_abs = torch.sqrt(torch.clamp(q_abs_sq, min=0.0))

    quat_by_rijk = torch.stack(
        [
            torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
            torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
            torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
        ],
        dim=-2,
    )
    denom = 2.0 * torch.clamp(q_abs[..., None], min=0.1)
    candidates = quat_by_rijk / denom
    best = torch.argmax(q_abs, dim=-1)
    idx = best[..., None, None].expand(batch + (1, 4))
    out = torch.gather(candidates, -2, idx).squeeze(-2)  # rijk
    out = out[..., [1, 2, 3, 0]]  # -> xyzw
    return standardize_quaternion(out)


def extri_intri_to_pose_encoding(extrinsics, intrinsics, image_size_hw: Tuple[int, int]):
    """(..., 3or4, 4) extrinsics + (..., 3, 3) intrinsics -> 9-D encoding."""
    R = extrinsics[..., :3, :3]
    T = extrinsics[..., :3, 3]
    quat = mat_to_quat(R)
    H, W = image_size_hw
    fov_h = 2 * torch.atan((H / 2) / intrinsics[..., 1, 1])
    fov_w = 2 * torch.atan((W / 2) / intrinsics[..., 0, 0])
    return torch.cat([T, quat, fov_h[..., None], fov_w[..., None]], dim=-1).float()


def pose_encoding_to_extri_intri(pose_encoding, image_size_hw: Tuple[int, int]):
    """9-D encoding -> ((..., 3, 4) extrinsics, (..., 3, 3) intrinsics)."""
    T = pose_encoding[..., :3]
    quat = pose_encoding[..., 3:7]
    fov_h = pose_encoding[..., 7]
    fov_w = pose_encoding[..., 8]
    R = quat_to_mat(quat)
    extr = torch.cat([R, T[..., None]], dim=-1)
    H, W = image_size_hw
    fy = (H / 2.0) / torch.clamp(torch.tan(fov_h / 2.0), min=1e-6)
    fx = (W / 2.0) / torch.clamp(torch.tan(fov_w / 2.0), min=1e-6)
    zeros = torch.zeros_like(fx)
    ones = torch.ones_like(fx)
    intr = torch.stack(
        [
            torch.stack([fx, zeros, ones * (W / 2)], dim=-1),
            torch.stack([zeros, fy, ones * (H / 2)], dim=-1),
            torch.stack([zeros, zeros, ones], dim=-1),
        ],
        dim=-2,
    )
    return extr, intr


def cam_quat_xyzw_to_world_quat_wxyz(cam_quat_xyzw, c2w):
    """Rotate camera-space quaternions (xyzw) into world space by the
    camera-to-world rotations ``c2w[..., :3, :3]`` (broadcast); returns wxyz."""
    rot_world = c2w[..., :3, :3] @ quat_to_mat(cam_quat_xyzw)
    q_xyzw = mat_to_quat(rot_world)
    return torch.cat([q_xyzw[..., 3:4], q_xyzw[..., 0:3]], dim=-1)
