"""Camera trajectory helpers for novel-view rendering (port of
``recondet3d/utils/camera_traj.py``, numpy, copied as it is).

Re-implementation of the reference trajectory toolbox
(reference: depth_anything_3/utils/camera_trj_helpers.py — pose
interpolation plus wander / wobble / dolly-zoom render paths used by the
gs_video exporter). Poses are (V, 3or4, 4) w2c; interpolation runs on
c2w with quaternion slerp.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from recondet3d_torch.utils.pose_align import _affine_inverse_np, _to44_np

__all__ = [
    "interpolate_camera_path",
    "wander_path",
    "wobble_path",
    "dolly_zoom_path",
    "stabilization_path",
]


def _mat_to_quat_np(R):
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                         (R[1, 0] - R[0, 1]) / s, 0.25 * s])
    i = np.argmax(np.diag(R))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k]) * 2
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[j] = (R[j, i] + R[i, j]) / s
    q[k] = (R[k, i] + R[i, k]) / s
    q[3] = (R[k, j] - R[j, k]) / s
    return q


def _quat_to_mat_np(q):
    x, y, z, w = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _slerp(q0, q1, t):
    d = np.dot(q0, q1)
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    th = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)


def interpolate_camera_path(extrinsics, intrinsics, n_frames: int = 60,
                            loop: bool = False):
    """Smoothly interpolate through the input views (slerp R, lerp t, K)."""
    ext = _to44_np(np.asarray(extrinsics, np.float64))
    c2w = _affine_inverse_np(ext)
    V = len(c2w)
    ixt = np.asarray(intrinsics, np.float64)
    keys = list(range(V)) + ([0] if loop else [])
    n_seg = len(keys) - 1
    if n_seg == 0:
        return (np.repeat(ext[:1], n_frames, 0).astype(np.float32),
                np.repeat(ixt[:1], n_frames, 0).astype(np.float32))
    out_e, out_k = [], []
    for f in range(n_frames):
        s = f * n_seg / max(n_frames - 1, 1)
        i = min(int(s), n_seg - 1)
        t = s - i
        a, b = keys[i], keys[i + 1]
        q = _slerp(_mat_to_quat_np(c2w[a][:3, :3]), _mat_to_quat_np(c2w[b][:3, :3]), t)
        pos = (1 - t) * c2w[a][:3, 3] + t * c2w[b][:3, 3]
        M = np.eye(4)
        M[:3, :3] = _quat_to_mat_np(q)
        M[:3, 3] = pos
        out_e.append(_affine_inverse_np(M[None])[0])
        out_k.append((1 - t) * ixt[a] + t * ixt[b])
    return np.stack(out_e).astype(np.float32), np.stack(out_k).astype(np.float32)


def _apply_local_offsets(ext0, ixt0, offsets, n_frames):
    """Offsets (n, 3) in the camera frame around a base pose."""
    ext0 = _to44_np(np.asarray(ext0, np.float64)[None])[0]
    c2w = _affine_inverse_np(ext0[None])[0]
    outs = []
    for off in offsets:
        M = c2w.copy()
        M[:3, 3] = c2w[:3, 3] + c2w[:3, :3] @ off
        outs.append(_affine_inverse_np(M[None])[0])
    ext = np.stack(outs).astype(np.float32)
    ixt = np.repeat(np.asarray(ixt0, np.float32)[None], n_frames, 0)
    return ext, ixt


def wander_path(ext0, ixt0, n_frames: int = 60, radius: float = 0.3):
    """Circular sideways wander around the base view."""
    th = np.linspace(0, 2 * np.pi, n_frames)
    offsets = np.stack([radius * np.sin(th), radius * np.cos(th) * 0.4,
                        np.zeros_like(th)], 1)
    return _apply_local_offsets(ext0, ixt0, offsets, n_frames)


def wobble_path(ext0, ixt0, n_frames: int = 60, radius: float = 0.1):
    th = np.linspace(0, 4 * np.pi, n_frames)
    offsets = np.stack([radius * np.sin(th), radius * np.sin(2 * th) * 0.5,
                        np.zeros_like(th)], 1)
    return _apply_local_offsets(ext0, ixt0, offsets, n_frames)


def dolly_zoom_path(ext0, ixt0, n_frames: int = 60, depth_range=(0.0, 0.5),
                    fov_scale=(1.0, 1.3)):
    """Move forward while widening the FOV."""
    zs = np.linspace(depth_range[0], depth_range[1], n_frames)
    offsets = np.stack([np.zeros_like(zs), np.zeros_like(zs), zs], 1)
    ext, ixt = _apply_local_offsets(ext0, ixt0, offsets, n_frames)
    scale = np.linspace(fov_scale[0], fov_scale[1], n_frames)
    ixt = ixt.copy()
    ixt[:, 0, 0] /= scale
    ixt[:, 1, 1] /= scale
    return ext, ixt


def stabilization_path(poses, k_size: int = 45):
    """Gaussian-smooth a camera path (reference: camera_trj_helpers.py
    render_stabilization_path:32-106 — filter r1/r2/t columns of each
    pose with a reflect-padded Gaussian, renormalize, rebuild r3 by cross
    product).

    poses (n, 4, 4) or (n, 3, 4) -> (n, 4, 4)."""
    poses = _to44_np(np.asarray(poses, np.float64))
    n = poses.shape[0]
    if n <= 1:
        return poses.astype(np.float32)

    # safe odd kernel size capped to the frame count (reference :45-57)
    k_size = max(int(k_size), 1)
    if k_size % 2 == 0:
        k_size += 1
    max_odd = n if n % 2 == 1 else n - 1
    k_size = min(k_size, max(max_odd, 1))
    if n >= 3 and k_size < 3:
        k_size = 3

    # cv2.getGaussianKernel(sigma=-1): sigma = 0.3*((ksize-1)*0.5 - 1) + 0.8
    sigma = 0.3 * ((k_size - 1) * 0.5 - 1) + 0.8
    x = np.arange(k_size) - (k_size - 1) / 2
    kern = np.exp(-(x**2) / (2 * sigma**2))
    kern /= kern.sum()
    pad = k_size // 2

    cols = np.stack(
        [poses[:, :3, 0], poses[:, :3, 1], poses[:, :3, 3]], axis=-1
    )  # (n, 3, 3): r1, r2, t
    padded = np.pad(cols, ((pad, pad), (0, 0), (0, 0)), mode="reflect")
    smooth = np.stack(
        [
            np.convolve(padded[:, d, c], kern, mode="valid")
            for d in range(3) for c in range(3)
        ], axis=-1,
    ).reshape(n, 3, 3)

    r1 = smooth[:, :, 0]
    r1 /= np.linalg.norm(r1, axis=-1, keepdims=True)
    r2 = smooth[:, :, 1]
    r2 /= np.linalg.norm(r2, axis=-1, keepdims=True)
    r3 = np.cross(r1, r2)
    t = smooth[:, :, 2]
    out = np.repeat(np.eye(4)[None], n, 0)
    out[:, :3, 0] = r1
    out[:, :3, 1] = r2
    out[:, :3, 2] = r3
    out[:, :3, 3] = t
    return out.astype(np.float32)
