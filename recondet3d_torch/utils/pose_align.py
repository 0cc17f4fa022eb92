"""Umeyama Sim(3) trajectory alignment (+RANSAC) (port of
``recondet3d/utils/pose_align.py``): the numpy host path copied as it is
(``align_poses_umeyama`` draws its RANSAC subsets from
``np.random.default_rng(random_state)``, so both packages draw the same
bits), and the batched scale the GS adapter needs in PyTorch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "umeyama_alignment",
    "align_poses_umeyama",
    "batch_align_poses_umeyama",
    "batch_umeyama_pose_scales",
]


def _to44_np(ext: np.ndarray) -> np.ndarray:
    if ext.shape[-2] == 3:
        out = np.tile(np.eye(4), (len(ext), 1, 1))
        out[:, :3, :4] = ext
        return out
    return ext


def _affine_inverse_np(A: np.ndarray) -> np.ndarray:
    R = A[..., :3, :3]
    T = A[..., :3, 3:]
    Rt = np.swapaxes(R, -1, -2)
    out = np.tile(np.eye(4), A.shape[:-2] + (1, 1))
    out[..., :3, :3] = Rt
    out[..., :3, 3:] = -Rt @ T
    return out


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = True):
    """Least-squares similarity transform mapping x -> y.

    x, y: (N, 3) point sets. Returns (R (3,3), t (3,), s scalar) with
    y ~= s * R @ x + t.
    """
    n = x.shape[0]
    mx, my = x.mean(0), y.mean(0)
    xc, yc = x - mx, y - my
    cov = yc.T @ xc / n
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_x = (xc ** 2).sum() / n
    s = float(np.trace(np.diag(D) @ S) / var_x) if with_scale else 1.0
    t = my - s * R @ mx
    return R, t, s


def _umeyama_from_ext(pose_ref: np.ndarray, pose_est: np.ndarray):
    """pose_* are c2w (N,4,4); align est centers to ref centers."""
    r, t, s = umeyama_alignment(pose_est[:, :3, 3], pose_ref[:, :3, 3])
    aligned = _apply_sim3(pose_est, r, t, s)
    return r, t, s, aligned


def _apply_sim3(poses: np.ndarray, r, t, s) -> np.ndarray:
    out = poses.copy()
    out[:, :3, :3] = r @ poses[:, :3, :3]
    out[:, :3, 3] = (r @ (s * poses[:, :3, 3].T)).T + t
    return out


def _median_nn_thresh(pose_ref, pose_est_aligned) -> float:
    P_ref = pose_ref[:, :3, 3]
    P_est = pose_est_aligned[:, :3, 3]
    d = np.linalg.norm(P_ref[None] - P_est[:, None], axis=-1).min(axis=1)
    return float(np.median(d)) if len(d) else 0.0


def align_poses_umeyama(
    ext_ref: np.ndarray,
    ext_est: np.ndarray,
    return_aligned: bool = False,
    ransac: bool = False,
    sub_n: Optional[int] = None,
    inlier_thresh: Optional[float] = None,
    ransac_max_iters: int = 10,
    random_state: Optional[int] = None,
):
    """Align estimated w2c extrinsics to reference (reference:
    pose_align.py:158-205). Returns (R, t, s[, aligned extrinsics])."""
    pose_ref = _affine_inverse_np(_to44_np(np.asarray(ext_ref, np.float64)))
    pose_est = _affine_inverse_np(_to44_np(np.asarray(ext_est, np.float64)))

    if not ransac:
        r, t, s, aligned = _umeyama_from_ext(pose_ref, pose_est)
    else:
        rng = np.random.default_rng(random_state)
        N = pose_ref.shape[0]
        sub_n = max(3, (N + 1) // 2) if sub_n is None else max(3, min(sub_n, N))
        r0, t0, s0, est0 = _umeyama_from_ext(pose_ref, pose_est)
        if inlier_thresh is None:
            inlier_thresh = _median_nn_thresh(pose_ref, est0)
        best_model, best_inliers = (r0, t0, s0), None
        best_score = (-1, np.inf)
        for _ in range(ransac_max_iters):
            sample = rng.choice(N, size=sub_n, replace=False)
            try:
                r, t, s, _ = _umeyama_from_ext(pose_ref[sample], pose_est[sample])
            except Exception:
                continue
            errs = np.linalg.norm(
                _apply_sim3(pose_est, r, t, s)[:, :3, 3] - pose_ref[:, :3, 3], axis=1
            )
            inliers = errs <= inlier_thresh
            k = int(inliers.sum())
            mean_err = float(errs[inliers].mean()) if k else np.inf
            if (k > best_score[0]) or (k == best_score[0] and mean_err < best_score[1]):
                best_score, best_model, best_inliers = (k, mean_err), (r, t, s), inliers
        if best_inliers is not None and best_inliers.sum() >= 3:
            r, t, s, _ = _umeyama_from_ext(pose_ref[best_inliers], pose_est[best_inliers])
        else:
            r, t, s = best_model
        aligned = _apply_sim3(pose_est, r, t, s)

    if return_aligned:
        return r, t, s, _affine_inverse_np(aligned)
    return r, t, s


def batch_align_poses_umeyama(ext_ref: np.ndarray, ext_est: np.ndarray):
    """(B, V, 3/4, 4) batch -> stacked (R, t, s) (reference: pose_align.py:50)."""
    rots, trans, scales = [], [], []
    for b in range(len(ext_ref)):
        r, t, s = align_poses_umeyama(ext_ref[b], ext_est[b])
        rots.append(r)
        trans.append(t)
        scales.append(s)
    return np.stack(rots), np.stack(trans), np.asarray(scales)


def batch_umeyama_pose_scales(ext_ref: torch.Tensor, ext_est: torch.Tensor) -> torch.Tensor:
    """Batched umeyama *scale* (the only part the GS adapter needs), on the
    tensors' device. ext_*: (B, V, 4, 4) w2c -> (B,)."""
    def centers(ext):
        R = ext[..., :3, :3]
        T = ext[..., :3, 3:]
        return (-R.transpose(-1, -2) @ T)[..., 0]  # c2w translation

    x = centers(ext_est).float()  # (B, V, 3)
    y = centers(ext_ref).float()
    n = x.shape[1]
    xc = x - x.mean(1, keepdim=True)
    yc = y - y.mean(1, keepdim=True)
    cov = torch.einsum("bni,bnj->bij", yc, xc) / n
    U, D, Vt = torch.linalg.svd(cov)
    sign = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    trace = D[..., 0] + D[..., 1] + sign * D[..., 2]
    var_x = torch.sum(xc ** 2, dim=(1, 2)) / n
    return trace / torch.clamp(var_x, min=1e-12)
