"""Ray-based camera pose estimation, the ``use_ray_pose`` path (port of
``recondet3d/utils/ray_utils.py``).

The DualDPT ray head predicts per-patch camera rays (direction +
translation); rotation and intrinsics come from the homography between the
identity camera's ray grid and the predicted directions (A = K R), split by
a QL decomposition; translation is the confidence-weighted mean.
Homographies are fit from the 9x9 weighted normal equations (smallest
eigenvector); RANSAC is a fixed batch of 100 minimal 8-point fits scored at
once, then a refit on the best candidate's inliers.

The minimal sets: the JAX package draws each view's 100 permutations with
``jax.random`` from ``PRNGKey(seed)`` split per view, which PyTorch cannot
reproduce. The port draws them on the rays' device from a
``torch.Generator`` seeded with ``seed`` (``draw_minimal_sets``, kept per
shape, seed and device, so a call after the first draws nothing), and
``camray_to_caminfo`` takes a view's sets as an argument, so that a test can
hand it the JAX package's and compare the two exactly.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

__all__ = ["get_extrinsic_from_camray", "camray_to_caminfo", "draw_minimal_sets"]

N_ITER = 100
N_MINIMAL = 8


def _homography_from_normal_eqs(src, dst, w):
    """Weighted DLT: rows of A for each point pair, min ||A h|| from the
    smallest eigenvector of A^T W A. src/dst (..., N, 2), w (..., N) ->
    (..., 3, 3)."""
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    r1 = torch.stack([-x, -y, -ones, zeros, zeros, zeros, x * u, y * u, u], dim=-1)
    r2 = torch.stack([zeros, zeros, zeros, -x, -y, -ones, x * v, y * v, v], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # (..., 2N, 9)
    ww = torch.cat([w, w], dim=-1)[..., None]
    AtA = torch.einsum("...ni,...nj->...ij", A * ww, A)
    _, vecs = torch.linalg.eigh(AtA)
    h = vecs[..., :, 0]  # smallest eigenvalue
    H = h.reshape(h.shape[:-1] + (3, 3))
    return H / H[..., 2:3, 2:3]


def n_sample_of(n_points: int) -> int:
    """How many of a view's top-weighted points the minimal sets draw from."""
    return max(N_MINIMAL, int(n_points * 0.3))


def draw_minimal_sets(n_views: int, n_points: int, seed: int = 42, device="cpu") -> torch.Tensor:
    """(n_views, N_ITER, N_MINIMAL) int64 on ``device``: for each view and
    iteration the first N_MINIMAL entries of a random permutation of
    range(n_sample), drawn on ``device`` from a ``torch.Generator`` seeded
    with ``seed``. The result is cached: callers must not write to it."""
    return _draw_minimal_sets(n_views, n_points, seed, torch.device(device))


@functools.lru_cache(maxsize=16)
def _draw_minimal_sets(n_views: int, n_points: int, seed: int, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):  # a normal tensor, usable by a later call under autograd
        gen = torch.Generator(device=device).manual_seed(seed)
        keys = torch.rand((n_views, N_ITER, n_sample_of(n_points)), generator=gen, device=device)
        return torch.argsort(keys, dim=-1)[..., :N_MINIMAL].contiguous()


def _ransac_homography(src, dst, weights, perm, reproj_threshold=0.2):
    """Per view: src/dst (V, N, 2), weights (V, N), perm (V, N_ITER,
    N_MINIMAL) positions among each view's n_sample top-weighted points ->
    (V, 3, 3)."""
    V, N = weights.shape
    order = torch.argsort(-weights, dim=-1, stable=True)[:, :n_sample_of(N)]
    idx = torch.gather(order[:, None, :].expand(V, perm.shape[1], order.shape[1]), 2, perm)  # (V, n_iter, 8)
    view = torch.arange(V, device=src.device)[:, None, None]
    H_cand = _homography_from_normal_eqs(src[view, idx], dst[view, idx], weights[view, idx])

    src_h = torch.cat([src, torch.ones_like(src[..., :1])], dim=-1)  # (V, N, 3)
    proj = torch.einsum("vkij,vnj->vkni", H_cand, src_h)
    z = proj[..., 2:3]
    proj_xy = proj[..., :2] / torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
    err = torch.linalg.norm(proj_xy - dst[:, None], dim=-1)  # (V, n_iter, N)
    inlier = err < reproj_threshold
    score = torch.sum(inlier * weights[:, None], dim=-1)
    best = torch.argmax(score, dim=-1)  # the first of equal scores
    rows = torch.arange(V, device=src.device)
    best_inlier = inlier[rows, best]

    # refit on all inliers (weighted); the best candidate when too few inliers
    w_in = torch.where(best_inlier, weights, torch.zeros_like(weights))
    H_fit = _homography_from_normal_eqs(src, dst, w_in)
    return torch.where((best_inlier.sum(-1) >= 4)[:, None, None], H_fit, H_cand[rows, best])


def _ql_decomposition(A):
    """A = Q L with Q a rotation, L lower-triangular with a positive diagonal."""
    P = torch.tensor([[0.0, 0, 1], [0, 1, 0], [1, 0, 0]], dtype=A.dtype, device=A.device)
    Qt, Rt = torch.linalg.qr(A @ P)
    Q = Qt @ P
    L = P @ Rt @ P
    d = torch.sign(torch.diagonal(L, dim1=-2, dim2=-1))
    return Q * d[..., None, :], L * d[..., :, None]


def camray_to_caminfo(camray, confidence=None, reproj_threshold: float = 0.2, seed: int = 42,
                      minimal_sets: Optional[torch.Tensor] = None):
    """camray (B, S, h, w, 6), confidence (B, S, h, w) ->
    (R (B,S,3,3), T (B,S,3), focal (B,S,2), pp (B,S,2)). ``minimal_sets``
    (B*S, N_ITER, N_MINIMAL) defaults to ``draw_minimal_sets(B*S, h*w, seed)``."""
    B, S, h, w, _ = camray.shape
    dev = camray.device
    if confidence is None:
        confidence = torch.ones(camray.shape[:-1], dtype=camray.dtype, device=dev)

    # identity-camera unit-depth ray grid with normalized K (principal point at (1, 1), image spanning 2x2)
    xs = (torch.arange(w, device=dev) + 0.5) * (2.0 / w) - 1.0
    ys = (torch.arange(h, device=dev) + 0.5) * (2.0 / h) - 1.0
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    origin = torch.stack([xg, yg, torch.ones_like(xg)], dim=-1).float()  # (h, w, 3)

    rays_o = origin.reshape(1, h * w, 3).expand(B * S, h * w, 3)
    cam = camray.reshape(B * S, h * w, 6).float()
    conf = confidence.reshape(B * S, h * w).float()
    rays_t = cam[..., :3]

    z_ok = (rays_t[..., 2].abs() > 1e-4) & (rays_o[..., 2].abs() > 1e-4)

    def z_norm(r):
        z = torch.where(r[..., 2:3].abs() > 1e-4, r[..., 2:3], torch.ones_like(r[..., 2:3]))
        return r[..., :2] / z

    src = z_norm(rays_o)
    dst = z_norm(rays_t)
    wts = torch.where(z_ok, conf, torch.zeros_like(conf))

    if minimal_sets is None:
        minimal_sets = draw_minimal_sets(B * S, h * w, seed, dev)
    A = _ransac_homography(src, dst, wts, minimal_sets.to(dev), reproj_threshold)
    A = torch.where(torch.linalg.det(A)[:, None, None] < 0, -A, A)

    Q, L = _ql_decomposition(A)
    L = L / L[:, 2:3, 2:3]
    f = torch.stack([L[:, 0, 0], L[:, 1, 1]], dim=-1)
    pp = torch.stack([L[:, 2, 0], L[:, 2, 1]], dim=-1)

    T = torch.sum(cam[..., 3:] * conf[..., None], dim=1) / torch.clamp(conf.sum(dim=1, keepdim=True), min=1e-8)

    return Q.reshape(B, S, 3, 3), T.reshape(B, S, 3), (1.0 / f).reshape(B, S, 2), (pp + 1.0).reshape(B, S, 2)


def get_extrinsic_from_camray(camray, conf, patch_size_y=None, patch_size_x=None):
    """(B, S, h, w, 6) rays + (B, S, h, w) conf -> (w2c (B,S,4,4),
    focal (B,S,2), pp (B,S,2))."""
    if conf is not None and conf.ndim == camray.ndim:
        conf = conf[..., 0]
    R, T, focal, pp = camray_to_caminfo(camray, conf)
    B, S = R.shape[:2]
    bottom = torch.tensor([0.0, 0, 0, 1.0], device=R.device).expand(B, S, 1, 4)
    ext = torch.cat([torch.cat([R, T[..., None]], dim=-1), bottom], dim=-2)
    return ext, focal, pp
