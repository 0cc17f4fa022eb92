"""3D Gaussian-splatting renderer in plain PyTorch (port of
``recondet3d/models/da3/gs_renderer.py``, which is plain XLA: no Pallas
kernel, so no hand-written kernel here either).

- EWA projection: the 3D covariance R S^2 R^T pushed through the perspective
  Jacobian to a 2D conic (+0.3 px low-pass, as gsplat).
- Tile binning as selection: for every 16x16 tile, the ``max_per_tile``
  nearest overlapping gaussians by depth, kept as a running top-K over
  blocks of gaussians; the top-K by depth is the depth sort too. Gaussians
  that overlap no tile (behind the camera, off screen) are left out first,
  and the blocks hold 32,768 (the JAX package's 4,096): with the distinct
  keys below, the K smallest of the union are the same whatever the blocks.
- Per tile, front-to-back alpha compositing over the K candidates,
  vectorised over the tile's 256 pixels.

Order among equal depths: ``lax.top_k`` keeps the lower index first among
equal keys and ``torch.topk`` promises no order, and a random net's depth
map holds many equal values. The top-K here runs on int64 keys (the depth's
fp32 bits, which order like the depths for the non-negative depths it sees,
over the gaussian's index), which are all distinct and order as the JAX
package's (depth, index) pairs do, so both composite in the same order.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from recondet3d_torch.specs import Gaussians
from recondet3d_torch.utils.device import resolve_device
from recondet3d_torch.utils.sh import eval_sh_basis
from recondet3d_torch.utils.transforms import quat_to_mat

__all__ = ["render_3dgs", "render_3dgs_single", "render_trajectory_frames", "render_trajectory_video"]

TILE = 16
BLOCK = 32768


def _quat_wxyz_to_mat(q):
    return quat_to_mat(torch.cat([q[..., 1:4], q[..., 0:1]], dim=-1))


def _project_gaussians(means, scales, rots_wxyz, w2c, K):
    """World gaussians -> screen: (xy (N,2), depth (N,), conic (N,3),
    radius (N,), valid (N,))."""
    R = w2c[:3, :3]
    t = w2c[:3, 3]
    p_cam = means @ R.T + t
    z = p_cam[:, 2]
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    zc = torch.clamp(z, min=1e-4)
    x2d = fx * p_cam[:, 0] / zc + cx
    y2d = fy * p_cam[:, 1] / zc + cy

    Rg = _quat_wxyz_to_mat(rots_wxyz)  # (N, 3, 3)
    M = Rg * scales[:, None, :]  # R @ diag(s)
    cov3d = M @ M.transpose(1, 2)
    cov_cam = torch.einsum("ij,njk,lk->nil", R, cov3d, R)

    # perspective Jacobian (EWA)
    J = torch.zeros((means.shape[0], 2, 3), dtype=means.dtype, device=means.device)
    J[:, 0, 0] = fx / zc
    J[:, 0, 2] = -fx * p_cam[:, 0] / zc ** 2
    J[:, 1, 1] = fy / zc
    J[:, 1, 2] = -fy * p_cam[:, 1] / zc ** 2
    cov2d = torch.einsum("nij,njk,nlk->nil", J, cov_cam, J)
    cov2d[:, 0, 0] += 0.3
    cov2d[:, 1, 1] += 0.3

    det = torch.clamp(cov2d[:, 0, 0] * cov2d[:, 1, 1] - cov2d[:, 0, 1] ** 2, min=1e-12)
    conic = torch.stack([cov2d[:, 1, 1] / det, -cov2d[:, 0, 1] / det, cov2d[:, 0, 0] / det], dim=-1)
    mid = 0.5 * (cov2d[:, 0, 0] + cov2d[:, 1, 1])
    lam = mid + torch.sqrt(torch.clamp(mid ** 2 - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam))
    valid = z > 0.01
    return torch.stack([x2d, y2d], -1), z, conic, radius, valid


def _depth_keys(depth: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """int64 keys that order (depth, index) pairs lexicographically, for
    depths >= 0 or +inf (their fp32 bit patterns order as the values do)."""
    bits = depth.float().contiguous().view(torch.int32).to(torch.int64)
    return (bits << 32) | index.to(torch.int64)


def render_3dgs_single(means, scales, rots_wxyz, harmonics, opacities, w2c, K, hw: Tuple[int, int],
                       max_per_tile: int = 192, sh_degree: int = 2, background: float = 0.0):
    """Render one view. Returns (rgb (H, W, 3), depth (H, W), alpha (H, W))."""
    H, W = hw
    dev = means.device
    Hp, Wp = ((H + TILE - 1) // TILE) * TILE, ((W + TILE - 1) // TILE) * TILE
    n_ty, n_tx = Hp // TILE, Wp // TILE
    n_tiles = n_ty * n_tx
    N = means.shape[0]
    means, w2c = means.float(), w2c.float()

    xy, depth, conic, radius, valid = _project_gaussians(means, scales.float(), rots_wxyz.float(), w2c, K.float())

    # view-dependent colour from SH
    cam_pos = -w2c[:3, :3].T @ w2c[:3, 3]
    dirs = means - cam_pos
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-8)
    basis = eval_sh_basis(dirs, sh_degree)  # (N, d_sh)
    colors = torch.clamp(torch.einsum("ncd,nd->nc", harmonics.float(), basis) + 0.5, min=0.0)

    x0, x1 = xy[:, 0] - radius, xy[:, 0] + radius
    y0, y1 = xy[:, 1] - radius, xy[:, 1] + radius
    tx = (torch.arange(n_tx, device=dev) * TILE).repeat(n_ty).float()[:, None]  # (T, 1), row-major tiles
    ty = (torch.arange(n_ty, device=dev) * TILE).repeat_interleave(n_tx).float()[:, None]

    # per-tile top-K by (depth, index) over blocks of the gaussians that overlap some tile
    inf = torch.tensor(float("inf"), device=dev)
    best = _depth_keys(inf.expand(n_tiles, max_per_tile), torch.zeros((), dtype=torch.int64, device=dev))
    seen = torch.nonzero(valid & (x1 >= 0) & (x0 <= Wp - 1) & (y1 >= 0) & (y0 <= Hp - 1))[:, 0]
    for lo in range(0, seen.numel(), BLOCK):
        ix = seen[lo:lo + BLOCK]
        overlap = ((x1[ix][None] >= tx) & (x0[ix][None] <= tx + TILE - 1)
                   & (y1[ix][None] >= ty) & (y0[ix][None] <= ty + TILE - 1))
        keys = _depth_keys(torch.where(overlap, depth[ix][None], inf), ix[None])
        best = torch.topk(torch.cat([best, keys], dim=1), max_per_tile, dim=1, largest=False, sorted=True).values
    cand_i = best & 0xFFFFFFFF  # an unfilled slot points at gaussian 0
    cand_d = (best >> 32).to(torch.int32).view(torch.float32)
    cand_ok = torch.isfinite(cand_d)  # (T, K) near to far

    xy_c, conic_c, color_c = xy[cand_i], conic[cand_i], colors[cand_i]
    opac_c = opacities.float()[cand_i]
    depth_c = torch.where(cand_ok, cand_d, torch.zeros_like(cand_d))

    ar = torch.arange(TILE, device=dev, dtype=torch.float32)
    pxx = (tx + ar[None]).repeat(1, TILE)  # (T, 256): x varies fastest
    pyy = (ty + ar[None]).repeat_interleave(TILE, dim=1)

    rgb = torch.zeros((n_tiles, TILE * TILE, 3), device=dev)
    dep = torch.zeros((n_tiles, TILE * TILE), device=dev)
    T = torch.ones((n_tiles, TILE * TILE), device=dev)
    for k in range(max_per_tile):
        dx = pxx - xy_c[:, k, 0:1] + 0.5 - 0.5  # the JAX package's roundings
        dy = pyy - xy_c[:, k, 1:2]
        a, b, c = conic_c[:, k, 0:1], conic_c[:, k, 1:2], conic_c[:, k, 2:3]
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = torch.clamp(opac_c[:, k, None] * torch.exp(torch.clamp(power, max=0.0)), 0.0, 0.999)
        alpha = torch.where(cand_ok[:, k, None] & (alpha > 1.0 / 255), alpha, torch.zeros_like(alpha))
        w = T * alpha
        rgb = rgb + w[..., None] * color_c[:, k, None, :]
        dep = dep + w * depth_c[:, k, None]
        T = T * (1 - alpha)
    alpha_img = 1 - T
    rgb = rgb + T[..., None] * background

    def untile(img):
        x = img.reshape(n_ty, n_tx, TILE, TILE, -1).permute(0, 2, 1, 3, 4).reshape(Hp, Wp, -1)
        return x[:H, :W]

    return untile(rgb)[..., :3], untile(dep[..., None])[..., 0], untile(alpha_img[..., None])[..., 0]


def _as_tensor(x, device):
    return x.to(device) if torch.is_tensor(x) else torch.from_numpy(np.asarray(x)).to(device)


def render_3dgs(gaussians: Gaussians, extrinsics, intrinsics, hw: Tuple[int, int], max_per_tile: int = 192,
                background: float = 0.0, device=None):
    """Batched multi-view rendering. ``extrinsics`` (V, 4, 4) or (B, V, 4, 4)
    w2c, ``intrinsics`` matching; the gaussians' fields are tensors or numpy
    arrays. Runs on ``device``: by default the means' device when they are a
    tensor, else the card (``resolve_device("cuda")``, which raises without
    CUDA; the CPU is asked for with ``device="cpu"``). Returns
    (rgb (V, H, W, 3), depth (V, H, W), alpha (V, H, W))."""
    if device is None:
        device = gaussians.means.device if torch.is_tensor(gaussians.means) else "cuda"
    device = resolve_device(device)
    means = _as_tensor(gaussians.means, device).reshape(-1, 3)
    scales = _as_tensor(gaussians.scales, device).reshape(-1, 3)
    rots = _as_tensor(gaussians.rotations, device).reshape(-1, 4)
    harm = _as_tensor(gaussians.harmonics, device)
    harm = harm.reshape(-1, harm.shape[-2], harm.shape[-1])
    opac = _as_tensor(gaussians.opacities, device).reshape(-1)
    sh_degree = int(np.sqrt(harm.shape[-1])) - 1
    ext = _as_tensor(extrinsics, device).reshape(-1, 4, 4)
    ixt = _as_tensor(intrinsics, device).reshape(-1, 3, 3)
    outs = [render_3dgs_single(means, scales, rots, harm, opac, ext[v], ixt[v], tuple(hw), max_per_tile=max_per_tile,
                               sh_degree=sh_degree, background=background) for v in range(ext.shape[0])]
    return tuple(torch.stack([o[i] for o in outs]) for i in range(3))


def render_trajectory_frames(gaussians: Gaussians, extrinsics, intrinsics, hw, device=None, **kwargs) -> np.ndarray:
    """The frames of a camera trajectory as uint8 (V, H, W, 3) RGB on the
    host, rendered on ``device`` (as ``render_3dgs``)."""
    rgb, _, _ = render_3dgs(gaussians, extrinsics, intrinsics, hw, device=device, **kwargs)
    return (np.clip(rgb.cpu().numpy(), 0, 1) * 255).astype(np.uint8)


def render_trajectory_video(gaussians: Gaussians, extrinsics, intrinsics, hw, out_path: str, fps: int = 15,
                            device=None, **kwargs):
    """Render a camera trajectory on ``device`` to an mp4 (written with
    OpenCV; without cv2 this raises before rendering)."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("the gs_video exporter writes its mp4 with OpenCV (cv2), which is not installed") from e

    frames = render_trajectory_frames(gaussians, extrinsics, intrinsics, hw, device=device, **kwargs)
    H, W = frames.shape[1:3]
    vw = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (W, H))
    for f in frames:
        vw.write(f[..., ::-1])
    vw.release()
    return out_path
