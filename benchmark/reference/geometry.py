"""Homogeneous geometry helpers (port of ``recondet3d/utils/geometry.py``)."""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = [
    "as_homogeneous",
    "affine_inverse",
    "homogenize_points",
    "sample_image_grid",
    "unproject",
    "get_world_rays",
    "map_pdf_to_opacity",
    "depth_to_points_cam",
]


def as_homogeneous(ext: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) or (..., 4, 4) -> (..., 4, 4)."""
    if ext.shape[-2:] == (4, 4):
        return ext
    if ext.shape[-2:] == (3, 4):
        bottom = torch.zeros_like(ext[..., :1, :4])
        bottom[..., 0, 3] = 1.0
        return torch.cat([ext, bottom], dim=-2)
    raise ValueError(f"invalid extrinsics shape {tuple(ext.shape)}")


def affine_inverse(A: torch.Tensor) -> torch.Tensor:
    """Inverse of an affine transform; keeps a (3,4) or (4,4) shape."""
    R = A[..., :3, :3]
    T = A[..., :3, 3:]
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, -Rt @ T], dim=-1)
    if A.shape[-2] == 3:
        return top
    return torch.cat([top, A[..., 3:, :]], dim=-2)


def homogenize_points(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def sample_image_grid(shape: Tuple[int, int], device="cuda"):
    """Normalized (0..1) xy coordinates + integer ij indices."""
    h, w = shape
    ys = torch.arange(h, device=device)
    xs = torch.arange(w, device=device)
    jj, ii = torch.meshgrid(ys, xs, indexing="ij")
    indices = torch.stack([jj, ii], dim=-1)
    xf = (xs + 0.5) / w
    yf = (ys + 0.5) / h
    xg, yg = torch.meshgrid(xf, yf, indexing="xy")
    coords = torch.stack([xg, yg], dim=-1)
    return coords, indices


def unproject(coordinates, z, intrinsics):
    """Unproject 2D (normalized) camera coords with Z values."""
    coords_h = homogenize_points(coordinates)
    inv_k = torch.linalg.inv(intrinsics.float()).to(intrinsics.dtype)
    dirs = torch.einsum("...ij,...j->...i", inv_k, coords_h.to(intrinsics.dtype))
    return dirs * z[..., None]


def get_world_rays(coordinates, extrinsics, intrinsics):
    """Ray origins + normalized directions in world space (c2w extrinsics)."""
    directions = unproject(coordinates, torch.ones_like(coordinates[..., 0]), intrinsics)
    directions = directions / torch.linalg.norm(directions, dim=-1, keepdim=True)
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0], dtype=directions.dtype, device=directions.device)
    dir_h = homogenize_points(directions) * mask
    org_h = torch.zeros_like(dir_h)
    org_h[..., 3] = 1.0
    world_dirs = torch.einsum("...ij,...j->...i", extrinsics, dir_h)[..., :3]
    world_orgs = torch.einsum("...ij,...j->...i", extrinsics, org_h)[..., :3]
    return world_orgs, world_dirs


def map_pdf_to_opacity(pdf, global_step: int = 0, opacity_mapping=None):
    """Density -> opacity mapping used by the GS adapter."""
    if opacity_mapping is not None:
        x = opacity_mapping["initial"] + min(
            global_step / opacity_mapping["warm_up"], 1
        ) * (opacity_mapping["final"] - opacity_mapping["initial"])
    else:
        x = 0.0
    exponent = 2.0 ** x
    return 0.5 * (1 - (1 - pdf) ** exponent + pdf ** (1 / exponent))


def depth_to_points_cam(depth: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Pinhole unprojection: depth (..., H, W), intrinsics (..., 3, 3) ->
    camera-frame points (..., H, W, 3)."""
    H, W = depth.shape[-2:]
    vv, uu = torch.meshgrid(
        torch.arange(H, dtype=depth.dtype, device=depth.device),
        torch.arange(W, dtype=depth.dtype, device=depth.device),
        indexing="ij",
    )
    fx = intrinsics[..., 0, 0][..., None, None]
    fy = intrinsics[..., 1, 1][..., None, None]
    cx = intrinsics[..., 0, 2][..., None, None]
    cy = intrinsics[..., 1, 2][..., None, None]
    z = depth
    x = (uu - cx) * z / fx
    y = (vv - cy) * z / fy
    return torch.stack([x, y, z], dim=-1)
