"""Voxel feature encoders (port of ``recondet3d/models/refine/vfe.py``):
``hard_simple_vfe`` on the inference path, ``soft_voxel_occupancy_vfe`` for
the training target.
"""

from __future__ import annotations

import torch

__all__ = ["hard_simple_vfe", "soft_voxel_occupancy_vfe"]


def hard_simple_vfe(voxels: torch.Tensor, num_points: torch.Tensor, num_features: int = 3) -> torch.Tensor:
    """(V, P, C), (V,) -> (V, num_features): mean of the valid points
    (empty slots of a voxel hold zeros)."""
    feats = voxels[..., :num_features]
    denom = num_points.clamp(min=1).to(feats.dtype)[:, None]
    return feats.sum(dim=1) / denom


def soft_voxel_occupancy_vfe(voxels: torch.Tensor, num_points: torch.Tensor, lambda_n: float = 0.3,
                             gamma_var: float = 5.0, eps: float = 1e-6) -> torch.Tensor:
    """(V, P, C), (V,) -> (V, 1): p_occ = 1 - exp(-lambda_n * n - gamma_var * var),
    var the mean over xyz of the variance of the voxel's n valid points."""
    P = voxels.shape[1]
    xyz = voxels[..., :3].float()
    mask = (torch.arange(P, device=voxels.device)[None, :] < num_points[:, None]).float()[..., None]
    n = num_points.float()
    denom = n[:, None] + eps
    mean = (xyz * mask).sum(dim=1) / denom
    diff = (xyz - mean[:, None]) * mask
    var = ((diff ** 2).sum(dim=1) / denom).mean(dim=1)
    return (1.0 - torch.exp(-lambda_n * n - gamma_var * var))[:, None]
