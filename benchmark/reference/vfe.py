"""Voxel feature encoders (port of ``recondet3d/models/refine/vfe.py``):
``hard_simple_vfe`` on the inference path, ``soft_voxel_occupancy_vfe`` for
the training target, ``hard_voxel_occupancy_vfe``, and the three config
wrappers registered in ``VOXEL_ENCODERS``. Outputs lie on the inputs' device.
"""

from __future__ import annotations

import torch


__all__ = [
    "hard_simple_vfe",
    "hard_voxel_occupancy_vfe",
    "soft_voxel_occupancy_vfe",
    "HardSimpleVFE",
    "HardVoxelOccupancyVFE",
    "SoftVoxelOccupancyVFE",
]


def hard_simple_vfe(voxels: torch.Tensor, num_points: torch.Tensor, num_features: int = 3) -> torch.Tensor:
    """(V, P, C), (V,) -> (V, num_features): mean of the valid points
    (empty slots of a voxel hold zeros)."""
    feats = voxels[..., :num_features]
    denom = num_points.clamp(min=1).to(feats.dtype)[:, None]
    return feats.sum(dim=1) / denom


def hard_voxel_occupancy_vfe(voxels: torch.Tensor, num_points: torch.Tensor) -> torch.Tensor:
    """(V,) -> (V, 1) fp32 binary occupancy."""
    return (num_points > 0).float()[:, None]


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


class HardSimpleVFE:
    def __init__(self, num_features: int = 3):
        self.num_features = num_features

    def __call__(self, voxels, num_points, coors=None):
        return hard_simple_vfe(voxels, num_points, self.num_features)


class HardVoxelOccupancyVFE:
    def __call__(self, voxels, num_points, coors=None):
        return hard_voxel_occupancy_vfe(voxels, num_points)


class SoftVoxelOccupancyVFE:
    def __init__(self, lambda_n=0.3, gamma_var=5.0, eps=1e-6):
        self.lambda_n, self.gamma_var, self.eps = lambda_n, gamma_var, eps

    def __call__(self, voxels, num_points, coors=None):
        return soft_voxel_occupancy_vfe(voxels, num_points, self.lambda_n, self.gamma_var, self.eps)
