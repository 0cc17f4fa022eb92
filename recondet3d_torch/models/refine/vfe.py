"""Voxel feature encoders (port of ``recondet3d/models/refine/vfe.py``).

Only ``hard_simple_vfe`` is on the inference path; the soft occupancy
encoder builds the training target and is not ported yet.
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


def soft_voxel_occupancy_vfe(*args, **kwargs):
    raise NotImplementedError(
        "soft_voxel_occupancy_vfe builds the training target of the refinement; "
        "training is not ported yet (ROADMAP §1 item 11)")
