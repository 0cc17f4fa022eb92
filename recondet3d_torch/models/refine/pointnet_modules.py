"""PointNet++ set abstraction and feature propagation (port of
``recondet3d/models/refine/pointnet_modules.py``).

``PointSAModuleMSG``: furthest-point sampling (the FPS kernel on CUDA
tensors, ``ops/fps.py``), one ball query a scale, grouping, a shared MLP
and a max over each group. ``PointFPModule``: inverse-distance 3-NN
interpolation and a shared MLP. Points and features are channels-last
rows, (N, 3) and (N, C), as in the JAX package.

Module names follow the flax tree (``mlp0.fc0``, ``mlp0.bn0``, ``mlp.fc1``,
...). The norms are ``FlaxBatchNorm`` over every (center, neighbour) row:
flax's ``nn.BatchNorm`` (momentum 0.99, eps 1e-3, E[x^2] - E[x]^2, biased
running variance). Constructors build on ``device`` (``cuda`` unless the
caller asks for the CPU) and take the input widths the flax modules infer.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from recondet3d_torch.models.refine.bev_unet import FlaxBatchNorm
from recondet3d_torch.ops.ball_query import ball_query
from recondet3d_torch.ops.grouping import three_interpolate, three_nn
from recondet3d_torch.ops.sampling import furthest_point_sample
from recondet3d_torch.utils.device import resolve_device

__all__ = ["PointSAModule", "PointSAModuleMSG", "PointFPModule"]


class _SharedMLP(nn.Module):
    """Dense (no bias) -> batch norm -> ReLU per width, over the last axis."""

    def __init__(self, in_channels: int, channels: Sequence[int], device=None):
        super().__init__()
        self.depth = len(channels)
        for i, c in enumerate(channels):
            setattr(self, f"fc{i}", nn.Linear(in_channels, c, bias=False, device=device))
            setattr(self, f"bn{i}", FlaxBatchNorm(c, device=device))
            in_channels = c

    def forward(self, x):
        for i in range(self.depth):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"fc{i}")(x)))
        return x


class PointSAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction: xyz (N, 3) [+ features
    (N, in_channels)] -> (new_xyz (num_point, 3), features (num_point,
    sum of the MLPs' last widths), FPS indices (num_point,) int64)."""

    def __init__(self, num_point: int, radii: Sequence[float], sample_nums: Sequence[int],
                 mlp_channels: Sequence[Sequence[int]], use_xyz: bool = True, in_channels: int = 0,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.num_point, self.radii, self.sample_nums = int(num_point), tuple(radii), tuple(sample_nums)
        self.use_xyz = use_xyz
        # the flax module infers its width: xyz offsets alone without features, features (+ xyz) with them
        width = (in_channels + (3 if use_xyz else 0)) if in_channels else 3
        for bi, mlp in enumerate(mlp_channels):
            setattr(self, f"mlp{bi}", _SharedMLP(width, tuple(mlp), device=dev))

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor] = None,
                valid: Optional[torch.Tensor] = None):
        idx = furthest_point_sample(xyz, self.num_point, valid)
        new_xyz = xyz[idx]
        outs = []
        for bi, (r, k) in enumerate(zip(self.radii, self.sample_nums)):
            nbr = ball_query(0.0, r, k, xyz, new_xyz, points_valid=valid)
            grouped = xyz[nbr] - new_xyz[:, None]  # (M, k, 3)
            if features is not None:
                grouped = torch.cat([grouped, features[nbr]], dim=-1) if self.use_xyz else features[nbr]
            outs.append(getattr(self, f"mlp{bi}")(grouped).amax(dim=1))
        return new_xyz, torch.cat(outs, dim=-1), idx


class PointSAModule(PointSAModuleMSG):
    """Single-scale set abstraction, built by ``PointSAModule.single``."""

    @classmethod
    def single(cls, num_point, radius, sample_num, mlp, **kw):
        return cls(num_point=num_point, radii=(radius,), sample_nums=(sample_num,), mlp_channels=(tuple(mlp),), **kw)


class PointFPModule(nn.Module):
    """Feature propagation: the source's features interpolated onto the
    target points by inverse-distance 3-NN (weights 1 / max(dist, 1e-8),
    normalised), concatenated after the target's own features, then a shared
    MLP. ``in_channels``: target + source feature widths."""

    def __init__(self, mlp_channels: Sequence[int], in_channels: int, device="cuda"):
        super().__init__()
        self.mlp = _SharedMLP(int(in_channels), tuple(mlp_channels), device=resolve_device(device))

    def forward(self, target_xyz, source_xyz, target_feats, source_feats):
        dist, idx = three_nn(target_xyz, source_xyz)
        w = 1.0 / dist.clamp(min=1e-8)
        w = w / w.sum(dim=1, keepdim=True)
        interp = three_interpolate(source_feats.t(), idx, w).t()  # (Nt, C)
        if target_feats is not None:
            interp = torch.cat([target_feats, interp], dim=-1)
        return self.mlp(interp)
