"""Sparse voxel refinement (port of
``recondet3d/models/refine/refinement.py``).

Pseudo points -> hard voxelize -> mean VFE -> ``SparseEncoder`` -> BEV
height-occupancy U-Net -> occupancy logits (B, Y, X, C) fp32. For training,
ground-truth points are voxelized on the occupancy grid through the soft
occupancy VFE into a dense soft target, and ``OccupancyLoss`` compares the
logits with it. Batch statistics of the norms follow the module's
``training`` flag (the JAX package's ``train`` argument).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from recondet3d_torch.models.refine.bev_unet import BEVHeightOccupancy
from recondet3d_torch.models.refine.sparse_encoder import SparseEncoder
from recondet3d_torch.models.losses.occupancy_loss import OccupancyLoss
from recondet3d_torch.models.refine.vfe import hard_simple_vfe, soft_voxel_occupancy_vfe
from recondet3d_torch.ops.voxelize import voxelize
from recondet3d_torch.utils.stage_timer import stage

__all__ = ["SparseRefinement", "batch_voxelize", "init_refinement_parameters_"]

def batch_voxelize(points, valid, *, point_cloud_range, voxel_size, max_points, max_voxels):
    """(B, N, C) -> flattened voxels (B*V, max_points, C), coords (B*V, 4)
    int32 [b, z, y, x] (-1 pads), num_points (B*V,)."""
    voxels, coors4, nums = [], [], []
    for b in range(points.shape[0]):
        v, c, n, _ = voxelize(points[b], valid[b], point_cloud_range=tuple(point_cloud_range),
                              voxel_size=tuple(voxel_size), max_points=max_points, max_voxels=max_voxels)
        batch_idx = torch.where(c[:, :1] >= 0, torch.full_like(c[:, :1], b), torch.full_like(c[:, :1], -1))
        voxels.append(v)
        coors4.append(torch.cat([batch_idx, c], dim=1))
        nums.append(n)
    return torch.cat(voxels), torch.cat(coors4), torch.cat(nums)


@torch.no_grad()
def init_refinement_parameters_(model: nn.Module, generator: torch.Generator) -> None:
    """Random init from ``generator``: N(0, 1/fan_in) sparse and dense
    kernels, zero biases; norms keep unit scale and their fresh running
    statistics. Numbers are drawn on the generator's device."""
    for name, p in model.named_parameters():
        if name.endswith("weight") and p.dim() >= 3:
            fan_in = p.shape[0] * p.shape[1] if p.dim() == 3 else p[0].numel()
            p.copy_(torch.randn(p.shape, generator=generator, device=generator.device) * fan_in ** -0.5)
        elif name.endswith("bias"):
            p.zero_()


class SparseRefinement(nn.Module):
    """``dtype`` is the computation dtype of the sparse encoder and the BEV
    U-Net; parameters, batch-norm statistics and the logits stay fp32."""

    def __init__(
        self,
        point_cloud_range: Sequence[float] = (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0),
        voxel_size: Sequence[float] = (0.075, 0.075, 0.2),
        max_num_points: int = 10,
        max_voxels: int = 65536,
        occ_feature_shape: Sequence[int] = (180, 180, 32),
        occ_max_voxels: int = 65536,
        occ_max_num_points: int = 10,
        soft_vfe: Tuple[float, float] = (0.3, 5.0),
        use_color: bool = False,
        sparse_shape: Sequence[int] = (41, 1440, 1440),
        encoder_out_channels: int = 128,
        unet_channels: Sequence[int] = (256, 512, 1024, 2048),
        stage_caps: Sequence[int] = (65536, 49152, 32768, 16384),
        loss_type: str = "bce",
        occupancy_loss_weight: float = 10.0,
        bug_compatible_relu_logits: bool = False,
        dtype=torch.float32,
        device=None,
    ):
        super().__init__()
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.max_num_points, self.max_voxels = int(max_num_points), int(max_voxels)
        self.occ_feature_shape = tuple(int(v) for v in occ_feature_shape)
        self.occ_max_voxels, self.occ_max_num_points = int(occ_max_voxels), int(occ_max_num_points)
        self.soft_vfe = tuple(soft_vfe)
        pcr = np.asarray(self.point_cloud_range, np.float64)
        self._occ_voxel_size = tuple((pcr[3:] - pcr[:3]) / np.asarray(self.occ_feature_shape, np.float64))
        self.loss_occupancy = OccupancyLoss(loss_type=loss_type, loss_weight=occupancy_loss_weight)
        self.use_color, self.dtype = bool(use_color), dtype
        self.middle_encoder = SparseEncoder(
            in_channels=6 if use_color else 3, sparse_shape=tuple(sparse_shape),
            output_channels=encoder_out_channels, stage_caps=tuple(stage_caps), device=device)
        self.bev_height_occupancy = BEVHeightOccupancy(
            in_channels=self.middle_encoder.bev_channels, unet_channels=tuple(unet_channels),
            occ_feature_shape=tuple(occ_feature_shape), bug_compatible_relu_logits=bug_compatible_relu_logits,
            dtype=dtype, device=device)

    def forward(self, pseudo_points: torch.Tensor, pseudo_valid: Optional[torch.Tensor] = None,
                gt_points=None, gt_valid=None, return_loss: bool = False):
        """pseudo_points (B, N, C), pseudo_valid (B, N) bool -> (refined
        points (the input), losses, aux with ``occupancy_logits``,
        ``pseudo_coors`` and ``bev_features``). With ``gt_points`` (B, M, 3)
        aux also holds ``gt_occupancy_map`` and, when ``return_loss`` is
        set, losses holds ``loss_occupancy``."""
        B = pseudo_points.shape[0]
        pts = pseudo_points if self.use_color else pseudo_points[..., :3]
        if pseudo_valid is None:
            pseudo_valid = torch.ones(pts.shape[:2], dtype=torch.bool, device=pts.device)

        with stage("voxelize_vfe"):
            voxels, coors, nums = batch_voxelize(
                pts, pseudo_valid, point_cloud_range=self.point_cloud_range, voxel_size=self.voxel_size,
                max_points=self.max_num_points, max_voxels=self.max_voxels)
            voxel_feats = hard_simple_vfe(voxels, nums, num_features=pts.shape[-1])
            voxel_feats = torch.where((coors[:, 0] >= 0)[:, None], voxel_feats, torch.zeros_like(voxel_feats))
        with stage("sparse_encoder"):
            sparse_features = self.middle_encoder(voxel_feats.to(self.dtype), coors, B)
        with stage("bev_unet"):
            occupancy_logits = self.bev_height_occupancy(sparse_features)
        aux = {"occupancy_logits": occupancy_logits, "pseudo_coors": coors, "bev_features": sparse_features}
        losses: Dict[str, torch.Tensor] = {}
        if gt_points is not None:
            with stage("gt_occupancy_map"):
                aux["gt_occupancy_map"] = self.generate_gt_occupancy_map(gt_points, gt_valid)
            if return_loss:
                losses["loss_occupancy"] = self.loss_occupancy(occupancy_logits, aux["gt_occupancy_map"],
                                                               use_logits=True)
        return pseudo_points, losses, aux

    @torch.no_grad()
    def generate_gt_occupancy_map(self, gt_points, gt_valid=None):
        """GT points (B, M, >=3) -> dense soft occupancy (B, Y, X, C) fp32, a constant of the loss."""
        B = gt_points.shape[0]
        if gt_valid is None:
            gt_valid = torch.ones(gt_points.shape[:2], dtype=torch.bool, device=gt_points.device)
        voxels, coors, nums = batch_voxelize(
            gt_points[..., :3], gt_valid, point_cloud_range=self.point_cloud_range, voxel_size=self._occ_voxel_size,
            max_points=self.occ_max_num_points, max_voxels=self.occ_max_voxels)
        occ = soft_voxel_occupancy_vfe(voxels, nums, *self.soft_vfe)[:, 0]
        X, Y, C = self.occ_feature_shape
        c = coors.long()
        valid = c[:, 0] >= 0
        gt_map = torch.zeros((B + 1, Y, X, C), dtype=torch.float32, device=gt_points.device)  # plane B takes the pads
        b = torch.where(valid, c[:, 0], torch.full_like(c[:, 0], B))
        zz, yy, xx = (torch.where(valid, c[:, i], torch.zeros_like(c[:, i])) for i in (1, 2, 3))
        gt_map[b, yy, xx, zz] = occ
        return gt_map[:B]
