"""SECOND backbone, SECONDFPN neck, PointPillars scatter and the learned
voxel feature encoders (port of ``recondet3d/models/refine/second.py``).

Public layouts are the JAX package's: BEV maps channels-last (B, H, W, C)
in and out (NCHW inside), voxels (V, P, C), points (N, C). Module names
follow the flax tree with its auto-names: a conv + norm block holds its
convolution as ``Conv_0`` and is itself the norm (``block0_down.Conv_0``,
``block0_down.weight`` / ``running_mean``); a PFN layer holds ``Dense_0``;
a deblock at stride > 1 keeps its (C, out, s, s) kernel as ``up`` (a
``ConvTranspose2d`` with kernel = stride, the JAX package's exact
depth-to-space einsum). Norms are flax's (``FlaxBatchNorm2d``,
``FlaxBatchNorm``); a PFN layer's statistics take every (voxel, slot) row,
the empty slots included, as in the JAX package. Constructors build on
``device`` (``cuda`` unless the caller asks for the CPU).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from recondet3d_torch.models.refine.bev_unet import FlaxBatchNorm, FlaxBatchNorm2d
from recondet3d_torch.ops.scatter import dynamic_scatter
from recondet3d_torch.ops.voxelize import compute_grid_size
from recondet3d_torch.utils.device import resolve_device

__all__ = ["SECOND", "SECONDFPN", "PointPillarsScatter", "HardVFE", "DynamicVFE"]


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class _ConvBNReLU(FlaxBatchNorm2d):
    """3x3 conv (no bias, padding 1) -> the norm this module is -> ReLU, NCHW."""

    def __init__(self, cin: int, cout: int, stride: int = 1, device=None):
        super().__init__(cout, device=device)
        self.Conv_0 = nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False, device=device)

    def forward(self, x):
        return F.relu(super().forward(self.Conv_0(x)))


class SECOND(nn.Module):
    def __init__(self, in_channels: int = 128, out_channels: Sequence[int] = (128, 128, 256),
                 layer_nums: Sequence[int] = (3, 5, 5), layer_strides: Sequence[int] = (2, 2, 2), device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.layer_nums = tuple(layer_nums)
        cin = in_channels
        for i, (n, s, c) in enumerate(zip(layer_nums, layer_strides, out_channels)):
            setattr(self, f"block{i}_down", _ConvBNReLU(cin, c, s, device=dev))
            for j in range(n):
                setattr(self, f"block{i}_conv{j}", _ConvBNReLU(c, c, 1, device=dev))
            cin = c

    def forward(self, x):
        """(B, H, W, C) -> tuple of channels-last multi-scale maps."""
        x = _nchw(x.float())
        outs = []
        for i, n in enumerate(self.layer_nums):
            x = getattr(self, f"block{i}_down")(x)
            for j in range(n):
                x = getattr(self, f"block{i}_conv{j}")(x)
            outs.append(_nhwc(x))
        return tuple(outs)


class _DeblockUp(FlaxBatchNorm2d):
    """stride s > 1: the transposed conv with kernel = stride (``up``); s == 1:
    a 3x3 conv, padding 1; s < 1: a conv of kernel and stride round(1 / s)
    with flax's 'SAME' padding. Then the norm this module is, and ReLU."""

    def __init__(self, cin: int, cout: int, stride, device=None):
        super().__init__(cout, device=device)
        if stride >= 1:
            s = int(stride)
            self.s = s
            if s > 1:
                self.up = nn.ConvTranspose2d(cin, cout, s, stride=s, bias=False, device=device)
            else:
                self.Conv_0 = nn.Conv2d(cin, cout, 3, padding=1, bias=False, device=device)
        else:
            self.s = -int(round(1 / stride))
            k = -self.s
            self.Conv_0 = nn.Conv2d(cin, cout, k, stride=k, bias=False, device=device)

    def forward(self, x):
        if self.s > 1:
            x = self.up(x)
        elif self.s == 1:
            x = self.Conv_0(x)
        else:
            k = -self.s
            ph, pw = (-x.shape[-2]) % k, (-x.shape[-1]) % k  # 'SAME': the output ceil(size / k), the extra row low half
            x = self.Conv_0(F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2)))
        return F.relu(super().forward(x))


class SECONDFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (128, 128, 256), out_channels: Sequence[int] = (256, 256, 256),
                 upsample_strides: Sequence[float] = (1, 2, 4), device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.n = len(in_channels)
        for i, (cin, c, s) in enumerate(zip(in_channels, out_channels, upsample_strides)):
            setattr(self, f"deblock{i}", _DeblockUp(cin, c, s, device=dev))

    def forward(self, feats):
        """Tuple of channels-last maps -> (B, H, W, sum of out_channels)."""
        ups = [getattr(self, f"deblock{i}")(_nchw(f.float())) for i, f in enumerate(feats)]
        return _nhwc(torch.cat(ups, dim=1) if len(ups) > 1 else ups[0])


class PointPillarsScatter(nn.Module):
    """(N, C) pillar features + (N, 4) [b, z, y, x] coords -> (B, ny, nx, C)
    pseudo image; rows with b < 0 are dropped."""

    def __init__(self, in_channels: int, output_shape: Tuple[int, int]):
        super().__init__()
        self.in_channels, self.output_shape = in_channels, tuple(output_shape)

    def forward(self, voxel_features, coors, batch_size: int):
        ny, nx = self.output_shape
        c = coors.long()
        valid = c[:, 0] >= 0
        b = torch.where(valid, c[:, 0], torch.full_like(c[:, 0], batch_size))  # plane batch_size: cut off below
        y, x = (torch.where(valid, c[:, i], torch.zeros_like(c[:, i])) for i in (2, 3))
        canvas = voxel_features.new_zeros((batch_size + 1, ny, nx, voxel_features.shape[-1]))
        canvas[b, y, x] = torch.where(valid[:, None], voxel_features, torch.zeros_like(voxel_features))
        return canvas[:batch_size]


class _PFNLayer(FlaxBatchNorm):
    """Dense (no bias) -> the norm this module is (over every (voxel, slot)
    row) -> ReLU -> a max over a voxel's valid slots (0 for an empty voxel);
    the last layer returns the max, the others the rows with it appended."""

    def __init__(self, cin: int, cout: int, last: bool = False, device=None):
        super().__init__(cout, device=device)
        self.last = last
        self.Dense_0 = nn.Linear(cin, cout, bias=False, device=device)

    def forward(self, x, mask):
        x = F.relu(super().forward(self.Dense_0(x)))
        pooled = torch.where(mask[..., None], x, torch.full_like(x, float("-inf"))).amax(dim=1)
        pooled = torch.where(torch.isfinite(pooled), pooled, torch.zeros_like(pooled))
        if self.last:
            return pooled
        return torch.cat([x, pooled[:, None].expand_as(x)], dim=-1)


class HardVFE(nn.Module):
    """Learned encoder over padded voxels: the points, their offsets from
    the voxel's mean (cluster center) and from its center, a PFN stack."""

    def __init__(self, in_channels: int = 4, feat_channels: Sequence[int] = (64,), with_cluster_center: bool = True,
                 with_voxel_center: bool = True, voxel_size: Sequence[float] = (0.2, 0.2, 4),
                 point_cloud_range: Sequence[float] = (0, -40, -3, 70.4, 40, 1), device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.with_cluster_center, self.with_voxel_center = with_cluster_center, with_voxel_center
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        cin = in_channels + 3 * int(with_cluster_center) + 3 * int(with_voxel_center)
        self.depth = len(feat_channels)
        for i, c in enumerate(feat_channels):
            last = i == self.depth - 1
            setattr(self, f"pfn{i}", _PFNLayer(cin, c, last=last, device=dev))
            cin = 2 * c

    def forward(self, voxels, num_points, coors):
        """voxels (V, P, C), num_points (V,), coors (V, 4) [b, z, y, x] ->
        (V, feat_channels[-1])."""
        V, P, C = voxels.shape
        mask = torch.arange(P, device=voxels.device)[None] < num_points[:, None]
        feats = [voxels]
        if self.with_cluster_center:
            denom = num_points.clamp(min=1)[:, None, None].to(voxels.dtype)
            mean = torch.where(mask[..., None], voxels[..., :3], torch.zeros_like(voxels[..., :3])).sum(
                1, keepdim=True) / denom
            feats.append(voxels[..., :3] - mean)
        if self.with_voxel_center:
            vs = torch.tensor(self.voxel_size, dtype=voxels.dtype, device=voxels.device)
            mins = torch.tensor(self.point_cloud_range[:3], dtype=voxels.dtype, device=voxels.device)
            centers = (coors[:, None, [3, 2, 1]].to(voxels.dtype) + 0.5) * vs + mins
            feats.append(voxels[..., :3] - centers)
        x = torch.cat(feats, dim=-1)
        x = torch.where(mask[..., None], x, torch.zeros_like(x))
        for i in range(self.depth):
            x = getattr(self, f"pfn{i}")(x, mask)
        return x


class DynamicVFE(nn.Module):
    """Per-point encoder: the points, their offsets from their voxel's mean
    and center, Dense -> norm -> ReLU layers (``fc<i>``, ``bn<i>``), then a
    max per voxel (``dynamic_scatter``)."""

    def __init__(self, in_channels: int = 4, feat_channels: Sequence[int] = (64,),
                 voxel_size: Sequence[float] = (0.2, 0.2, 4),
                 point_cloud_range: Sequence[float] = (0, -40, -3, 70.4, 40, 1), max_voxels: int = 65536,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.max_voxels = int(max_voxels)
        self.depth = len(feat_channels)
        cin = in_channels + 6
        for i, c in enumerate(feat_channels):
            setattr(self, f"fc{i}", nn.Linear(cin, c, bias=False, device=dev))
            setattr(self, f"bn{i}", FlaxBatchNorm(c, device=dev))
            cin = c

    def forward(self, points, coors_zyx):
        """points (N, C), coors_zyx (N, 3) (-1 rows invalid) ->
        (voxel_feats (max_voxels, C'), voxel_coors (max_voxels, 3))."""
        grid = compute_grid_size(self.point_cloud_range, self.voxel_size)
        valid = (coors_zyx >= 0).all(dim=-1)
        mean, _, p2v, _ = dynamic_scatter(points[:, :3], coors_zyx, grid=grid, max_voxels=self.max_voxels,
                                          reduce="mean")
        cluster_offset = points[:, :3] - mean[p2v.long().clamp(0, self.max_voxels - 1)]
        vs = torch.tensor(self.voxel_size, dtype=points.dtype, device=points.device)
        mins = torch.tensor(self.point_cloud_range[:3], dtype=points.dtype, device=points.device)
        centers = (coors_zyx[:, [2, 1, 0]].to(points.dtype) + 0.5) * vs + mins
        x = torch.cat([points, cluster_offset, points[:, :3] - centers], dim=-1)
        x = torch.where(valid[:, None], x, torch.zeros_like(x))
        for i in range(self.depth):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"fc{i}")(x)))
        vfeat, vcoors, _, _ = dynamic_scatter(x, coors_zyx, grid=grid, max_voxels=self.max_voxels, reduce="max")
        return vfeat, vcoors
