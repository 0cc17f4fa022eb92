"""SECOND-style sparse middle encoder (port of
``recondet3d/models/refine/sparse_encoder.py``).

Module and parameter names follow the flax tree (``conv_input``,
``encoder_layer1_block0.conv1``, ``encoder_layer1_down.norm``, ...), with
torch leaf names: a sparse kernel is ``weight`` in the flax (K, Cin, Cout)
layout, a norm has ``weight`` / ``bias`` / ``running_mean`` /
``running_var``. Each stage's submanifold convs share one neighbour map.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from recondet3d_torch.ops.sparse_conv import (
    SparseTensor,
    _out_grid,
    build_neighbor_map,
    sort_by_column,
    sparse_conv_downsample,
    sparse_tensor_from_voxels,
    subm_conv_apply,
    to_dense_bev,
)

__all__ = ["SparseEncoder", "MaskedBatchNorm"]

class MaskedBatchNorm(nn.Module):
    """BatchNorm over (N, C) rows in fp32 (eps 1e-3), returned in the
    input's dtype. In eval mode it uses its running statistics. In train
    mode it normalises with the mean and the biased variance of the rows
    that ``mask`` marks valid (one batch-global pair, whatever the batch
    size) and moves the running statistics towards them:
    ``running = momentum * running + (1 - momentum) * batch`` with the flax
    momentum 0.99."""

    def __init__(self, channels: int, eps: float = 1e-3, momentum: float = 0.99, device=None):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        xf = x.float()
        if self.training:
            if mask is None:
                raise ValueError("MaskedBatchNorm in train mode needs the validity mask of its rows")
            m = mask.to(torch.float32)[:, None]
            n = m.sum().clamp(min=1.0)
            mean = (xf * m).sum(dim=0) / n
            var = ((xf - mean) ** 2 * m).sum(dim=0) / n
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_(mean, alpha=1 - self.momentum)
                self.running_var.mul_(self.momentum).add_(var, alpha=1 - self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


def _kernel_param(k: int, cin: int, cout: int, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(k, cin, cout, device=device))


class _SubmConv(nn.Module):
    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.weight = _kernel_param(27, cin, cout, device)

    def forward(self, features, nbr_map):
        return subm_conv_apply(features, nbr_map, self.weight)


class _SparseBasicBlock(nn.Module):
    """conv-bn-relu-conv-bn + residual + relu."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.conv1 = _SubmConv(channels, channels, device)
        self.norm1 = MaskedBatchNorm(channels, device=device)
        self.conv2 = _SubmConv(channels, channels, device)
        self.norm2 = MaskedBatchNorm(channels, device=device)

    def forward(self, features, nbr_map, mask):
        out = F.relu(self.norm1(self.conv1(features, nbr_map), mask))
        out = self.norm2(self.conv2(out, nbr_map), mask)
        return F.relu(out + features)


class _DownConv(nn.Module):
    """Strided sparse conv + BN + ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride, padding, max_out: int, device=None):
        super().__init__()
        self.kernel, self.stride, self.padding, self.max_out = tuple(kernel), tuple(stride), tuple(padding), max_out
        self.weight = _kernel_param(int(np.prod(kernel)), cin, cout, device)
        self.norm = MaskedBatchNorm(cout, device=device)

    def forward(self, st: SparseTensor) -> SparseTensor:
        out = sparse_conv_downsample(st, self.weight, None, kernel=self.kernel, stride=self.stride,
                                     padding=self.padding, max_out=self.max_out)
        feats = F.relu(self.norm(out.features, out.valid))
        feats = torch.where(out.valid[:, None], feats, torch.zeros_like(feats))
        return SparseTensor(feats, out.coords, out.grid, out.batch_size)


class SparseEncoder(nn.Module):
    def __init__(
        self,
        in_channels: int = 3,
        sparse_shape: Tuple[int, int, int] = (41, 1440, 1440),  # (Z, Y, X)
        base_channels: int = 16,
        output_channels: int = 128,
        encoder_channels: Sequence[Sequence[int]] = ((16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128)),
        encoder_paddings: Sequence = ((0, 0, 1), (0, 0, 1), (0, 0, (0, 1, 1)), (0, 0)),
        stage_caps: Sequence[int] = (65536, 49152, 32768, 16384),
        device=None,
    ):
        super().__init__()
        self.sparse_shape = tuple(sparse_shape)
        self.conv_input = _SubmConv(in_channels, base_channels, device)
        self.conv_input_norm = MaskedBatchNorm(base_channels, device=device)
        # (name, is_down) in execution order; the modules are attributes named as in the flax tree
        self._layers = []
        cin = base_channels
        n_stages = len(encoder_channels)
        for i, blocks in enumerate(encoder_channels):
            for j, out_ch in enumerate(blocks):
                last = j == len(blocks) - 1
                if last and i != n_stages - 1:
                    pad = encoder_paddings[i][j]
                    pad = tuple(pad) if isinstance(pad, (tuple, list)) else (pad,) * 3
                    name = f"encoder_layer{i + 1}_down"
                    mod = _DownConv(cin, out_ch, (3, 3, 3), (2, 2, 2), pad,
                                    stage_caps[min(i + 1, len(stage_caps) - 1)], device)
                    cin = out_ch
                else:
                    if out_ch != cin:
                        raise ValueError(f"basic block {i}/{j}: {out_ch} channels on a {cin}-channel input")
                    name = f"encoder_layer{i + 1}_block{j}"
                    mod = _SparseBasicBlock(out_ch, device)
                setattr(self, name, mod)
                self._layers.append((name, isinstance(mod, _DownConv)))
        self.conv_out = _DownConv(cin, output_channels, (3, 1, 1), (2, 1, 1), (0, 0, 0), stage_caps[-1], device)
        grid = self.sparse_shape
        for mod in [getattr(self, n) for n, down in self._layers if down] + [self.conv_out]:
            grid = _out_grid(grid, mod.kernel, mod.stride, mod.padding)
        self.bev_channels = output_channels * grid[0]  # to_dense_bev folds the depth planes left into channels

    @staticmethod
    @torch.no_grad()
    def _neighbor_map(st: SparseTensor) -> torch.Tensor:
        return build_neighbor_map(st, 3)

    def forward(self, voxel_features: torch.Tensor, coors: torch.Tensor, batch_size: int) -> torch.Tensor:
        """voxel_features (N, C), coors (N, 4) [b, z, y, x] (-1 pads) ->
        BEV features (B, Y/8, X/8, output_channels * Z_out)."""
        st = sort_by_column(sparse_tensor_from_voxels(voxel_features, coors, self.sparse_shape, batch_size))
        nbr = self._neighbor_map(st)
        mask = st.valid

        x = F.relu(self.conv_input_norm(self.conv_input(st.features, nbr), mask))
        x = torch.where(mask[:, None], x, torch.zeros_like(x))
        st = SparseTensor(x, st.coords, st.grid, st.batch_size)
        for name, is_down in self._layers:
            mod = getattr(self, name)
            if is_down:
                st = mod(st)
                nbr = self._neighbor_map(st)
                mask = st.valid
            else:
                feats = mod(st.features, nbr, mask)
                feats = torch.where(mask[:, None], feats, torch.zeros_like(feats))
                st = SparseTensor(feats, st.coords, st.grid, st.batch_size)
        return to_dense_bev(self.conv_out(st))
