"""Sparse U-Net middle encoder (port of
``recondet3d/models/refine/sparse_unet.py``).

A SECOND-style encoder, then a decoder whose stages run a lateral
``_SparseBasicBlock`` on the skip's active set, an inverse conv of the
coarser features onto it, a concat-merge submanifold conv with a norm, and a
residual. Returns the per-voxel ("seg") features on the full-resolution
active set and the BEV map of ``conv_out``.

The inverse conv is the scatter form: each coarse voxel's K products are
index-added into its fine children (rows from ``_children_map``, one sort
and ``searchsorted``, no table over the grid); its backward is a gather.
Module names follow the flax tree (``conv_input``, ``enc1_down``,
``enc2_block0``, ``conv_out``, ``dec0_lateral``, ``dec0_up``,
``dec0_merge``, ``dec0_merge_norm``); sparse kernels stay (K, Cin, Cout). The downsample ranks its output cells by (b, y, x, z), as
the JAX package's column ranking does on the appearance-ordered active set
this module starts from. Built on ``device`` (``cuda`` unless the caller
asks for the CPU), kernels drawn N(0, 1/fan_in) from torch's generator.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from recondet3d_torch.models.refine.sparse_encoder import MaskedBatchNorm, _DownConv, _SparseBasicBlock, _SubmConv
from recondet3d_torch.ops.sparse_conv import (
    SparseTensor,
    _kernel_offsets,
    _linear_ids,
    _lookup_rows,
    _out_grid,
    build_neighbor_map,
    sparse_tensor_from_voxels,
    to_dense_bev,
)
from recondet3d_torch.utils.device import resolve_device

__all__ = ["SparseUNet"]


def _triple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * 3


@torch.no_grad()
def _children_map(coarse: SparseTensor, fine: SparseTensor, kernel=3, stride=2, padding=1) -> torch.Tensor:
    """(M_coarse, K) rows into the FINE active set: child(m, d) = m * s + d -
    pad, or the fine row count where that cell is not active (or m is padding)."""
    kernel, stride, padding = _triple(kernel), _triple(stride), _triple(padding)
    Z, Y, X = fine.grid
    dev = coarse.coords.device
    offsets = torch.from_numpy(_kernel_offsets(kernel)).to(dev)
    s = torch.tensor(stride, device=dev)
    p = torch.tensor(padding, device=dev)
    c = coarse.coords.long()
    child = c[:, None, 1:4] * s + offsets[None] - p
    ok = ((child >= 0) & (child < torch.tensor([Z, Y, X], device=dev))).all(dim=-1) & coarse.valid[:, None]
    cand = ((c[:, 0:1] * Z + child[..., 0]) * Y + child[..., 1]) * X + child[..., 2]
    n_cells = fine.batch_size * Z * Y * X  # the sentinel
    cand = torch.where(ok, cand, torch.full_like(cand, n_cells)).reshape(-1)
    rows = _lookup_rows(_linear_ids(fine.coords, fine.grid, fine.batch_size), cand, n_cells)
    return rows.reshape(c.shape[0], -1)


class _InverseConv(nn.Module):
    """Coarse -> fine sparse 'deconv' (scatter form) + masked norm + ReLU."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(27, cin, cout, device=device))
        self.norm = MaskedBatchNorm(cout, device=device)

    def forward(self, coarse_feats, children_rows, n_fine: int, fine_valid):
        M, K = children_rows.shape
        Cin, Cout = self.weight.shape[1:]
        w = self.weight.to(coarse_feats.dtype).transpose(0, 1).reshape(Cin, K * Cout)
        contrib = (coarse_feats @ w).reshape(M * K, Cout)
        out = coarse_feats.new_zeros((n_fine + 1, Cout)).index_add(0, children_rows.reshape(-1), contrib)[:n_fine]
        return F.relu(self.norm(out, fine_valid))


class SparseUNet(nn.Module):
    def __init__(
        self,
        in_channels: int = 4,
        sparse_shape: Tuple[int, int, int] = (41, 1600, 1408),
        base_channels: int = 16,
        output_channels: int = 128,
        encoder_channels: Sequence[Sequence[int]] = ((16,), (32, 32, 32), (64, 64, 64), (64, 64, 64)),
        decoder_channels: Sequence[Sequence[int]] = ((64, 64, 64), (64, 64, 32), (32, 32, 16), (16, 16, 16)),
        stage_caps: Sequence[int] = (32768, 24576, 16384, 8192),
        device="cuda",
    ):
        super().__init__()
        dev = resolve_device(device)
        self.sparse_shape = tuple(int(v) for v in sparse_shape)
        self.encoder_channels = [tuple(b) for b in encoder_channels]
        self.decoder_channels = [tuple(b) for b in decoder_channels]
        caps = tuple(stage_caps)
        self.conv_input = _SubmConv(in_channels, base_channels, dev)
        self.conv_input_norm = MaskedBatchNorm(base_channels, device=dev)
        ch = base_channels
        level_ch = []
        grid = self.sparse_shape
        for i, blocks in enumerate(self.encoder_channels):
            if i > 0:
                level_ch.append(ch)
                setattr(self, f"enc{i}_down", _DownConv(ch, blocks[0], (3, 3, 3), (2, 2, 2), (1, 1, 1),
                                                         caps[min(i, len(caps) - 1)], dev))
                grid = _out_grid(grid, (3, 3, 3), (2, 2, 2), (1, 1, 1))
                ch = blocks[0]
            for j, c in enumerate(blocks):
                if c != ch:
                    raise ValueError(f"basic block enc{i}_block{j}: {c} channels on a {ch}-channel input")
                setattr(self, f"enc{i}_block{j}", _SparseBasicBlock(c, dev))
        self.conv_out = _DownConv(ch, output_channels, (3, 1, 1), (2, 1, 1), (0, 0, 0), caps[-1], dev)
        self.bev_channels = output_channels * _out_grid(grid, (3, 1, 1), (2, 1, 1), (0, 0, 0))[0]
        for di, blocks in enumerate(self.decoder_channels[:-1]):
            skip_ch = level_ch[-(di + 1)]
            c_mid = blocks[0]
            setattr(self, f"dec{di}_lateral", _SparseBasicBlock(skip_ch, dev))
            setattr(self, f"dec{di}_up", _InverseConv(ch, c_mid, dev))
            setattr(self, f"dec{di}_merge", _SubmConv(c_mid + skip_ch, c_mid, dev))
            setattr(self, f"dec{di}_merge_norm", MaskedBatchNorm(c_mid, device=dev))
            ch = c_mid
        self.seg_channels = ch
        with torch.no_grad():
            for p in self.parameters():
                if p.dim() == 3:  # the sparse kernels (K, Cin, Cout)
                    p.normal_(0.0, (p.shape[0] * p.shape[1]) ** -0.5)

    @staticmethod
    @torch.no_grad()
    def _neighbor_map(st: SparseTensor) -> torch.Tensor:
        return build_neighbor_map(st, 3)

    def forward(self, voxel_features: torch.Tensor, coors: torch.Tensor, batch_size: int):
        """voxel_features (N, C), coors (N, 4) [b, z, y, x] (-1 pads) ->
        (seg features (N, seg_channels) on the full-resolution active set,
        BEV features (B, Y', X', bev_channels))."""
        st = sparse_tensor_from_voxels(voxel_features, coors, self.sparse_shape, batch_size)
        nbr = self._neighbor_map(st)
        x = F.relu(self.conv_input_norm(self.conv_input(st.features, nbr), st.valid))
        st = SparseTensor(torch.where(st.valid[:, None], x, torch.zeros_like(x)), st.coords, st.grid, st.batch_size)

        skips, nbrs = [], [nbr]
        for i, blocks in enumerate(self.encoder_channels):
            if i > 0:
                skips.append(st)
                st = getattr(self, f"enc{i}_down")(st)
                nbr = self._neighbor_map(st)
                nbrs.append(nbr)
            for j in range(len(blocks)):
                f = getattr(self, f"enc{i}_block{j}")(st.features, nbr, st.valid)
                st = SparseTensor(torch.where(st.valid[:, None], f, torch.zeros_like(f)), st.coords, st.grid,
                                  st.batch_size)

        bev = to_dense_bev(self.conv_out(st))

        for di in range(len(self.decoder_channels) - 1):
            skip, skip_nbr = skips[-(di + 1)], nbrs[-(di + 2)]
            lateral = getattr(self, f"dec{di}_lateral")(skip.features, skip_nbr, skip.valid)
            up = getattr(self, f"dec{di}_up")(st.features, _children_map(st, skip), skip.features.shape[0],
                                               skip.valid)
            merged = getattr(self, f"dec{di}_merge")(torch.cat([up, lateral], dim=-1), skip_nbr)
            merged = F.relu(getattr(self, f"dec{di}_merge_norm")(merged, skip.valid)) + up
            merged = torch.where(skip.valid[:, None], merged, torch.zeros_like(merged))
            st = SparseTensor(merged, skip.coords, skip.grid, skip.batch_size)
        return st.features, bev
