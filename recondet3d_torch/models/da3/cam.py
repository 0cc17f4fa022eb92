"""Camera pose encoder / decoder heads (port of ``recondet3d/models/da3/cam.py``).

Both run fp32. ``CameraEnc`` turns GT poses into conditioning tokens
(9-D encoding -> MLP -> 4 transformer blocks); it runs only when the caller
passes GT extrinsics, which the main path does not. Its trunk attention is
fp32 with head dim dim_out / 16 (24 at small, 96 at giant scale) over one
token a view: on CUDA it runs the CUDA-core attention kernels, forward and
backward (``ops/attention.py`` ``attention_fwd_cuda_core`` and its dq and
dk/dv), on the CPU the plain versions.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from recondet3d_torch.models.da3.layers import Block, Mlp
from recondet3d_torch.utils.geometry import affine_inverse
from recondet3d_torch.utils.transforms import extri_intri_to_pose_encoding

__all__ = ["CameraEnc", "CameraDec"]


class CameraEnc(nn.Module):
    def __init__(self, dim_out=1024, dim_in=9, trunk_depth=4, num_heads=16, mlp_ratio=4.0,
                 init_values=0.01, device="cuda"):
        super().__init__()
        self.pose_branch = Mlp(dim_in, dim_out // 2, out_features=dim_out, device=device)
        self.token_norm = nn.LayerNorm(dim_out, eps=1e-5, device=device)
        # trunk blocks use the default LayerNorm eps (1e-5) in the reference
        self.trunk = nn.ModuleList(
            Block(dim_out, num_heads, mlp_ratio=mlp_ratio, init_values=init_values, ln_eps=1e-5, device=device)
            for _ in range(trunk_depth)
        )
        self.trunk_norm = nn.LayerNorm(dim_out, eps=1e-5, device=device)

    def forward(self, ext, ixt, image_size_hw: Tuple[int, int]):
        """ext: (B, S, 3or4, 4) w2c; ixt: (B, S, 3, 3) -> tokens (B, S, C)."""
        c2ws = affine_inverse(ext.float())
        enc = extri_intri_to_pose_encoding(c2ws, ixt.float(), image_size_hw)
        tok = self.token_norm(self.pose_branch(enc))
        for blk in self.trunk:
            tok = blk(tok)
        return self.trunk_norm(tok)


class CameraDec(nn.Module):
    def __init__(self, dim_in=1536, device="cuda"):
        super().__init__()
        self.backbone = nn.Sequential(
            nn.Linear(dim_in, dim_in, device=device), nn.ReLU(),
            nn.Linear(dim_in, dim_in, device=device), nn.ReLU(),
        )
        self.fc_t = nn.Linear(dim_in, 3, device=device)
        self.fc_qvec = nn.Linear(dim_in, 4, device=device)
        self.fc_fov = nn.Sequential(nn.Linear(dim_in, 2, device=device), nn.ReLU())

    def forward(self, feat):
        """feat: (B, S, C) camera tokens -> (B, S, 9) pose encoding."""
        B, S = feat.shape[:2]
        x = self.backbone(feat.reshape(B * S, -1).float())
        t = self.fc_t(x).reshape(B, S, 3)
        qvec = self.fc_qvec(x).reshape(B, S, 4)
        fov = self.fc_fov(x).reshape(B, S, 2)
        return torch.cat([t, qvec, fov], dim=-1)
