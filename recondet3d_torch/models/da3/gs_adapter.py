"""Gaussian adapter: the GS head's raw output -> world-space 3D gaussians
(port of ``recondet3d/models/da3/gs_adapter.py``), fp32 throughout.

Means by ray unprojection with xy / depth offsets, sigmoid scales clamped
and scaled by depth and pixel footprint, camera -> world quaternions and SH
rotation, opacity from density. With GT extrinsics the camera centres and
depths take the Umeyama scale between the predicted and the GT poses
(clamped to [1/3, 3]). Parameter-free, so a plain callable, not a module.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from recondet3d_torch.specs import Gaussians
from recondet3d_torch.utils.geometry import affine_inverse, get_world_rays, sample_image_grid
from recondet3d_torch.utils.pose_align import batch_umeyama_pose_scales
from recondet3d_torch.utils.sh import rotate_sh
from recondet3d_torch.utils.transforms import cam_quat_xyzw_to_world_quat_wxyz

__all__ = ["GaussianAdapter"]


@dataclasses.dataclass
class GaussianAdapter:
    sh_degree: int = 0
    pred_color: bool = False
    pred_offset_depth: bool = False
    pred_offset_xy: bool = True
    gaussian_scale_min: float = 1e-5
    gaussian_scale_max: float = 30.0

    @property
    def d_sh(self) -> int:
        return 1 if self.pred_color else (self.sh_degree + 1) ** 2

    @property
    def d_in(self) -> int:
        d = 3 + 4 + 3 * self.d_sh
        if self.pred_offset_xy:
            d += 2
        if self.pred_offset_depth:
            d += 1
        return d

    def _sh_mask(self) -> np.ndarray:
        mask = np.ones((self.d_sh,), np.float32)
        for degree in range(1, self.sh_degree + 1):
            mask[degree ** 2: (degree + 1) ** 2] = 0.1 * 0.25 ** degree
        return mask

    def __call__(
        self,
        extrinsics: torch.Tensor,  # (B, V, 4, 4) w2c
        intrinsics: torch.Tensor,  # (B, V, 3, 3)
        depths: torch.Tensor,  # (B, V, H, W)
        opacities: torch.Tensor,  # (B, V, H, W)
        raw_gaussians: torch.Tensor,  # (B, V, H, W, d_in)
        image_shape: Tuple[int, int],
        gt_extrinsics: Optional[torch.Tensor] = None,
        eps: float = 1e-8,
    ) -> Gaussians:
        H, W = image_shape
        b, v = raw_gaussians.shape[:2]
        dev = raw_gaussians.device
        raw = raw_gaussians.float()
        depths = depths.float()

        cam2worlds = affine_inverse(extrinsics.float())
        intr_normed = intrinsics.float().clone()
        intr_normed[..., 0, :] = intr_normed[..., 0, :] / W
        intr_normed[..., 1, :] = intr_normed[..., 1, :] / H

        if self.pred_offset_depth:
            gs_depths = depths + raw[..., -1]
            raw = raw[..., :-1]
        else:
            gs_depths = depths

        if gt_extrinsics is not None:
            pose_scales = batch_umeyama_pose_scales(gt_extrinsics.float(), extrinsics.float())
            pose_scales = torch.clamp(pose_scales, 1 / 3.0, 3.0)
            cam2worlds = cam2worlds.clone()
            cam2worlds[:, :, :3, 3] = cam2worlds[:, :, :3, 3] * pose_scales[:, None, None]
            gs_depths = gs_depths * pose_scales[:, None, None, None]

        pixel_size = torch.tensor([1.0 / W, 1.0 / H], dtype=torch.float32, device=dev)
        xy_ray, _ = sample_image_grid((H, W), device=dev)
        xy_ray = xy_ray[None, None].float()
        if self.pred_offset_xy:
            xy_ray = xy_ray + raw[..., :2] * pixel_size
            raw = raw[..., 2:]
        else:
            xy_ray = xy_ray.expand(b, v, H, W, 2)

        origins, directions = get_world_rays(xy_ray, cam2worlds[:, :, None, None], intr_normed[:, :, None, None])
        means = (origins + directions * gs_depths[..., None]).reshape(b, v * H * W, 3)

        scales = raw[..., 0:3]
        rotations = raw[..., 3:7]
        sh = raw[..., 7: 7 + 3 * self.d_sh]

        smin, smax = self.gaussian_scale_min, self.gaussian_scale_max
        scales = smin + (smax - smin) * torch.sigmoid(scales)
        multiplier = self._scale_multiplier(intr_normed, pixel_size)
        gs_scales = (scales * gs_depths[..., None] * multiplier[..., None, None, None]).reshape(b, v * H * W, 3)

        rotations = rotations / (torch.linalg.norm(rotations, dim=-1, keepdim=True) + eps)
        # each view's camera-to-world rotation, broadcast over its pixels
        world_quat = cam_quat_xyzw_to_world_quat_wxyz(rotations, cam2worlds[:, :, None, None])
        world_quat = world_quat.reshape(b, v * H * W, 4)

        sh = sh.reshape(*sh.shape[:-1], 3, self.d_sh)
        if not self.pred_color:
            sh = sh * torch.from_numpy(self._sh_mask()).to(dev)
        if self.pred_color or self.sh_degree == 0:
            sh_world = sh
        else:
            sh_world = rotate_sh(sh, cam2worlds[:, :, None, None, None, :3, :3])
        sh_world = sh_world.reshape(b, v * H * W, 3, self.d_sh)

        return Gaussians(
            means=means,
            harmonics=sh_world,
            opacities=opacities.float().reshape(b, v * H * W),
            scales=gs_scales,
            rotations=world_quat,
        )

    def _scale_multiplier(self, intr_normed, pixel_size, multiplier: float = 0.1):
        inv2 = torch.linalg.inv(intr_normed[..., :2, :2])
        return multiplier * torch.einsum("...ij,j->...i", inv2, pixel_size).sum(-1)
