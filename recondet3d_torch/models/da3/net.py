"""DA3 network assembly (port of ``recondet3d/models/da3/net.py``): backbone +
heads (depth, camera, ray pose, Gaussian splats), and the nested any-view +
metric net joined by least-squares scale alignment. The backbone runs in its
dtype (bf16 on the card); heads and camera math run fp32. Guards are tensor
``where``s, so a forward of depth and cameras makes no host synchronisation
(the ray-pose and GS branches may).

As in the JAX package (``net.py:110-158``), ``_ray_pose`` stores the
camera-to-world 3x4 matrix under ``"extrinsics"``, and ``_gs`` hands the GS
head the normalised images the net was given.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn

from recondet3d_torch.models.da3.dpt import DualDPT
from recondet3d_torch.parallel.mesh import global_sum
from recondet3d_torch.utils.alignment import (
    apply_metric_scaling,
    compute_alignment_mask,
    compute_sky_mask,
    least_squares_scale_scalar,
    masked_quantile,
    set_sky_regions_to_max_depth,
)
from recondet3d_torch.utils.constants import PATCH_SIZE
from recondet3d_torch.utils.geometry import affine_inverse, as_homogeneous, map_pdf_to_opacity
from recondet3d_torch.utils.ray_utils import get_extrinsic_from_camray
from recondet3d_torch.utils.stage_timer import stage
from recondet3d_torch.utils.transforms import pose_encoding_to_extri_intri

__all__ = ["DepthAnything3Net", "NestedDepthAnything3Net"]


class DepthAnything3Net(nn.Module):
    """Backbone (``backbone.pretrained``) + head (+ cam_dec / cam_enc, + the
    Gaussian-splat head ``gs_head`` and its parameter-free ``gs_adapter``)."""

    def __init__(self, net: nn.Module, head: nn.Module, cam_dec: Optional[nn.Module] = None,
                 cam_enc: Optional[nn.Module] = None, gs_head: Optional[nn.Module] = None,
                 gs_adapter: Optional[Any] = None):
        super().__init__()
        self.backbone = nn.Module()
        self.backbone.pretrained = net
        self.head = head
        self.cam_dec = cam_dec
        self.cam_enc = cam_enc
        self.gs_head = gs_head
        self.gs_adapter = gs_adapter

    def forward(self, x, extrinsics=None, intrinsics=None, export_feat_layers: Sequence[int] = (),
                infer_gs: bool = False, use_ray_pose: bool = False,
                ref_view_strategy: str = "saddle_balanced") -> Dict[str, torch.Tensor]:
        """x: (B, S, H, W, 3) normalized images. Returns depth/depth_conf/(sky)/
        extrinsics/intrinsics/(gaussians)/(aux)."""
        B, S, H, W, _ = x.shape

        cam_token = None
        if extrinsics is not None and self.cam_enc is not None:
            cam_token = self.cam_enc(extrinsics, intrinsics, (H, W))

        with stage("da3_trunk"):
            feats, aux_feats = self.backbone.pretrained(
                x, cam_token=cam_token, export_feat_layers=tuple(export_feat_layers),
                ref_view_strategy=ref_view_strategy,
            )
        with stage("da3_heads"):
            if isinstance(self.head, DualDPT):
                # the ray branch is dropped unused when a camera decoder gives the pose and the rays are not asked for
                output = dict(self.head(feats, H, W, patch_start_idx=0,
                                        with_aux=self.cam_dec is None or use_ray_pose))
            else:
                output = dict(self.head(feats, H, W, patch_start_idx=0))
            if use_ray_pose:
                output = self._ray_pose(output, H, W)
            else:
                output = self._camera_estimation(feats, H, W, output)
            if infer_gs and self.gs_head is not None:
                output = self._gs(feats, H, W, output, x, extrinsics)
            output = self._mono_sky(output)

        if export_feat_layers:
            output["aux"] = {
                f"feat_layer_{layer}": feat.reshape(B, S, H // PATCH_SIZE, W // PATCH_SIZE, feat.shape[-1])
                for feat, layer in zip(aux_feats, export_feat_layers)
            }
        return output

    def _camera_estimation(self, feats, H, W, output):
        if self.cam_dec is None:
            return output
        pose_enc = self.cam_dec(feats[-1][1])
        output.pop("ray", None)
        output.pop("ray_conf", None)
        c2w, ixt = pose_encoding_to_extri_intri(pose_enc, (H, W))
        output["extrinsics"] = affine_inverse(c2w)
        output["intrinsics"] = ixt
        return output

    def _ray_pose(self, output, H, W):
        """Pose and intrinsics from the ray head (RANSAC homographies per view)."""
        if "ray" not in output:
            return output
        ray = output.pop("ray")
        ray_conf = output.pop("ray_conf")
        extr_w2c, focal, pp = get_extrinsic_from_camray(ray, ray_conf, ray.shape[-3], ray.shape[-2])
        c2w = affine_inverse(extr_w2c)[..., :3, :]
        zeros = torch.zeros_like(focal[..., 0])
        ones = torch.ones_like(zeros)
        fx = focal[..., 0] / 2 * W
        fy = focal[..., 1] / 2 * H
        cx = pp[..., 0] * W * 0.5
        cy = pp[..., 1] * H * 0.5
        output["extrinsics"] = c2w
        output["intrinsics"] = torch.stack([
            torch.stack([fx, zeros, cx], -1),
            torch.stack([zeros, fy, cy], -1),
            torch.stack([zeros, zeros, ones], -1),
        ], dim=-2)
        return output

    def _gs(self, feats, H, W, output, images, gt_extrinsics):
        if "depth" not in output:
            raise ValueError("the GS head needs multi-view depth")
        gs_outs = self.gs_head(feats, H, W, images=images, patch_start_idx=0)
        output["gaussians"] = self.gs_adapter(
            extrinsics=as_homogeneous(output["extrinsics"]),
            intrinsics=output["intrinsics"],
            depths=output["depth"],
            opacities=map_pdf_to_opacity(gs_outs["raw_gs_conf"]),
            raw_gaussians=gs_outs["raw_gs"],
            image_shape=(H, W),
            gt_extrinsics=None if gt_extrinsics is None else as_homogeneous(gt_extrinsics),
        )
        return output

    def _mono_sky(self, output):
        """Clamp sky pixels to the 99th-percentile non-sky depth."""
        if "sky" not in output:
            return output
        non_sky = compute_sky_mask(output["sky"], threshold=0.3)
        n_non_sky = global_sum(non_sky.sum())
        n_sky = global_sum((~non_sky).sum())
        ok = (n_non_sky > 10) & (n_sky > 10)
        non_sky_max = masked_quantile(output["depth"], non_sky, 0.99)
        clamped, _ = set_sky_regions_to_max_depth(output["depth"], None, non_sky, non_sky_max)
        output["depth"] = torch.where(ok, clamped, output["depth"])
        return output


class NestedDepthAnything3Net(nn.Module):
    """Any-view branch (``da3``) + metric branch (``da3_metric``) with
    least-squares scale alignment. As in the JAX package, the alignment
    statistics (median confidence, scale, sky depth) are taken over the
    whole batch at once: under data parallelism over the global batch
    (``utils/alignment.py``)."""

    def __init__(self, anyview: nn.Module, metric: nn.Module, sky_depth_def: float = 200.0):
        super().__init__()
        self.da3 = anyview
        self.da3_metric = metric
        self.sky_depth_def = sky_depth_def

    def forward(self, x, extrinsics=None, intrinsics=None, export_feat_layers: Sequence[int] = (),
                infer_gs: bool = False, use_ray_pose: bool = False,
                ref_view_strategy: str = "saddle_balanced") -> Dict[str, torch.Tensor]:
        output = self.da3(
            x, extrinsics, intrinsics, export_feat_layers=export_feat_layers, infer_gs=infer_gs,
            use_ray_pose=use_ray_pose, ref_view_strategy=ref_view_strategy,
        )
        metric_output = self.da3_metric(x)

        with stage("da3_align"):
            metric_depth = apply_metric_scaling(metric_output["depth"], output["intrinsics"])
            non_sky = compute_sky_mask(metric_output["sky"], threshold=0.3)

            median_conf = masked_quantile(output["depth_conf"], non_sky, 0.5)
            align_mask = compute_alignment_mask(
                output["depth_conf"], non_sky, output["depth"], metric_depth, median_conf
            )
            scale = least_squares_scale_scalar(metric_depth, output["depth"], mask=align_mask)
            scale = torch.where(global_sum(align_mask.sum()) > 0, scale, torch.ones_like(scale))

            depth = output["depth"] * scale
            extr = output["extrinsics"].clone()
            extr[..., :3, 3] = extr[..., :3, 3] * scale

            non_sky_max = torch.clamp(masked_quantile(depth, non_sky, 0.99), max=self.sky_depth_def)
            depth, depth_conf = set_sky_regions_to_max_depth(depth, output["depth_conf"], non_sky, non_sky_max)

        output["depth"] = depth
        output["depth_conf"] = depth_conf
        output["extrinsics"] = extr
        output["sky"] = metric_output["sky"]
        output["is_metric"] = torch.tensor(1, dtype=torch.int32, device=depth.device)
        output["scale_factor"] = scale
        return output
