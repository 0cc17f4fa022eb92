"""Reconstruction backbone (port of
``recondet3d/models/detect/reconstruction_backbone.py``): DA3 multi-view
depth -> pseudo-LiDAR points -> point pipeline -> sparse refinement, with
the refinement's occupancy loss when ground-truth points are given.

Images are (B, N, H, W, 3) raw RGB 0..255; ``cam2lidar_rts`` is (B, N, 4, 4)
in the row-vector convention (p_lidar = p_cam @ M[:3, :3].T + M[3, :3]).

Gradients. With ``freeze_da3=True`` (the default) the DA3 forward runs
without a graph, the port's form of the JAX package's ``stop_gradient`` on
the DA3 outputs. With ``freeze_da3=False`` depth and intrinsics stay in the
graph, and the loss reaches the ViT through the unprojection and the row
gathers of the point pipeline (pre-reduce, ball-query union, FPS, voxelize,
the mean VFE); the index selections themselves carry no gradient.
Callers that want no graph at all (``ResDet3D.simple_test``) wrap the call
in ``torch.no_grad``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn

from recondet3d_torch.data.input_processor import process_tensor_batch
from recondet3d_torch.data.pipelines.point_pipeline import (
    ball_query_downsample,
    filter_point_by_range,
    fps_downsample,
    voxel_pre_reduce,
)
from recondet3d_torch.utils.geometry import depth_to_points_cam
from recondet3d_torch.utils.interpolation import resize_2d
from recondet3d_torch.utils.stage_timer import stage

__all__ = ["ReconstructionBackbone"]

class ReconstructionBackbone(nn.Module):
    def __init__(
        self,
        da3: nn.Module,
        refinement: Optional[nn.Module] = None,
        process_res: int = 504,
        ref_view_strategy: str = "saddle_balanced",
        use_ray_pose: bool = False,
        max_depth: float = 100.0,
        freeze_da3: bool = True,
        filter_range: Sequence[float] = (-54.0, -54.0, -5.0, 54.0, 54.0, 6.0),
        bq_anchor_points: int = 25000,
        bq_max_radius: float = 0.5,
        bq_sample_num: int = 16,
        bq_selection: str = "first",
        bq_grid_dim: int = 128,
        bq_share_sort: bool = True,
        num_points: int = 40000,
        gt_num_points: int = 40000,
        voxel_pre_reduce: float = 0.0,
        pre_reduce_cap: int = 393216,
        fps_impl: str = "auto",
    ):
        super().__init__()
        self.da3, self.refinement = da3, refinement
        self.process_res, self.ref_view_strategy, self.use_ray_pose = process_res, ref_view_strategy, use_ray_pose
        self.max_depth, self.freeze_da3 = float(max_depth), bool(freeze_da3)
        self.filter_range = tuple(float(v) for v in filter_range)
        self.bq_anchor_points, self.bq_max_radius, self.bq_sample_num = bq_anchor_points, bq_max_radius, bq_sample_num
        # 'first': the CUDA op's tie-break (the smallest original indices); 'any': the smallest sorted positions
        self.bq_selection = bq_selection
        self.bq_grid_dim, self.bq_share_sort = bq_grid_dim, bq_share_sort
        self.num_points = num_points
        # GT points a training scene carries (the training CLI's data iterator pads or cuts each lidar sweep to it)
        self.gt_num_points = int(gt_num_points)
        self.voxel_pre_reduce, self.pre_reduce_cap = float(voxel_pre_reduce), int(pre_reduce_cap)
        # 'auto': the FPS kernel on CUDA tensors; 'plain': its plain version (reference runs)
        self.fps_impl = fps_impl
        # valid-point counts after each stage of the last points_from_depth call, one 0-d tensor per scene
        self.last_stage_counts: Dict[str, list] = {}

    @property
    def use_color(self) -> bool:
        return bool(self.refinement is not None and self.refinement.use_color)

    def predict_depth(self, img):
        """DA3 multi-view depth + intrinsics from raw images: (depth
        (B, N, h, w) fp32, intrinsics (B, N, 3, 3) fp32, the DA3 outputs)."""
        with stage("da3"), torch.set_grad_enabled(torch.is_grad_enabled() and not self.freeze_da3):
            with stage("da3_input"):
                x, _ = process_tensor_batch(img, process_res=self.process_res)
            da3_out = self.da3(x, use_ray_pose=self.use_ray_pose, ref_view_strategy=self.ref_view_strategy)
        return da3_out["depth"].float(), da3_out["intrinsics"].float(), da3_out

    def _pipeline(self, p, m, counts):
        with stage("pre_reduce"):
            if self.voxel_pre_reduce > 0.0:
                # subsumes the range filter (a point outside the grid gets the sentinel id)
                p, m = voxel_pre_reduce(p, m, voxel_size=self.voxel_pre_reduce, point_cloud_range=self.filter_range,
                                        max_out=min(self.pre_reduce_cap, p.shape[0]))
            else:
                p, m = filter_point_by_range(p, m, self.filter_range)
        counts["pre_reduce"].append(m.sum())
        with stage("ball_query_downsample"):  # holds cell_sort, fps_anchors and ball_query
            p, m = ball_query_downsample(
                p, m, anchor_points=self.bq_anchor_points, max_radius=self.bq_max_radius,
                sample_num=self.bq_sample_num, compact=True, grid_dim=self.bq_grid_dim,
                share_sort=self.bq_share_sort, fps_impl=self.fps_impl, selection=self.bq_selection)
        counts["union"].append(m.sum())
        with stage("fps_downsample"):  # holds fps_final
            p, m = fps_downsample(p, m, num_points=self.num_points, input_spatially_sorted=self.bq_share_sort,
                                  fps_impl=self.fps_impl)
        counts["final"].append(m.sum())
        return p, m

    def points_from_depth(self, depth, intr, img, cam2lidar_rts):
        """Unproject, pre-reduce and downsample: (points (B, num_points, C),
        valid (B, num_points)); C = 6 (xyzrgb) when the refinement uses
        colours."""
        B, N, H, W, _ = img.shape
        with stage("unprojection"):
            pts_cam = depth_to_points_cam(depth, intr)  # (B, N, h, w, 3)
            valid = (depth > 0) & torch.isfinite(depth) & (depth <= self.max_depth)
            R = cam2lidar_rts[..., :3, :3].float()
            t = cam2lidar_rts[..., 3, :3].float()
            pts = torch.einsum("bnhwc,bndc->bnhwd", pts_cam, R) + t[:, :, None, None]
            if self.use_color:
                h, w = depth.shape[2:]
                rgb = resize_2d((img.float() / 255.0).reshape(B * N, H, W, 3), (h, w), mode="bilinear",
                                align_corners=False).reshape(B, N, h, w, 3)
                pts = torch.cat([pts, rgb], dim=-1)
            pts = pts.reshape(B, -1, pts.shape[-1])
            msk = valid.reshape(B, -1)
        counts = {"pre_reduce": [], "union": [], "final": []}
        outs = [self._pipeline(pts[b], msk[b], counts) for b in range(B)]
        self.last_stage_counts = counts
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])

    def predict_points(self, img, cam2lidar_rts, depth_override=None):
        """(points, valid, DA3 outputs). ``depth_override`` (B, N, h, w)
        replaces the predicted depth (0 = no point) while the DA3 forward
        still runs: a benchmark times DA3 on real images but drives the
        point pipeline with a realistic depth distribution."""
        depth, intr, da3_out = self.predict_depth(img)
        if depth_override is not None:
            depth = depth_override.float()
        pts, msk = self.points_from_depth(depth, intr, img, cam2lidar_rts)
        return pts, msk, da3_out

    @torch.no_grad()
    def colorize_gt_points(self, gt_points, gt_valid, img, lidar2img):
        """Project GT LiDAR points into the views and sample RGB: the first
        camera that sees a point wins, zeros where none does. gt_points
        (B, M, 3); img (B, N, H, W, 3) raw RGB 0..255; lidar2img
        (B, N, 4, 4) column form (proj = pts_h @ L.T) -> (B, M, 6) xyzrgb."""
        B, M, _ = gt_points.shape
        N, H, W = img.shape[1:4]
        pts_h = torch.cat([gt_points, gt_points.new_ones((B, M, 1))], dim=-1)
        proj = torch.einsum("bmc,bndc->bnmd", pts_h, lidar2img.float())
        z = proj[..., 2]
        u, v = proj[..., 0] / z, proj[..., 1] / z
        vis = (z > 0) & (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)  # (B, N, M)
        # out-of-view projections may be non-finite; they are masked below, so any pixel will do
        ui = torch.nan_to_num(u, nan=0.0, posinf=0.0, neginf=0.0).clamp(0, W - 1).to(torch.int64)
        vi = torch.nan_to_num(v, nan=0.0, posinf=0.0, neginf=0.0).clamp(0, H - 1).to(torch.int64)
        flat = (img.float() / 255.0).reshape(B, N, H * W, 3)
        cols = torch.gather(flat, 2, (vi * W + ui)[..., None].expand(B, N, M, 3))
        first = torch.argmax(vis.to(torch.uint8), dim=1)  # (B, M) first visible camera
        picked = torch.gather(cols, 1, first[:, None, :, None].expand(B, 1, M, 3))[:, 0]
        filled = vis.any(dim=1)
        if gt_valid is not None:
            filled = filled & gt_valid
        rgb = torch.where(filled[..., None], picked, torch.zeros_like(picked))
        return torch.cat([gt_points, rgb], dim=-1)

    def forward(self, img, cam2lidar_rts, gt_points=None, gt_valid=None, lidar2img=None,
                return_loss: bool = False, depth_override=None):
        """Returns (pseudo_points, valid, losses, aux). Batch statistics of
        the refinement's norms follow ``self.training`` (the JAX package's
        ``train`` argument)."""
        pts, msk, da3_out = self.predict_points(img, cam2lidar_rts, depth_override=depth_override)
        if self.use_color and gt_points is not None and gt_points.shape[-1] == 3 and lidar2img is not None:
            gt_points = self.colorize_gt_points(gt_points, gt_valid, img, lidar2img)
        aux: Dict[str, Any] = {"da3": da3_out}
        losses: Dict[str, torch.Tensor] = {}
        if self.refinement is not None:
            pts, r_losses, r_aux = self.refinement(pts, msk, gt_points=gt_points, gt_valid=gt_valid,
                                                   return_loss=return_loss)
            losses.update(r_losses)
            aux.update(r_aux)
        return pts, msk, losses, aux
