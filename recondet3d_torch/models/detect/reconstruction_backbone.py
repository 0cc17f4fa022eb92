"""Reconstruction backbone (port of
``recondet3d/models/detect/reconstruction_backbone.py``, inference path):
DA3 multi-view depth -> pseudo-LiDAR points -> point pipeline -> sparse
refinement.

Images are (B, N, H, W, 3) raw RGB 0..255; ``cam2lidar_rts`` is (B, N, 4, 4)
in the row-vector convention (p_lidar = p_cam @ M[:3, :3].T + M[3, :3]).
DA3 is frozen: the whole module runs under ``torch.no_grad``.
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

_TRAINING = "ground-truth points and losses belong to training, which is not ported yet (ROADMAP §1 item 11)"


class ReconstructionBackbone(nn.Module):
    def __init__(
        self,
        da3: nn.Module,
        refinement: Optional[nn.Module] = None,
        process_res: int = 504,
        ref_view_strategy: str = "saddle_balanced",
        use_ray_pose: bool = False,
        max_depth: float = 100.0,
        filter_range: Sequence[float] = (-54.0, -54.0, -5.0, 54.0, 54.0, 6.0),
        bq_anchor_points: int = 25000,
        bq_max_radius: float = 0.5,
        bq_sample_num: int = 16,
        bq_grid_dim: int = 128,
        bq_share_sort: bool = True,
        num_points: int = 40000,
        voxel_pre_reduce: float = 0.0,
        pre_reduce_cap: int = 393216,
        fps_impl: str = "auto",
    ):
        super().__init__()
        self.da3, self.refinement = da3, refinement
        self.process_res, self.ref_view_strategy, self.use_ray_pose = process_res, ref_view_strategy, use_ray_pose
        self.max_depth = float(max_depth)
        self.filter_range = tuple(float(v) for v in filter_range)
        self.bq_anchor_points, self.bq_max_radius, self.bq_sample_num = bq_anchor_points, bq_max_radius, bq_sample_num
        self.bq_grid_dim, self.bq_share_sort = bq_grid_dim, bq_share_sort
        self.num_points = num_points
        self.voxel_pre_reduce, self.pre_reduce_cap = float(voxel_pre_reduce), int(pre_reduce_cap)
        # 'auto': the FPS kernel on CUDA tensors; 'plain': its plain version (reference runs)
        self.fps_impl = fps_impl
        # valid-point counts after each stage of the last points_from_depth call, one 0-d tensor per scene
        self.last_stage_counts: Dict[str, list] = {}

    @property
    def use_color(self) -> bool:
        return bool(self.refinement is not None and self.refinement.use_color)

    @torch.no_grad()
    def predict_depth(self, img):
        """DA3 multi-view depth + intrinsics from raw images: (depth
        (B, N, h, w) fp32, intrinsics (B, N, 3, 3) fp32, the DA3 outputs)."""
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
                share_sort=self.bq_share_sort, fps_impl=self.fps_impl)
        counts["union"].append(m.sum())
        with stage("fps_downsample"):  # holds fps_final
            p, m = fps_downsample(p, m, num_points=self.num_points, input_spatially_sorted=self.bq_share_sort,
                                  fps_impl=self.fps_impl)
        counts["final"].append(m.sum())
        return p, m

    @torch.no_grad()
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

    @torch.no_grad()
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

    def colorize_gt_points(self, *args, **kwargs):
        raise NotImplementedError(_TRAINING)

    @torch.no_grad()
    def forward(self, img, cam2lidar_rts, gt_points=None, gt_valid=None, lidar2img=None,
                return_loss: bool = False, depth_override=None):
        """Returns (pseudo_points, valid, losses {}, aux)."""
        if gt_points is not None or return_loss:
            raise NotImplementedError(_TRAINING)
        pts, msk, da3_out = self.predict_points(img, cam2lidar_rts, depth_override=depth_override)
        aux: Dict[str, Any] = {"da3": da3_out}
        losses: Dict[str, torch.Tensor] = {}
        if self.refinement is not None:
            pts, _, r_aux = self.refinement(pts, msk)
            aux.update(r_aux)
        return pts, msk, losses, aux
