"""ResDet3D (port of ``recondet3d/models/detect/resdet3d.py``): camera
images -> pseudo-LiDAR points and occupancy logits through the
reconstruction backbone; ``forward_train`` returns the reconstruction
losses. The detection head is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from recondet3d_torch.models.detect.reconstruction_backbone import ReconstructionBackbone

__all__ = ["ResDet3D"]


class ResDet3D(nn.Module):
    def __init__(self, reconstruction_backbone: ReconstructionBackbone, pts_bbox_head: Optional[nn.Module] = None,
                 class_names: tuple = ()):
        super().__init__()
        if pts_bbox_head is not None:
            raise NotImplementedError("detection heads are not ported yet (ROADMAP §1 item 12)")
        self.reconstruction_backbone = reconstruction_backbone
        self.class_names = tuple(class_names)

    def forward(self, img, cam2lidar_rts, gt_points=None, gt_valid=None, gt_bboxes_3d=None, gt_labels_3d=None,
                gt_bboxes_valid=None, lidar2img=None, return_loss: bool = False, depth_override=None):
        if return_loss:
            return self.forward_train(img, cam2lidar_rts, gt_points, gt_valid, gt_bboxes_3d, gt_labels_3d,
                                      gt_bboxes_valid, lidar2img=lidar2img)
        return self.simple_test(img, cam2lidar_rts, depth_override=depth_override)

    def forward_train(self, img, cam2lidar_rts, gt_points, gt_valid=None, gt_bboxes_3d=None, gt_labels_3d=None,
                      gt_bboxes_valid=None, lidar2img=None):
        """(losses with 'reconstruction_'-prefixed keys, aux with
        ``pseudo_points``, ``pseudo_valid`` and the backbone's aux).
        ``lidar2img`` colours the GT points when the refinement uses
        colours. Box targets are accepted for the JAX package's signature
        and unused: there is no detection head yet (ROADMAP §1 item 12).
        Batch statistics follow ``self.training``: call ``.train()`` first
        for the JAX package's ``train=True``."""
        pts, msk, r_losses, aux = self.reconstruction_backbone(
            img, cam2lidar_rts, gt_points=gt_points, gt_valid=gt_valid, lidar2img=lidar2img, return_loss=True)
        losses = {f"reconstruction_{k}": v for k, v in r_losses.items()}
        return losses, {"pseudo_points": pts, "pseudo_valid": msk, **aux}

    @torch.no_grad()
    def simple_test(self, img, cam2lidar_rts, depth_override=None) -> Dict[str, Any]:
        """img (B, N, H, W, 3) raw RGB 0..255, cam2lidar_rts (B, N, 4, 4) ->
        {"pseudo_points" (B, P, C), "pseudo_valid" (B, P), "aux"}; ``aux``
        holds ``occupancy_logits`` (B, Y, X, C) when a refinement is set."""
        pts, msk, _, aux = self.reconstruction_backbone(img, cam2lidar_rts, depth_override=depth_override)
        return {"pseudo_points": pts, "pseudo_valid": msk, "aux": aux}

    @torch.no_grad()
    def pipelined_test_step(self, prev_depth, prev_intr, prev_img, img, cam2lidar_rts):
        """One step over a scene stream: DA3 on scene t's images, the point
        pipeline and refinement on scene t-1's depth (with scene t-1's
        images, which colour its points). Returns ((depth_t, intr_t),
        out_{t-1}); prime the carry with ``predict_depth`` on scene 0."""
        bk = self.reconstruction_backbone
        depth, intr, _ = bk.predict_depth(img)
        pts, msk = bk.points_from_depth(prev_depth, prev_intr, prev_img, cam2lidar_rts)
        aux: Dict[str, Any] = {}
        if bk.refinement is not None:
            pts, _, aux = bk.refinement(pts, msk)
        return (depth, intr), {"pseudo_points": pts, "pseudo_valid": msk, "aux": aux}
