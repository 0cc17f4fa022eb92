"""ResDet3D, inference path (port of
``recondet3d/models/detect/resdet3d.py``): camera images -> pseudo-LiDAR
points and occupancy logits through the reconstruction backbone. Training
and the detection head are not ported yet.
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

    def forward(self, img, cam2lidar_rts, return_loss: bool = False, depth_override=None, **train_inputs):
        if return_loss or train_inputs:
            return self.forward_train(img, cam2lidar_rts, **train_inputs)
        return self.simple_test(img, cam2lidar_rts, depth_override=depth_override)

    def forward_train(self, *args, **kwargs):
        raise NotImplementedError(
            "forward_train: training (ROADMAP §1 item 11) and the detection losses (item 12) are not ported yet")

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
