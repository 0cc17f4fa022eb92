"""ResDet3D (port of ``recondet3d/models/detect/resdet3d.py``): camera
images -> pseudo-LiDAR points and occupancy logits through the
reconstruction backbone; ``forward_train`` returns the reconstruction
losses and, with a detection head (``pts_bbox_head``, e.g. ``CenterHead``)
and box targets, the head's losses; ``simple_test`` and
``pipelined_test_step`` add the head's raw predictions (``det_preds``,
decoded on the host by ``pts_bbox_head.decode``).
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
        self.reconstruction_backbone = reconstruction_backbone
        self.pts_bbox_head = pts_bbox_head
        self.class_names = tuple(class_names or ())

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
        colours. With a detection head and ``gt_bboxes_3d`` (B, M, 7 or 9),
        ``gt_labels_3d`` (B, M) (-1 pads) and ``gt_bboxes_valid`` (B, M)
        (default: labels >= 0), the head's losses join under their own names
        and aux holds its predictions as ``det_preds``. Batch statistics
        follow ``self.training``: call ``.train()`` first for the JAX
        package's ``train=True``."""
        pts, msk, r_losses, aux = self.reconstruction_backbone(
            img, cam2lidar_rts, gt_points=gt_points, gt_valid=gt_valid, lidar2img=lidar2img, return_loss=True)
        losses = {f"reconstruction_{k}": v for k, v in r_losses.items()}
        if self.pts_bbox_head is not None and gt_bboxes_3d is not None:
            head = self.pts_bbox_head
            preds = head(aux["bev_features"])
            valid = gt_bboxes_valid if gt_bboxes_valid is not None else gt_labels_3d >= 0
            targets = head.get_targets(gt_bboxes_3d, gt_labels_3d, valid,
                                       self.class_names or head.task_class_names())
            losses.update(head.loss(preds, targets))
            aux["det_preds"] = preds
        return losses, {"pseudo_points": pts, "pseudo_valid": msk, **aux}

    @torch.no_grad()
    def simple_test(self, img, cam2lidar_rts, depth_override=None) -> Dict[str, Any]:
        """img (B, N, H, W, 3) raw RGB 0..255, cam2lidar_rts (B, N, 4, 4) ->
        {"pseudo_points" (B, P, C), "pseudo_valid" (B, P), "aux"}; ``aux``
        holds ``occupancy_logits`` (B, Y, X, C) when a refinement is set;
        with a detection head ``det_preds`` holds its raw predictions."""
        pts, msk, _, aux = self.reconstruction_backbone(img, cam2lidar_rts, depth_override=depth_override)
        out = {"pseudo_points": pts, "pseudo_valid": msk, "aux": aux}
        if self.pts_bbox_head is not None:
            out["det_preds"] = self.pts_bbox_head(aux["bev_features"])
        return out

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
        out = {"pseudo_points": pts, "pseudo_valid": msk, "aux": aux}
        if self.pts_bbox_head is not None:
            out["det_preds"] = self.pts_bbox_head(aux["bev_features"])
        return (depth, intr), out
