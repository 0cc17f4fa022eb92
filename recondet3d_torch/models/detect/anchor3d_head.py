"""Anchor-based 3D detection head, SECOND / PointPillars style (port of
``recondet3d/models/detect/anchor3d_head.py``).

Three 1x1 convolutions over BEV features (B, H, W, C) give class scores, box
deltas and direction logits, channels-last as in the JAX package. Training
targets come from one (A, G) nearest-BEV IoU matrix per sample with
per-class thresholds and a force match of each GT's best anchor; losses are
sigmoid focal classification, smooth-L1 on sin-difference boxes and
direction cross-entropy, averaged by the positives. ``get_bboxes`` decodes
and runs the per-class NMS on the host. Module names follow the flax tree
(``conv_cls``, ``conv_reg``, ``conv_dir_cls``).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from recondet3d_torch.core.post_processing import box3d_multiclass_nms

__all__ = ["Anchor3DHead", "generate_anchors_3d", "delta_encode", "delta_decode", "get_direction_target"]


def generate_anchors_3d(feature_size: Tuple[int, int], ranges: Sequence[Sequence[float]],
                        sizes: Sequence[Sequence[float]], rotations: Sequence[float] = (0.0, math.pi / 2),
                        custom_values: int = 0) -> np.ndarray:
    """(A, 7 + custom_values) anchors, A = H*W*len(sizes)*len(rotations),
    laid out y-major, then x, then size, then rotation (numpy, as in the
    JAX package)."""
    H, W = feature_size
    R = len(rotations)
    per_size = []
    for rng, size in zip(ranges, sizes):
        x = np.linspace(rng[0], rng[3], W)
        y = np.linspace(rng[1], rng[4], H)
        yy, xx = np.meshgrid(y, x, indexing="ij")
        cen = np.stack([xx, yy, np.broadcast_to(np.array([rng[2]]), xx.shape)], axis=-1)
        per_size.append(np.concatenate([
            np.broadcast_to(cen[:, :, None, None, :], (H, W, 1, R, 3)),
            np.broadcast_to(np.asarray(size, np.float64)[None, None, None, None, :], (H, W, 1, R, 3)),
            np.broadcast_to(np.asarray(rotations, np.float64)[None, None, None, :, None], (H, W, 1, R, 1)),
        ], axis=-1))
    anchors = np.concatenate(per_size, axis=2)
    if custom_values:
        anchors = np.concatenate([anchors, np.zeros((*anchors.shape[:-1], custom_values))], axis=-1)
    return anchors.reshape(-1, anchors.shape[-1]).astype(np.float32)


def delta_encode(anchors: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Box -> regression deltas: diagonal-normalised center offsets (z at
    the gravity center), log size ratios, raw yaw delta."""
    xa, ya, za, dxa, dya, dza, ra = anchors[..., :7].unbind(-1)
    xg, yg, zg, dxg, dyg, dzg, rg = gt[..., :7].unbind(-1)
    za = za + dza / 2
    zg = zg + dzg / 2
    diag = torch.sqrt(dxa ** 2 + dya ** 2)
    out = torch.stack([(xg - xa) / diag, (yg - ya) / diag, (zg - za) / dza, torch.log(dxg / dxa),
                       torch.log(dyg / dya), torch.log(dzg / dza), rg - ra], -1)
    if anchors.shape[-1] > 7:
        out = torch.cat([out, gt[..., 7:] - anchors[..., 7:]], -1)
    return out


def delta_decode(anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Regression deltas -> boxes (the inverse of ``delta_encode``)."""
    xa, ya, za, dxa, dya, dza, ra = anchors[..., :7].unbind(-1)
    xt, yt, zt, dxt, dyt, dzt, rt = deltas[..., :7].unbind(-1)
    za = za + dza / 2
    diag = torch.sqrt(dxa ** 2 + dya ** 2)
    dzg = torch.exp(dzt) * dza
    out = torch.stack([xt * diag + xa, yt * diag + ya, zt * dza + za - dzg / 2, torch.exp(dxt) * dxa,
                       torch.exp(dyt) * dya, dzg, rt + ra], -1)
    if deltas.shape[-1] > 7:
        out = torch.cat([out, deltas[..., 7:] + anchors[..., 7:]], -1)
    return out


def _limit_period(val, offset=0.5, period=math.pi * 2):
    return val - torch.floor(val / period + offset) * period


def get_direction_target(anchors, reg_targets, dir_offset=0.0, num_bins=2):
    """Yaw -> direction bin."""
    rot_gt = reg_targets[..., 6] + anchors[..., 6]
    offset_rot = _limit_period(rot_gt - dir_offset, 0, 2 * math.pi)
    bins = torch.floor(offset_rot / (2 * math.pi / num_bins)).long()
    return bins.clamp(0, num_bins - 1)


class Anchor3DHead(nn.Module):
    """Single-level anchor head; ``anchor_ranges`` / ``anchor_sizes`` and the
    IoU thresholds are per class."""

    def __init__(
        self,
        num_classes: int,
        in_channels: int = 256,
        feat_channels: int = 256,
        anchor_ranges: Sequence[Sequence[float]] = ((0, -40.0, -1.78, 70.4, 40.0, -1.78),),
        anchor_sizes: Sequence[Sequence[float]] = ((3.9, 1.6, 1.56),),
        anchor_rotations: Sequence[float] = (0.0, math.pi / 2),
        anchor_custom_values: int = 0,
        pos_iou_thr: Sequence[float] = (0.6,),
        neg_iou_thr: Sequence[float] = (0.45,),
        dir_offset: float = 0.0,
        dir_limit_offset: float = 0.0,
        use_direction_classifier: bool = True,
        diff_rad_by_sin: bool = True,
        focal_alpha: float = 0.25,
        focal_gamma: float = 2.0,
        smooth_l1_beta: float = 1.0 / 9.0,
        loss_cls_weight: float = 1.0,
        loss_bbox_weight: float = 2.0,
        loss_dir_weight: float = 0.2,
        device=None,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.anchor_ranges, self.anchor_sizes = tuple(anchor_ranges), tuple(anchor_sizes)
        self.anchor_rotations, self.anchor_custom_values = tuple(anchor_rotations), anchor_custom_values
        self.pos_iou_thr, self.neg_iou_thr = pos_iou_thr, neg_iou_thr
        self.dir_offset, self.dir_limit_offset = dir_offset, dir_limit_offset
        self.use_direction_classifier, self.diff_rad_by_sin = use_direction_classifier, diff_rad_by_sin
        self.focal_alpha, self.focal_gamma, self.smooth_l1_beta = focal_alpha, focal_gamma, smooth_l1_beta
        self.loss_cls_weight, self.loss_bbox_weight, self.loss_dir_weight = (loss_cls_weight, loss_bbox_weight,
                                                                             loss_dir_weight)
        self.conv_cls = nn.Conv2d(in_channels, self.num_anchors * num_classes, 1, device=device)
        self.conv_reg = nn.Conv2d(in_channels, self.num_anchors * self.box_code_size, 1, device=device)
        self.conv_dir_cls = (nn.Conv2d(in_channels, self.num_anchors * 2, 1, device=device)
                             if use_direction_classifier else None)
        with torch.no_grad():
            self.conv_cls.bias.fill_(float(-np.log((1 - 0.01) / 0.01)))

    @property
    def box_code_size(self) -> int:
        return 7 + self.anchor_custom_values

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_sizes) * len(self.anchor_rotations)

    def forward(self, x: torch.Tensor):
        """x (B, H, W, C) -> dict of cls_score (B, H, W, A*num_classes),
        bbox_pred (B, H, W, A*code) and dir_pred (B, H, W, A*2)."""
        h = x.float().permute(0, 3, 1, 2)
        out = {"cls_score": self.conv_cls(h).permute(0, 2, 3, 1), "bbox_pred": self.conv_reg(h).permute(0, 2, 3, 1)}
        if self.conv_dir_cls is not None:
            out["dir_pred"] = self.conv_dir_cls(h).permute(0, 2, 3, 1)
        return out

    def anchors_for(self, feature_size: Tuple[int, int], device=None) -> torch.Tensor:
        return torch.from_numpy(generate_anchors_3d(
            feature_size, ranges=self.anchor_ranges, sizes=self.anchor_sizes, rotations=self.anchor_rotations,
            custom_values=self.anchor_custom_values)).to(device)

    # ---------------- training ----------------

    @torch.no_grad()
    def get_targets(self, anchors, gt_bboxes, gt_labels, gt_mask):
        """Max-IoU assignment with per-GT-class thresholds and a force match
        of each GT's best anchor. anchors (A, code); gt_bboxes (B, G, code);
        gt_labels (B, G); gt_mask (B, G) bool. Returns labels (B, A) (the
        background is num_classes), label_weights, bbox_targets (B, A,
        code), bbox_weights and dir_targets (B, A)."""
        from recondet3d_torch.ops.iou3d import nearest_bev_iou

        dev = anchors.device
        pos_thr = torch.from_numpy(np.broadcast_to(np.asarray(self.pos_iou_thr, np.float32),
                                                   (self.num_classes,)).copy()).to(dev)
        neg_thr = torch.from_numpy(np.broadcast_to(np.asarray(self.neg_iou_thr, np.float32),
                                                   (self.num_classes,)).copy()).to(dev)
        A = anchors.shape[0]
        outs = []
        for gt, labels, mask in zip(gt_bboxes, gt_labels.long(), gt_mask.bool()):
            iou = nearest_bev_iou(anchors, gt)
            iou = torch.where(mask[None, :], iou, torch.full_like(iou, -1.0))
            best_iou, best_gt = iou.max(dim=1)
            cls = labels[best_gt].clamp(0, self.num_classes - 1)
            a_pos = best_iou >= pos_thr[cls]
            a_neg = (best_iou < neg_thr[cls]) | (best_iou < 0)
            gt_best_iou, gt_best_anchor = iou.max(dim=0)
            gt_has = mask & (gt_best_iou > 1e-6)
            force = torch.zeros(A, dtype=torch.bool, device=dev)
            forced_gt = torch.full((A,), -1, dtype=torch.long, device=dev)
            # the last GT that forces an anchor wins it, as the scatter of the JAX package writes them in order
            for g in torch.nonzero(gt_has).flatten().tolist():
                force[gt_best_anchor[g]] = True
                forced_gt[gt_best_anchor[g]] = g
            assigned = torch.where(forced_gt >= 0, forced_gt, best_gt)
            pos = a_pos | force
            neg = a_neg & ~pos
            out_labels = torch.where(pos, labels[assigned], torch.full_like(labels[assigned], self.num_classes))
            tgt = delta_encode(anchors, gt[assigned])
            tgt = torch.where(pos[:, None], tgt, torch.zeros_like(tgt))
            outs.append((out_labels, (pos | neg).float(), tgt, pos.float(),
                         get_direction_target(anchors, tgt, self.dir_offset)))
        labels, lw, tgt, bw, dir_t = (torch.stack(x) for x in zip(*outs))
        return {"labels": labels, "label_weights": lw, "bbox_targets": tgt, "bbox_weights": bw, "dir_targets": dir_t}

    def loss(self, preds, targets):
        """Sigmoid focal classification over positive and negative anchors,
        smooth-L1 with the sin-difference yaw over positives and direction
        cross-entropy, each averaged by the number of positives."""
        B = preds["cls_score"].shape[0]
        cls = preds["cls_score"].reshape(B, -1, self.num_classes)
        box = preds["bbox_pred"].reshape(B, -1, self.box_code_size)
        labels, lw = targets["labels"], targets["label_weights"]
        tgt, bw = targets["bbox_targets"], targets["bbox_weights"]
        num_pos = (bw > 0).sum().float().clamp(min=1.0)

        onehot = F.one_hot(labels, self.num_classes + 1)[..., :self.num_classes].float()  # background -> zeros
        p = torch.sigmoid(cls)
        pt = torch.where(onehot > 0, p, 1 - p)
        alpha_t = torch.where(onehot > 0, self.focal_alpha, 1 - self.focal_alpha)
        focal = alpha_t * (1 - pt) ** self.focal_gamma * -torch.log(pt.clamp(min=1e-12))
        loss_cls = (focal.sum(-1) * lw).sum() / num_pos

        pred_box = box
        if self.diff_rad_by_sin:
            sin_p = torch.sin(box[..., 6]) * torch.cos(tgt[..., 6])
            sin_t = torch.cos(box[..., 6]) * torch.sin(tgt[..., 6])
            pred_box = torch.cat([box[..., :6], sin_p[..., None], box[..., 7:]], -1)
            tgt = torch.cat([tgt[..., :6], sin_t[..., None], tgt[..., 7:]], -1)
        diff = (pred_box - tgt).abs()
        beta = self.smooth_l1_beta
        sl1 = torch.where(diff < beta, 0.5 * diff ** 2 / beta, diff - 0.5 * beta)
        losses = {"loss_cls": self.loss_cls_weight * loss_cls,
                  "loss_bbox": self.loss_bbox_weight * (sl1 * bw[..., None]).sum() / num_pos}
        if self.use_direction_classifier and "dir_pred" in preds:
            logp = F.log_softmax(preds["dir_pred"].reshape(B, -1, 2), -1)
            dir_ce = -torch.gather(logp, -1, targets["dir_targets"][..., None])[..., 0]
            losses["loss_dir"] = self.loss_dir_weight * (dir_ce * bw).sum() / num_pos
        return losses

    # ---------------- inference (host) ----------------

    @torch.no_grad()
    def get_bboxes(self, preds, score_thr: float = 0.1, max_num: int = 50, nms_thr: float = 0.2,
                   use_rotate_nms: bool = True):
        """Decode + per-class NMS on the host, with the direction bins' yaw
        correction. Returns per sample (boxes (n, code), scores, labels) as
        numpy arrays."""
        cls = preds["cls_score"].float().cpu()
        box = preds["bbox_pred"].float().cpu()
        B, H, W = cls.shape[:3]
        anchors = self.anchors_for((H, W))
        results = []
        for b in range(B):
            scores = torch.sigmoid(cls[b].reshape(-1, self.num_classes)).numpy()
            boxes = delta_decode(anchors, box[b].reshape(-1, self.box_code_size)).numpy()
            dir_scores = None
            if self.use_direction_classifier and "dir_pred" in preds:
                dir_scores = preds["dir_pred"][b].float().cpu().reshape(-1, 2).argmax(-1).numpy().astype(np.float32)
            padded = np.concatenate([scores, np.zeros((len(scores), 1), scores.dtype)], -1)
            out = box3d_multiclass_nms(boxes, boxes[:, [0, 1, 3, 4, 6]], padded, score_thr, max_num,
                                       dict(use_rotate_nms=use_rotate_nms, nms_thr=nms_thr),
                                       mlvl_dir_scores=dir_scores)
            bboxes, sc, lb = out[:3]
            if dir_scores is not None and len(bboxes):
                rot = bboxes[:, 6] - self.dir_offset
                bboxes[:, 6] = rot - np.floor(rot / np.pi + self.dir_limit_offset) * np.pi + self.dir_offset \
                    + np.pi * out[3]
            results.append((bboxes, sc, lb))
        return results
