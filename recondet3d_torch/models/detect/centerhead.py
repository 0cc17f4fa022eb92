"""CenterPoint-style detection head on BEV features (port of
``recondet3d/models/detect/centerhead.py``).

A shared 3x3 conv + batch norm + ReLU, then per task six branches (heatmap,
center offset, height, log dims, sin/cos yaw, velocity), each a 3x3 conv +
batch norm + ReLU + 3x3 conv. Public layout channels-last as in the JAX
package ((B, H, W, C) in, (B, H, W, ch) out), NCHW inside. The flax module
has no dtype of its own, so it computes in the promotion of its input's and
its fp32 parameters' types: fp32, whatever the trunk's compute dtype. The
port does the same (the bf16 BEV features of the production trunk are
widened to fp32 at its input). Batch norms are flax's (momentum 0.9, eps
1e-5, biased variance in the running statistics; batch statistics in train
mode, running ones in eval mode). Module names follow the flax tree
(``shared_conv``, ``shared_bn``, ``task_<i>/hm_conv`` -> ``branches.<i>.hm_conv``),
so ``api/weights.py`` carries parameters and batch statistics across.

Targets are drawn vectorised (max over a static ``max_objs`` of per-object
gaussians), as in the JAX package; decode takes the per-task top-K and the
NMS's IoU matrix on the predictions' device, and walks the greedy NMS and
returns numpy arrays on the host.

Under data parallelism (``parallel/mesh.py``) the losses' normalisers, the
heatmap's positive count and the boxes' mask count, are the global batch's
(summed over the ranks), as GSPMD computes them, and each rank's loss is its
share of the global loss times the rank count, which DDP's gradient average
turns back into the global loss's gradient.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from recondet3d_torch.models.refine.bev_unet import FlaxBatchNorm2d
from recondet3d_torch.parallel.mesh import data_parallel_size, global_sum
from recondet3d_torch.utils.stage_timer import stage

__all__ = ["CenterHead", "gaussian_radius", "draw_heatmap", "init_head_parameters_", "DEFAULT_TASKS"]

DEFAULT_TASKS = (
    ("car",),
    ("truck", "construction_vehicle"),
    ("bus", "trailer"),
    ("barrier",),
    ("motorcycle", "bicycle"),
    ("pedestrian", "traffic_cone"),
)
_FIELDS = (("hm", "heatmap"), ("reg", "reg"), ("height", "height"), ("dim", "dim"), ("rot", "rot"), ("vel", "vel"))
_HM_PRIOR = -2.19  # the heatmap's focal-loss prior bias


def gaussian_radius(dims_xy: torch.Tensor, min_overlap: float = 0.1) -> torch.Tensor:
    """CornerNet-style radius from BEV box dims (feature cells)."""
    w, l = dims_xy[..., 0], dims_xy[..., 1]
    b1 = w + l
    c1 = w * l * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt((b1 ** 2 - 4 * c1).clamp(min=0))) / 2
    b2 = 2 * (w + l)
    c2 = (1 - min_overlap) * w * l
    r2 = (b2 + torch.sqrt((b2 ** 2 - 16 * c2).clamp(min=0))) / 8
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (w + l)
    c3 = (min_overlap - 1) * w * l
    r3 = (b3 + torch.sqrt((b3 ** 2 - 4 * a3 * c3).clamp(min=0))) / (2 * a3)
    return torch.minimum(torch.minimum(r1, r2), r3).clamp(min=0.0)


def draw_heatmap(centers: torch.Tensor, radii: torch.Tensor, valid: torch.Tensor, hw: Tuple[int, int]):
    """Vectorised gaussian splat: centers (..., M, 2) feature coords, radii
    (..., M), valid (..., M) -> (..., H, W) heatmap (max over objects)."""
    H, W = hw
    ys = torch.arange(H, dtype=torch.float32, device=centers.device)[:, None, None]
    xs = torch.arange(W, dtype=torch.float32, device=centers.device)[None, :, None]
    c = centers[..., None, None, :, :]
    dx = xs - c[..., 0]
    dy = ys - c[..., 1]
    sigma = ((2 * radii + 1) / 6.0).clamp(min=1e-3)[..., None, None, :]
    g = torch.exp(-(dx ** 2 + dy ** 2) / (2 * sigma ** 2))
    g = torch.where(valid[..., None, None, :], g, torch.zeros_like(g))
    return g.amax(dim=-1)


def _conv(cin, cout, device):
    return nn.Conv2d(cin, cout, 3, padding=1, device=device)


class _TaskBranch(nn.Module):
    def __init__(self, n_cls: int, share_ch: int, device=None):
        super().__init__()
        outs = dict(hm=n_cls, reg=2, height=1, dim=3, rot=2, vel=2)
        for name, _ in _FIELDS:
            setattr(self, f"{name}_conv", _conv(share_ch, share_ch, device))
            setattr(self, f"{name}_bn", FlaxBatchNorm2d(share_ch, device, momentum=0.9, eps=1e-5))
            setattr(self, f"{name}_out", _conv(share_ch, outs[name], device))

    def forward(self, x):
        out = {}
        for name, key in _FIELDS:
            h = F.relu(getattr(self, f"{name}_bn")(getattr(self, f"{name}_conv")(x)))
            out[key] = getattr(self, f"{name}_out")(h).permute(0, 2, 3, 1)
        return out


def init_head_parameters_(head: nn.Module, generator: torch.Generator) -> None:
    """Random init from ``generator``: N(0, 1/fan_in) convolution kernels,
    zero biases but the heatmap's (-2.19, the focal prior, as the JAX
    package initialises it); norms keep unit scale. Numbers are drawn on the
    generator's device."""
    with torch.no_grad():
        for name, p in head.named_parameters():
            if name.endswith("weight") and p.dim() == 4:
                p.copy_(torch.randn(p.shape, generator=generator, device=generator.device) * p[0].numel() ** -0.5)
            elif name.endswith("bias") and not name.endswith("_bn.bias"):
                p.fill_(_HM_PRIOR if name.endswith("hm_out.bias") else 0.0)


class CenterHead(nn.Module):
    def __init__(
        self,
        in_channels: int = 256,
        tasks: Sequence[Sequence[str]] = DEFAULT_TASKS,
        share_ch: int = 64,
        point_cloud_range: Sequence[float] = (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0),
        voxel_size: Sequence[float] = (0.075, 0.075, 0.2),
        out_size_factor: int = 8,
        max_objs: int = 500,
        gaussian_overlap: float = 0.1,
        min_radius: float = 2.0,
        loss_cls_weight: float = 1.0,
        loss_bbox_weight: float = 0.25,
        code_weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.2, 0.2),
        device=None,
    ):
        super().__init__()
        self.tasks = tuple(tuple(t) for t in tasks)
        self.point_cloud_range = tuple(point_cloud_range)
        self.voxel_size = tuple(voxel_size)
        self.out_size_factor = out_size_factor
        self.max_objs = max_objs
        self.gaussian_overlap, self.min_radius = gaussian_overlap, min_radius
        self.loss_cls_weight, self.loss_bbox_weight = loss_cls_weight, loss_bbox_weight
        self.code_weights = tuple(code_weights)
        self.shared_conv = _conv(in_channels, share_ch, device)
        self.shared_bn = FlaxBatchNorm2d(share_ch, device, momentum=0.9, eps=1e-5)
        self.branches = nn.ModuleList(_TaskBranch(len(t), share_ch, device) for t in self.tasks)
        with torch.no_grad():
            for b in self.branches:
                b.hm_out.bias.fill_(_HM_PRIOR)

    def forward(self, bev_feats: torch.Tensor):
        """bev_feats (B, H, W, C) -> list of per-task dicts of (B, H, W, ch)
        fp32 maps; batch statistics follow ``self.training``."""
        x = bev_feats.float().permute(0, 3, 1, 2)
        x = F.relu(self.shared_bn(self.shared_conv(x)))
        return [branch(x) for branch in self.branches]

    # ------------------------------------------------------------------ targets + loss

    def class_to_task(self):
        return {name: (ti, ci) for ti, cls_list in enumerate(self.tasks) for ci, name in enumerate(cls_list)}

    def task_class_names(self):
        return [c for t in self.tasks for c in t]

    def _grid(self):
        pcr, vs, fs = np.asarray(self.point_cloud_range), np.asarray(self.voxel_size), self.out_size_factor
        return int(round((pcr[3] - pcr[0]) / vs[0])) // fs, int(round((pcr[4] - pcr[1]) / vs[1])) // fs

    @torch.no_grad()
    def get_targets(self, gt_boxes, gt_labels, gt_valid, class_names):
        """gt_boxes (B, M, 7 or 9), gt_labels (B, M), gt_valid (B, M) ->
        per-task dict(heatmap (B, H, W, C_t), anno (B, M, 10), inds (B, M),
        mask (B, M))."""
        pcr, vs, fs = self.point_cloud_range, self.voxel_size, self.out_size_factor
        W, H = self._grid()
        mapping = self.class_to_task()
        task_of = np.full(len(class_names), -1, np.int64)
        cls_of = np.zeros(len(class_names), np.int64)
        for li, name in enumerate(class_names):
            if name in mapping:
                task_of[li], cls_of[li] = mapping[name]
        dev = gt_boxes.device
        boxes = gt_boxes.float()
        cx = (boxes[..., 0] - pcr[0]) / (vs[0] * fs)
        cy = (boxes[..., 1] - pcr[1]) / (vs[1] * fs)
        in_grid = (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
        dims_feat = torch.stack([boxes[..., 3] / (vs[0] * fs), boxes[..., 4] / (vs[1] * fs)], -1)
        radii = gaussian_radius(dims_feat, self.gaussian_overlap).clamp(min=self.min_radius)
        ix = cx.to(torch.int32).clamp(0, W - 1)
        iy = cy.to(torch.int32).clamp(0, H - 1)
        inds = (iy * W + ix).long()
        vel = boxes[..., 7:9] if boxes.shape[-1] >= 9 else boxes.new_zeros(boxes.shape[:2] + (2,))
        anno = torch.cat([
            (cx - ix.float())[..., None], (cy - iy.float())[..., None],
            (boxes[..., 2] + boxes[..., 5] * 0.5)[..., None],  # gravity z
            torch.log(boxes[..., 3:6].clamp(min=1e-6)),
            torch.sin(boxes[..., 6])[..., None], torch.cos(boxes[..., 6])[..., None], vel], dim=-1)
        lab = gt_labels.long().clamp(0, len(class_names) - 1)
        gt_task = torch.as_tensor(task_of, device=dev)[lab]
        gt_cls = torch.as_tensor(cls_of, device=dev)[lab]
        base_valid = gt_valid.bool() & (gt_labels >= 0) & in_grid
        # gaussians sit on the integer cell, so the peak is exactly 1 for the focal loss's positives
        centers = torch.stack([ix.float(), iy.float()], dim=-1)
        targets = []
        for ti, cls_list in enumerate(self.tasks):
            tmask = base_valid & (gt_task == ti)
            heatmap = torch.stack([draw_heatmap(centers, radii, tmask & (gt_cls == ci), (H, W))
                                   for ci in range(len(cls_list))], dim=-1)
            targets.append(dict(heatmap=heatmap, anno=anno, inds=inds, mask=tmask))
        return targets

    def loss(self, preds, targets):
        """Gaussian focal heatmap loss + masked L1 regression, per task."""
        losses = {}
        for ti, (pred, tgt) in enumerate(zip(preds, targets)):
            hm_pred = torch.sigmoid(pred["heatmap"]).clamp(1e-4, 1 - 1e-4)
            hm_gt = tgt["heatmap"]
            pos = (hm_gt >= 1.0 - 1e-4).float()
            neg_w = (1 - hm_gt) ** 4
            pos_loss = -torch.log(hm_pred) * (1 - hm_pred) ** 2 * pos
            neg_loss = -torch.log(1 - hm_pred) * hm_pred ** 2 * neg_w * (1 - pos)
            # the normalisers count the global batch, as GSPMD's sums do; divided by the rank count they make a rank's
            # loss its share times that count, which DDP's average turns back into the global loss (parallel/mesh.py)
            dp = data_parallel_size()
            n_pos = global_sum(pos.sum()).clamp(min=1.0) / dp
            losses[f"task{ti}_loss_heatmap"] = (pos_loss.sum() + neg_loss.sum()) / n_pos * self.loss_cls_weight

            reg_pred = torch.cat([pred["reg"], pred["height"], pred["dim"], pred["rot"], pred["vel"]], dim=-1)
            B, H, W, C = reg_pred.shape
            picked = torch.gather(reg_pred.reshape(B, H * W, C), 1, tgt["inds"][..., None].expand(-1, -1, C))
            mask = tgt["mask"].float()[..., None]
            cw = torch.tensor(self.code_weights, dtype=torch.float32, device=reg_pred.device)
            l1 = (picked - tgt["anno"]).abs() * mask * cw
            n_box = (global_sum(mask.sum()) * C).clamp(min=1.0) / dp
            losses[f"task{ti}_loss_bbox"] = l1.sum() / n_box * self.loss_bbox_weight
        return losses

    # ------------------------------------------------------------------ decode

    @torch.no_grad()
    def decode(self, preds, max_per_task: int = 128, score_threshold: float = 0.1, nms_thresh: float = 0.2,
               class_names=None):
        """Per-task top-K decode -> per batch element a dict of numpy
        ``boxes_3d`` (n, 9), ``scores_3d`` and ``labels_3d``, after the score
        threshold and rotated NMS. Labels index the flattened task order
        (``task_class_names()``), or ``class_names`` when given."""
        from recondet3d_torch.ops.iou3d import nms_bev

        with stage("decode"):
            pcr, vs, fs = self.point_cloud_range, self.voxel_size, self.out_size_factor
            label_base = 0
            outputs = []
            for pred in preds:
                hm = torch.sigmoid(pred["heatmap"])
                B, H, W, C = hm.shape
                # lax.top_k's order: equal scores (the many empty cells of a random head) lowest index first, which
                # torch.topk does not promise
                scores, idx = torch.sort(hm.reshape(B, -1), dim=1, descending=True, stable=True)
                scores, idx = scores[:, :max_per_task], idx[:, :max_per_task]
                cls = idx % C
                pix = idx // C
                iy, ix = pix // W, pix % W

                def gather(field):
                    f = pred[field].reshape(B, H * W, -1)
                    return torch.gather(f, 1, pix[..., None].expand(-1, -1, f.shape[-1]))

                reg, height, dim = gather("reg"), gather("height"), torch.exp(gather("dim"))
                rot, vel = gather("rot"), gather("vel")
                x = (ix.float() + reg[..., 0]) * vs[0] * fs + pcr[0]
                y = (iy.float() + reg[..., 1]) * vs[1] * fs + pcr[1]
                z = height[..., 0] - dim[..., 2] * 0.5  # gravity -> bottom
                yaw = torch.atan2(rot[..., 0], rot[..., 1])
                boxes = torch.cat([torch.stack([x, y, z], -1), dim, yaw[..., None], vel], dim=-1)
                outputs.append((boxes, scores, cls + label_base))
                label_base += C

            label_map = None
            if class_names is not None:
                label_map = np.array([list(class_names).index(n) for n in self.task_class_names()], np.int64)
            results = []
            for b in range(outputs[0][0].shape[0]):
                boxes = torch.cat([o[0][b] for o in outputs])
                scores = torch.cat([o[1][b] for o in outputs])
                labels = torch.cat([o[2][b] for o in outputs])
                keep = scores >= score_threshold
                boxes, scores, labels = boxes[keep], scores[keep], labels[keep]
                if len(boxes):  # the IoU matrix where the predictions are; the greedy walk on the host
                    with stage("nms"):
                        keep = nms_bev(boxes[:, [0, 1, 3, 4, 6]], scores, nms_thresh)
                    boxes, scores, labels = boxes[keep], scores[keep], labels[keep]
                labels = labels.cpu().numpy().astype(np.int64)
                if label_map is not None:
                    labels = label_map[labels]
                results.append(dict(boxes_3d=boxes.cpu().numpy(), scores_3d=scores.cpu().numpy(), labels_3d=labels))
            return results
