"""Occupancy losses: bce / focal / dice / bce_dice (port of
``recondet3d/models/losses/occupancy_loss.py``, the same arithmetic):
BCE-with-logits by default, focal with alpha / gamma, dice over the
flattened spatial dims, per-channel weights, mean / sum / none reductions,
``loss_weight`` scaling. Predictions and targets are (B, H, W, C)
channels-last; everything is computed in fp32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = ["OccupancyLoss", "binary_cross_entropy_with_logits"]


def binary_cross_entropy_with_logits(logits, targets):
    """Numerically stable BCE-with-logits (elementwise)."""
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


class OccupancyLoss:
    def __init__(self, loss_type: str = "bce", reduction: str = "mean", loss_weight: float = 1.0,
                 focal_alpha: float = 0.25, focal_gamma: float = 2.0, dice_weight: float = 0.5, pos_weight=None,
                 channel_weights: Optional[Sequence[float]] = None):
        if loss_type not in ("bce", "focal", "dice", "bce_dice"):
            raise ValueError(f"unknown loss_type {loss_type!r}")
        if reduction not in ("none", "sum", "mean"):
            raise ValueError(f"unknown reduction {reduction!r}")
        self.loss_type, self.reduction, self.loss_weight = loss_type, reduction, loss_weight
        self.focal_alpha, self.focal_gamma, self.dice_weight = focal_alpha, focal_gamma, dice_weight
        self.channel_weights = None if channel_weights is None else tuple(float(w) for w in channel_weights)

    def _bce(self, pred, target, use_logits):
        if use_logits:
            return binary_cross_entropy_with_logits(pred, target)
        p = pred.clamp(1e-6, 1 - 1e-6)
        return -(target * torch.log(p) + (1 - target) * torch.log(1 - p))

    def _focal(self, prob, target):
        bce = -(target * torch.log(prob.clamp(min=1e-12)) + (1 - target) * torch.log((1 - prob).clamp(min=1e-12)))
        p_t = prob * target + (1 - prob) * (1 - target)
        alpha_t = self.focal_alpha * target + (1 - self.focal_alpha) * (1 - target)
        return alpha_t * (1 - p_t) ** self.focal_gamma * bce

    @staticmethod
    def _dice(prob, target, smooth=1e-6):
        B, C = prob.shape[0], prob.shape[-1]
        pf, tf = prob.reshape(B, -1, C), target.reshape(B, -1, C)
        inter = (pf * tf).sum(dim=1)
        union = pf.sum(dim=1) + tf.sum(dim=1)
        return 1.0 - (2.0 * inter + smooth) / (union + smooth)  # (B, C)

    def __call__(self, pred, target, reduction_override=None, use_logits: bool = True):
        reduction = reduction_override or self.reduction
        pred, target = pred.float(), target.float()
        prob = torch.sigmoid(pred) if use_logits else pred.clamp(1e-6, 1 - 1e-6)
        if self.loss_type == "bce":
            loss = self._bce(pred, target, use_logits)
        elif self.loss_type == "focal":
            loss = self._focal(prob, target)
        elif self.loss_type == "dice":
            loss = self._dice(prob, target)[:, None, None, :].expand(pred.shape)
        else:
            loss = self._bce(pred, target, use_logits) + self.dice_weight * self._dice(prob, target)[:, None, None, :]
        if self.channel_weights is not None:
            loss = loss * torch.tensor(self.channel_weights, dtype=loss.dtype, device=loss.device)
        if reduction == "mean":
            loss = loss.mean()
        elif reduction == "sum":
            loss = loss.sum()
        return loss * self.loss_weight
