"""Losses of the port."""

from recondet3d_torch.models.losses.occupancy_loss import OccupancyLoss
from recondet3d_torch.models.losses.point_losses import ColorLoss, EMDLoss, SimpleL2Loss, SmoothnessLoss, emd_loss

__all__ = ["OccupancyLoss", "EMDLoss", "SmoothnessLoss", "ColorLoss", "SimpleL2Loss", "emd_loss"]
