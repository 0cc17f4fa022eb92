"""Occupancy loss (``recondet3d/models/losses/occupancy_loss.py``): part of
the training path, which is not ported yet."""

from __future__ import annotations

__all__ = ["OccupancyLoss"]


class OccupancyLoss:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError("OccupancyLoss belongs to training, which is not ported yet (ROADMAP §1 item 11)")
