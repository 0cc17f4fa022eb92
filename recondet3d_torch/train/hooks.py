"""Training hooks: device-memory logging, occupancy debug dumps,
augmentation fading, step timing (port of ``recondet3d/train/hooks.py``).

Hooks are callables ``hook(step, state, metrics)`` invoked by the Trainer
after every step, on every rank; only rank 0 writes files.
"""

from __future__ import annotations

import logging
import os
import pickle
import time
from typing import Callable, Optional

import numpy as np
import torch

from recondet3d_torch.parallel.distributed import is_main_process

logger = logging.getLogger("recondet3d_torch.hooks")

__all__ = ["DeviceMemoryLoggerHook", "OccupancyDebugHook", "FadingHook", "TimingHook"]


def _numpy(x):
    return x.detach().float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class DeviceMemoryLoggerHook:
    """Log the CUDA allocator's bytes in use, their peak and the card's
    total every ``interval`` steps (nothing on a machine without a card)."""

    def __init__(self, interval: int = 1):
        self.interval = interval
        self.last = None

    def __call__(self, step, state, metrics):
        if step % self.interval or not torch.cuda.is_available():
            return
        gib = 2 ** 30
        self.last = dict(in_use=torch.cuda.memory_allocated() / gib, peak=torch.cuda.max_memory_allocated() / gib,
                         limit=torch.cuda.get_device_properties(0).total_memory / gib)
        logger.info("step %d: device memory %.2f GiB in use (peak %.2f / limit %.2f)", step, self.last["in_use"],
                    self.last["peak"], self.last["limit"])


class OccupancyDebugHook:
    """Dump occupancy maps for offline visualization every ``interval``
    steps. ``aux_fn()`` returns the aux dict of the last step
    ('occupancy_logits', 'gt_occupancy_map', 'pseudo_coors')."""

    def __init__(self, out_dir: str, interval: int = 10, aux_fn: Optional[Callable] = None,
                 voxel_size=(0.075, 0.075, 0.2), point_cloud_range=(-54.0, -54.0, -5.0, 54.0, 54.0, 3.0)):
        self.out_dir, self.interval, self.aux_fn = out_dir, interval, aux_fn
        self.voxel_size, self.point_cloud_range = list(voxel_size), list(point_cloud_range)
        os.makedirs(out_dir, exist_ok=True)

    def __call__(self, step, state, metrics):
        if step % self.interval or self.aux_fn is None or not is_main_process():
            return
        aux = self.aux_fn()
        if not aux:
            return
        data = {
            "pseudo_occupancy_map": 1 / (1 + np.exp(-_numpy(aux["occupancy_logits"]).astype(np.float64)))
            if "occupancy_logits" in aux else None,
            "gt_occupancy_map": _numpy(aux["gt_occupancy_map"]) if "gt_occupancy_map" in aux else None,
            "pseudo_coors": _numpy(aux["pseudo_coors"]) if "pseudo_coors" in aux else None,
            "voxel_size": self.voxel_size,
            "point_cloud_range": self.point_cloud_range,
            "step": step,
        }
        with open(os.path.join(self.out_dir, f"debug_iter_{step:06d}.pkl"), "wb") as f:
            pickle.dump(data, f)


class FadingHook:
    """Disable an augmentation from a given step on (the reference's Fading
    hook drops ObjectSample after epoch N)."""

    def __init__(self, target, attr: str = "enabled", after_step: int = 0):
        self.target, self.attr, self.after_step = target, attr, after_step
        self._done = False

    def __call__(self, step, state, metrics):
        if not self._done and step >= self.after_step:
            setattr(self.target, self.attr, False)
            self._done = True
            logger.info("fading: disabled %s.%s at step %d", type(self.target).__name__, self.attr, step)


class TimingHook:
    """Log steps per second every ``interval`` steps (host wall clock)."""

    def __init__(self, interval: int = 10):
        self.interval = interval
        self._last = time.time()
        self._steps = 0
        self.steps_per_sec = None

    def __call__(self, step, state, metrics):
        self._steps += 1
        if self._steps % self.interval == 0:
            now = time.time()
            self.steps_per_sec = self.interval / max(now - self._last, 1e-9)
            logger.info("step %d: %.2f steps/s", step, self.steps_per_sec)
            self._last = now
