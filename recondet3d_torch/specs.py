"""Output dataclasses of the DA3 API (port of ``recondet3d/specs.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

__all__ = ["Gaussians", "Prediction"]


@dataclasses.dataclass
class Gaussians:
    """World-space 3D gaussians (means/scales/rotations wxyz/harmonics/opacities)."""

    means: Any  # (B, N, 3)
    scales: Any  # (B, N, 3)
    rotations: Any  # (B, N, 4) wxyz
    harmonics: Any  # (B, N, 3, d_sh)
    opacities: Any  # (B, N)


@dataclasses.dataclass
class Prediction:
    """DA3 inference output."""

    depth: np.ndarray  # (N, H, W)
    conf: Optional[np.ndarray] = None  # (N, H, W)
    sky: Optional[np.ndarray] = None  # (N, H, W) bool
    extrinsics: Optional[np.ndarray] = None  # (N, 3, 4) w2c
    intrinsics: Optional[np.ndarray] = None  # (N, 3, 3)
    gaussians: Optional[Gaussians] = None
    aux: Optional[Dict[str, np.ndarray]] = None
    scale_factor: Optional[float] = None
    is_metric: bool = False
    processed_images: Optional[np.ndarray] = None  # (N, H, W, 3) uint8
