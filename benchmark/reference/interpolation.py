"""Image / feature-map resizing.

The JAX package builds ``resize_2d`` (``recondet3d/utils/interpolation.py``)
as dense resampling matrices that reproduce torch ``F.interpolate``; the
port calls ``F.interpolate`` itself and is held against ``resize_2d`` by
the tests. ``interpolate_nchw`` is the NCHW form the convolution heads use.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["resize_2d", "interpolate_nchw"]


def interpolate_nchw(
    x: torch.Tensor,
    size: Tuple[int, int],
    mode: str = "bilinear",
    align_corners: bool = False,
    scale: Optional[Tuple[float, float]] = None,
) -> torch.Tensor:
    """Resize (N, C, H, W) to ``size``.

    ``scale`` pins torch's ``scale_factor`` coordinate mapping (the DINOv2
    pos-embed interpolate-offset kludge): the output size then follows from
    ``scale`` and must equal ``size``.
    """
    kwargs = {}
    if mode in ("bilinear", "bicubic"):
        kwargs["align_corners"] = align_corners
    if scale is not None:
        y = F.interpolate(x, scale_factor=tuple(float(s) for s in scale), mode=mode, **kwargs)
        if tuple(y.shape[-2:]) != tuple(size):
            raise ValueError(f"scale {scale} gives {tuple(y.shape[-2:])}, expected {tuple(size)}")
        return y
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode=mode, **kwargs)


def resize_2d(
    x: torch.Tensor,
    size: Tuple[int, int],
    mode: str = "bilinear",
    align_corners: bool = False,
    scale: Optional[Tuple[float, float]] = None,
) -> torch.Tensor:
    """Resize (..., H, W, C) channels-last tensors to ``size`` (out_h, out_w);
    the layout of the JAX ``resize_2d``."""
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    y = interpolate_nchw(x.reshape(-1, h, w, c).permute(0, 3, 1, 2), size, mode, align_corners, scale)
    return y.permute(0, 2, 3, 1).reshape(*lead, y.shape[-2], y.shape[-1], c)
