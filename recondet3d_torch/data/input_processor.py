"""DA3 input processing on the device (port of
``recondet3d/data/input_processor.py`` ``compute_process_shape`` and
``process_tensor_batch``): aspect-preserving resize to ``process_res``,
patch-14 alignment, ImageNet normalization, intrinsics rescale.

The host list-of-images path (``InputProcessor``, PIL and cv2's INTER_AREA /
INTER_CUBIC) belongs to the DA3 API and is ROADMAP item 13. The training and
test CLIs read their images through ``data/image_io.py`` and hand this
module float tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from recondet3d_torch.utils.constants import IMAGENET_MEAN, IMAGENET_STD, PATCH_SIZE
from recondet3d_torch.utils.interpolation import interpolate_nchw

__all__ = ["process_tensor_batch", "compute_process_shape"]


def _nearest_multiple(x: int, p: int) -> int:
    down = (x // p) * p
    up = down + p
    return max(p, up if abs(up - x) <= abs(x - down) else down)


def compute_process_shape(H: int, W: int, process_res: int = 504,
                          method: str = "upper_bound_resize") -> Tuple[int, int, int, int]:
    """(new_H, new_W) after the aspect-preserving resize and (final_H,
    final_W) after patch-14 rounding."""
    if method in ("upper_bound_resize", "upper_bound_crop"):
        scale = process_res / max(H, W)
    elif method in ("lower_bound_resize", "lower_bound_crop"):
        scale = process_res / min(H, W)
    else:
        raise ValueError(method)
    new_H, new_W = int(H * scale), int(W * scale)
    return new_H, new_W, _nearest_multiple(new_H, PATCH_SIZE), _nearest_multiple(new_W, PATCH_SIZE)


def process_tensor_batch(images: torch.Tensor, intrinsics: Optional[torch.Tensor] = None,
                         process_res: int = 504, method: str = "upper_bound_resize",
                         assume_range: str = "auto"):
    """images (B, N, H, W, 3) -> ((B, N, H', W', 3) normalized fp32, rescaled
    intrinsics). H', W' are multiples of 14. Runs where ``images`` lies.

    assume_range: '255' | '01' | 'auto' (divide by 255 when the batch's max
    exceeds 1, decided on the device)."""
    B, N, H, W, _ = images.shape
    new_H, new_W, final_H, final_W = compute_process_shape(H, W, process_res, method)

    x = images.reshape(B * N, H, W, 3).float().permute(0, 3, 1, 2)
    x = interpolate_nchw(x, (new_H, new_W), mode="bilinear", align_corners=False)
    if (final_H, final_W) != (new_H, new_W):
        upscale = final_H > new_H or final_W > new_W
        x = interpolate_nchw(x, (final_H, final_W), mode="bilinear" if upscale else "area")

    if assume_range == "255":
        x = x / 255.0
    elif assume_range == "auto":
        x = torch.where(x.max() > 1.0, x / 255.0, x)
    elif assume_range != "01":
        raise ValueError(f"unknown assume_range {assume_range!r}")
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)[None, :, None, None]
    std = torch.tensor(IMAGENET_STD, device=x.device)[None, :, None, None]
    x = ((x - mean) / std).permute(0, 2, 3, 1).reshape(B, N, final_H, final_W, 3)

    if intrinsics is not None:
        sx, sy = final_W / W, final_H / H
        scale = torch.tensor([[sx, 1.0, sx], [1.0, sy, sy], [1.0, 1.0, 1.0]],
                             dtype=intrinsics.dtype, device=intrinsics.device)
        intrinsics = intrinsics * scale
    return x, intrinsics
