"""Image decode and resize for the host loader, without a hard cv2 dependency.

The JAX package's loader decodes with ``cv2.imread`` and upsamples with
``cv2.resize`` (INTER_LINEAR). A host without OpenCV still reads images here:

- ``imread_rgb`` reads binary PPM (``P6``, maxval 255) with numpy and any
  other format through cv2, imported when the file needs it; without cv2
  it raises and names the file's format. It never returns nothing.
- ``write_ppm`` writes the same P6 format (cv2 reads a P6 file whatever its
  extension, so one image tree serves both packages).
- ``resize_bilinear`` is cv2's INTER_LINEAR geometry (half-pixel centres,
  edge pixels repeated, no antialiasing) run through
  ``torch.nn.functional.interpolate`` on the host. cv2 interpolates uint8
  in 11-bit fixed point and this in fp32, so uint8 results may differ from
  cv2's by 1 (tests/test_torch_train_cli.py measures the share).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["imread_rgb", "write_ppm", "resize_bilinear"]

_MAGIC = ((b"\xff\xd8\xff", "JPEG"), (b"\x89PNG", "PNG"), (b"BM", "BMP"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"),
          (b"RIFF", "WebP"), (b"P5", "PGM"), (b"P3", "ASCII PPM"))


def _ppm_header(data: bytes) -> Tuple[int, int, int, int]:
    """(width, height, maxval, offset of the pixels) of a P6 file: four
    whitespace-separated fields after which one whitespace byte ends the
    header; '#' starts a comment that runs to the end of its line."""
    fields, i = [], 2
    while len(fields) < 3:
        c = data[i:i + 1]
        if not c:
            raise ValueError("truncated PPM header")
        if c == b"#":
            i = data.index(b"\n", i) + 1
        elif c.isspace():
            i += 1
        else:
            j = i
            while data[j:j + 1] and not data[j:j + 1].isspace():
                j += 1
            fields.append(int(data[i:j]))
            i = j
    return fields[0], fields[1], fields[2], i + 1


def _format_of(head: bytes) -> str:
    return next((name for magic, name in _MAGIC if head.startswith(magic)), "unknown")


def imread_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of the image at ``path``."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"P6":
        w, h, maxval, off = _ppm_header(data)
        if maxval != 255:
            raise ValueError(f"{path}: P6 with maxval {maxval}; only 8-bit PPM is read")
        n = w * h * 3
        if len(data) < off + n:
            raise ValueError(f"{path}: P6 of {w}x{h} holds {len(data) - off} of its {n} pixel bytes")
        return np.frombuffer(data, np.uint8, n, off).reshape(h, w, 3).copy()
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{path} is a {_format_of(data[:4])} file, which needs OpenCV (cv2) to decode; "
                          "without it only binary PPM (P6) is read") from e
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError(f"{path}: cv2 could not decode this {_format_of(data[:4])} file")
    return np.ascontiguousarray(img[..., ::-1])


def write_ppm(path: str, rgb: np.ndarray) -> None:
    """Write (H, W, 3) uint8 RGB as binary PPM (P6)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"write_ppm takes (H, W, 3) RGB, got {rgb.shape}")
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(rgb.tobytes())


def resize_bilinear(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """(H, W, C) uint8 or float32 -> (h, w, C) of the same dtype, bilinear
    with half-pixel centres (cv2.INTER_LINEAR's geometry); uint8 is rounded
    to nearest and clamped."""
    h, w = size_hw
    if img.shape[:2] == (h, w):
        return img
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)[0].permute(1, 2, 0)
    if img.dtype == np.uint8:
        y = y.round_().clamp_(0, 255).to(torch.uint8)
    elif img.dtype != np.float32:
        raise TypeError(f"resize_bilinear takes uint8 or float32, got {img.dtype}")
    return y.contiguous().numpy()
