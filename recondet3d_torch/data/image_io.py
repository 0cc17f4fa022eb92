"""Image decode and resize for the host loader, without a hard cv2 dependency.

The JAX package's loader decodes with ``cv2.imread`` and upsamples with
``cv2.resize`` (INTER_LINEAR). A host without OpenCV still reads images here:

- ``imread_rgb`` reads binary PPM (``P6``, maxval 255) with numpy and any
  other format through cv2, imported when the file needs it; without cv2
  it raises and names the file's format. It never returns nothing.
- ``write_ppm`` writes the same P6 format (cv2 reads a P6 file whatever its
  extension, so one image tree serves both packages).
- ``resize_bilinear`` is cv2's INTER_LINEAR (half-pixel centres, edge
  pixels repeated, no antialiasing) as cv2 computes it (``_linear_resize``):
  uint8 in cv2's own 11-bit fixed point, the same bits as ``cv2.resize``;
  float32 with cv2's taps in float32.
- ``imread_rgb`` also reads 8-bit non-interlaced PNG (RGB, RGBA, grey, grey
  + alpha) with ``zlib`` and numpy, all five row filters; alpha is dropped
  and grey repeated, as PIL's ``convert("RGB")`` does. Other PNGs and other
  formats go to cv2, or with ``prefer_pil`` to PIL first, where one imports;
  without them the error names the file's format.
- ``write_png`` writes (H, W, 3) uint8 as an RGB PNG, filter 0, zlib level
  6: the bytes of the JAX package's depth_vis writer.
- ``resize_area`` and ``resize_cubic`` are cv2's INTER_AREA and INTER_CUBIC
  (the DA3 API's ``InputProcessor``). INTER_AREA shrinking both axes
  weighs each source pixel by the share of it a destination cell covers
  (at a factor that is not a whole number, which
  ``F.interpolate(mode="area")`` does not do): per-axis (dst, src) weight
  matrices applied as weighted sums of each row's taps in fp64, rounded
  once (uint8 halving: cv2's (s + 2) >> 2). Where an axis does not shrink,
  cv2's INTER_AREA interpolates linearly with its own fractions
  (``_linear_resize``: uint8 in cv2's fixed point, the same bits as
  ``cv2.resize``). INTER_CUBIC is
  Keys' kernel with A = -0.75, half-pixel centres, edge pixels repeated, in
  fp64 sums. cv2 runs uint8 cubic in 11-bit fixed point and rounds between
  its two passes, so uint8 cubic (and area shrinking, summed in another
  order) may differ from cv2's by 1 (tests/test_torch_input_processor.py
  states the share).
"""

from __future__ import annotations

import importlib.util
import struct
import zlib
from typing import Tuple

import numpy as np
import torch

__all__ = ["imread_rgb", "write_ppm", "write_png", "read_png", "resize_bilinear", "resize_area", "resize_cubic"]

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


def imread_rgb(path: str, prefer_pil: bool = False) -> np.ndarray:
    """(H, W, 3) uint8 RGB of the image at ``path``. PPM and the PNGs
    ``read_png`` takes are read here; other files by cv2 (the training
    loader's decoder), or by PIL first with ``prefer_pil`` (the DA3 API's, as
    in the JAX package) where PIL imports."""
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
    if data[:8] == _PNG_MAGIC and _png_unsupported(data) is None:
        return read_png(data)
    if prefer_pil and importlib.util.find_spec("PIL") is not None:
        import io

        from PIL import Image

        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGB")).copy()
    try:
        import cv2
    except ImportError as e:
        what = _png_unsupported(data) if data[:8] == _PNG_MAGIC else f"a {_format_of(data[:4])} file"
        raise ImportError(f"{path} is {what}, which needs OpenCV (cv2) to decode; without it only binary PPM (P6) "
                          "and 8-bit non-interlaced RGB / RGBA / grey PNG are read") from e
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError(f"{path}: cv2 could not decode this {_format_of(data[:4])} file")
    return np.ascontiguousarray(img[..., ::-1])


_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel


def _png_chunks(data: bytes):
    i = 8
    while i + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[i:i + 8])
        yield tag, data[i + 8:i + 8 + n]
        i += 12 + n


def _png_unsupported(data: bytes):
    """None if ``read_png`` takes this PNG, else what it is."""
    for tag, body in _png_chunks(data):
        if tag == b"IHDR":
            _, _, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if depth != 8 or ctype not in _PNG_CHANNELS or interlace:
                return (f"a PNG of bit depth {depth}, colour type {ctype}" + (", interlaced" if interlace else ""))
            return None
    return "a PNG without a header"


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def read_png(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 RGB of an 8-bit non-interlaced PNG (colour types 0, 2,
    4 and 6) given as its bytes: the IDAT stream inflated, each row's filter
    undone (none, sub, up, average, Paeth), alpha dropped, grey repeated."""
    if data[:8] != _PNG_MAGIC:
        raise ValueError("not a PNG")
    why = _png_unsupported(data)
    if why is not None:
        raise ValueError(f"read_png takes 8-bit non-interlaced grey / RGB / RGBA PNG, not {why}")
    idat = []
    for tag, body in _png_chunks(data):
        if tag == b"IHDR":
            w, h, _, ctype = struct.unpack(">IIBB", body[:10])
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    bpp = _PNG_CHANNELS[ctype]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError(f"PNG of {w}x{h}: {raw.size} bytes of rows, {h * (stride + 1)} needed")
    rows = raw[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # sub: running sums of every bpp-th byte
            cur = (np.cumsum(line.reshape(w, bpp).astype(np.int64), axis=0) % 256).astype(np.uint8).reshape(-1)
        elif ftype == 2:
            cur = line + prev  # uint8 arithmetic wraps mod 256
        elif ftype in (3, 4):  # each byte depends on the one bpp before it
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    cur[i] = (cur[i] + ((a + up[i]) >> 1)) & 255
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    cur[i] = (cur[i] + _paeth(a, up[i], c)) & 255
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ftype}")
        out[y] = cur
        prev = out[y]
    px = out.reshape(h, w, bpp)
    if bpp <= 2:
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write (H, W, 3) uint8 RGB as a PNG: one IDAT, every row filter 0, zlib level 6."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"write_png takes (H, W, 3) RGB, got {rgb.shape}")
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(_PNG_MAGIC)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


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
    """cv2.resize(img, (w, h)) (INTER_LINEAR) for (H, W, C) uint8 (the same
    bits: cv2's fixed point) or float32 (cv2's taps in float32)."""
    if img.shape[:2] == tuple(size_hw):
        return img
    if img.dtype not in (np.uint8, np.float32):
        raise TypeError(f"resize_bilinear takes uint8 or float32, got {img.dtype}")
    return _linear_resize(img, size_hw, area=False)


def _area_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) weights of cv2's INTER_AREA shrinking one axis: a
    destination cell spans [d * scale, (d + 1) * scale) source pixels and
    weighs each by the share of it that it covers."""
    scale = 1.0 / (dst / src)  # as cv2 forms it: src / dst can round the other way
    w = np.zeros((dst, src), np.float64)
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        s1, s2 = int(np.ceil(f1)), int(np.floor(f2))
        cell = min(scale, src - f1)
        if s1 - f1 > 1e-3:
            w[d, s1 - 1] = (s1 - f1) / cell
        w[d, s1:min(s2, src)] = 1.0 / cell
        if f2 - s2 > 1e-3 and s2 < src:
            w[d, s2] = min(min(f2 - s2, 1.0), cell) / cell
    return w


def _linear_taps(src: int, dst: int, area: bool):
    """cv2's two-tap interpolation of one axis, as cv2 forms it: for each
    destination index the first source index s (int64) and the float32
    fraction f of the next one. INTER_LINEAR: f = (d + 0.5) * scale - 0.5,
    taken through float32, less its floor; INTER_AREA on an axis that does
    not shrink: s = floor(d * scale), f = ((d + 1) - (s + 1) / scale) mod 1
    (0 where it is not positive). Nothing is clamped here."""
    d = np.arange(dst, dtype=np.float64)
    inv = dst / src
    scale = 1.0 / inv  # as cv2 forms it: src / dst can round the other way
    if area:
        s = np.floor(d * scale)
        f = ((d + 1) - (s + 1) * inv).astype(np.float32)
        f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
        return s.astype(np.int64), f
    f = ((d + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    return s.astype(np.int64), (f - s).astype(np.float32)


def _clamp_taps(s: np.ndarray, f: np.ndarray, src: int):
    """cv2's clamp of a horizontal tap: a first index before the image or on
    its last pixel takes that edge pixel alone (f = 0)."""
    edge = (s < 0) | (s >= src - 1)
    return np.clip(s, 0, src - 1), np.where(edge, np.float32(0), f).astype(np.float32)


_COEF_SCALE = 2048  # cv2's INTER_RESIZE_COEF_SCALE: uint8 taps are round(w * 2^11)


def _fixed_taps(f: np.ndarray) -> np.ndarray:
    """(n, 2) int32 taps round((1 - f) * 2048), round(f * 2048), formed in
    float32 and rounded half to even, as cv2's saturate_cast<short> does."""
    one = np.float32(1)
    taps = np.stack([(one - f) * np.float32(_COEF_SCALE), f * np.float32(_COEF_SCALE)], -1)
    return np.rint(taps).astype(np.int32)


def _linear_resize(img: np.ndarray, size_hw: Tuple[int, int], area: bool) -> np.ndarray:
    """cv2's two-tap resize (INTER_LINEAR, or INTER_AREA where an axis does
    not shrink) of (H, W[, C]) uint8 or float32, as cv2 computes it: a row
    pass over the source rows the output reads, then each output row from
    two of them. uint8 runs cv2's fixed point, the same bits as cv2.resize:
    11-bit taps summed in integers, the two row sums combined as cv2's
    vectorised VResizeLinear does, ((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >>
    4)) >> 16) rounded by (x + 2) >> 2. float32 takes the float taps 1 - f
    and f. Horizontal taps are clamped at the edges; vertical ones are not
    (cv2 reads the edge row twice with both weights)."""
    squeeze = img.ndim == 2
    x = img[..., None] if squeeze else img
    (H, W), (h, w) = x.shape[:2], size_hw
    sx, fx = _clamp_taps(*_linear_taps(W, w, area), W)
    sy, fy = _linear_taps(H, h, area)
    fixed = img.dtype == np.uint8
    ax, by = (torch.from_numpy(_fixed_taps(f) if fixed else np.stack([np.float32(1) - f, f], -1)) for f in (fx, fy))
    y0, y1 = np.clip(sy, 0, H - 1), np.clip(sy + 1, 0, H - 1)
    need = np.unique(np.concatenate([y0, y1]))  # the source rows the output reads, each summed once
    src = torch.from_numpy(np.ascontiguousarray(x[need])).to(torch.int32 if fixed else torch.float32)
    ix = torch.from_numpy(sx)
    rows = src[:, ix].mul_(ax[None, :, :1]).add_(src[:, ix.add(1).clamp_(max=W - 1)].mul_(ax[None, :, 1:]))
    r0, r1 = (rows[torch.from_numpy(np.searchsorted(need, yy))] for yy in (y0, y1))
    if fixed:
        r0, r1 = r0.bitwise_right_shift_(4), r1.bitwise_right_shift_(4)
        out = r0.mul_(by[:, :1, None]).bitwise_right_shift_(16).add_(r1.mul_(by[:, 1:, None]).bitwise_right_shift_(16))
        out = out.add_(2).bitwise_right_shift_(2).clamp_(0, 255).to(torch.uint8)
    else:
        out = r0.mul_(by[:, :1, None]).add_(r1.mul_(by[:, 1:, None]))
    out = out.numpy()
    return out[..., 0] if squeeze else out


def _cubic_weights(src: int, dst: int, A: float = -0.75) -> np.ndarray:
    """(dst, src) weights of cv2's INTER_CUBIC on one axis: source position
    (d + 0.5) * scale - 0.5, four taps, Keys' kernel with ``A``, taps past an
    edge on the edge pixel."""
    scale = 1.0 / (dst / src)
    w = np.zeros((dst, src), np.float64)
    for d in range(dst):
        fx = float(np.float32((d + 0.5) * scale - 0.5))
        s = int(np.floor(fx))
        x = fx - s
        c0 = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1) - 4 * A
        c1 = ((A + 2) * x - (A + 3)) * x * x + 1
        c2 = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1
        for k, c in enumerate((c0, c1, c2, 1.0 - c0 - c1 - c2)):
            w[d, min(max(s - 1 + k, 0), src - 1)] += c
    return w


def _taps(w: np.ndarray):
    """A (dst, src) weight matrix as its nonzero taps: (dst, K) source
    indices and (dst, K) weights, rows padded with weight 0."""
    k = max(1, int((w != 0).sum(1).max()))
    idx = np.zeros((w.shape[0], k), np.int64)
    val = np.zeros((w.shape[0], k), np.float64)
    for d, row in enumerate(w):
        nz = np.flatnonzero(row)
        idx[d, :len(nz)], val[d, :len(nz)] = nz, row[nz]
    return torch.from_numpy(idx), torch.from_numpy(val)


def _separable(img: np.ndarray, wy: np.ndarray, wx: np.ndarray) -> np.ndarray:
    """(H, W, C) -> (h, w, C) = wy @ img @ wx^T per channel, as weighted sums
    of each row's few taps in fp64 on the host; uint8 is rounded to nearest
    and clamped."""
    if img.dtype not in (np.uint8, np.float32):
        raise TypeError(f"resampling takes uint8 or float32, got {img.dtype}")
    squeeze = img.ndim == 2
    x = torch.from_numpy(np.array(img if not squeeze else img[..., None])).double()  # a writable copy
    iy, vy = _taps(wy)
    ix, vx = _taps(wx)
    y = (x[iy] * vy[:, :, None, None]).sum(1)  # rows: (h, W, C)
    y = (y[:, ix] * vx[None, :, :, None]).sum(2)  # columns: (h, w, C)
    if img.dtype == np.uint8:
        y = y.round_().clamp_(0, 255).to(torch.uint8)
    else:
        y = y.float()
    y = y.contiguous().numpy()
    return y[..., 0] if squeeze else y


def resize_area(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA) for (H, W, C)
    uint8 or float32."""
    (H, W), (h, w) = img.shape[:2], size_hw
    if (H, W) == (h, w):
        return img.copy()
    if img.dtype == np.uint8 and (H, W) == (2 * h, 2 * w) and (img.ndim == 2 or img.shape[2] in (1, 3, 4)):
        # cv2's vectorised halving: each 2 x 2 sum rounded by (s + 2) >> 2, where a fp64 mean rounds ties to even
        x = img.astype(np.int32)
        return ((x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2] + 2) >> 2).astype(np.uint8)
    if H >= h and W >= w:
        return _separable(img, _area_weights(H, h), _area_weights(W, w))
    return _linear_resize(img, (h, w), area=True)


def resize_cubic(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=cv2.INTER_CUBIC) for (H, W, C)
    uint8 or float32."""
    (H, W), (h, w) = img.shape[:2], size_hw
    if (H, W) == (h, w):
        return img.copy()
    return _separable(img, _cubic_weights(H, h), _cubic_weights(W, w))
