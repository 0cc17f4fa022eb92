"""The DA3 API's host input path, port vs JAX package (cv2 / PIL), on the CPU.

- ``InputProcessor``: the processed uint8 images of the two packages agree
  within one level (cv2 runs uint8 cubic in 11-bit fixed point and rounds
  between passes, its area path accumulates in another order) and bit for
  bit where INTER_AREA takes cv2's linear path (an axis that grows), which
  the port runs in cv2's fixed point; the share of pixels that differ is
  bounded per case below (readings with cv2 5.0.0 in the comments). The normalised batches follow from
  the uint8 images in both, and the intrinsics are scaled identically.
- ``resize_area`` / ``resize_cubic`` against cv2 directly, in float32 (no
  rounding: 1e-3 of the 0-255 range for area, 3e-2 for cubic, whose
  fixed-point weights cv2 keeps even in float) and uint8, each case's share
  of values one level off bounded at its reading.
- ``read_png`` against PIL for RGB, RGBA, grey and grey + alpha, each row
  filter (none, sub, up, average, Paeth) written here on purpose, and
  ``imread_rgb`` on PNG and PPM; ``write_png`` gives the JAX package's bytes.
"""

import io
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from recondet3d.data.export import _write_png as j_write_png
from recondet3d.data.input_processor import InputProcessor as JInputProcessor
from recondet3d_torch.data.image_io import imread_rgb, read_png, resize_area, resize_cubic, write_png, write_ppm
from recondet3d_torch.data.input_processor import InputProcessor


def _photo(seed, h, w):
    """A smooth image with noise, so that resampling lands between levels."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    base = np.stack([127 + 100 * np.sin(xx / 37.0 + c) * np.cos(yy / 23.0 - c) for c in range(3)], -1)
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)


# (source size, process_res, the most share of pixels that may differ by one level, resize method)
PROCESS_CASES = {
    "downscale_900x1600_to_504": ((900, 1600), 504, 1e-3, "upper_bound_resize"),  # INTER_AREA; reading 2.1e-5
    "upscale_90x160_to_504": ((90, 160), 504, 1e-3, "upper_bound_resize"),  # INTER_CUBIC; reading 2.0e-5
    "downscale_90x160_to_56": ((90, 160), 56, 5e-3, "upper_bound_resize"),  # INTER_AREA; reading 3.2e-4
    # INTER_AREA where one axis grows: cv2's linear path in its fixed point, matched bit for bit
    "mixed_405x510_to_406x504": ((405, 510), 504, 0.0, "upper_bound_resize"),
    "mixed_503x2983_to_504x2982": ((503, 2983), 504, 0.0, "lower_bound_resize"),
    "mixed_10x1008_to_14x504": ((10, 1008), 504, 0.0, "upper_bound_resize"),
}


@pytest.mark.parametrize("case", list(PROCESS_CASES))
def test_input_processor_matches_jax(case):
    (H, W), res, share, method = PROCESS_CASES[case]
    imgs = [_photo(10 + i, H, W) for i in range(2)]
    ixt = np.tile(np.array([[1266.0, 0, W / 2], [0, 1266.0, H / 2], [0, 0, 1]], np.float32), (2, 1, 1))
    ext = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    jb, je, jk, jraw = JInputProcessor(process_res=res, process_res_method=method)(imgs, ext, ixt)
    tb, te, tk, traw = InputProcessor(process_res=res, process_res_method=method)(imgs, ext, ixt)
    assert traw.shape == jraw.shape and traw.dtype == np.uint8
    diff = np.abs(traw.astype(int) - jraw.astype(int))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= share, (diff > 0).mean()
    # the normalised batch is a function of the uint8 images: one level is 1/255/std
    np.testing.assert_allclose(tb, jb, atol=1.0 / 255 / 0.224 + 1e-6)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(te, je)


# (source, destination) -> the most share of uint8 values resize_area / resize_cubic may put one level off cv2's:
# the readings with cv2 5.0.0. INTER_AREA where an axis grows (cv2's linear path) and at an exact halving (cv2's
# (s + 2) >> 2) is bit for bit; shrinking at other factors sums in fp64 and rounds once; uint8 cubic is not cv2's
# fixed point
RESAMPLE_SHARES = {
    ((900, 1600), (280, 504)): dict(resize_area=1e-4, resize_cubic=2.5e-3),  # readings 6.1e-5, 1.9e-3
    ((90, 160), (280, 504)): dict(resize_area=0.0, resize_cubic=3e-4),  # reading 2.0e-4
    ((90, 160), (28, 56)): dict(resize_area=3e-4, resize_cubic=0.0),  # reading 2.1e-4
    ((100, 100), (50, 50)): dict(resize_area=0.0, resize_cubic=0.0),
    ((60, 90), (70, 40)): dict(resize_area=0.0, resize_cubic=0.0),
    ((375, 1242), (154, 504)): dict(resize_area=0.0, resize_cubic=2e-3),  # reading 1.4e-3
}


@pytest.mark.parametrize("src,dst", list(RESAMPLE_SHARES))
def test_resamplers_match_cv2(src, dst):
    img = np.random.default_rng(sum(src) + sum(dst)).integers(0, 256, src + (3,), dtype=np.uint8)
    for fn, flag, f32_tol in ((resize_area, cv2.INTER_AREA, 1e-3), (resize_cubic, cv2.INTER_CUBIC, 3e-2)):
        ref = cv2.resize(img.astype(np.float32), dst[::-1], interpolation=flag)
        np.testing.assert_allclose(fn(img.astype(np.float32), dst), ref, atol=f32_tol)
        diff = np.abs(fn(img, dst).astype(int) - cv2.resize(img, dst[::-1], interpolation=flag).astype(int))
        share = RESAMPLE_SHARES[src, dst][fn.__name__]
        assert diff.max() <= 1 and (diff > 0).mean() <= share, (fn.__name__, diff.max(), (diff > 0).mean())


def _png_bytes(px: np.ndarray, ctype: int, filters) -> bytes:
    """An 8-bit PNG of ``px`` (H, W, channels) whose row y uses filter
    ``filters[y % len(filters)]``, encoded here (PIL picks its own)."""
    h, w, bpp = px.shape
    rows = px.reshape(h, w * bpp).astype(np.int64)
    out = []
    for y in range(h):
        f = filters[y % len(filters)]
        cur, up = rows[y], rows[y - 1] if y else np.zeros(w * bpp, np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if f == 0:
            enc = cur
        elif f == 1:
            enc = cur - left
        elif f == 2:
            enc = cur - up
        elif f == 3:
            enc = cur - (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
            enc = cur - pred
        out.append(bytes([f]) + (enc % 256).astype(np.uint8).tobytes())

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("mode,ctype,bpp", [("RGB", 2, 3), ("RGBA", 6, 4), ("L", 0, 1), ("LA", 4, 2)])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)])
def test_png_reader_matches_pil(mode, ctype, bpp, filters):
    px = _photo(bpp, 23, 31)
    px = np.concatenate([px, px[..., :1] ^ 0x5A], -1)[..., :bpp] if bpp != 1 else px[..., :1]
    data = _png_bytes(px, ctype, filters)
    with Image.open(io.BytesIO(data)) as im:
        assert im.mode == mode
        ref = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(read_png(data), ref)


def test_imread_and_writers(tmp_path):
    img = _photo(3, 17, 29)
    write_png(str(tmp_path / "a.png"), img)
    j_write_png(str(tmp_path / "b.png"), img)
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()
    np.testing.assert_array_equal(imread_rgb(str(tmp_path / "a.png")), img)
    with Image.open(str(tmp_path / "a.png")) as im:
        np.testing.assert_array_equal(np.asarray(im), img)
    Image.fromarray(img).save(str(tmp_path / "pil.png"), optimize=True)
    np.testing.assert_array_equal(imread_rgb(str(tmp_path / "pil.png")), img)
    write_ppm(str(tmp_path / "c.ppm"), img)
    np.testing.assert_array_equal(imread_rgb(str(tmp_path / "c.ppm")), img)
    # the API loads paths, arrays and PIL images alike
    proc = InputProcessor(process_res=56)
    outs = [proc([src])[3] for src in (str(tmp_path / "a.png"), img, Image.fromarray(img))]
    assert all(np.array_equal(o, outs[0]) for o in outs)
