"""The attention of one request, counted from the configuration's shapes.

Each ViT trunk of DA3 runs one attention a block: over each view's tokens
(local) or, from ``alt_start`` on at odd blocks, over all views' tokens of a
scene (global). A view has (ph / 14) * (pw / 14) patch tokens and one
class or camera token. A launch over (B, H, N, M, D) needs 4 * N * M * D
operations a head (QK^T and PV) and reads q, k, v and writes o once, in
bfloat16; its least time is the larger of operations over the bf16 peak and
bytes over the HBM bandwidth.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from benchmark.counts import PEAK_BF16_FLOPS, PEAK_HBM_BYTES

__all__ = ["launches", "least_seconds"]

VIT = {"vits": (12, 6, 64), "vitl": (24, 16, 64), "vitg": (40, 24, 64)}  # depth, heads, D
# (trunk, alt_start) of each DA3 preset's trunks: -1 has no global blocks; da3-small is the CPU tests' tiny net
TRUNKS = {
    "da3nested-giant-large": (("vitg", 13), ("vitl", -1)),
    "da3-small": (("vits", 4),),
}


def launches(preset: str, scenes: int, views: int, ph: int, pw: int) -> List[Tuple[int, int, int, int, int]]:
    """(B, H, N, M, D) of every attention launch of one forward."""
    tokens = (ph // 14) * (pw // 14) + 1
    out = []
    for vit, alt in TRUNKS[preset.split("/")[-1].lower()]:
        depth, heads, d = VIT[vit]
        for i in range(depth):
            if alt != -1 and i >= alt and i % 2 == 1:
                out.append((scenes, heads, views * tokens, views * tokens, d))
            else:
                out.append((scenes * views, heads, tokens, tokens, d))
    return out


def least_seconds(shapes) -> Dict[str, float]:
    """Operations, bytes and the least time of the launches ``shapes``."""
    flops = bytes_ = least = 0.0
    for B, H, N, M, D in shapes:
        f = 4.0 * B * H * N * M * D
        b = 2.0 * B * H * D * (2 * N + 2 * M)  # q and o: N rows; k and v: M rows; bf16
        flops, bytes_ = flops + f, bytes_ + b
        least += max(f / PEAK_BF16_FLOPS, b / PEAK_HBM_BYTES)
    return {"flops": flops, "bytes": bytes_, "least_s": least}
