"""How ``correct`` is decided: the numbers a family's check reads
(``benchmark/families/<family>.py``, ``readings``), each held against its
limit in the cell's file, and the comparisons they are made of. The
reference runs once the window has closed and the program is freed
(``PERF.md`` lists the numbers, the readings they were set from and the
limits).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

__all__ = ["rel_l2", "max_rel", "points_gap", "boxes_gap", "verdict", "median"]


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp(min=1e-30))


def max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest elementwise gap over the reference's largest magnitude."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def points_gap(p: torch.Tensor, v: torch.Tensor, p_ref: torch.Tensor, v_ref: torch.Tensor, tol: float = 1e-4) -> float:
    """The share of output slots (B, P) where the program and the reference
    disagree: one valid and the other not, or both valid and a coordinate
    more than ``tol`` m apart."""
    both = v & v_ref
    far = (p[..., :3].double() - p_ref[..., :3].double()).abs().amax(-1) > tol
    bad = (v != v_ref) | (both & far)
    return float(bad.double().mean())


def boxes_gap(res: List[Dict], res_ref: List[Dict], tol: float = 1e-3) -> float:
    """The decoded boxes with no equal box on the other side, counted over
    the scenes and both sides: equal is the same label, the score within
    ``tol`` and every box field within ``tol`` (metres, radians, m/s), in
    any order (equal scores may come out in either order)."""
    unmatched = 0
    for r, q in zip(res, res_ref):
        a = torch.cat([torch.as_tensor(r["boxes_3d"]).double().reshape(-1, 9),
                       torch.as_tensor(r["scores_3d"]).double().reshape(-1, 1)], 1)
        b = torch.cat([torch.as_tensor(q["boxes_3d"]).double().reshape(-1, 9),
                       torch.as_tensor(q["scores_3d"]).double().reshape(-1, 1)], 1)
        la, lb = torch.as_tensor(r["labels_3d"]).reshape(-1), torch.as_tensor(q["labels_3d"]).reshape(-1)
        ok = ((a[:, None] - b[None]).abs().amax(-1) <= tol) & (la[:, None] == lb[None])
        used = torch.zeros(b.shape[0], dtype=torch.bool)
        for i in range(a.shape[0]):
            free = (ok[i] & ~used).nonzero()
            if len(free):
                used[free[0, 0]] = True
            else:
                unmatched += 1
        unmatched += int((~used).sum())
    return float(unmatched)


def verdict(readings: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every limited number is finite and within its limit."""
    return all(k in readings and math.isfinite(readings[k]) and readings[k] <= lim for k, lim in limits.items())


def median(values) -> float:
    """The upper median (the middle value of an odd count)."""
    v = sorted(values)
    return v[len(v) // 2] if v else 0.0

