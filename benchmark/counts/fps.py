"""Furthest point sampling, counted from what the benchmark's own reference
selected on the same inputs.

A selection of K points from N rows of which n_valid are valid needs, per
selection, one squared distance (3 subtractions, 3 products, 2 sums) and
one minimum against every valid row: 9 operations, on the CUDA cores in
fp32. It reads the rows (3 fp32 coordinates and a validity byte) once and
writes K indices (int64). Its least time is the larger of 9 * K * n_valid
over the fp32 peak and the bytes over the HBM bandwidth (PERF.md's bound).
"""

from __future__ import annotations

from typing import Iterable, Tuple

from benchmark.counts import PEAK_FP32_FLOPS, PEAK_HBM_BYTES

__all__ = ["least_seconds"]


def least_seconds(calls: Iterable[Tuple[int, int, int]]) -> float:
    """The least time of FPS calls given as (N rows, n_valid, K)."""
    total = 0.0
    for n, n_valid, k in calls:
        total += max(9.0 * k * n_valid / PEAK_FP32_FLOPS, (13.0 * n + 8.0 * k) / PEAK_HBM_BYTES)
    return total
