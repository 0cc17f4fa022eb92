"""Fixed-radius ball query with static output shapes (port of
``recondet3d/ops/ball_query.py``).

Contract (``selection="first"``): for each query center, the ``nsample``
smallest **original** indices of the points whose distance lies in
[min_radius, max_radius]; the remaining slots are filled with the first
found index; a center with no neighbour returns all zeros.

``selection="any"`` keeps the ``nsample`` smallest **sorted positions**
instead, in the cell sort the JAX package's grid route scans (the
``structure`` when one is given, else its own sort of the points over a
grid laid over the centers' extent plus the radius), mapped back to
original indices. As in the JAX package it applies on the grid route only:
with a ``structure``, with ``impl="grid"``, or with ``impl="auto"`` and at
least 65,536 points. On the scan route (``impl="scan"``, or ``"auto"``
below that size) the JAX package returns the 'first' selection, and so
does the port.

A full (M, N) distance matrix does not fit at the pipeline's sizes, so the
search runs over a ``CellSort`` of the points (shared with the
furthest-point sampler when the caller passes ``structure``): a point
within ``max_radius`` of a center lies at most one grid row and one column
away from the center's cell, because a cell is at least ``max_radius``
wide. Each of the three rows of that band is one contiguous range of the
sorted points. Centers are grouped by the length of their longest range,
so that a chunk of centers gathers a dense (chunk, 3, width) block of
candidates with little padding; the chunk widths are read back from the
device once per call (the one host synchronisation here).
"""

from __future__ import annotations

from typing import Optional

import torch

from benchmark.reference.cell_sort import CellSort, cell_sort, sort_into_cells
from benchmark.reference.grouping import sq_dist

__all__ = ["ball_query"]

# candidates (chunk x 3 x width) gathered at a time
_CHUNK_ELEMS = 1 << 24


@torch.no_grad()
def ball_query(
    min_radius: float,
    max_radius: float,
    nsample: int,
    points: torch.Tensor,
    centers: torch.Tensor,
    points_valid: Optional[torch.Tensor] = None,
    grid_dim: int = 64,
    structure: Optional[CellSort] = None,
    chunk: int = 2048,
    selection: str = "first",
    impl: str = "auto",
) -> torch.Tensor:
    """points (N, 3), centers (M, 3) -> (M, nsample) int64.

    ``structure``: a ``CellSort`` over (points, points_valid) built with
    ``min_cell >= max_radius``; built here when absent. ``chunk`` moves the
    cost only; ``grid_dim`` too under 'first', while under 'any' it is the
    grid of the JAX package's own sort. ``selection`` and ``impl``: see the
    module docstring.
    """
    if selection not in ("first", "any"):
        raise ValueError(f"unknown ball-query selection {selection!r}")
    if impl not in ("auto", "grid", "scan"):
        raise ValueError(f"unknown ball-query impl {impl!r}")
    if structure is not None and impl == "scan":
        raise ValueError("structure= requires the grid impl")
    grid_route = structure is not None or impl == "grid" or (impl == "auto" and points.shape[0] >= 65536)
    by_position = selection == "any" and grid_route
    if structure is None:
        structure = (_center_extent_sort(points, points_valid, centers, grid_dim, max_radius) if by_position
                     else cell_sort(points, points_valid, grid_dim=grid_dim, min_cell=max_radius))
    if structure.min_cell < max_radius:
        raise ValueError(
            f"CellSort built with min_cell={structure.min_cell} < max_radius={max_radius}: "
            "the +-1-cell band search would miss in-radius points")
    N = points.shape[0]
    M = centers.shape[0]
    G = structure.grid_dim
    dev = points.device
    min_sq, max_sq = float(min_radius) ** 2, float(max_radius) ** 2
    cen = centers[:, :3].float()
    spts, sval, sorig, cell_start = structure.spts, structure.sval, structure.sorig, structure.cell_start

    # per center and band row: the sorted-point range [start, end)
    rc = structure.cell_of(cen[:, :2])  # (M, 2)
    dr = torch.tensor([-1, 0, 1], device=dev)
    row = rc[:, :1] + dr[None, :]  # (M, 3)
    oob = (row < 0) | (row >= G)
    row = row.clamp(0, G - 1)
    c0 = (rc[:, 1:] - 1).clamp(0, G - 1)
    c1 = (rc[:, 1:] + 1).clamp(0, G - 1)
    starts = torch.where(oob, torch.zeros_like(row), cell_start[row * G + c0])
    ends = torch.where(oob, torch.zeros_like(row), cell_start[row * G + c1 + 1])

    # group centers by their longest range; one read-back gives every chunk's width
    longest = (ends - starts).amax(dim=1)
    by_len = torch.argsort(longest)
    chunk = max(1, min(int(chunk), M))
    bounds = list(range(0, M, chunk))
    widths = longest[by_len[[min(b + chunk, M) - 1 for b in bounds]]].tolist()

    big = N
    out = torch.zeros((M, nsample), dtype=torch.long, device=dev)
    for b0, width in zip(bounds, widths):
        if width == 0:
            continue
        rows = max(1, _CHUNK_ELEMS // (3 * width))
        for s0 in range(b0, min(b0 + chunk, M), rows):
            sel = by_len[s0:min(s0 + rows, b0 + chunk, M)]
            pos = starts[sel][:, :, None] + torch.arange(width, device=dev)  # (c, 3, width)
            in_rng = pos < ends[sel][:, :, None]
            pos = torch.where(in_rng, pos, torch.zeros_like(pos)).reshape(len(sel), -1)
            p = spts[pos]  # (c, 3 * width, 3)
            d2 = sq_dist(cen[sel][:, None, :], p)
            in_ball = (d2 <= max_sq) & sval[pos] & in_rng.reshape(len(sel), -1)
            if min_sq > 0:
                in_ball &= d2 >= min_sq
            score = torch.where(in_ball, pos if by_position else sorig[pos], torch.full_like(pos, big))
            k = min(nsample, score.shape[1])
            best = torch.topk(score, k, dim=1, largest=False, sorted=True).values
            if k < nsample:
                best = torch.cat([best, best.new_full((len(sel), nsample - k), big)], dim=1)
            found = best < big
            if by_position:
                best = torch.where(found, sorig[best.clamp(max=N - 1)], best)
            first = torch.where(found[:, :1], best[:, :1], torch.zeros_like(best[:, :1]))
            out[sel] = torch.where(found, best, first)
    return out


def _center_extent_sort(points, points_valid, centers, grid_dim: int, radius: float) -> CellSort:
    """The sort the JAX package's grid route builds when it gets no
    structure: a grid_dim^2 BEV grid over the centers' extent widened by
    the radius, cells at least ``radius`` wide, points clipped into the
    boundary cells, a stable sort by cell (invalid rows last)."""
    r = float(radius)
    v = points_valid.bool() if points_valid is not None else torch.ones(points.shape[0], dtype=torch.bool,
                                                                        device=points.device)
    cen = centers[:, :2].float()
    lo = cen.amin(dim=0) - r
    cell = ((cen.amax(dim=0) + r - lo) / grid_dim).clamp(min=r)
    pts = points[:, :3].float()
    xy = torch.where(v[:, None], pts[:, :2], torch.zeros_like(pts[:, :2]))
    return sort_into_cells(pts, xy, v, lo, cell, grid_dim, r)
