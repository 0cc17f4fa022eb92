"""Shared BEV cell-sort structure for the point pipeline (port of
``recondet3d/ops/cell_sort.py``).

``cell_sort`` sorts a cloud by the cells of a G x G BEV grid laid over the
**valid** points' extent (stable, invalid rows last) and records where each
cell starts. The ball query searches the +-1-cell band of this structure;
the furthest-point sampler accepts it as ``presorted``. The band search is
exact only when a cell is at least as wide as the query radius, so
``cell_sort`` always builds cells >= ``min_cell`` and ``ball_query`` always
checks ``min_cell >= max_radius``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

__all__ = ["CellSort", "cell_sort"]


class CellSort(NamedTuple):
    """Cell-sorted view of a (N, 3) cloud over a G x G BEV grid."""

    spts: torch.Tensor        # (N, 3) f32, sorted by cell id (invalid last)
    sval: torch.Tensor        # (N,) bool, sorted
    sorig: torch.Tensor       # (N,) int64: sorted position -> original index
    scell: torch.Tensor       # (N,) int64: cell id per sorted row (G*G for invalid)
    cell_start: torch.Tensor  # (G*G + 2,) int64: first sorted row per cell
    lo: torch.Tensor          # (2,) f32 grid origin (xy)
    cell: torch.Tensor        # (2,) f32 cell size (xy)
    min_cell: float = 0.0     # the lower bound on the cell size it was built with

    @property
    def grid_dim(self) -> int:
        return math.isqrt(self.cell_start.shape[0] - 2)

    def cell_of(self, xy: torch.Tensor) -> torch.Tensor:
        """(.., 2) xy -> (.., 2) integer (row, col), clipped into the grid."""
        rc = torch.floor((xy - self.lo) / self.cell)
        return rc.clamp(0, self.grid_dim - 1).long()


def cell_sort(points: torch.Tensor, valid: Optional[torch.Tensor], grid_dim: int = 128,
              min_cell: float = 0.5) -> CellSort:
    """Sort ``points`` (N, >=3; xy used for cells) by a grid_dim^2 BEV grid
    over the valid extent. ``min_cell`` must be >= the largest radius any
    consumer will query."""
    N = points.shape[0]
    G = int(grid_dim)
    n_cells = G * G
    pts = points[:, :3].float()
    v = valid.bool() if valid is not None else torch.ones(N, dtype=torch.bool, device=points.device)
    # invalid rows may hold anything (inf, nan): keep them out of the arithmetic
    xy = torch.where(v[:, None], pts[:, :2], torch.zeros_like(pts[:, :2]))

    inf = torch.full_like(xy, float("inf"))
    lo = torch.where(v[:, None], xy, inf).amin(dim=0)
    hi = torch.where(v[:, None], xy, -inf).amax(dim=0)
    cell = ((hi - lo) / G).clamp(min=float(min_cell))
    # with no valid point lo/hi are infinite; any finite grid will do then
    ok = torch.isfinite(lo) & torch.isfinite(hi)
    lo = torch.where(ok, lo, torch.zeros_like(lo))
    cell = torch.where(ok, cell, torch.full_like(cell, float(min_cell) if min_cell > 0 else 1.0))
    rc = torch.floor((xy - lo) / cell).clamp(0, G - 1).long()
    pcell = torch.where(v, rc[:, 0] * G + rc[:, 1], torch.full_like(rc[:, 0], n_cells))

    scell, order = torch.sort(pcell, stable=True)
    counts = torch.bincount(scell, minlength=n_cells + 1)
    cell_start = torch.cat([counts.new_zeros(1), torch.cumsum(counts, dim=0)])
    return CellSort(pts[order], v[order], order, scell, cell_start, lo, cell, float(min_cell))
