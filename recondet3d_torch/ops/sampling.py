"""Furthest point sampling (port of ``recondet3d/ops/sampling.py``).

``furthest_point_sample_plain`` is the port of ``furthest_point_sample_xla``
and the plain version of the CUDA kernel (``ops/fps.py``): the CPU path,
and the reference the kernel is checked against on the card. The
dispatcher ``furthest_point_sample`` runs the kernel on CUDA tensors and
the plain version on CPU tensors; ``impl="plain"`` is the one switch.

``furthest_point_sample_with_dist`` (a precomputed distance matrix) is the
port of the JAX package's XLA loop of that name, plain PyTorch on any
device: no kernel replaces it.

Contract: the first index is the first valid point in original order; an
invalid point is never chosen while a valid one remains (min-distance
starts at 1e10 for valid points and -inf for the others, and invalid rows'
coordinates count as zero, so whatever they hold never reaches the
arithmetic); with fewer than K valid points the selection goes on and
still returns K indices; ties go to the lowest position. Index selection
has no gradient.
"""

from __future__ import annotations

from typing import Optional

import torch

from recondet3d_torch.ops.grouping import sq_dist

__all__ = ["furthest_point_sample", "furthest_point_sample_plain", "furthest_point_sample_with_dist"]


def _prepare(points, valid_mask):
    pts = points[:, :3].float()
    N = pts.shape[0]
    valid = (valid_mask.bool() if valid_mask is not None
             else torch.ones(N, dtype=torch.bool, device=pts.device))
    return pts, valid


def _first_valid(valid: torch.Tensor) -> torch.Tensor:
    """Index of the first True (0 when there is none), as a 0-d int64 tensor."""
    return torch.argmax(valid.to(torch.uint8))


@torch.no_grad()
def furthest_point_sample_plain(points: torch.Tensor, num_samples: int,
                                valid_mask: Optional[torch.Tensor] = None,
                                start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K sequential selections in plain PyTorch -> (K,) int64.

    ``start`` (0-d integer tensor) overrides the first selected index, which
    defaults to the first valid point. The squared distance is
    ``grouping.sq_dist``'s, ``(dx*dx + dy*dy) + dz*dz``, each product and sum
    rounded on its own: the CUDA kernel rounds the same way, and
    ``torch.argmax`` returns the first maximum, so both give one sequence.
    """
    pts, valid = _prepare(points, valid_mask)
    pts = torch.where(valid[:, None], pts, torch.zeros_like(pts))
    min_dist = torch.where(valid, torch.full_like(pts[:, 0], 1e10), torch.full_like(pts[:, 0], float("-inf")))
    last = _first_valid(valid) if start is None else start.reshape(()).long()
    idxs = torch.zeros(int(num_samples), dtype=torch.long, device=pts.device)
    idxs[0] = last
    for i in range(1, int(num_samples)):
        min_dist = torch.minimum(min_dist, sq_dist(pts, pts[last]))
        last = torch.argmax(min_dist)
        idxs[i] = last
    return idxs


@torch.no_grad()
def furthest_point_sample(points: torch.Tensor, num_samples: int,
                          valid_mask: Optional[torch.Tensor] = None, impl: str = "auto",
                          presorted=None) -> torch.Tensor:
    """FPS over one point set: points (N, >=3), K static -> (K,) int64
    indices into ``points``.

    impl: 'auto' launches the CUDA kernel on CUDA tensors (and raises if it
    cannot) and runs the plain version on CPU tensors; 'plain' forces the
    plain version. ``presorted``: a ``CellSort`` over (points, valid_mask)
    or a bare ``(spts, sval, sorig)`` tuple with the same meaning; the
    selection then runs over the sorted rows (ties go to the lowest SORTED
    position) and maps back through ``sorig``.
    """
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown FPS impl {impl!r}")
    pts, valid = _prepare(points, valid_mask)
    start = _first_valid(valid)
    sorig = None
    if presorted is not None:
        spts, sval, sorig = (presorted.spts, presorted.sval, presorted.sorig) if hasattr(presorted, "spts") \
            else presorted
        if spts.shape[0] != pts.shape[0]:
            raise ValueError(f"presorted rows {spts.shape[0]} != points rows {pts.shape[0]}")
        pts, valid = _prepare(spts, sval)
        start = torch.argmax((sorig == start).to(torch.uint8))  # the seed's sorted position

    if impl == "plain" or pts.device.type == "cpu":
        idx = furthest_point_sample_plain(pts, num_samples, valid, start=start)
    else:
        from recondet3d_torch.ops.fps import furthest_point_sample_cuda

        idx = furthest_point_sample_cuda(pts.contiguous(), valid.contiguous(),
                                         start.to(torch.int32).reshape(1), num_samples).long()
    return idx if sorig is None else sorig.long()[idx]


@torch.no_grad()
def furthest_point_sample_with_dist(dist_matrix: torch.Tensor, num_samples: int) -> torch.Tensor:
    """FPS given a precomputed (N, N) pairwise distance matrix -> (K,) int64.

    As in the JAX package: the selection starts at index 0 whatever the
    input, with no validity mask; the running minimum starts at 1e10 in the
    matrix's dtype; each step takes the first maximum (``torch.argmax``)."""
    N = dist_matrix.shape[0]
    min_dist = torch.full((N,), 1e10, dtype=dist_matrix.dtype, device=dist_matrix.device)
    idxs = torch.zeros(int(num_samples), dtype=torch.long, device=dist_matrix.device)
    last = torch.zeros((), dtype=torch.long, device=dist_matrix.device)
    for i in range(1, int(num_samples)):
        min_dist = torch.minimum(min_dist, dist_matrix[last])
        last = torch.argmax(min_dist)
        idxs[i] = last
    return idxs
