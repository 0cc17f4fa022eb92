"""Furthest point sampling (port of ``recondet3d/ops/sampling.py``).

``furthest_point_sample_plain`` is the port of ``furthest_point_sample_xla``
and the plain version of the CUDA kernel (``ops/fps.py``): the CPU path,
and the reference the kernel is checked against on the card. The
dispatcher ``furthest_point_sample`` runs the kernel on CUDA tensors and
the plain version on CPU tensors; ``impl="plain"`` is the one switch.

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

from benchmark.reference.grouping import sq_dist

__all__ = ["furthest_point_sample", "furthest_point_sample_plain"]


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
    if pts.device.type == "cuda" and num_samples > 2 * _GRAPH_STEPS:
        return _fps_graphed(pts, min_dist, last, idxs)
    for i in range(1, int(num_samples)):
        min_dist = torch.minimum(min_dist, sq_dist(pts, pts[last]))
        last = torch.argmax(min_dist)
        idxs[i] = last
    return idxs


_GRAPH_STEPS = 256  # selections one CUDA graph replays
# (rows, valid rows, selections) of every call while a list (the benchmark's count of FPS work)
CALLS = None


def _fps_graphed(pts, min_dist, last, idxs):
    """The loop above, ``_GRAPH_STEPS`` selections a replay of one CUDA
    graph: the same operations on the same values, without a host launch a
    selection."""
    K = idxs.shape[0]
    md, cur = min_dist.clone(), last.clone()
    blk = torch.zeros(_GRAPH_STEPS, dtype=torch.long, device=pts.device)

    def steps():
        m, c = md, cur
        for j in range(_GRAPH_STEPS):
            # index_select: a 0-d index tensor in pts[c] would be read on the host, which a capture forbids
            m = torch.minimum(m, sq_dist(pts, torch.index_select(pts, 0, c.reshape(1))[0]))
            c = torch.argmax(m)
            blk[j:j + 1].copy_(c.reshape(1))
        md.copy_(m)
        cur.copy_(c)

    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    md0, cur0 = md.clone(), cur.clone()
    with torch.cuda.stream(side):
        steps()  # warm-up outside the capture, as CUDA graphs need
    torch.cuda.current_stream().wait_stream(side)
    md.copy_(md0)
    cur.copy_(cur0)
    with torch.cuda.graph(graph):
        steps()
    i = 1
    while K - i >= _GRAPH_STEPS:
        graph.replay()
        idxs[i:i + _GRAPH_STEPS].copy_(blk)
        i += _GRAPH_STEPS
    m, c = md, cur
    for j in range(i, K):
        m = torch.minimum(m, sq_dist(pts, pts[c]))
        c = torch.argmax(m)
        idxs[j] = c
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
    if CALLS is not None:
        CALLS.append((pts.shape[0], int(valid.sum()), int(num_samples)))
    start = _first_valid(valid)
    sorig = None
    if presorted is not None:
        spts, sval, sorig = (presorted.spts, presorted.sval, presorted.sorig) if hasattr(presorted, "spts") \
            else presorted
        if spts.shape[0] != pts.shape[0]:
            raise ValueError(f"presorted rows {spts.shape[0]} != points rows {pts.shape[0]}")
        pts, valid = _prepare(spts, sval)
        start = torch.argmax((sorig == start).to(torch.uint8))  # the seed's sorted position

    idx = furthest_point_sample_plain(pts, num_samples, valid, start=start)
    return idx if sorig is None else sorig.long()[idx]
