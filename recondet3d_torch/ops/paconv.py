"""PAConv score-weighted kernel assembly (port of ``recondet3d/ops/paconv.py``):
one gather and one einsum."""

from __future__ import annotations

import torch

__all__ = ["assign_score_withk"]


def assign_score_withk(
    scores: torch.Tensor,  # (N, K, M) assignment scores (K neighbours, M kernels)
    point_features: torch.Tensor,  # (N, M, C) per-kernel features of each point
    center_features: torch.Tensor,  # (N, M, C)
    knn_idx: torch.Tensor,  # (N, K) neighbour indices
    aggregate: str = "sum",
) -> torch.Tensor:
    """Returns (N, K, C): the score-mixed (neighbour - center) features.
    ``aggregate`` other than 'sum' raises ``ValueError``, as in the JAX package."""
    diff = point_features[knn_idx.long()] - center_features[:, None]  # (N, K, M, C)
    out = torch.einsum("nkm,nkmc->nkc", scores, diff)
    if aggregate == "sum":
        return out
    raise ValueError(aggregate)
