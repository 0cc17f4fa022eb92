"""Plain attention: softmax(q k^T * scale) v with fp32 logits, taken a block
of query rows at a time so that a 4,326-token global layer fits."""

import torch

__all__ = ["attention"]

_NEG_INF = -1e30
_ROWS = 1024  # query rows a block


def attention(q, k, v, kv_len=None, scale=None):
    """q (B, H, N, D), k / v (B, H, M, D), kv_len (B,) or None -> (B, H, N, D) in q's dtype."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    kf, vf = k.float(), v.float()
    keep = None
    if kv_len is not None:
        col = torch.arange(k.shape[2], device=k.device)
        keep = col[None, None, None, :] < kv_len.to(k.device)[:, None, None, None]
    outs = []
    for s in range(0, q.shape[2], _ROWS):
        logits = torch.einsum("bhnd,bhmd->bhnm", q[:, :, s:s + _ROWS].float(), kf) * scale
        if keep is not None:
            logits = torch.where(keep, logits, torch.full_like(logits, _NEG_INF))
        outs.append(torch.einsum("bhnm,bhmd->bhnd", torch.softmax(logits, dim=-1), vf))
    return torch.cat(outs, dim=2).to(q.dtype)
