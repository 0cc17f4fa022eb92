"""Attention: the flash-attention forward as a hand-written Hopper kernel.

Replaces the Pallas TPU kernel ``_flash_kernel``
(``recondet3d/ops/attention.py:54``, launched by
``_flash_attention_fwd_impl`` at ``:126``): online-softmax attention over
(B, H, N, D) with QK^T and PV in bf16 and fp32 accumulation, the scale
folded into q in fp32 and rounded to bf16, P rounded to bf16 before PV,
emitting O and the per-row logsumexp that a backward pass needs.

What bounds it on an H100: at the DA3 shapes (D = 64, N = 721 local and
4,326 global) it does 4·N·M·D operations per head over 2·(N+M)·D·2 bytes,
hundreds of operations per byte, so the tensor cores bound it, not memory.
The design (``csrc/flash_attn_fwd.cu``) keeps the (N, M) scores out of
device memory entirely: one CTA of 4 warps owns 64 query rows held in
registers, streams 64-key K/V tiles through double-buffered shared memory
with ``cp.async``, runs both products on ``mma.sync.m16n8k16`` (bf16 in,
fp32 accumulate) and keeps the softmax statistics in fp32 registers. The
ragged N and M edges are masked in the kernel; nothing is padded on the
host. ``wgmma``/TMA/warp specialisation are left for a later change.

``attention_plain`` (the port of ``attention_xla``, ``:37``, extended to
return lse) is the kernel's plain version: the CPU path and the reference
the kernel is checked against on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "attention_plain",
    "flash_attention_fwd",
    "reset_launch_counts",
    "flash_attention",
    "multi_head_attention",
]

_NEG_INF = -1e30
_HEAD_DIM = 64


def attention_plain(q, k, v, kv_len=None, scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(q k^T * scale) v with fp32 logits; keys at index >= kv_len[b]
    get a -1e30 logit. q (B, H, N, D), k/v (B, H, M, D), kv_len (B,) int.
    Returns (out in q's dtype, lse (B, H, N) fp32)."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    logits = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * scale
    if kv_len is not None:
        col = torch.arange(k.shape[2], device=k.device)
        keep = col[None, None, None, :] < kv_len.to(k.device)[:, None, None, None]
        logits = torch.where(keep, logits, torch.full_like(logits, _NEG_INF))
    lse = torch.logsumexp(logits, dim=-1)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhnm,bhmd->bhnd", weights, v.float()).to(q.dtype)
    return out, lse


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    from recondet3d_torch.ops.build import load_kernels

    fn = load_kernels()["flash_attn_fwd"].flash_attn_fwd_bf16_d64
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_fwd(q, k, v, kv_len=None, scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward: (out (B, H, N, D), lse (B, H, N) fp32).

    CPU tensors take the plain version. CUDA tensors launch the kernel,
    which takes bf16, D = 64 and contiguous (B, H, N, D) inputs; anything
    else raises. ``kv_len`` (B,) masks keys at index >= kv_len[b] and must
    be >= 1. Each kernel launch adds one to ``flash_attention_fwd.launches``
    and to ``flash_attention_fwd.launches_by_shape[(B, H, N, M)]``; call
    ``reset_launch_counts()`` to set both to zero.
    """
    if q.device.type == "cpu":
        return attention_plain(q, k, v, kv_len, scale)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention_fwd: tensors on {q.device}/{k.device}/{v.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention_fwd kernel takes bf16; {name} is {t.dtype}")
        if t.dim() != 4 or t.shape[-1] != _HEAD_DIM:
            raise ValueError(f"flash_attention_fwd kernel takes (B, H, N, {_HEAD_DIM}); {name} is {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_fwd kernel takes contiguous 16-byte aligned tensors; {name} is not")
    B, H, N, D = q.shape
    M = k.shape[2]
    if k.shape != (B, H, M, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if N == 0 or M == 0 or B * H > 65535:
        raise ValueError(f"flash_attention_fwd: unsupported shape {tuple(q.shape)}")
    if kv_len is not None:
        if kv_len.shape != (B,) or kv_len.device != q.device:
            raise ValueError(f"kv_len must be ({B},) on {q.device}; got {tuple(kv_len.shape)} on {kv_len.device}")
        kv_len = kv_len.to(torch.int32).contiguous()
    scale = D ** -0.5 if scale is None else float(scale)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _kernel_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_len is None else kv_len.data_ptr(),
            out.data_ptr(), lse.data_ptr(), B, H, N, M, scale, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: cudaError {err}")
    flash_attention_fwd.launches += 1
    by_shape = flash_attention_fwd.launches_by_shape
    by_shape[(B, H, N, M)] = by_shape.get((B, H, N, M), 0) + 1
    return out, lse


def reset_launch_counts() -> None:
    flash_attention_fwd.launches = 0
    flash_attention_fwd.launches_by_shape = {}


reset_launch_counts()


def flash_attention(q, k, v, kv_len=None, scale=None, impl: str = "auto") -> torch.Tensor:
    """Attention over (B, H, N, D) tensors (port of the JAX dispatcher).

    impl: 'auto' runs the kernel on CUDA tensors and the plain version on
    CPU tensors; 'plain' forces the plain version (the reference runs).
    """
    if impl == "plain":
        return attention_plain(q, k, v, kv_len, scale)[0]
    if impl != "auto":
        raise ValueError(f"unknown attention impl {impl!r}")
    return flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(), kv_len, scale)[0]


def multi_head_attention(x, qkv_w, qkv_b, proj_w, proj_b, num_heads, **kwargs):
    """Fused qkv projection + attention + output projection for (B, N, C)
    tokens. Weights in the torch (out, in) layout."""
    B, N, C = x.shape
    qkv = F.linear(x, qkv_w, qkv_b).reshape(B, N, 3, num_heads, C // num_heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    o = flash_attention(q, k, v, **kwargs)
    return F.linear(o.transpose(1, 2).reshape(B, N, C), proj_w, proj_b)
