"""Attention: flash-attention forward and backward as hand-written Hopper kernels.

Forward. Replaces the Pallas TPU kernel ``_flash_kernel``
(``recondet3d/ops/attention.py:54``, launched by
``_flash_attention_fwd_impl`` at ``:126``): online-softmax attention over
(B, H, N, D) with QK^T and PV in bf16 and fp32 accumulation, the scores
equal to bf16(q * scale) k^T in fp32, P rounded to bf16 before PV,
emitting O and the per-row logsumexp that the backward pass reads.

Backward. Replaces ``_flash_bwd_dq_kernel`` (``:185``) and
``_flash_bwd_dkv_kernel`` (``:231``), joined to the forward by
``_FlashAttention`` (the counterpart of the ``jax.custom_vjp`` at
``:368-390``): dq = scale * (dS k), dv = P^T dO, dk = scale * (dS^T q) with
P = exp(qs k^T - lse) recomputed tile by tile, dS = P * (dO v^T - delta),
P and dS rounded to bf16 before the second products and the trailing scale
applied in fp32. delta = rowsum(dO * O) in fp32 stays a PyTorch expression,
as the JAX package computes it outside its kernels.

What bounds them on an H100: at the DA3 shapes (D = 64, N = 721 local and
4,326 global) the forward does 4*N*M*D operations per head, the dq kernel
6*N*M*D and the dk/dv kernel 8*N*M*D, over a few (N+M)*D*2 bytes: hundreds
of operations per byte, so the tensor cores bound all three, not memory;
and at D = 64 one ex2 per score on the MUFU (16 a clock per SM) costs about
as much as the products, so the softmax has to run under the products.
None of them lets the (N, M) scores reach device memory, and none uses
atomics, so gradients are the same bits from run to run. The ragged N and M
edges and ``kv_len`` are masked in the kernels; nothing is padded on the host.

The forward and dk/dv kernels (``csrc/flash_attn_fwd.cu``,
``csrc/flash_attn_bwd.cu`` ``flash_bwd_dkv_kernel``, building blocks in
``csrc/hopper_common.cuh``) are Hopper kernels: a producer warpgroup whose
one thread issues TMA copies of 128-byte-swizzled tiles (3-D tensor maps,
built on the host through the driver entry point) into an mbarrier ring in
dynamic shared memory, and consumer warpgroups of 64 rows (queries in the
forward, keys in dk/dv) that run every product on ``wgmma``; ``setmaxnreg``
moves registers from the producer to the consumers. In the forward the
consumers take turns on named barriers so that one's softmax runs under the
other's products. The dq kernel is still the first design: 4 warps on
``mma.sync.m16n8k16`` with ``cp.async`` double buffering (shared blocks in
``csrc/flash_attn_common.cuh``).

The scale: ``score_operand`` hands the kernels raw q and the scale as an
fp32 multiplier of the scores when the scale is a power of two (every call
of the DA3 trunks: D = 64 gives 0.125), which gives bf16(q * scale) k^T
exactly; for any other scale it hands them bf16(q * scale) and 1.

``attention_plain`` (the port of ``attention_xla``, ``:37``, extended to
return lse) and ``attention_bwd_plain`` (explicit formulae with the kernels'
roundings, no autograd) are the kernels' plain versions: the CPU path and
the reference the kernels are checked against on the card.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "score_operand",
    "attention_plain",
    "attention_bwd_plain",
    "flash_attention_fwd",
    "flash_attention_bwd",
    "flash_attention_bwd_dq",
    "flash_attention_bwd_dkv",
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


def score_operand(q, scale: float) -> Tuple[torch.Tensor, float]:
    """(q', mul) such that (q' k^T) * mul, in fp32, equals bf16(q * scale) k^T
    (q's dtype for bf16): for a power-of-two scale raw q and the scale, exact
    because scaling by a power of two commutes with every rounding; for any
    other scale q * scale rounded to q's dtype, and 1."""
    if scale > 0 and math.frexp(scale)[0] == 0.5:
        return q, float(scale)
    return (q.float() * scale).to(q.dtype), 1.0


def attention_bwd_plain(q, k, v, out, lse, dout, kv_len=None, scale=None):
    """Gradients (dq, dk, dv) of ``attention_plain``'s ``out`` from explicit
    formulae, with the roundings of the kernels (no-ops on fp32 inputs): the
    scale goes into q in fp32 and is rounded to the input dtype before
    q k^T; P and dS are rounded to it before the second products; the
    trailing scale of dq and dk is applied in fp32. ``out`` and ``lse`` are
    what the forward returned; a key at index >= kv_len[b] gets p = 0
    whatever ``lse`` is."""
    dt = q.dtype
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    qs = (q.float() * scale).to(dt).float()
    kf, vf, dof = k.float(), v.float(), dout.float()
    x = torch.einsum("bhnd,bhmd->bhnm", qs, kf) - lse[..., None]
    if kv_len is not None:
        col = torch.arange(k.shape[2], device=k.device)
        keep = col[None, None, None, :] < kv_len.to(k.device)[:, None, None, None]
        x = torch.where(keep, x, torch.full_like(x, float("-inf")))
    p = torch.exp(x)
    delta = (dof * out.float()).sum(dim=-1)
    dv = torch.einsum("bhnm,bhnd->bhmd", p.to(dt).float(), dof)
    ds = (p * (torch.einsum("bhnd,bhmd->bhnm", dof, vf) - delta[..., None])).to(dt).float()
    dq = torch.einsum("bhnm,bhmd->bhnd", ds, kf) * scale
    dk = torch.einsum("bhnm,bhnd->bhmd", ds, q.float()) * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)


_ARGTYPES = {
    "flash_attn_fwd_bf16_d64": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p],
    "flash_attn_bwd_dq_bf16_d64": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p],
    "flash_attn_bwd_dkv_bf16_d64": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
    + [ctypes.c_void_p],
}


@functools.lru_cache(maxsize=None)
def _kernel_fn(name: str):
    from recondet3d_torch.ops.build import load_kernels

    library = "flash_attn_fwd" if name == "flash_attn_fwd_bf16_d64" else "flash_attn_bwd"
    fn = getattr(load_kernels()[library], name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _check_kernel_inputs(what: str, q, k, v, kv_len, scale, like_q=(), row_stats=()):
    """The kernels take bf16, D = 64, contiguous 16-byte aligned (B, H, N, D)
    tensors on one CUDA device; anything else raises. ``like_q``: (name,
    tensor) pairs that must match q in shape and dtype; ``row_stats``:
    (name, tensor) pairs that must be fp32 (B, H, N). Returns (B, H, N, M,
    kv_len as int32 or None, scale as float)."""
    if any(t.device != q.device for t in (k, v)) or q.device.type != "cuda":
        raise ValueError(f"{what}: tensors on {q.device}/{k.device}/{v.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{what} kernel takes bf16; {name} is {t.dtype}")
        if t.dim() != 4 or t.shape[-1] != _HEAD_DIM:
            raise ValueError(f"{what} kernel takes (B, H, N, {_HEAD_DIM}); {name} is {tuple(t.shape)}")
    B, H, N, D = q.shape
    M = k.shape[2]
    if k.shape != (B, H, M, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if N == 0 or M == 0 or B * H > 65535:
        raise ValueError(f"{what}: unsupported shape {tuple(q.shape)}")
    more = [(n, t, q.shape, torch.bfloat16) for n, t in like_q] + \
           [(n, t, (B, H, N), torch.float32) for n, t in row_stats]
    for name, t, shape, dtype in more:
        if t.device != q.device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what} kernel takes {name} as {dtype} {tuple(shape)} on {q.device}; "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t in [("q", q), ("k", k), ("v", v)] + [(n, t) for n, t, _, _ in more]:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what} kernel takes contiguous 16-byte aligned tensors; {name} is not")
    if kv_len is not None:
        if kv_len.shape != (B,) or kv_len.device != q.device:
            raise ValueError(f"kv_len must be ({B},) on {q.device}; got {tuple(kv_len.shape)} on {kv_len.device}")
        kv_len = kv_len.to(torch.int32).contiguous()
    return B, H, N, M, kv_len, D ** -0.5 if scale is None else float(scale)


def _launch(wrapper, name: str, tensors, shape, floats, device):
    """Launch kernel ``name`` on PyTorch's current stream with ``tensors``
    (None = a null pointer), (B, H, N, M) and the fp32 arguments ``floats``;
    raises if the launch is refused and adds one to ``wrapper``'s counts."""
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _kernel_fn(name)(*(None if t is None else t.data_ptr() for t in tensors), *shape, *floats, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    wrapper.launches += 1
    wrapper.launches_by_shape[shape] = wrapper.launches_by_shape.get(shape, 0) + 1


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
    B, H, N, M, kv_len, scale = _check_kernel_inputs("flash_attention_fwd", q, k, v, kv_len, scale)
    qk, mul = score_operand(q, scale)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    _launch(flash_attention_fwd, "flash_attn_fwd_bf16_d64", (qk, k, v, kv_len, out, lse), (B, H, N, M), (mul,),
            q.device)
    return out, lse


def _check_bwd_inputs(what, q, k, v, dout, lse, delta, kv_len, scale):
    return _check_kernel_inputs(what, q, k, v, kv_len, scale, like_q=(("dout", dout),),
                                row_stats=(("lse", lse), ("delta", delta)))


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, kv_len=None, scale=None) -> torch.Tensor:
    """dq (B, H, N, D) bf16 from the dq kernel: one CTA per 64 query rows,
    looping over the keys. CUDA tensors only (``flash_attention_bwd`` takes
    CPU tensors to the plain version); ``delta`` (B, H, N) fp32 is
    rowsum(dout * out). Counts its launches like ``flash_attention_fwd``."""
    B, H, N, M, kv_len, scale = _check_bwd_inputs("flash_attention_bwd_dq", q, k, v, dout, lse, delta, kv_len, scale)
    dq = torch.empty_like(q)
    _launch(flash_attention_bwd_dq, "flash_attn_bwd_dq_bf16_d64", (q, k, v, dout, lse, delta, kv_len, dq),
            (B, H, N, M), (scale,), q.device)
    return dq


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, kv_len=None, scale=None):
    """(dk, dv) (B, H, M, D) bf16 from the dk/dv kernel: one CTA per 128 key
    rows (two warpgroups of 64), looping over the queries; keys at index >=
    kv_len[b] get zeros. CUDA tensors only. Counts its launches like
    ``flash_attention_fwd``."""
    B, H, N, M, kv_len, scale = _check_bwd_inputs("flash_attention_bwd_dkv", q, k, v, dout, lse, delta, kv_len, scale)
    qk, mul = score_operand(q, scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(flash_attention_bwd_dkv, "flash_attn_bwd_dkv_bf16_d64", (q, qk, k, v, dout, lse, delta, kv_len, dk, dv),
            (B, H, N, M), (mul, scale), q.device)
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, dout, kv_len=None, scale=None):
    """Flash-attention backward: (dq, dk, dv) in the inputs' dtype from
    ``out`` and ``lse`` as ``flash_attention_fwd`` returned them and the
    gradient ``dout`` of ``out``.

    CPU tensors take ``attention_bwd_plain``. CUDA tensors launch the two
    kernels (bf16, D = 64, contiguous; anything else raises, never the
    plain version)."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, out, lse, dout, kv_len, scale)
    if out.shape != q.shape or out.device != q.device or dout.device != q.device:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)} on {out.device}, dout on {dout.device}, "
                         f"q {tuple(q.shape)} on {q.device}")
    delta = (dout.float() * out.float()).sum(dim=-1)
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, kv_len, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, kv_len, scale)
    return dq, dk, dv


def reset_launch_counts() -> None:
    for wrapper in (flash_attention_fwd, flash_attention_bwd_dq, flash_attention_bwd_dkv):
        wrapper.launches = 0
        wrapper.launches_by_shape = {}


reset_launch_counts()


class _FlashAttention(torch.autograd.Function):
    """Joins the forward and the backward kernels. Everything the backward
    reads (q, k, v, out, lse, kv_len) is saved here, so a forward recomputed
    under activation checkpointing brings its own lse."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, scale):
        out, lse = flash_attention_fwd(q, k, v, kv_len, scale)
        ctx.save_for_backward(q, k, v, out, lse, kv_len)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, kv_len = ctx.saved_tensors
        # the gradient arrives through a transpose of the output: the kernels take it contiguous
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(), kv_len, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, kv_len=None, scale=None, impl: str = "auto") -> torch.Tensor:
    """Attention over (B, H, N, D) tensors (port of the JAX dispatcher),
    differentiable in q, k and v.

    impl: 'auto' runs the kernels on CUDA tensors (forward, and the two
    backward kernels when a gradient flows) and the plain versions on CPU
    tensors; 'plain' forces ``attention_plain`` under autograd (the
    reference runs).
    """
    if impl == "plain":
        return attention_plain(q, k, v, kv_len, scale)[0]
    if impl != "auto":
        raise ValueError(f"unknown attention impl {impl!r}")
    return _FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), kv_len, scale)


def multi_head_attention(x, qkv_w, qkv_b, proj_w, proj_b, num_heads, **kwargs):
    """Fused qkv projection + attention + output projection for (B, N, C)
    tokens. Weights in the torch (out, in) layout."""
    B, N, C = x.shape
    qkv = F.linear(x, qkv_w, qkv_b).reshape(B, N, 3, num_heads, C // num_heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    o = flash_attention(q, k, v, **kwargs)
    return F.linear(o.transpose(1, 2).reshape(B, N, C), proj_w, proj_b)
