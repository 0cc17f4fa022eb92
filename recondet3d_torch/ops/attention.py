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
edges and ``kv_len`` are masked in the kernels.

The three kernels (``csrc/flash_attn_fwd.cu``, ``csrc/flash_attn_bwd.cu``,
building blocks in ``csrc/hopper_common.cuh``) are Hopper kernels: a
producer warpgroup whose one thread issues TMA copies of 128-byte-swizzled
tiles (3-D tensor maps, built on the host through the driver entry point)
into an mbarrier ring in dynamic shared memory, and consumer warpgroups of
64 rows (queries in the forward and dq, keys in dk/dv) that run every
product on ``wgmma``; ``setmaxnreg``
moves registers from the producer to the consumers. In the forward the
consumers take turns on named barriers so that one's softmax runs under the
other's products. The dq kernel (``csrc/flash_attn_bwd.cu``
``flash_bwd_dq_kernel``) has the forward's shape: a producer streams K and V
tiles by TMA, and consumer warpgroups of 64 query rows run S and dP on
``wgmma`` from shared memory and dQ += dS K with dS from registers, taking
turns on named barriers. All three are templates on the number of 64-column
chunks of the head dim (DC = ceil(D / 64), D up to 256): each chunk is its
own swizzled tile, the score products sum over the chunks and the output
keeps one 64 x 64 accumulator a chunk. Past D = 64 (the forward past 128)
the accumulators leave room for one consumer warpgroup a CTA; dk/dv past
D = 128, whose dK and dV accumulators take 64 registers a thread a chunk,
splits the chunks between two CTAs that each recompute the scores.

Head dims that are not a multiple of 8. A TMA row stride is a multiple of
16 bytes, so the wrappers pad q, k, v (and dO) with zero columns to the
next multiple of 8 (``tma_cols``), pass the scale of the original D
(D^-0.5 by default), and slice the outputs: zero columns add nothing to
q . k and give zero output columns, so this is exact. The pad and the
slice are part of the wrapper's call and of its time.

The scale: ``score_operand`` hands the kernels raw q and the scale as an
fp32 multiplier of the scores when the scale is a power of two (every call
of the DA3 trunks: D = 64 gives 0.125), which gives bf16(q * scale) k^T
exactly; for any other scale it hands them bf16(q * scale) and 1.

``attention_plain`` (the port of ``attention_xla``, ``:37``, extended to
return lse) and ``attention_bwd_plain`` (explicit formulae with the kernels'
roundings, no autograd) are the kernels' plain versions: the CPU path and
the reference the kernels are checked against on the card.

fp32. The JAX package runs ``_flash_kernel`` and its backward in fp32 for
the camera encoder's trunk (GT-pose conditioning: 16 heads of dim_out / 16,
D = 24 to 96, one token a view). ``csrc/attn_cuda_core.cu`` holds two
CUDA-core designs (fp32 products, no TF32) for any D from 1 to 256:
- short sequences (N and M up to 32, every ``CameraEnc`` up to the CLI's 32
  views; fp32): ``attention_fwd_short``, the forward in one pass, and
  ``attention_bwd_short``, dq, dk and dv with delta = rowsum(dO * O) in one
  launch. They read q, k, v, O and dO through any B, H and row strides
  (the qkv split's views are not copied) and the forward writes its output
  as (B, N, H, D), returned as the (B, H, N, D) view whose
  ``transpose(1, 2).reshape(B, N, C)`` is a view again;
- any length: a tiled forward, dq and dk/dv kernel, templated on the
  element type (fp32, bf16), with the roundings of the plain versions (for
  bf16 inputs qs, P and dS rounded to bf16 before the second products).

Which kernel a CUDA call runs is decided for each of the three kernels by
dtype, head dim and sequence lengths alone (``kernel_variant``): bf16 at any
D from 1 to 256 on the wgmma kernels; fp32 on the short kernels where N and
M are at most 32, else on the tiled CUDA-core ones; anything else (fp16,
fp64, D > 256; no config of either package builds them) raises. This is
routing by shape, not a fallback: a call never reaches a kernel its route
does not name, and no call on a CUDA tensor reaches a plain version. The
bf16 instances of the tiled CUDA-core family, and its fp32 ones at short
lengths, are routed no more; they stay callable through their wrappers
(``attention_fwd_cuda_core``, ``attention_bwd_dq_cuda_core``,
``attention_bwd_dkv_cuda_core``) for the comparisons on the card. Every
kernel folds B*H into grid.x, so B*H has no limit of its own.
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "score_operand",
    "attention_plain",
    "attention_bwd_plain",
    "flash_attention_fwd",
    "attention_fwd",
    "attention_fwd_cuda_core",
    "attention_bwd_dq_cuda_core",
    "attention_bwd_dkv_cuda_core",
    "attention_fwd_short",
    "attention_bwd_short",
    "kernel_variant",
    "tma_cols",
    "flash_attention_bwd",
    "flash_attention_bwd_dq",
    "flash_attention_bwd_dkv",
    "reset_launch_counts",
    "flash_attention",
    "multi_head_attention",
]

_NEG_INF = -1e30
MAX_HEAD_DIM = 256  # the limit of every kernel (the JAX kernels take any D; no preset goes past 96)
SHORT_MAX_ROWS = 32  # the most query or key rows the short fp32 kernels take: one warp a query, one lane a key
KERNELS = ("fwd", "dq", "dkv")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_TMA_COL_MULTIPLE = 8  # a TMA row stride is a multiple of 16 bytes: 8 bf16


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


def attention_bwd_plain(q, k, v, out, lse, dout, kv_len=None, scale=None, out_dtype=None):
    """Gradients (dq, dk, dv) of ``attention_plain``'s ``out`` from explicit
    formulae, with the roundings of the kernels (no-ops on fp32 inputs): the
    scale goes into q in fp32 and is rounded to the input dtype before
    q k^T; P and dS are rounded to it before the second products; the
    trailing scale of dq and dk is applied in fp32. ``out`` and ``lse`` are
    what the forward returned; a key at index >= kv_len[b] gets p = 0
    whatever ``lse`` is. The gradients come in the input dtype, or in
    ``out_dtype`` (fp32: the sums before their last rounding, a reference
    that a kernel's own rounding is held to)."""
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
    od = dt if out_dtype is None else out_dtype
    return dq.to(od), dk.to(od), dv.to(od)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "flash_attn_fwd_bf16": [_P] * 6 + [_I] * 5 + [_F, _P],
    "flash_attn_bwd_dq_bf16": [_P] * 8 + [_I] * 5 + [_F] * 2 + [_P],
    "flash_attn_bwd_dkv_bf16": [_P] * 10 + [_I] * 5 + [_F] * 2 + [_P],
    "attn_cc_fwd": [_P] * 6 + [_I] * 6 + [_F, _P],
    "attn_cc_bwd_dq": [_P] * 8 + [_I] * 6 + [_F] * 2 + [_P],
    "attn_cc_bwd_dkv": [_P] * 10 + [_I] * 6 + [_F] * 2 + [_P],
    "attn_cc_short_fwd": [ctypes.c_char_p],
    "attn_cc_short_bwd": [ctypes.c_char_p],
}
# the short kernels' one packed argument (csrc/attn_cuda_core.cu ShortFwdArgs, ShortBwdArgs): the data pointers and
# the stream, B, H, N, M, D, the B, H and row strides of each strided view, the scale(s). A ctypes call's host time
# grows with its arguments, and these calls are launch-bound
_SHORT_FWD_ARGS = struct.Struct("<7Q14qd")
_SHORT_BWD_ARGS = struct.Struct("<11Q20q2d")
_LIBRARY = {"flash_attn_fwd_bf16": "flash_attn_fwd", "flash_attn_bwd_dq_bf16": "flash_attn_bwd",
            "flash_attn_bwd_dkv_bf16": "flash_attn_bwd", "attn_cc_fwd": "attn_cuda_core",
            "attn_cc_bwd_dq": "attn_cuda_core", "attn_cc_bwd_dkv": "attn_cuda_core",
            "attn_cc_short_fwd": "attn_cuda_core", "attn_cc_short_bwd": "attn_cuda_core"}


@functools.lru_cache(maxsize=None)
def _kernel_fn(name: str):
    from recondet3d_torch.ops.build import load_kernels

    fn = getattr(load_kernels()[_LIBRARY[name]], name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _check_kernel_inputs(what: str, dtypes, max_d: int, q, k, v, kv_len, scale, like_q=(), row_stats=(), align=1):
    """Takes contiguous (B, H, N, D) tensors of one of ``dtypes`` with D
    from 1 to ``max_d``, ``align``-byte aligned, all on
    one CUDA device; anything else raises. ``like_q``: (name, tensor) pairs
    that must match q in shape and dtype; ``row_stats``: (name, tensor) pairs
    that must be fp32 (B, H, N). Returns (B, H, N, M, D, kv_len as int32 or
    None, scale as float)."""
    if any(t.device != q.device for t in (k, v)) or q.device.type != "cuda":
        raise ValueError(f"{what}: tensors on {q.device}/{k.device}/{v.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4 or t.dtype != q.dtype:
            raise ValueError(f"{what} takes (B, H, N, D) tensors of one dtype; {name} is {t.dtype} {tuple(t.shape)}")
    d = q.shape[-1]
    if q.dtype not in dtypes or not 1 <= d <= max_d:
        raise ValueError(f"{what} kernel takes {' or '.join(str(t) for t in dtypes)} with D from 1 to {max_d}; q is "
                         f"{q.dtype} {tuple(q.shape)}")
    B, H, N, D = q.shape
    M = k.shape[2]
    if k.shape != (B, H, M, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if N == 0 or M == 0 or B * H == 0:
        raise ValueError(f"{what}: empty shape {tuple(q.shape)}")
    more = [(n, t, q.shape, q.dtype) for n, t in like_q] + \
           [(n, t, (B, H, N), torch.float32) for n, t in row_stats]
    for name, t, shape, dtype in more:
        if t.device != q.device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what} kernel takes {name} as {dtype} {tuple(shape)} on {q.device}; "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t in [("q", q), ("k", k), ("v", v)] + [(n, t) for n, t, _, _ in more]:
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"{what} kernel takes contiguous {align}-byte aligned tensors; {name} is not")
    if kv_len is not None:
        if kv_len.shape != (B,) or kv_len.device != q.device:
            raise ValueError(f"kv_len must be ({B},) on {q.device}; got {tuple(kv_len.shape)} on {kv_len.device}")
        kv_len = kv_len.to(torch.int32).contiguous()
    return B, H, N, M, D, kv_len, D ** -0.5 if scale is None else float(scale)


def tma_cols(head_dim: int) -> int:
    """The head dim the wgmma kernels are launched at: ``head_dim`` rounded
    up to a multiple of 8 (a TMA row stride is a multiple of 16 bytes)."""
    return -(-head_dim // _TMA_COL_MULTIPLE) * _TMA_COL_MULTIPLE


def _pad_cols(t, cols: int):
    """``t`` with zero columns appended up to ``cols`` (``t`` itself when it
    has that many)."""
    return t if t.shape[-1] == cols else F.pad(t, (0, cols - t.shape[-1]))


def _cut_cols(t, cols: int):
    """The first ``cols`` columns of ``t``, contiguous."""
    return t if t.shape[-1] == cols else t[..., :cols].contiguous()


@functools.lru_cache(maxsize=None)
def _cuda_hooks():
    """(current device index, raw current stream of a device index):
    PyTorch's own C entry points, looked up once (the public
    ``torch.cuda.current_stream`` builds a Stream object a call)."""
    return torch._C._cuda_getDevice, torch._C._cuda_getCurrentRawStream


_COUNT_LOCK = threading.Lock()


def _launch(wrapper, name: str, tensors, ints, floats, device, key, packed: Optional[struct.Struct] = None):
    """Launch kernel ``name`` on PyTorch's current stream with ``tensors``
    (None = a null pointer), the int arguments ``ints`` and the fp32
    arguments ``floats`` (with ``packed``: the pointers, the stream, the
    ints and the floats in that layout, handed over as one argument);
    raises if the launch is refused and adds one to ``wrapper.launches`` and
    to ``wrapper.launches_by_shape[key]``. The device is made current for
    the launch only where it is not already."""
    fn = _kernel_fn(name)
    current, raw_stream = _cuda_hooks()
    ptrs = [0 if t is None else t.data_ptr() for t in tensors]
    stream = raw_stream(device.index)
    args = (packed.pack(*ptrs, stream, *ints, *floats),) if packed else (*ptrs, *ints, *floats, stream)
    if current() == device.index:
        err = fn(*args)
    else:
        with torch.cuda.device(device):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    with _COUNT_LOCK:  # threads that launch at once (a server's) lose no count
        wrapper.launches += 1
        wrapper.launches_by_shape[key] = wrapper.launches_by_shape.get(key, 0) + 1


def kernel_variant(dtype: torch.dtype, head_dim: int, kernel: str, n: Optional[int] = None,
                   m: Optional[int] = None) -> str:
    """The kernel that takes CUDA inputs of this dtype, head dim and, where
    given, query and key counts ``n`` and ``m`` for ``kernel`` ('fwd', 'dq'
    or 'dkv'): 'wgmma' for bf16 at any D from 1 to 256
    (``csrc/flash_attn_fwd.cu``, ``flash_attn_bwd.cu``); for fp32 at any D
    from 1 to 256 (the camera encoder's trunk is fp32) 'short' where n and m
    are at most 32 (``attn_cuda_core.cu``'s one-pass forward and fused
    backward) and 'cuda_core' otherwise, or where they are not given (the
    tiled kernels, which take any length). Raises ValueError for anything
    else (fp16, fp64, D > 256)."""
    if kernel not in KERNELS:
        raise ValueError(f"unknown attention kernel {kernel!r}: one of {KERNELS}")
    if dtype not in _DTYPE_CODE or not 1 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"no attention kernel takes {dtype} with head dim {head_dim}: fp32 and bf16 take D from 1 "
                         f"to {MAX_HEAD_DIM}")
    if dtype != torch.float32:
        return "wgmma"
    short = n is not None and m is not None and 1 <= n <= SHORT_MAX_ROWS and 1 <= m <= SHORT_MAX_ROWS
    return "short" if short else "cuda_core"


def _route(q, k, kernel: str) -> str:
    """``kernel_variant`` of (B, H, N, D) queries over (B, H, M, D) keys."""
    return kernel_variant(q.dtype, q.shape[-1], kernel, q.shape[-2], k.shape[-2])


def flash_attention_fwd(q, k, v, kv_len=None, scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward on the wgmma kernel: (out (B, H, N, D), lse
    (B, H, N) fp32).

    CPU tensors take the plain version. CUDA tensors launch the kernel,
    which takes bf16 contiguous 16-byte aligned (B, H, N, D) inputs with D
    from 1 to 256 (padded to ``tma_cols(D)`` columns here when D is no
    multiple of 8); anything else raises. ``kv_len`` (B,) masks keys at
    index >= kv_len[b] and must be >= 1. Each kernel launch adds one to
    ``flash_attention_fwd.launches`` and to
    ``flash_attention_fwd.launches_by_shape[(B, H, N, M, D)]``; call
    ``reset_launch_counts()`` to set both to zero.
    """
    if q.device.type == "cpu":
        return attention_plain(q, k, v, kv_len, scale)
    B, H, N, M, D, kv_len, scale = _check_kernel_inputs("flash_attention_fwd", (torch.bfloat16,), MAX_HEAD_DIM,
                                                        q, k, v, kv_len, scale, align=16)
    qk, mul = score_operand(q, scale)
    cols = tma_cols(D)
    qk, k, v = (_pad_cols(t, cols) for t in (qk, k, v))
    out = torch.empty((B, H, N, cols), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    _launch(flash_attention_fwd, "flash_attn_fwd_bf16", (qk, k, v, kv_len, out, lse), (B, H, N, M, cols), (mul,),
            q.device, (B, H, N, M, D))
    return _cut_cols(out, D), lse


def _cc_score_operand(q, scale: float) -> Tuple[torch.Tensor, float]:
    """``score_operand`` for the CUDA-core kernels: on fp32 inputs raw q and
    the scale, which the kernels apply to q . k in fp32 (the rounding of q *
    scale to the input type is no rounding for fp32: the two orders differ
    by fp32 rounding alone), so no scale takes a pass over q there."""
    return (q, float(scale)) if q.dtype == torch.float32 else score_operand(q, scale)


def attention_fwd_cuda_core(q, k, v, kv_len=None, scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward on the CUDA cores: (out (B, H, N, D) in q's dtype,
    lse (B, H, N) fp32), what ``attention_plain`` computes, with the scores
    bf16(q * scale) k^T and P rounded to bf16 before P V for bf16 inputs.

    CPU tensors take the plain version. CUDA tensors launch
    ``csrc/attn_cuda_core.cu``, which takes contiguous fp32 or bf16 (B, H,
    N, D) inputs with D up to 256; anything else raises. Each launch adds
    one to ``attention_fwd_cuda_core.launches`` and to
    ``attention_fwd_cuda_core.launches_by_shape[(B, H, N, M, D)]``.
    """
    if q.device.type == "cpu":
        return attention_plain(q, k, v, kv_len, scale)
    B, H, N, M, D, kv_len, scale = _check_kernel_inputs("attention_fwd_cuda_core", tuple(_DTYPE_CODE), MAX_HEAD_DIM,
                                                        q, k, v, kv_len, scale)
    qk, mul = _cc_score_operand(q, scale)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    _launch(attention_fwd_cuda_core, "attn_cc_fwd", (qk, k, v, kv_len, out, lse),
            (_DTYPE_CODE[q.dtype], B, H, N, M, D), (mul,), q.device, (B, H, N, M, D))
    return out, lse


def _check_short(what: str, q, k, v, kv_len, rows_like_q=(), lse=None):
    """Takes fp32 (B, H, N, D) q and (B, H, M, D) k and v with N and M from 1
    to 32 and D from 1 to 256, each with a unit stride along D and any other
    strides, ``rows_like_q`` tensors of q's shape and dtype with a unit
    stride along D (the forward's out and its gradient) and ``lse``, if
    given, as contiguous fp32 (B, H, N), all on one CUDA device; anything
    else raises (the device last, so that a tensor without storage meets
    every other check). Returns (B, H, N, M, D, kv_len as int32 or None,
    the B, H and row strides of q, k, v and of each of ``rows_like_q``)."""
    f32 = torch.float32
    if q.dtype != f32 or k.dtype != f32 or v.dtype != f32 or q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{what} kernel takes fp32 (B, H, N, D) tensors; q {q.dtype} {tuple(q.shape)}, k {k.dtype} "
                         f"{tuple(k.shape)}, v {v.dtype}")
    B, H, N, D = shape = q.shape
    M = k.shape[2]
    if k.shape != (B, H, M, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if not (0 < D <= MAX_HEAD_DIM and 0 < N <= SHORT_MAX_ROWS and 0 < M <= SHORT_MAX_ROWS and B * H):
        raise ValueError(f"{what} kernel takes N and M from 1 to {SHORT_MAX_ROWS}, D from 1 to {MAX_HEAD_DIM}; q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    for t in rows_like_q:
        if t.dtype != f32 or t.shape != shape:
            raise ValueError(f"{what} kernel takes out and dout as q's {q.dtype} {tuple(q.shape)}; got {t.dtype} "
                             f"{tuple(t.shape)}")
    strides = [t.stride() for t in (q, k, v, *rows_like_q)]
    if any(st[3] != 1 for st in strides):
        raise ValueError(f"{what} kernel takes views with a unit stride along D")
    if lse is not None and (lse.dtype != f32 or lse.shape != (B, H, N) or not lse.is_contiguous()):
        raise ValueError(f"{what} kernel takes lse as contiguous fp32 ({B}, {H}, {N}); got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    dev = q.device
    if kv_len is not None and (kv_len.shape != (B,) or kv_len.device != dev):
        raise ValueError(f"kv_len must be ({B},) on {dev}; got {tuple(kv_len.shape)} on {kv_len.device}")
    if dev.type != "cuda" or any(t.device != dev for t in (k, v, *rows_like_q, *([] if lse is None else [lse]))):
        raise ValueError(f"{what}: tensors on {q.device}/{k.device}/{v.device}, not on one CUDA device")
    kv_len = None if kv_len is None else kv_len.to(torch.int32).contiguous()
    return B, H, N, M, D, kv_len, [x for st in strides for x in st[:3]]


def _bnhd(B: int, H: int, N: int, D: int, device=None) -> torch.Tensor:
    """An fp32 (B, H, N, D) tensor laid out as a contiguous (B, N, H, D) one:
    its ``transpose(1, 2).reshape(B, N, H * D)`` is a view."""
    return torch.empty_strided((B, H, N, D), (N * H * D, D, H * D, 1), dtype=torch.float32, device=device)


def attention_fwd_short(q, k, v, kv_len=None, scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward for short fp32 sequences (N, M <= 32) in one launch:
    (out (B, H, N, D), lse (B, H, N) fp32), what ``attention_plain``
    computes. ``out`` is the ``transpose(1, 2)`` of a contiguous (B, N, H,
    D) tensor, the layout an output projection over (B, N, H * D) reads.

    q, k and v may be any views with a unit stride along D (the qkv split's).
    CPU tensors take the plain version, laid out the same way. CUDA tensors
    launch ``cc_short_fwd_kernel`` (``csrc/attn_cuda_core.cu``); anything it
    does not take raises. Each launch adds one to
    ``attention_fwd_short.launches`` and to
    ``attention_fwd_short.launches_by_shape[(B, H, N, M, D)]``."""
    if q.device.type == "cpu":
        o, lse = attention_plain(q, k, v, kv_len, scale)
        out = _bnhd(*o.shape)
        out.copy_(o)
        return out, lse
    B, H, N, M, D, kv_len, strides = _check_short("attention_fwd_short", q, k, v, kv_len)
    out = _bnhd(B, H, N, D, q.device)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    _launch(attention_fwd_short, "attn_cc_short_fwd", (q, k, v, kv_len, out, lse), (B, H, N, M, D, *strides),
            (D ** -0.5 if scale is None else scale,), q.device, (B, H, N, M, D), packed=_SHORT_FWD_ARGS)
    return out, lse


def attention_bwd_short(q, k, v, out, lse, dout, kv_len=None, scale=None):
    """dq, dk and dv of ``attention_fwd_short``'s ``out`` for short fp32
    sequences in one launch: ``cc_short_bwd_kernel`` forms delta =
    rowsum(dout * out), P and dS of each head in shared memory and sums
    every gradient row in a fixed order (the same bits run to run). q, k, v,
    out and dout may be any views with a unit stride along D; dq (B, H, N,
    D), dk and dv (B, H, M, D) come contiguous. CPU tensors take
    ``attention_bwd_plain``; CUDA tensors launch the kernel or raise.
    Launches counted under (B, H, N, M, D)."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, out, lse, dout, kv_len, scale)
    B, H, N, M, D, kv_len, strides = _check_short("attention_bwd_short", q, k, v, kv_len, rows_like_q=(out, dout),
                                                  lse=lse)
    scale = D ** -0.5 if scale is None else scale
    dq = torch.empty((B, H, N, D), dtype=torch.float32, device=q.device)
    dk, dv = (torch.empty((B, H, M, D), dtype=torch.float32, device=q.device) for _ in range(2))
    _launch(attention_bwd_short, "attn_cc_short_bwd", (q, k, v, out, dout, lse, kv_len, dq, dk, dv),
            (B, H, N, M, D, *strides), (scale, scale), q.device, (B, H, N, M, D), packed=_SHORT_BWD_ARGS)
    return dq, dk, dv


def attention_fwd(q, k, v, kv_len=None, scale=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): the plain version on CPU tensors; on CUDA tensors the
    kernel ``kernel_variant`` names for the dtype, head dim and lengths
    (raises for what none takes)."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, kv_len, scale)
    route = _route(q, k, "fwd")
    fwd = flash_attention_fwd if route == "wgmma" else attention_fwd_short if route == "short" else \
        attention_fwd_cuda_core
    return fwd(q, k, v, kv_len, scale)


def _check_bwd_inputs(what, dtypes, max_d, q, k, v, dout, lse, delta, kv_len, scale, **kw):
    return _check_kernel_inputs(what, dtypes, max_d, q, k, v, kv_len, scale, like_q=(("dout", dout),),
                                row_stats=(("lse", lse), ("delta", delta)), **kw)


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, kv_len=None, scale=None) -> torch.Tensor:
    """dq (B, H, N, D) bf16 from the wgmma dq kernel: one CTA per 128
    query rows (two warpgroups of 64) at D <= 64, per 64 past it, looping
    over the keys. CUDA tensors only (``flash_attention_bwd`` takes CPU
    tensors to the plain version), bf16 with D from 1 to 256 (padded to
    ``tma_cols(D)`` columns here when D is no multiple of 8); ``delta`` (B,
    H, N) fp32 is rowsum(dout * out). Counts its launches like
    ``flash_attention_fwd``."""
    B, H, N, M, D, kv_len, scale = _check_bwd_inputs("flash_attention_bwd_dq", (torch.bfloat16,), MAX_HEAD_DIM, q,
                                                     k, v, dout, lse, delta, kv_len, scale, align=16)
    qk, mul = score_operand(q, scale)
    cols = tma_cols(D)
    qk, k, v, dout = (_pad_cols(t, cols) for t in (qk, k, v, dout))
    dq = torch.empty((B, H, N, cols), dtype=q.dtype, device=q.device)
    _launch(flash_attention_bwd_dq, "flash_attn_bwd_dq_bf16", (qk, k, v, dout, lse, delta, kv_len, dq),
            (B, H, N, M, cols), (mul, scale), q.device, (B, H, N, M, D))
    return _cut_cols(dq, D)


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, kv_len=None, scale=None):
    """(dk, dv) (B, H, M, D) bf16 from the wgmma dk/dv kernel: one CTA per
    128 key rows (two warpgroups of 64) at D <= 64, per 64 past it (and per
    half of the columns past D = 128), looping over the queries; keys at
    index >= kv_len[b] get zeros. CUDA tensors only, bf16 with D from 1 to
    256 (padded to ``tma_cols(D)`` columns here when D is no multiple of 8).
    Counts its launches like ``flash_attention_fwd``."""
    B, H, N, M, D, kv_len, scale = _check_bwd_inputs("flash_attention_bwd_dkv", (torch.bfloat16,), MAX_HEAD_DIM, q,
                                                     k, v, dout, lse, delta, kv_len, scale, align=16)
    qk, mul = score_operand(q, scale)
    cols = tma_cols(D)
    qp = _pad_cols(q, cols)
    qk = qp if qk is q else _pad_cols(qk, cols)  # the kernel loads a separate bf16(q * scale) only when it is one
    k, v, dout = (_pad_cols(t, cols) for t in (k, v, dout))
    dk, dv = (torch.empty((B, H, M, cols), dtype=q.dtype, device=q.device) for _ in range(2))
    _launch(flash_attention_bwd_dkv, "flash_attn_bwd_dkv_bf16", (qp, qk, k, v, dout, lse, delta, kv_len, dk, dv),
            (B, H, N, M, cols), (mul, scale), q.device, (B, H, N, M, D))
    return _cut_cols(dk, D), _cut_cols(dv, D)


def attention_bwd_dq_cuda_core(q, k, v, dout, lse, delta, kv_len=None, scale=None) -> torch.Tensor:
    """dq (B, H, N, D) in q's dtype from the CUDA-core dq kernel: one warp a
    query row, looping over tiles of 32 keys. CUDA tensors only; fp32 or
    bf16 with D up to 256. Launches counted under (B, H, N, M, D)."""
    B, H, N, M, D, kv_len, scale = _check_bwd_inputs("attention_bwd_dq_cuda_core", tuple(_DTYPE_CODE), MAX_HEAD_DIM,
                                                     q, k, v, dout, lse, delta, kv_len, scale)
    qk, mul = _cc_score_operand(q, scale)
    dq = torch.empty_like(q)
    _launch(attention_bwd_dq_cuda_core, "attn_cc_bwd_dq", (qk, k, v, dout, lse, delta, kv_len, dq),
            (_DTYPE_CODE[q.dtype], B, H, N, M, D), (mul, scale), q.device, (B, H, N, M, D))
    return dq


def attention_bwd_dkv_cuda_core(q, k, v, dout, lse, delta, kv_len=None, scale=None):
    """(dk, dv) (B, H, M, D) in q's dtype from the CUDA-core dk/dv kernel:
    one warp a key row, looping over tiles of 32 queries; keys at index >=
    kv_len[b] get zeros. CUDA tensors only. Launches counted under (B, H,
    N, M, D)."""
    B, H, N, M, D, kv_len, scale = _check_bwd_inputs("attention_bwd_dkv_cuda_core", tuple(_DTYPE_CODE),
                                                     MAX_HEAD_DIM, q, k, v, dout, lse, delta, kv_len, scale)
    qk, mul = _cc_score_operand(q, scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(attention_bwd_dkv_cuda_core, "attn_cc_bwd_dkv", (q, qk, k, v, dout, lse, delta, kv_len, dk, dv),
            (_DTYPE_CODE[q.dtype], B, H, N, M, D), (mul, scale), q.device, (B, H, N, M, D))
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, dout, kv_len=None, scale=None):
    """Attention backward: (dq, dk, dv) in the inputs' dtype from ``out``
    and ``lse`` as the forward returned them and the gradient ``dout`` of
    ``out``.

    CPU tensors take ``attention_bwd_plain``. CUDA tensors launch what
    ``kernel_variant`` names (bf16: the wgmma dq and dk/dv kernels; fp32 at
    N, M <= 32: the one fused short kernel, which reads any strides; other
    fp32: the tiled CUDA-core dq and dk/dv kernels; the kernels of two
    launches take contiguous inputs and delta = rowsum(dout * out) from here;
    anything else raises, never the plain version)."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, out, lse, dout, kv_len, scale)
    if out.shape != q.shape or out.device != q.device or dout.device != q.device:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)} on {out.device}, dout on {dout.device}, "
                         f"q {tuple(q.shape)} on {q.device}")
    route = _route(q, k, "dq")
    if route == "short":
        return attention_bwd_short(q, k, v, out, lse, dout, kv_len, scale)
    dq_fn, dkv_fn = ((flash_attention_bwd_dq, flash_attention_bwd_dkv) if route == "wgmma"
                     else (attention_bwd_dq_cuda_core, attention_bwd_dkv_cuda_core))
    dout = dout.contiguous()
    delta = (dout.float() * out.float()).sum(dim=-1)
    dq = dq_fn(q, k, v, dout, lse, delta, kv_len, scale)
    dk, dv = dkv_fn(q, k, v, dout, lse, delta, kv_len, scale)
    return dq, dk, dv


_KERNEL_WRAPPERS = (flash_attention_fwd, flash_attention_bwd_dq, flash_attention_bwd_dkv, attention_fwd_cuda_core,
                   attention_bwd_dq_cuda_core, attention_bwd_dkv_cuda_core, attention_fwd_short, attention_bwd_short)


def reset_launch_counts() -> None:
    for wrapper in _KERNEL_WRAPPERS:
        wrapper.launches = 0
        wrapper.launches_by_shape = {}


reset_launch_counts()


class _FlashAttention(torch.autograd.Function):
    """Joins the forward and the backward kernels. Everything the backward
    reads (q, k, v, out, lse, kv_len) is saved here, so a forward recomputed
    under activation checkpointing brings its own lse."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, scale):
        out, lse = attention_fwd(q, k, v, kv_len, scale)
        ctx.save_for_backward(q, k, v, out, lse, kv_len)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, kv_len = ctx.saved_tensors
        # the gradient arrives through a transpose of the output: flash_attention_bwd makes it contiguous for the
        # kernels that need it, the short one reads it as it comes
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, kv_len, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, kv_len=None, scale=None, impl: str = "auto") -> torch.Tensor:
    """Attention over (B, H, N, D) tensors (port of the JAX dispatcher),
    differentiable in q, k and v.

    impl: 'auto' runs the kernels on CUDA tensors (forward, and the two
    backward kernels when a gradient flows) and the plain versions on CPU
    tensors; 'plain' forces ``attention_plain`` under autograd (the
    reference runs). On CUDA each of the forward, dq and dk/dv kernels is
    the one ``kernel_variant`` names for the dtype, head dim and lengths
    (bf16: the wgmma kernels at any D up to 256; fp32: the short kernels at
    N, M <= 32, which read q, k and v as they come where their stride along
    D is 1, else the tiled CUDA-core family); other inputs raise ValueError.
    Only the kernels that need them get contiguous copies.
    """
    if impl == "plain":
        return attention_plain(q, k, v, kv_len, scale)[0]
    if impl != "auto":
        raise ValueError(f"unknown attention impl {impl!r}")
    strided = (q.device.type != "cpu" and q.dtype == torch.float32 and q.dim() == 4 and k.dim() == 4
               and _route(q, k, "fwd") == "short")
    q, k, v = (t if strided and t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    return _FlashAttention.apply(q, k, v, kv_len, scale)


def multi_head_attention(x, qkv_w, qkv_b, proj_w, proj_b, num_heads, **kwargs):
    """Fused qkv projection + attention + output projection for (B, N, C)
    tokens. Weights in the torch (out, in) layout."""
    B, N, C = x.shape
    qkv = F.linear(x, qkv_w, qkv_b).reshape(B, N, 3, num_heads, C // num_heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    o = flash_attention(q, k, v, **kwargs)
    return F.linear(o.transpose(1, 2).reshape(B, N, C), proj_w, proj_b)
