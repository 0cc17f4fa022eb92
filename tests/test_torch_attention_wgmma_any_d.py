"""bf16 attention at every head dim on the wgmma kernels: the forward
(``csrc/flash_attn_fwd.cu``, D from 1 to 256) and the dk/dv kernel
(``csrc/flash_attn_bwd.cu``, D up to 128), templated on the number of
64-column chunks of the head dim.

On the CPU: the routing of each kernel (``kernel_variant``) for fp32 and
bf16 at every D from 1 to 256 and its refusals; that no wrapper hands a
device tensor to a plain version; and the wrappers' padding of head dims
that are no multiple of 8 (``tma_cols``): the plain forward and backward on
zero-padded inputs, cut back to D columns, equal the unpadded ones within
1e-6 (fp32 sums of the same nonzero terms; exact zeros added), and at D = 20
they match the JAX package's Pallas kernels in interpret mode: relative L2
<= 1e-5 in fp32 (sums in another order), <= 1e-2 in bf16 (both sides round
qs, P, dS and the outputs to bf16), the gates of
``test_torch_attention_any_d.py``.

On a GPU (marker ``cuda``): the wgmma forward and dk/dv against the plain
versions through ``flash_attention`` and autograd at D in {16, 20, 24, 32,
48, 96, 128, 160, 256} and N in {1, 37, 721, 4326}, with and without
``kv_len``, at scale 0.1, and at B*H = 65,552 for D = 128. Gates, those of
``chip_smoke.py``'s bf16 cases: forward max |error| <= 5e-3 * max(1,
|value|), relative L2 <= 1e-2 and |error of lse| <= 1e-3; dq, dk and dv
relative L2 <= 1e-2 and max |error| <= 5e-3 * max(1, |value|) (a bf16
value carries a rounding of up to 2^-9 of itself); the same bits run to
run. The references are the plain versions' fp32 values before any last
rounding to bf16 (the forward's fp32 out, ``attention_bwd_plain(...,
out_dtype=torch.float32)``): the kernel's output is then one rounding away
from them, where two roundings of fp32 sums taken in other orders can land
one bf16 ulp apart, 2^-7 at values in [1, 2), more than the absolute gate.
At B*H = 65,552 the worst head's relative L2 (gradients against the head's
largest gradient norm) to 1e-2.

JAX is imported inside a fixture, so the CUDA tests run on a machine
without JAX (``python -m pytest --noconftest -m cuda``)."""

import numpy as np
import pytest
import torch

from recondet3d_torch.ops import attention as tattn
from recondet3d_torch.ops.attention import (
    attention_bwd_dkv_cuda_core,
    attention_bwd_dq_cuda_core,
    attention_bwd_plain,
    attention_fwd_cuda_core,
    attention_plain,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_fwd,
    KERNELS,
    kernel_variant,
    reset_launch_counts,
    tma_cols,
)

F32_REL, BF16_REL, BF16_ABS, LSE_ABS = 1e-5, 1e-2, 5e-3, 1e-3
PAD_TOL = 1e-6


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from recondet3d.ops import attention as jattn

    return jax, jnp, jattn


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _inputs(shape_q, M, seed):
    B, H, N, D = shape_q
    rng = np.random.default_rng(seed)
    q, g = (rng.normal(size=(B, H, N, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(B, H, M, D)).astype(np.float32) for _ in range(2))
    return q, k, v, g


# ---------------------------------------------------------------- routing

@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_each_kernel_is_routed_by_dtype_and_head_dim(dtype, kernel):
    for D in range(1, tattn.MAX_HEAD_DIM + 1):
        if dtype == torch.float32:
            want = "cuda_core"
        else:
            want = {"fwd": "wgmma", "dq": "wgmma" if D == 64 else "cuda_core",
                    "dkv": "wgmma" if D <= 128 else "cuda_core"}[kernel]
        assert kernel_variant(dtype, D, kernel) == want, D


@pytest.mark.parametrize("dtype,D,kernel", [(torch.float16, 64, "fwd"), (torch.float64, 64, "dkv"),
                                            (torch.bfloat16, 257, "fwd"), (torch.float32, 257, "dq"),
                                            (torch.bfloat16, 0, "dkv"), (torch.float16, 128, "dq")])
def test_routing_refuses_what_no_kernel_takes(dtype, D, kernel):
    with pytest.raises(ValueError, match="no attention kernel"):
        kernel_variant(dtype, D, kernel)


def test_routing_refuses_an_unknown_kernel():
    with pytest.raises(ValueError, match="unknown attention kernel"):
        kernel_variant(torch.bfloat16, 64, "dk")


def test_tma_cols_is_the_next_multiple_of_8():
    for D in range(1, tattn.MAX_HEAD_DIM + 1):
        cols = tma_cols(D)
        assert cols % 8 == 0 and D <= cols < D + 8, D
    assert [tma_cols(d) for d in (20, 24, 64, 96, 100)] == [24, 24, 64, 96, 104]


def _meta(dtype, D):
    q = torch.empty(2, 4, 8, D, device="meta", dtype=dtype)
    return q, torch.empty(2, 4, 8, device="meta")


_CALLS = {
    "flash_attention_fwd": lambda q, s: flash_attention_fwd(q, q, q),
    "attention_fwd_cuda_core": lambda q, s: attention_fwd_cuda_core(q, q, q),
    "attention_fwd": lambda q, s: tattn.attention_fwd(q, q, q),
    "flash_attention_bwd_dq": lambda q, s: flash_attention_bwd_dq(q, q, q, q, s, s),
    "flash_attention_bwd_dkv": lambda q, s: flash_attention_bwd_dkv(q, q, q, q, s, s),
    "attention_bwd_dq_cuda_core": lambda q, s: attention_bwd_dq_cuda_core(q, q, q, q, s, s),
    "attention_bwd_dkv_cuda_core": lambda q, s: attention_bwd_dkv_cuda_core(q, q, q, q, s, s),
    "flash_attention_bwd": lambda q, s: flash_attention_bwd(q, q, q, q, s, q),
    "flash_attention": lambda q, s: flash_attention(q, q, q),
}


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 20), (torch.bfloat16, 64), (torch.bfloat16, 96),
                                     (torch.bfloat16, 160), (torch.float32, 20)])
@pytest.mark.parametrize("call", sorted(_CALLS))
def test_device_tensors_never_reach_a_plain_version_in_any_kernel(monkeypatch, call, dtype, D):
    """A meta tensor stands for a device tensor: each kernel wrapper, the
    routed forward and backward and the autograd Function go to a kernel
    wrapper, which raises on a tensor that is not on CUDA, and never to a
    plain version; nothing is counted as a launch."""

    def refuse(*_a, **_k):
        raise AssertionError("a device tensor reached a plain version")

    monkeypatch.setattr(tattn, "attention_plain", refuse)
    monkeypatch.setattr(tattn, "attention_bwd_plain", refuse)
    reset_launch_counts()
    with pytest.raises(ValueError):
        _CALLS[call](*_meta(dtype, D))
    assert all(w.launches == 0 for w in tattn._KERNEL_WRAPPERS)


# ---------------------------------------------------------------- padding

def _padded_plain(q, k, v, g, kv_len):
    """The plain forward and backward at the wrappers' padded width
    (``tma_cols``), with the scale of the original D, cut back to D."""
    D = q.shape[-1]
    cols, scale = tma_cols(D), D ** -0.5
    qp, kp, vp, gp = (tattn._pad_cols(t, cols) for t in (q, k, v, g))
    assert qp.shape[-1] == cols > D
    out, lse = attention_plain(qp, kp, vp, kv_len, scale)
    grads = attention_bwd_plain(qp, kp, vp, out, lse, gp, kv_len, scale)
    for t in (out,) + tuple(grads):  # zero columns in, zero columns out
        assert torch.all(t[..., D:] == 0)
    return tattn._cut_cols(out, D), lse, [tattn._cut_cols(t, D) for t in grads]


@pytest.mark.parametrize("use_kv_len", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_forward_equals_the_unpadded_one(dtype, use_kv_len):
    q, k, v, g = (torch.from_numpy(a).to(dtype) for a in _inputs((2, 2, 37, 20), 45, seed=20))
    kv_len = torch.tensor([23, 45]) if use_kv_len else None
    out, lse, _ = _padded_plain(q, k, v, g, kv_len)
    ref_out, ref_lse = attention_plain(q, k, v, kv_len)
    assert out.shape == ref_out.shape and out.is_contiguous()
    assert (out.float() - ref_out.float()).abs().max().item() <= PAD_TOL
    assert (lse - ref_lse).abs().max().item() <= PAD_TOL


@pytest.mark.parametrize("use_kv_len", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_padded_backward_equals_the_unpadded_one(dtype, use_kv_len):
    q, k, v, g = (torch.from_numpy(a).to(dtype) for a in _inputs((2, 2, 37, 20), 45, seed=21))
    kv_len = torch.tensor([23, 45]) if use_kv_len else None
    _, _, grads = _padded_plain(q, k, v, g, kv_len)
    out, lse = attention_plain(q, k, v, kv_len)
    ref = attention_bwd_plain(q, k, v, out, lse, g, kv_len)
    for name, a, r in zip(("dq", "dk", "dv"), grads, ref):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        assert (a.float() - r.float()).abs().max().item() <= PAD_TOL, name


@pytest.mark.parametrize("use_kv_len", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_padded_path_matches_pallas_at_d20(jx, dtype, use_kv_len):
    """What the wrappers hand the kernels at D = 20 (24 columns, the scale of
    20), through the plain versions, against the Pallas forward and its vjp
    in interpret mode."""
    jax, jnp, jattn = jx
    q, k, v, g = _inputs((2, 2, 40, 20), 40, seed=22)
    kv_len = np.array([21, 40], np.int32) if use_kv_len else None
    jdt = getattr(jnp, dtype)
    args = tuple(jnp.asarray(a).astype(jdt) for a in (q, k, v))
    jkv = None if kv_len is None else jnp.asarray(kv_len)
    jout, vjp = jax.vjp(lambda q, k, v: jattn.flash_attention(q, k, v, kv_len=jkv, impl="pallas"), *args)
    jgrads = vjp(jnp.asarray(g).astype(jdt))
    tdt = getattr(torch, dtype)
    out, _, grads = _padded_plain(*(torch.from_numpy(a).to(tdt) for a in (q, k, v, g)),
                                  None if kv_len is None else torch.from_numpy(kv_len))
    tol = F32_REL if dtype == "float32" else BF16_REL
    assert rel_l2(out.float().numpy(), np.asarray(jout.astype(jnp.float32))) <= tol
    for name, a, r in zip(("dq", "dk", "dv"), grads, jgrads):
        assert rel_l2(a.float().numpy(), np.asarray(r.astype(jnp.float32))) <= tol, name


# ---------------------------------------------------------------- on the card

def _gate(got, ref, scale=None):
    """(relative L2 against ``scale`` or the reference's norm, largest
    |error| / max(1, |value|)), in fp32."""
    got, ref = got.float(), ref.float()
    err = got - ref
    rel = (torch.linalg.norm(err) / (torch.linalg.norm(ref) if scale is None else scale)).item()
    return rel, (err.abs() / ref.abs().clamp(min=1.0)).max().item()


def _check_routed(B, H, N, M, D, kv_len, scale, seed):
    """Forward and backward through ``flash_attention`` under autograd,
    twice: the launches of each kernel, the gates, the same bits."""
    q, k, v, g = (torch.from_numpy(a).cuda().to(torch.bfloat16) for a in _inputs((B, H, N, D), M, seed))
    kvl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    reset_launch_counts()
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    out = flash_attention(*leaves, kv_len=kvl, scale=scale)
    grads = torch.autograd.grad(out, leaves, g)
    out2 = flash_attention(*leaves, kv_len=kvl, scale=scale)
    again = torch.autograd.grad(out2, leaves, g)
    torch.cuda.synchronize()
    key = (B, H, N, M, D)
    assert flash_attention_fwd.launches_by_shape == {key: 2} and attention_fwd_cuda_core.launches == 0
    assert attention_bwd_dq_cuda_core.launches_by_shape == {key: 2} and flash_attention_bwd_dq.launches == 0
    on_wgmma = D <= tattn.WGMMA_DKV_MAX_HEAD_DIM
    assert flash_attention_bwd_dkv.launches_by_shape == ({key: 2} if on_wgmma else {})
    assert attention_bwd_dkv_cuda_core.launches_by_shape == ({} if on_wgmma else {key: 2})
    assert torch.equal(out, out2) and all(torch.equal(a, b) for a, b in zip(grads, again))
    s = D ** -0.5 if scale is None else scale
    qs = (q.float() * s).to(torch.bfloat16)
    ref_out, ref_lse = attention_plain(qs.float(), k.float(), v.float(), kvl, 1.0)
    _, lse = flash_attention_fwd(q, k, v, kvl, scale)
    rel, scaled = _gate(out, ref_out)
    assert torch.isfinite(out).all() and rel <= BF16_REL and scaled <= BF16_ABS, (rel, scaled)
    assert (lse - ref_lse).abs().max().item() <= LSE_ABS
    ref = attention_bwd_plain(q, k, v, out.detach(), lse, g, kvl, scale, out_dtype=torch.float32)
    for name, a, r in zip(("dq", "dk", "dv"), grads, ref):
        assert a.shape == r.shape and torch.isfinite(a).all(), name
        rel, scaled = _gate(a, r)
        # one query over one key: p = 1, and dq, dk are rounding noise of dP - delta (only the absolute gate)
        assert (rel <= BF16_REL or (M == 1 and name != "dv")) and scaled <= BF16_ABS, (name, rel, scaled)


@pytest.mark.cuda
@pytest.mark.parametrize("use_kv_len", [False, True])
@pytest.mark.parametrize("N", [1, 37, 721, 4326])
@pytest.mark.parametrize("D", [16, 20, 24, 32, 48, 96, 128, 160, 256])
def test_wgmma_forward_and_dkv_match_plain(D, N, use_kv_len):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    M = max(N, 70)
    _check_routed(2, 2, N, M, D, [max(1, M // 2 - 3), M] if use_kv_len else None, None, seed=D + N)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [20, 96, 128, 256])
def test_wgmma_forward_and_dkv_at_scale_0_1(D):
    """A scale that is no power of two: the wrappers hand the kernels
    bf16(q * 0.1) with a multiplier of 1 (and dk/dv raw q beside it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    _check_routed(2, 3, 721, 721, D, [300, 721], 0.1, seed=D)


def _worst_head(got, ref, scale=None):
    err = torch.linalg.vector_norm((got.float() - ref.float()).flatten(2), dim=-1)
    return (err / (torch.linalg.vector_norm(ref.float().flatten(2), dim=-1) if scale is None else scale)).max().item()


@pytest.mark.cuda
def test_wgmma_forward_and_dkv_take_more_than_65535_heads_at_d128():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    B, H, N, D = 4097, 16, 64, 128
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v, g = (torch.randn((B, H, N, D), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(4))
    reset_launch_counts()
    out, lse = flash_attention_fwd(q, k, v)
    delta = (g.float() * out.float()).sum(dim=-1)
    dk, dv = flash_attention_bwd_dkv(q, k, v, g, lse, delta)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == 1 and flash_attention_bwd_dkv.launches == 1
    qs = (q.float() * D ** -0.5).to(torch.bfloat16)
    assert _worst_head(out, attention_plain(qs.float(), k.float(), v.float(), None, 1.0)[0]) <= BF16_REL
    _, ref_dk, ref_dv = attention_bwd_plain(q, k, v, out, lse, g)
    scale = torch.stack([torch.linalg.vector_norm(r.float().flatten(2), dim=-1) for r in (ref_dk, ref_dv)]).amax(0)
    for name, a, r in (("dk", dk, ref_dk), ("dv", dv, ref_dv)):
        assert _worst_head(a, r, scale) <= BF16_REL, name
