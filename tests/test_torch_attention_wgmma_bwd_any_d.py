"""The bf16 attention backward at every head dim on the wgmma kernels
(``csrc/flash_attn_bwd.cu``): the dq kernel at any D from 1 to 256, the
dk/dv kernel past D = 128, where it splits the head dim's chunks of dK and
dV between two CTAs that each recompute the scores.

On the CPU: the dq wrapper's pad and cut of head dims that are no multiple
of 8 (``tma_cols``): the plain backward on zero-padded inputs with the scale
of the original D, cut back to D columns, equals the unpadded one within
1e-6 (fp32 sums of the same nonzero terms; exact zeros added) at D = 20 and
100, and matches the JAX package's Pallas backward in interpret mode:
relative L2 <= 1e-5 in fp32 (sums in another order), <= 1e-2 in bf16 (both
sides round qs, P, dS and the outputs to bf16), the gates of
``test_torch_attention_any_d.py``; and D = 160 / 256 through
``flash_attention`` under autograd (the CPU's plain path) against the
Pallas backward under the same gates.

On a GPU (marker ``cuda``): the wgmma dq at D in {16, 20, 32, 48, 96, 128,
160, 256} and the wgmma dk/dv at D in {136, 160, 192, 256}, N in {1, 37,
721, 4326}, with and without ``kv_len``, called directly on out and lse of
the wgmma forward; both at scale 0.1 (D = 96 and 256: the kernels read
bf16(q * 0.1), dk/dv raw q beside it); B*H = 65,552 at D = 256. Gates, those
of ``chip_smoke.py``'s bf16 cases: relative L2 <= 1e-2 and max |error| <=
5e-3 * max(1, |value|) against ``attention_bwd_plain(...,
out_dtype=torch.float32)``, the plain sums before their last rounding (a
kernel's bf16 output is one rounding away from them); one launch a call;
the same bits run to run. At B*H = 65,552 the worst head's relative L2
(gradients against the head's largest gradient norm) to 1e-2.

JAX is imported inside a fixture, so the CUDA tests run on a machine
without JAX (``python -m pytest --noconftest -m cuda``)."""

import numpy as np
import pytest
import torch

from recondet3d_torch.ops import attention as tattn
from recondet3d_torch.ops.attention import (
    attention_bwd_plain,
    attention_plain,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_fwd,
    reset_launch_counts,
    tma_cols,
)

F32_REL, BF16_REL, BF16_ABS = 1e-5, 1e-2, 5e-3
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


def _padded_dq(q, k, v, g, kv_len):
    """dq of the plain backward at the dq wrapper's padded width
    (``tma_cols``: q's score operand, k, v and dO padded with zero columns),
    with the scale of the original D, cut back to D columns."""
    D = q.shape[-1]
    cols, scale = tma_cols(D), D ** -0.5
    qp, kp, vp, gp = (tattn._pad_cols(t, cols) for t in (q, k, v, g))
    assert qp.shape[-1] == cols > D
    out, lse = attention_plain(qp, kp, vp, kv_len, scale)
    dq = attention_bwd_plain(qp, kp, vp, out, lse, gp, kv_len, scale)[0]
    assert torch.all(dq[..., D:] == 0)  # zero columns in, zero columns out
    return tattn._cut_cols(dq, D)


# ---------------------------------------------------------------- on the CPU

@pytest.mark.parametrize("use_kv_len", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [20, 100])
def test_padded_dq_equals_the_unpadded_one(D, dtype, use_kv_len):
    q, k, v, g = (torch.from_numpy(a).to(dtype) for a in _inputs((2, 2, 37, D), 45, seed=D))
    kv_len = torch.tensor([23, 45]) if use_kv_len else None
    dq = _padded_dq(q, k, v, g, kv_len)
    out, lse = attention_plain(q, k, v, kv_len)
    ref = attention_bwd_plain(q, k, v, out, lse, g, kv_len)[0]
    assert dq.shape == ref.shape and dq.dtype == ref.dtype and dq.is_contiguous()
    assert (dq.float() - ref.float()).abs().max().item() <= PAD_TOL


def _pallas_grads(jx, q, k, v, g, kv_len, dtype):
    """(dq, dk, dv) of the JAX package's Pallas attention (interpret mode on
    the CPU), as fp32 numpy arrays."""
    jax, jnp, jattn = jx
    jdt = getattr(jnp, dtype)
    args = tuple(jnp.asarray(a).astype(jdt) for a in (q, k, v))
    jkv = None if kv_len is None else jnp.asarray(kv_len)
    _, vjp = jax.vjp(lambda q, k, v: jattn.flash_attention(q, k, v, kv_len=jkv, impl="pallas"), *args)
    return [np.asarray(r.astype(jnp.float32)) for r in vjp(jnp.asarray(g).astype(jdt))]


@pytest.mark.parametrize("use_kv_len", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [20, 100])
def test_padded_dq_matches_pallas(jx, D, dtype, use_kv_len):
    """What the dq wrapper hands the kernel at D = 20 and 100 (24 and 104
    columns, the scale of D), through the plain backward, against the Pallas
    backward in interpret mode."""
    q, k, v, g = _inputs((2, 2, 40, D), 40, seed=D + 1)
    kv_len = np.array([21, 40], np.int32) if use_kv_len else None
    jdq = _pallas_grads(jx, q, k, v, g, kv_len, dtype)[0]
    tdt = getattr(torch, dtype)
    dq = _padded_dq(*(torch.from_numpy(a).to(tdt) for a in (q, k, v, g)),
                    None if kv_len is None else torch.from_numpy(kv_len))
    assert rel_l2(dq.float().numpy(), jdq) <= (F32_REL if dtype == "float32" else BF16_REL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [160, 256])
def test_backward_past_d128_matches_pallas(jx, D, dtype):
    """``flash_attention`` under autograd on CPU tensors (the plain forward
    and backward the kernels are held to on the card) against the Pallas
    backward at the head dims the dk/dv kernel splits between two CTAs."""
    q, k, v, g = _inputs((1, 2, 40, D), 48, seed=D + 2)
    kv_len = np.array([29], np.int32)
    jgrads = _pallas_grads(jx, q, k, v, g, kv_len, dtype)
    tdt = getattr(torch, dtype)
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*leaves, kv_len=torch.from_numpy(kv_len))
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g).to(tdt))
    for name, a, r in zip(("dq", "dk", "dv"), grads, jgrads):
        assert a.shape == r.shape, name
        assert rel_l2(a.float().numpy(), r) <= (F32_REL if dtype == "float32" else BF16_REL), name


# ---------------------------------------------------------------- on the card

def _gate(got, ref, scale=None):
    """(relative L2 against ``scale`` or the reference's norm, largest
    |error| / max(1, |value|)), in fp32."""
    got, ref = got.float(), ref.float()
    err = got - ref
    rel = (torch.linalg.norm(err) / (torch.linalg.norm(ref) if scale is None else scale)).item()
    return rel, (err.abs() / ref.abs().clamp(min=1.0)).max().item()


def _check_kernels(B, H, N, M, D, kv_len, scale, seed, kinds):
    """The wgmma ``kinds`` ('dq', 'dkv') called directly on out and lse of
    the wgmma forward, twice: one launch a call, the gates, the same bits."""
    q, k, v, g = (torch.from_numpy(a).cuda().to(torch.bfloat16) for a in _inputs((B, H, N, D), M, seed))
    kvl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    out, lse = flash_attention_fwd(q, k, v, kvl, scale)
    delta = (g.float() * out.float()).sum(dim=-1)
    ref = dict(zip(("dq", "dk", "dv"), attention_bwd_plain(q, k, v, out, lse, g, kvl, scale,
                                                           out_dtype=torch.float32)))
    calls = {"dq": (flash_attention_bwd_dq, ("dq",)), "dkv": (flash_attention_bwd_dkv, ("dk", "dv"))}
    for kind in kinds:
        wrapper, names = calls[kind]
        reset_launch_counts()
        got, again = (wrapper(q, k, v, g, lse, delta, kvl, scale) for _ in range(2))
        torch.cuda.synchronize()
        assert wrapper.launches_by_shape == {(B, H, N, M, D): 2}, kind
        got, again = ((got,), (again,)) if kind == "dq" else (got, again)
        for name, a, b in zip(names, got, again):
            assert a.shape == ref[name].shape and torch.isfinite(a).all() and torch.equal(a, b), name
            rel, scaled = _gate(a, ref[name])
            assert rel <= BF16_REL and scaled <= BF16_ABS, (name, rel, scaled)


@pytest.mark.cuda
@pytest.mark.parametrize("use_kv_len", [False, True])
@pytest.mark.parametrize("N", [1, 37, 721, 4326])
@pytest.mark.parametrize("D", [16, 20, 32, 48, 96, 128, 160, 256])
def test_wgmma_dq_matches_plain(D, N, use_kv_len):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    M = max(N, 70)
    _check_kernels(2, 2, N, M, D, [max(1, M // 2 - 3), M] if use_kv_len else None, None, D + N, ("dq",))


@pytest.mark.cuda
@pytest.mark.parametrize("use_kv_len", [False, True])
@pytest.mark.parametrize("N", [1, 37, 721, 4326])
@pytest.mark.parametrize("D", [136, 160, 192, 256])
def test_wgmma_dkv_past_d128_matches_plain(D, N, use_kv_len):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    M = max(N, 70)
    _check_kernels(2, 2, N, M, D, [max(1, M // 2 - 3), M] if use_kv_len else None, None, D + N + 1, ("dkv",))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [96, 256])
def test_wgmma_backward_at_scale_0_1(D):
    """A scale that is no power of two: the kernels take bf16(q * 0.1) with a
    multiplier of 1 as the score operand, and dk/dv raw q beside it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    _check_kernels(2, 3, 721, 721, D, [300, 721], 0.1, D + 3, ("dq", "dkv"))


def _worst_head(got, ref, scale):
    err = torch.linalg.vector_norm((got.float() - ref.float()).flatten(2), dim=-1)
    return (err / scale).max().item()


@pytest.mark.cuda
def test_wgmma_backward_takes_more_than_65535_heads_at_d256():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    B, H, N, D = 4097, 16, 64, 256
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, g = (torch.randn((B, H, N, D), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(4))
    reset_launch_counts()
    out, lse = flash_attention_fwd(q, k, v)
    delta = (g.float() * out.float()).sum(dim=-1)
    dq = flash_attention_bwd_dq(q, k, v, g, lse, delta)
    dk, dv = flash_attention_bwd_dkv(q, k, v, g, lse, delta)
    torch.cuda.synchronize()
    assert flash_attention_bwd_dq.launches == 1 and flash_attention_bwd_dkv.launches == 1
    ref = attention_bwd_plain(q, k, v, out, lse, g)
    # each head's gradients against its largest gradient norm
    scale = torch.stack([torch.linalg.vector_norm(r.float().flatten(2), dim=-1) for r in ref]).amax(0)
    for name, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert _worst_head(a, r, scale) <= BF16_REL, name
