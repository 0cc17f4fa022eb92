"""Port attention vs the JAX package: the plain flash forward (out and lse)
against the Pallas kernel in interpret mode and against ``attention_xla``;
the scale helper the kernels' wrappers use; and, on a GPU, the hand-written
CUDA kernel against the plain version.

JAX is imported inside fixtures so that the CUDA test also runs on a
machine that has no JAX (``python -m pytest --noconftest -m cuda``)."""

import numpy as np
import pytest
import torch

from recondet3d_torch.ops.attention import (
    attention_bwd_plain,
    attention_plain,
    flash_attention,
    flash_attention_fwd,
    multi_head_attention,
    reset_launch_counts,
    score_operand,
)

# kernel vs plain (fp32 math on the same bf16 values): max |out error|, its
# relative L2, max |lse error|; the same gates as chip_smoke.py
OUT_TOL, OUT_REL_TOL, LSE_TOL = 5e-3, 1e-2, 1e-3


@pytest.fixture(scope="module")
def jax_attn():
    pytest.importorskip("jax")
    from recondet3d.ops import attention as jattn

    return jattn


def _qkv(B, H, N, M, D=64, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, N, D)).astype(np.float32)
    k = rng.normal(size=(B, H, M, D)).astype(np.float32)
    v = rng.normal(size=(B, H, M, D)).astype(np.float32)
    return q, k, v


def _kv_len(N, use):
    return np.array([max(1, N // 2 + 1), N], np.int32) if use else None


@pytest.mark.parametrize("use_kv_len", [False, True])
@pytest.mark.parametrize("N", [37, 150])
def test_plain_flash_matches_jax(jax_attn, N, use_kv_len):
    import jax.numpy as jnp

    q, k, v = _qkv(2, 3, N, N, seed=N)
    kv_len = _kv_len(N, use_kv_len)
    jkv = None if kv_len is None else jnp.asarray(kv_len)
    tkv = None if kv_len is None else torch.from_numpy(kv_len)

    out, lse = flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tkv)
    j_pallas = jax_attn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len=jkv, impl="pallas")
    j_xla = jax_attn.attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len=jkv)
    _, j_lse = jax_attn._flash_attention_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jkv, 64 ** -0.5, 128, 128, True
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(j_pallas), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_xla), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[:, :, :N], atol=1e-5, rtol=1e-4)


def test_dispatch_and_mha_on_cpu(jax_attn):
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    B, N, C, H = 2, 19, 128, 2
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    qkv_w = (rng.normal(size=(C, 3 * C)) / np.sqrt(C)).astype(np.float32)
    qkv_b = rng.normal(size=(3 * C,)).astype(np.float32)
    proj_w = (rng.normal(size=(C, C)) / np.sqrt(C)).astype(np.float32)
    proj_b = rng.normal(size=(C,)).astype(np.float32)
    ref = jax_attn.multi_head_attention(
        jnp.asarray(x), qkv_w, qkv_b, proj_w, proj_b, H, impl="xla"
    )
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got = multi_head_attention(t(x), t(qkv_w.T), t(qkv_b), t(proj_w.T), t(proj_b), H)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-4)
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 9, 9))
    assert torch.equal(flash_attention(q, k, v, impl="plain"), attention_plain(q, k, v)[0])
    with pytest.raises(ValueError):
        flash_attention(q, k, v, impl="pallas")


def test_cpu_calls_launch_no_kernel():
    reset_launch_counts()
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 9, 9))
    flash_attention_fwd(q, k, v)
    flash_attention(q, k, v)
    assert flash_attention_fwd.launches == 0 and flash_attention_fwd.launches_by_shape == {}


def _bf16_qkv(seed=21):
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(2, 2, 33, 40, seed=seed))
    return q, k, v


def test_score_operand_for_a_power_of_two_scale_is_raw_q_and_the_scale():
    q, k, _ = _bf16_qkv()
    qk, mul = score_operand(q, 0.125)
    assert qk is q and mul == 0.125 and isinstance(mul, float)
    # the scores of raw q times the multiplier are those of bf16(q * 0.125), bit for bit in fp32
    rounded = (q.float() * 0.125).to(torch.bfloat16).float()
    got = torch.einsum("bhnd,bhmd->bhnm", qk.float(), k.float()) * mul
    assert torch.equal(got, torch.einsum("bhnd,bhmd->bhnm", rounded, k.float()))


def test_score_operand_for_another_scale_is_rounded_q_and_one():
    q, _, _ = _bf16_qkv()
    qk, mul = score_operand(q, 0.1)
    assert mul == 1.0 and qk.dtype == torch.bfloat16
    assert torch.equal(qk, (q.float() * 0.1).to(torch.bfloat16))
    for bad in (0.3, 1 / 3, -0.125):
        assert score_operand(q, bad)[1] == 1.0


@pytest.mark.parametrize("scale", [0.125, 0.1])
def test_plain_versions_fed_the_score_operand_equal_the_default_path(scale):
    """The helper's (q', mul) in place of (q, scale) changes neither plain
    version: exactly for a power of two; for 0.1 the forward's reference
    (which keeps q * scale in fp32) moves by the one bf16 rounding of q * 0.1
    that the kernels make, and the backward already makes it."""
    q, k, v = _bf16_qkv()
    qk, mul = score_operand(q, scale)
    out, lse = attention_plain(q.float(), k.float(), v.float(), scale=scale)
    out_h, lse_h = attention_plain(qk.float(), k.float(), v.float(), scale=mul)
    if scale == 0.125:
        assert torch.equal(out, out_h) and torch.equal(lse, lse_h)
    else:  # scores of size ~1 moved by ~2^-9 relative
        torch.testing.assert_close(out_h, out, atol=1e-2, rtol=1e-2)
        torch.testing.assert_close(lse_h, lse, atol=1e-2, rtol=0)
    # the backward's explicit formulae with qs = bf16(q * scale), as before the helper existed
    g = torch.from_numpy(np.random.default_rng(4).normal(size=q.shape).astype(np.float32)).to(torch.bfloat16)
    out_b, lse_b = attention_plain(q, k, v, scale=scale)
    qs = (q.float() * scale).to(torch.bfloat16).float()
    p = torch.exp(torch.einsum("bhnd,bhmd->bhnm", qs, k.float()) - lse_b[..., None])
    dof = g.float()
    delta = (dof * out_b.float()).sum(-1)
    ds = (p * (torch.einsum("bhnd,bhmd->bhnm", dof, v.float()) - delta[..., None])).to(torch.bfloat16).float()
    ref = ((torch.einsum("bhnm,bhmd->bhnd", ds, k.float()) * scale).to(torch.bfloat16),
           (torch.einsum("bhnm,bhnd->bhmd", ds, q.float()) * scale).to(torch.bfloat16),
           torch.einsum("bhnm,bhnd->bhmd", p.to(torch.bfloat16).float(), dof).to(torch.bfloat16))
    for name, a, r in zip(("dq", "dk", "dv"), attention_bwd_plain(q, k, v, out_b, lse_b, g, scale=scale), ref):
        assert torch.equal(a, r), name


LOUD = 100.0  # the factor of a "loud" head's q, k and v


def _cuda_inputs(B, H, N, M, inputs, seed):
    """bf16 (q, k, v) on the card and the (B, H) mask of loud heads. inputs:
    'normal'; 'loud': every odd head of the flattened B*H (the next head of
    an even one) has q, k, v 100x larger, so a tile read across heads would
    show; 'neg_lse': logits near -150, lse < -100."""
    if inputs == "neg_lse":
        from test_torch_attention_bwd import _very_negative_lse

        q, k, v, _ = _very_negative_lse(B, H, N, M, seed)
    else:
        q, k, v = _qkv(B, H, N, M, seed=seed)
    loud = torch.zeros(B * H, dtype=torch.bool)
    if inputs == "loud":
        loud[1::2] = True
        loud = loud.reshape(B, H)
        for a in (q, k, v):
            a[loud.numpy()] *= LOUD
    return tuple(torch.from_numpy(a).cuda().to(torch.bfloat16) for a in (q, k, v)) + (loud.reshape(B, H).cuda(),)


# (B, H, N, M, kv_len, scale, inputs): N and M across the query blocks (64 rows a
# consumer warpgroup) and key tiles (128) of the kernel, kv_len off every tile
# multiple, B*H > 1 with loud next heads, a scale that is no power of two, lse < -100
_CUDA_FWD_CASES = [
    (2, 3, 37, 37, None, None, "normal"),
    (2, 4, 150, 150, [50, 150], None, "normal"),
    (3, 2, 721, 721, None, None, "normal"),
    (2, 2, 200, 333, [111, 333], None, "normal"),
    (1, 2, 4326, 4326, None, None, "normal"),
    *[(1, 2, n, n, None, None, "loud") for n in (1, 17, 63, 64, 65, 127, 128, 129, 192, 721)],
    (2, 3, 65, 129, [1, 129], None, "loud"),
    (2, 2, 129, 721, [127, 257], None, "loud"),
    (3, 2, 192, 721, [63, 65, 600], None, "normal"),
    (2, 2, 721, 721, [255, 721], 0.1, "loud"),
    (2, 2, 17, 200, None, 0.1, "normal"),
    (2, 2, 100, 150, [77, 150], None, "neg_lse"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,N,M,kv_len,scale,inputs", _CUDA_FWD_CASES)
def test_cuda_kernel_matches_plain(B, H, N, M, kv_len, scale, inputs):
    """Against the plain version on the scores of the TPU kernel, bf16(q *
    scale) k^T, formed here: quiet heads under the gates of chip_smoke.py; a loud
    head's output (the v row of its one dominant key) under the relative L2
    gate and its lse (up to ~3e4) to 1e-6 of its largest value."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    q, k, v, loud = _cuda_inputs(B, H, N, M, inputs, seed=N + M)
    kvl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32).cuda()
    reset_launch_counts()
    out, lse = flash_attention_fwd(q, k, v, kvl, scale)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == 1
    assert flash_attention_fwd.launches_by_shape == {(B, H, N, M): 1}
    qs = (q.float() * (64 ** -0.5 if scale is None else scale)).to(q.dtype)
    ref_out, ref_lse = attention_plain(qs.float(), k.float(), v.float(), kvl, 1.0)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    if inputs == "neg_lse":
        assert lse.max().item() < -100
    quiet = ~loud
    err = out.float()[quiet] - ref_out[quiet]
    assert err.abs().max().item() <= OUT_TOL
    assert (torch.linalg.norm(err) / torch.linalg.norm(ref_out[quiet])).item() <= OUT_REL_TOL
    assert (lse[quiet] - ref_lse[quiet]).abs().max().item() <= LSE_TOL
    if loud.any():
        err = out.float()[loud] - ref_out[loud]
        assert (torch.linalg.norm(err) / torch.linalg.norm(ref_out[loud])).item() <= OUT_REL_TOL
        # scores of +-3e4 are resolved to ~2e-3 in fp32: lse to 1e-6 of the head's largest
        assert (lse[loud] - ref_lse[loud]).abs().max().item() <= 1e-6 * ref_lse[loud].abs().max().item()
    with pytest.raises(ValueError):
        flash_attention_fwd(q.float(), k.float(), v.float())


# the fp32 kernel (the camera encoder's trunk) against fp32 attention_plain: relative L2 of out, and lse to
# 1e-5 absolute (|lse| is a few units here); both are fp32 sums of the same terms in another order
F32_REL_TOL, F32_LSE_TOL = 1e-5, 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("use_kv_len", [False, True])
@pytest.mark.parametrize("D", [24, 48, 64, 96])
@pytest.mark.parametrize("S", [1, 6, 37, 300])
def test_cuda_fp32_kernel_matches_plain(S, D, use_kv_len):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from recondet3d_torch.ops.attention import (attention_bwd_dkv_cuda_core, attention_bwd_dq_cuda_core,
                                                attention_bwd_plain, attention_fwd_cuda_core)

    B, H = 2, 16
    rng = np.random.default_rng(S * 1000 + D)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, H, S, D)).astype(np.float32)).cuda() for _ in range(3))
    kvl = torch.tensor([max(1, S // 2 - 1), S], dtype=torch.int32).cuda() if use_kv_len else None
    reset_launch_counts()
    out, lse = attention_fwd_cuda_core(q, k, v, kvl)
    got = flash_attention(q, k, v, kv_len=kvl)  # the dispatcher takes fp32 CUDA inputs to the same kernel
    torch.cuda.synchronize()
    assert attention_fwd_cuda_core.launches == 2
    assert attention_fwd_cuda_core.launches_by_shape == {(B, H, S, S, D): 2}
    assert flash_attention_fwd.launches == 0
    ref_out, ref_lse = attention_plain(q, k, v, kvl)
    assert out.dtype == torch.float32 and torch.isfinite(out).all() and torch.equal(got, out)
    assert (torch.linalg.norm(out - ref_out) / torch.linalg.norm(ref_out)).item() <= F32_REL_TOL
    assert (lse - ref_lse).abs().max().item() <= F32_LSE_TOL
    # the backward runs the CUDA-core dq and dk/dv kernels, to the forward's gate; errors are measured against
    # the call's gradient scale (the largest norm of dq, dk, dv): with one key (S = 1) p = 1, and dq and dk are
    # rounding noise of dP - delta, which cancels, so their own norms are no scale
    g = torch.from_numpy(rng.normal(size=(B, H, S, D)).astype(np.float32)).cuda()
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    grads = torch.autograd.grad(flash_attention(*leaves, kv_len=kvl), leaves, g)
    assert attention_bwd_dq_cuda_core.launches == 1 and attention_bwd_dkv_cuda_core.launches == 1
    ref = attention_bwd_plain(q, k, v, ref_out, ref_lse, g, kvl)
    scale = max(torch.linalg.norm(r).item() for r in ref)
    for a, r in zip(grads, ref):
        assert torch.isfinite(a).all()
        assert torch.linalg.norm(a - r).item() <= F32_REL_TOL * scale
