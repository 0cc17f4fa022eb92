"""Port attention vs the JAX package: the plain flash forward (out and lse)
against the Pallas kernel in interpret mode and against ``attention_xla``;
and, on a GPU, the hand-written CUDA kernel against the plain version.

JAX is imported inside fixtures so that the CUDA test also runs on a
machine that has no JAX (``python -m pytest --noconftest -m cuda``)."""

import numpy as np
import pytest
import torch

from recondet3d_torch.ops.attention import (
    attention_plain,
    flash_attention,
    flash_attention_fwd,
    multi_head_attention,
    reset_launch_counts,
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


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,H,N,M,use_kv_len",
    [(2, 3, 37, 37, False), (2, 4, 150, 150, True), (3, 2, 721, 721, False),
     (2, 2, 200, 333, True), (1, 2, 4326, 4326, False)],
)
def test_cuda_kernel_matches_plain(B, H, N, M, use_kv_len):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    q, k, v = (torch.from_numpy(a).cuda().to(torch.bfloat16) for a in _qkv(B, H, N, M, seed=N + M))
    kv_len = None if not use_kv_len else torch.tensor([max(1, M // 3), M][:B] + [M] * (B - 2), dtype=torch.int32).cuda()
    reset_launch_counts()
    out, lse = flash_attention_fwd(q, k, v, kv_len)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == 1
    assert flash_attention_fwd.launches_by_shape == {(B, H, N, M): 1}
    ref_out, ref_lse = attention_plain(q.float(), k.float(), v.float(), kv_len)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    err = out.float() - ref_out
    assert err.abs().max().item() <= OUT_TOL
    assert (torch.linalg.norm(err) / torch.linalg.norm(ref_out)).item() <= OUT_REL_TOL
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL
    with pytest.raises(ValueError):
        flash_attention_fwd(q.float(), k.float(), v.float())
