"""The port's attention backward vs the JAX package: ``attention_bwd_plain``
and the autograd ``Function`` behind ``flash_attention`` on the CPU against
``jax.vjp`` of ``attention_xla`` and against the Pallas backward kernels in
interpret mode; and, on a GPU, the hand-written CUDA kernels against the
plain version.

Tolerances. fp32 on the CPU: atol 5e-5 / rtol 5e-4 on gradients of size
~0.1-1 (sums over <= 150 keys in another order; the JAX package's own
backward test uses 5e-5 / 5e-5 to 5e-4 / 5e-4). bf16 inputs: relative L2
<= 1e-2 (both sides round qs, P, dS and the outputs to bf16, a relative
step of 2^-9 each). CUDA kernels vs plain: relative L2 <= 1e-2 and max
|error| <= 5e-3 on each of dq, dk, dv, the gates of ``chip_smoke.py``.

JAX is imported inside fixtures so that the CUDA test also runs on a
machine that has no JAX (``python -m pytest --noconftest -m cuda``)."""

import numpy as np
import pytest
import torch

from recondet3d_torch.ops.attention import (
    attention_bwd_plain,
    attention_plain,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_fwd,
    reset_launch_counts,
)

ATOL, RTOL = 5e-5, 5e-4
REL_TOL, ABS_TOL = 1e-2, 5e-3


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from recondet3d.ops import attention as jattn

    return jax, jnp, jattn


def _inputs(B, H, N, M, seed, D=64):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, n, D)).astype(np.float32) for n in (N, M, M))
    g = rng.normal(size=(B, H, N, D)).astype(np.float32)
    return q, k, v, g


def _kv_len(B, M, use):
    return np.array([max(1, M // 2 + 1), M][:B] + [M] * (B - 2), np.int32) if use else None


def _jax_grads(jx, fn, q, k, v, g, kv_len, dtype=None):
    jax, jnp, _ = jx
    dtype = dtype or jnp.float32
    jkv = None if kv_len is None else jnp.asarray(kv_len)
    args = tuple(jnp.asarray(a).astype(dtype) for a in (q, k, v))
    _, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, kv_len=jkv), *args)
    return [np.asarray(x.astype(jnp.float32)) for x in vjp(jnp.asarray(g).astype(dtype))]


def _port_grads(q, k, v, g, kv_len, dtype=torch.float32):
    """(explicit plain formulae, the autograd Function on the CPU)."""
    tq, tk, tv, tg = (torch.from_numpy(a).to(dtype) for a in (q, k, v, g))
    tkv = None if kv_len is None else torch.from_numpy(kv_len)
    out, lse = attention_plain(tq, tk, tv, tkv)
    plain = attention_bwd_plain(tq, tk, tv, out, lse, tg, tkv)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    # the gradient reaches the Function through a transpose, as in the ViT's attention layer
    o = flash_attention(*leaves, kv_len=tkv).transpose(1, 2)
    fn = torch.autograd.grad(o, leaves, tg.transpose(1, 2))
    return [x.float().numpy() for x in plain], [x.float().numpy() for x in fn]


@pytest.mark.parametrize("use_kv_len", [False, True])
@pytest.mark.parametrize("N,M", [(37, 37), (150, 150), (37, 50), (130, 70)])
def test_plain_backward_matches_jax_vjp_of_attention_xla(jx, N, M, use_kv_len):
    q, k, v, g = _inputs(2, 3, N, M, seed=N + M)
    kv_len = _kv_len(2, M, use_kv_len)
    ref = _jax_grads(jx, jx[2].attention_xla, q, k, v, g, kv_len)
    plain, fn = _port_grads(q, k, v, g, kv_len)
    for name, r, a, b in zip(("dq", "dk", "dv"), ref, plain, fn):
        np.testing.assert_allclose(a, r, atol=ATOL, rtol=RTOL, err_msg=name)
        np.testing.assert_allclose(b, r, atol=ATOL, rtol=RTOL, err_msg=name + " (Function)")
    if use_kv_len:  # masked-out keys get exactly zero gradient
        assert np.all(plain[1][0, :, kv_len[0]:] == 0) and np.all(plain[2][0, :, kv_len[0]:] == 0)


@pytest.mark.parametrize("use_kv_len", [False, True])
@pytest.mark.parametrize("N", [37, 150, 200])
def test_plain_backward_matches_pallas_backward_in_interpret_mode(jx, N, use_kv_len):
    """N is no multiple of 64 or of the Pallas blocks: both sides mask their own ragged edge."""
    _, _, jattn = jx
    q, k, v, g = _inputs(2, 2, N, N, seed=100 + N)
    kv_len = _kv_len(2, N, use_kv_len)
    ref = _jax_grads(jx, lambda q, k, v, kv_len: jattn.flash_attention(q, k, v, kv_len=kv_len, impl="pallas"),
                     q, k, v, g, kv_len)
    plain, fn = _port_grads(q, k, v, g, kv_len)
    for name, r, a, b in zip(("dq", "dk", "dv"), ref, plain, fn):
        np.testing.assert_allclose(a, r, atol=ATOL, rtol=RTOL, err_msg=name)
        np.testing.assert_allclose(b, r, atol=ATOL, rtol=RTOL, err_msg=name + " (Function)")


def test_plain_backward_with_bf16_inputs_matches_pallas_bf16(jx):
    """bf16 in, bf16 out on both sides, with the same roundings of qs, P and dS."""
    jax, jnp, jattn = jx
    N = 150
    q, k, v, g = _inputs(2, 2, N, N, seed=7)
    kv_len = _kv_len(2, N, True)
    ref = _jax_grads(jx, lambda q, k, v, kv_len: jattn.flash_attention(q, k, v, kv_len=kv_len, impl="pallas"),
                     q, k, v, g, kv_len, dtype=jnp.bfloat16)
    plain, fn = _port_grads(q, k, v, g, kv_len, dtype=torch.bfloat16)
    for name, r, a, b in zip(("dq", "dk", "dv"), ref, plain, fn):
        for got in (a, b):
            assert np.linalg.norm(got - r) / np.linalg.norm(r) <= REL_TOL, name
        np.testing.assert_array_equal(a, b)  # the Function runs the plain formulae on the CPU


def _very_negative_lse(B, H, N, M, seed):
    """Logits near -150 in every row: lse < -100, where exp(-lse) of a padded
    column overflows fp32 unless the column is masked by a select."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(B, H, 1, 64)).astype(np.float32)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    a = np.sqrt(150.0 * 8.0)  # |q||k| * scale = 150 at scale 1/8
    q = (a * u + 0.3 * rng.normal(size=(B, H, N, 64))).astype(np.float32)
    k = (-a * u + 0.3 * rng.normal(size=(B, H, M, 64))).astype(np.float32)
    v = rng.normal(size=(B, H, M, 64)).astype(np.float32)
    g = rng.normal(size=(B, H, N, 64)).astype(np.float32)
    return q, k, v, g


@pytest.mark.parametrize("use_kv_len", [False, True])
def test_plain_backward_with_lse_below_minus_100(jx, use_kv_len):
    q, k, v, g = _very_negative_lse(2, 2, 37, 50, seed=3)
    kv_len = _kv_len(2, 50, use_kv_len)
    tkv = None if kv_len is None else torch.from_numpy(kv_len)
    _, lse = attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), tkv)
    assert lse.max().item() < -100
    ref = _jax_grads(jx, jx[2].attention_xla, q, k, v, g, kv_len)
    plain, fn = _port_grads(q, k, v, g, kv_len)
    for name, r, a, b in zip(("dq", "dk", "dv"), ref, plain, fn):
        assert np.isfinite(a).all() and np.isfinite(b).all(), name
        # |q|, |k| ~ 35: gradients of size ~10, the tolerance scales with them
        np.testing.assert_allclose(a, r, atol=2e-3, rtol=2e-3, err_msg=name)
        np.testing.assert_allclose(b, r, atol=2e-3, rtol=2e-3, err_msg=name + " (Function)")


def test_cpu_backward_launches_no_kernel_and_cuda_only_wrappers_raise():
    reset_launch_counts()
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(1, 2, 9, 9, seed=0))
    out, lse = flash_attention_fwd(q, k, v)
    dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g)
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    for wrapper in (flash_attention_fwd, flash_attention_bwd_dq, flash_attention_bwd_dkv):
        assert wrapper.launches == 0 and wrapper.launches_by_shape == {}
    delta = (g * out).sum(-1)
    with pytest.raises(ValueError):  # the kernel wrappers never give way to the plain version
        flash_attention_bwd_dq(q, k, v, g, lse, delta)
    with pytest.raises(ValueError):
        flash_attention_bwd_dkv(q, k, v, g, lse, delta)


def test_checkpointed_function_gives_the_same_gradients():
    """Under activation checkpointing the forward runs again and the backward
    reads the lse of that second run, saved by the Function itself."""
    from torch.utils.checkpoint import checkpoint

    q, k, v, g = (torch.from_numpy(a) for a in _inputs(2, 2, 37, 37, seed=5))
    kv = torch.tensor([20, 37])
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(flash_attention(*leaves, kv_len=kv), leaves, g)
    got = torch.autograd.grad(
        checkpoint(lambda a, b, c: flash_attention(a, b, c, kv_len=kv), *leaves, use_reentrant=False), leaves, g)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def _rel_abs(got, ref):
    err = got.float() - ref.float()
    return (torch.linalg.norm(err) / torch.linalg.norm(ref.float())).item(), err.abs().max().item()


# (B, H, N, M, kv_len, scale, loud): N and M across the tiles of the kernels (64-query
# tiles and 64-key warpgroups of dk/dv, 64-row dq blocks), kv_len off every tile
# multiple, a scale that is no power of two; loud: every odd head of the flattened
# B*H has q, k, v 100x larger, so a tile read across heads would show
_CUDA_BWD_CASES = [
    (2, 3, 37, 37, None, None, False),
    (2, 4, 150, 150, [50, 150], None, False),
    (3, 2, 721, 721, None, None, False),
    (2, 2, 200, 333, [111, 333], None, False),
    (2, 2, 333, 200, [66, 200], None, False),
    (1, 2, 4326, 4326, None, None, False),
    (2, 2, 64, 128, None, None, False),
    *[(1, 2, n, n, None, None, True) for n in (1, 17, 63, 64, 65, 127, 128, 129, 192, 721)],
    (2, 3, 65, 129, [1, 129], None, True),
    (2, 2, 129, 721, [127, 257], None, True),
    (3, 2, 192, 721, [63, 65, 600], None, False),
    (2, 2, 721, 721, [255, 721], 0.1, True),
    (2, 2, 17, 200, None, 0.1, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,N,M,kv_len,scale,loud", _CUDA_BWD_CASES)
def test_cuda_backward_kernels_match_plain(B, H, N, M, kv_len, scale, loud):
    """Quiet heads under the gates of chip_smoke.py. A loud head's softmax is
    one-hot, so its dq and dk are rounding noise (dP - delta cancels) and
    only its dv (= dO of the dominant query) is gated, by relative L2. With a
    single key (M = 1) p = 1 and dq, dk are such noise everywhere: only the
    absolute gate holds them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    q, k, v, g = _inputs(B, H, N, M, seed=N + M)
    heads = np.zeros((B, H), bool)
    if loud:
        heads.reshape(-1)[1::2] = True
        for a in (q, k, v):
            a[heads] *= 100.0
    q, k, v, g = (torch.from_numpy(a).cuda().to(torch.bfloat16) for a in (q, k, v, g))
    kvl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32).cuda()
    out, lse = flash_attention_fwd(q, k, v, kvl, scale)
    reset_launch_counts()
    got = flash_attention_bwd(q, k, v, out, lse, g, kvl, scale)
    torch.cuda.synchronize()
    assert flash_attention_bwd_dq.launches == 1 and flash_attention_bwd_dkv.launches == 1
    assert flash_attention_bwd_dq.launches_by_shape == {(B, H, N, M): 1}
    assert flash_attention_bwd_dkv.launches_by_shape == {(B, H, N, M): 1}
    ref = attention_bwd_plain(q, k, v, out, lse, g, kvl, scale)
    quiet, noisy = torch.from_numpy(~heads).cuda(), torch.from_numpy(heads).cuda()
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == torch.bfloat16 and a.shape == r.shape and torch.isfinite(a).all(), name
        rel, mx = _rel_abs(a[quiet], r[quiet])
        assert (rel <= REL_TOL or (M == 1 and name != "dv")) and mx <= ABS_TOL, (name, rel, mx)
        if name == "dv" and loud:
            rel, _ = _rel_abs(a[noisy], r[noisy])
            assert rel <= REL_TOL, (name, "loud heads", rel)
    if kv_len is not None:
        for b, n in enumerate(kv_len):
            assert not got[1][b, :, n:].any() and not got[2][b, :, n:].any()
    again = flash_attention_bwd(q, k, v, out, lse, g, kvl, scale)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics: the same bits every run
    with pytest.raises(ValueError):  # fp16: no kernel takes it (fp32 goes to the CUDA-core kernels)
        flash_attention_bwd(q.half(), k.half(), v.half(), out.half(), lse, g.half())


@pytest.mark.cuda
def test_cuda_backward_kernels_with_lse_below_minus_100():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    q, k, v, g = (torch.from_numpy(a).cuda().to(torch.bfloat16) for a in _very_negative_lse(2, 2, 100, 150, seed=4))
    kv_len = torch.tensor([77, 150], dtype=torch.int32).cuda()
    out, lse = flash_attention_fwd(q, k, v, kv_len)
    assert lse.max().item() < -100
    got = flash_attention_bwd(q, k, v, out, lse, g, kv_len)
    ref = attention_bwd_plain(q, k, v, out, lse, g, kv_len)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert torch.isfinite(a).all(), name
        rel, _ = _rel_abs(a, r)
        assert rel <= REL_TOL, (name, rel)


@pytest.mark.cuda
def test_cuda_function_runs_both_kernels_through_autograd():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    q, k, v, g = (torch.from_numpy(a).cuda().to(torch.bfloat16) for a in _inputs(2, 4, 300, 300, seed=11))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    reset_launch_counts()
    o = flash_attention(*leaves).transpose(1, 2)  # the gradient arrives non-contiguous
    got = torch.autograd.grad(o, leaves, g.transpose(1, 2))
    assert (flash_attention_fwd.launches, flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches) == (1, 1, 1)
    leaves2 = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(flash_attention(*leaves2, impl="plain"), leaves2, g)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        rel, _ = _rel_abs(a, r)
        assert rel <= 2e-2, (name, rel)  # autograd through the plain forward makes no bf16 roundings of P and dS
