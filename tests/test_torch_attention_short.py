"""The fp32 attention of short sequences (N, M <= 32: ``CameraEnc``'s trunk)
on its own route: ``attention_fwd_short`` (one launch of
``cc_short_fwd_kernel``) and ``attention_bwd_short`` (dq, dk and dv in one
launch of ``cc_short_bwd_kernel``).

On the CPU: the wrappers on the strided views the qkv split hands over,
their (B, N, H, D) output layout and the gradient as it comes back through
the output projection's reshape, against the JAX package's Pallas forward
and backward in interpret mode at (2, 16, 6, 96) and (1, 16, 32, 24); the
refusals, on meta tensors, which stand for device tensors and meet every
check but the device's; ``flash_attention`` handing the short route its
views (the routing itself: ``test_torch_cam_enc.py``,
``test_torch_attention_wgmma_any_d.py``).

On a GPU (``-m cuda``): both kernels against the plain versions through
``flash_attention`` and autograd, on the qkv split's views, at N = M in {1,
6, 32} x D in {24, 48, 64, 96, 256}, with ``kv_len`` and at scale 0.1, one
launch of each a call and none of the tiled kernels, the same bits run to
run.

Tolerances (fp32 on both sides, sums in another order): against Pallas the
forward within 1e-4 absolute and relative (``test_torch_cam_enc.py``'s), the
gradients to relative L2 <= 1e-5 (``test_torch_attention_any_d.py``'s);
against the plain versions on the card relative L2 <= 1e-5, |lse error| <=
1e-5, the gradients against the call's largest gradient norm (with few keys
dq and dk can be rounding noise of dP - delta, which cancels): the gates of
``chip_smoke.py`` phase 11b.

JAX is imported inside a fixture, so the CUDA cases run where there is no
JAX (``python -m pytest --noconftest -m cuda``)."""

import numpy as np
import pytest
import torch

from recondet3d_torch.ops import attention as tattn
from recondet3d_torch.ops.attention import (
    attention_bwd_short,
    attention_bwd_plain,
    attention_fwd_short,
    attention_plain,
    flash_attention,
    reset_launch_counts,
)

ATOL, RTOL, F32_REL, LSE_TOL = 1e-4, 1e-4, 1e-5, 1e-5


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


def qkv_views(B, H, N, D, seed, device="cpu"):
    """q, k, v as ``layers.Attention`` hands them over: views of one (B, N,
    3, H, D) projection, strided in B, H and N; and dout as the gradient of
    ``o.transpose(1, 2).reshape(B, N, H * D)`` reaches the attention."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((B, N, 3 * H * D), dtype=np.float32)).to(device)
    q, k, v = qkv.reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0)
    g = torch.from_numpy(rng.standard_normal((B, N, H * D), dtype=np.float32)).to(device)
    return q, k, v, g.view(B, N, H, D).transpose(1, 2)


# ---------------------------------------------------------------- on the CPU

SHAPES = [(2, 16, 6, 96), (1, 16, 32, 24)]


@pytest.mark.parametrize("use_kv_len", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_strided_short_route_matches_pallas(jx, shape, use_kv_len):
    jax, jnp, jattn = jx
    B, H, N, D = shape
    q, k, v, g = qkv_views(B, H, N, D, seed=N * D)
    assert not q.is_contiguous() and q.stride(-1) == 1 and not g.is_contiguous()
    kv_len = torch.tensor([max(1, N // 2), N][:B], dtype=torch.int32) if use_kv_len else None
    jkv = None if kv_len is None else jnp.asarray(kv_len.numpy())
    args = [jnp.asarray(t.contiguous().numpy()) for t in (q, k, v)]
    ref, vjp = jax.vjp(lambda q, k, v: jattn.flash_attention(q, k, v, kv_len=jkv, impl="pallas"), *args)
    ref_grads = vjp(jnp.asarray(g.contiguous().numpy()))

    out, lse = attention_fwd_short(q, k, v, kv_len)
    # the (B, N, H, D) layout: the output projection's reshape is a view of the kernel's buffer
    flat = out.transpose(1, 2).reshape(B, N, H * D)
    assert out.shape == (B, H, N, D) and out.transpose(1, 2).is_contiguous() and flat.data_ptr() == out.data_ptr()
    assert flat._base is not None and lse.shape == (B, H, N)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    grads = attention_bwd_short(q, k, v, out, lse, g, kv_len)
    for name, a, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        assert a.shape == r.shape and rel_l2(a.numpy(), r) <= F32_REL, name


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, device="meta", dtype=dtype)


def test_short_wrappers_refuse_what_they_do_not_take(monkeypatch):
    """A meta tensor stands for a device tensor: every wrong input raises
    (each check named by its message), the device's check last, and no
    tensor reaches a plain version or counts as a launch."""

    def refuse(*_a, **_k):
        raise AssertionError("a device tensor reached a plain version")

    monkeypatch.setattr(tattn, "attention_plain", refuse)
    monkeypatch.setattr(tattn, "attention_bwd_plain", refuse)
    reset_launch_counts()
    q, lse = _meta((2, 16, 6, 96)), _meta((2, 16, 6))
    cases = [
        ("fp32", (_meta((2, 16, 6, 96), torch.float16), q, q)),
        ("fp32", (_meta((2, 16, 6)), q, q)),
        ("shape mismatch", (q, _meta((2, 16, 6, 64)), q)),
        ("N and M from 1 to 32", (_meta((2, 16, 33, 96)), _meta((2, 16, 6, 96)), _meta((2, 16, 6, 96)))),
        ("N and M from 1 to 32", (q, _meta((2, 16, 33, 96)), _meta((2, 16, 33, 96)))),
        ("N and M from 1 to 32", (_meta((2, 16, 6, 264)),) * 3),
        ("unit stride along D", (_meta((2, 16, 96, 6)).transpose(2, 3), q, q)),
        ("not on one CUDA device", (q, q, q)),
    ]
    for match, (a, b, c) in cases:
        with pytest.raises(ValueError, match=match):
            attention_fwd_short(a, b, c)
        with pytest.raises(ValueError, match=match):
            attention_bwd_short(a, b, c, a, lse, a)
    with pytest.raises(ValueError, match="kv_len"):
        attention_fwd_short(q, q, q, kv_len=_meta((3,), torch.int32))
    with pytest.raises(ValueError, match="out and dout"):
        attention_bwd_short(q, q, q, _meta((2, 16, 6, 64)), lse, q)
    with pytest.raises(ValueError, match="lse"):
        attention_bwd_short(q, q, q, q, _meta((2, 16, 7)), q)
    assert all(w.launches == 0 for w in tattn._KERNEL_WRAPPERS)


def test_flash_attention_hands_the_short_route_its_views(monkeypatch):
    """``flash_attention`` copies q, k and v only for the kernels that need
    contiguous inputs: fp32 device tensors of at most 32 rows (meta tensors
    stand for them) reach ``attention_fwd_short`` as the qkv split's views,
    longer ones the tiled kernel's wrapper as contiguous copies."""
    seen = {}

    def record(name):
        def wrapper(q, k, v, kv_len=None, scale=None):
            seen[name] = (q, k, v)
            raise ValueError("recorded")
        return wrapper

    monkeypatch.setattr(tattn, "attention_fwd_short", record("short"))
    monkeypatch.setattr(tattn, "attention_fwd_cuda_core", record("cuda_core"))
    for N, route in ((6, "short"), (33, "cuda_core")):
        qkv = torch.empty((1, N, 3 * 4 * 8), device="meta")
        views = qkv.reshape(1, N, 3, 4, 8).permute(2, 0, 3, 1, 4).unbind(0)
        with pytest.raises(ValueError, match="recorded"):
            flash_attention(*views)
        got = seen[route]
        assert all(a.shape == b.shape for a, b in zip(got, views))
        if route == "short":
            assert all(a.stride() == b.stride() and not a.is_contiguous() for a, b in zip(got, views))
        else:
            assert all(a.is_contiguous() for a in got)


# ---------------------------------------------------------------- on the card

def _gate(got, ref, scale=None):
    err = torch.linalg.norm(got.float() - ref.float())
    return (err / (torch.linalg.norm(ref.float()) if scale is None else scale)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["plain", "kv_len", "scale_0.1"])
@pytest.mark.parametrize("D", [24, 48, 64, 96, 256])
@pytest.mark.parametrize("N", [1, 6, 32])
def test_short_kernels_match_plain(N, D, case):
    """Forward and fused backward through ``flash_attention`` and autograd on
    the qkv split's views: one launch of each, none of the tiled kernels,
    the plain versions' values, the same bits run to run, the (B, N, H, D)
    output."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    B, H = 2, 16
    q, k, v, g = qkv_views(B, H, N, D, seed=100 * N + D, device="cuda")
    kvl = torch.tensor([max(1, N // 2), N], dtype=torch.int32, device="cuda") if case == "kv_len" else None
    scale = 0.1 if case == "scale_0.1" else None
    reset_launch_counts()
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, kv_len=kvl, scale=scale)
    grads = torch.autograd.grad(out, leaves, g)
    out2 = flash_attention(*leaves, kv_len=kvl, scale=scale)
    again = torch.autograd.grad(out2, leaves, g)
    torch.cuda.synchronize()
    key = (B, H, N, N, D)
    assert attention_fwd_short.launches_by_shape == {key: 2} and attention_bwd_short.launches_by_shape == {key: 2}
    assert sum(w.launches for w in tattn._KERNEL_WRAPPERS) == 4
    assert out.transpose(1, 2).is_contiguous()
    ref_out, ref_lse = attention_plain(q, k, v, kvl, scale)
    _, lse = attention_fwd_short(q, k, v, kvl, scale)
    assert _gate(out, ref_out) <= F32_REL and (lse - ref_lse).abs().max().item() <= LSE_TOL
    ref = attention_bwd_plain(q, k, v, out.detach(), lse, g, kvl, scale)
    gscale = max(torch.linalg.norm(r) for r in ref)
    for name, a, r, b in zip(("dq", "dk", "dv"), grads, ref, again):
        assert torch.isfinite(a).all() and _gate(a, r, gscale) <= F32_REL and torch.equal(a, b), name
    assert torch.equal(out, out2)
