"""Attention at every head dim and dtype the Pallas kernels take, forward and
backward: the port's plain backward (what the CPU runs, and what the
CUDA-core kernels of ``csrc/attn_cuda_core.cu`` are held to on the card)
against the JAX package's Pallas backward in interpret mode at D in {20, 24,
32, 96, 128}; ``CameraEnc``'s parameter gradients against ``jax.grad`` of the
JAX module; the dispatch (``kernel_variant``) of device tensors, which never
reaches a plain version; and, on a GPU, the CUDA-core kernels and the B*H >
65535 launches of all the attention kernels against their plain versions.

Tolerances. fp32: relative L2 <= 1e-5 per gradient (fp32 sums of the same
terms in another order; readings ~1e-7). bf16: relative L2 <= 1e-2, the gate
of ``test_plain_backward_with_bf16_inputs_matches_pallas_bf16`` (both sides
round qs, P, dS and the outputs to bf16). CameraEnc gradients: relative L2
<= 1e-5 per leaf. CUDA kernels vs plain: fp32 relative L2 <= 1e-5; bf16
relative L2 <= 1e-2 and |error| <= 5e-3 * max(1, |value|) elementwise
(``chip_smoke.py``'s bf16 gates, the absolute one scaled where a value
exceeds 1: a bf16 output carries a rounding of up to 2^-9 of itself). At
B*H = 65,552 the worst head's relative L2 (gradients against the head's
largest gradient norm) to the same relative gates.

JAX is imported inside fixtures so that the CUDA tests also run on a machine
that has no JAX (``python -m pytest --noconftest -m cuda``)."""

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
    reset_launch_counts,
)

F32_REL, BF16_REL, BF16_ABS = 1e-5, 1e-2, 5e-3
HEAD_DIMS = [24, 32, 96, 128, 20]


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


def _pallas_grads(jx, q, k, v, g, kv_len, dtype):
    jax, jnp, jattn = jx
    jkv = None if kv_len is None else jnp.asarray(kv_len)
    args = tuple(jnp.asarray(a).astype(dtype) for a in (q, k, v))
    _, vjp = jax.vjp(lambda q, k, v: jattn.flash_attention(q, k, v, kv_len=jkv, impl="pallas"), *args)
    return [np.asarray(x.astype(jnp.float32)) for x in vjp(jnp.asarray(g).astype(dtype))]


def _port_grads(q, k, v, g, kv_len, dtype):
    """(explicit plain formulae, the autograd Function on the CPU)."""
    tq, tk, tv, tg = (torch.from_numpy(a).to(dtype) for a in (q, k, v, g))
    tkv = None if kv_len is None else torch.from_numpy(kv_len)
    out, lse = attention_plain(tq, tk, tv, tkv)
    plain = attention_bwd_plain(tq, tk, tv, out, lse, tg, tkv)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    fn = torch.autograd.grad(flash_attention(*leaves, kv_len=tkv), leaves, tg)
    return [x.float().numpy() for x in plain], [x.float().numpy() for x in fn]


@pytest.mark.parametrize("use_kv_len", [False, True])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_fp32_backward_matches_pallas_at_any_head_dim(jx, D, use_kv_len):
    q, k, v, g = _inputs((2, 2, 37, D), 45, seed=D)
    kv_len = np.array([23, 45], np.int32) if use_kv_len else None
    ref = _pallas_grads(jx, q, k, v, g, kv_len, jx[1].float32)
    plain, fn = _port_grads(q, k, v, g, kv_len, torch.float32)
    for name, r, a, b in zip(("dq", "dk", "dv"), ref, plain, fn):
        assert rel_l2(a, r) <= F32_REL, name
        np.testing.assert_array_equal(a, b)  # the Function runs the plain formulae on the CPU
    if use_kv_len:  # masked-out keys get exactly zero gradient on both sides
        assert np.all(plain[1][0, :, 23:] == 0) and np.all(ref[1][0, :, 23:] == 0)


@pytest.mark.parametrize("use_kv_len", [False, True])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_bf16_backward_matches_pallas_bf16_at_any_head_dim(jx, D, use_kv_len):
    q, k, v, g = _inputs((2, 2, 40, D), 40, seed=50 + D)
    kv_len = np.array([21, 40], np.int32) if use_kv_len else None
    ref = _pallas_grads(jx, q, k, v, g, kv_len, jx[1].bfloat16)
    plain, fn = _port_grads(q, k, v, g, kv_len, torch.bfloat16)
    for name, r, a, b in zip(("dq", "dk", "dv"), ref, plain, fn):
        assert rel_l2(a, r) <= BF16_REL, name
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dim_out", [384, 1024])  # 16 heads of 24 (da3-small) and of 64 (da3-large)
def test_camera_encoder_gradients_match_jax(jx, dim_out):
    """The GT-pose path's backward: ``CameraEnc``'s fp32 trunk attention
    differentiated in both packages, every parameter's gradient compared."""
    jax, jnp, _ = jx
    from recondet3d.api.weights import _flatten
    from recondet3d_torch.api.weights import flax_from_named
    from test_torch_cam_enc import _JWrap, _TWrap
    from test_torch_da3_net import _poses
    from test_torch_weights import load_into_port, random_flax_params

    ext, ixt = _poses(2, 6, seed=dim_out + 7)
    w = np.random.default_rng(dim_out).normal(size=(2, 6, dim_out)).astype(np.float32)
    jw = _JWrap(dim_out)
    params = random_flax_params(jax.eval_shape(jw.init, jax.random.PRNGKey(0), jnp.asarray(ext), jnp.asarray(ixt)),
                                seed=dim_out + 2)
    jgrads = jax.grad(lambda p: jnp.sum(jw.apply(p, jnp.asarray(ext), jnp.asarray(ixt)) * w))(params)
    tw = load_into_port(_TWrap(dim_out), params)
    (tw(torch.from_numpy(ext), torch.from_numpy(ixt)) * torch.from_numpy(w)).sum().backward()
    jflat = _flatten(jgrads)
    got = flax_from_named({n: p.grad for n, p in tw.named_parameters()}, jflat)
    assert set(got) == set(jflat) and len(got) > 10
    for path, ref in jflat.items():
        assert rel_l2(got[path], ref) <= F32_REL, path


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 64), (torch.float32, 24), (torch.bfloat16, 96),
                                     (torch.float32, 264), (torch.float16, 64)])
def test_device_tensors_never_reach_a_plain_version(monkeypatch, dtype, D):
    """A meta tensor stands for a device tensor: forward and backward go to
    a kernel wrapper, which raises on a tensor that is not on CUDA (or on a
    dtype / D that no kernel takes), and never to the plain versions."""

    def refuse(*_a, **_k):
        raise AssertionError("a device tensor reached a plain version")

    monkeypatch.setattr(tattn, "attention_plain", refuse)
    monkeypatch.setattr(tattn, "attention_bwd_plain", refuse)
    q = torch.empty(2, 4, 8, D, device="meta", dtype=dtype)
    lse = torch.empty(2, 4, 8, device="meta")
    for call in (lambda: flash_attention(q, q, q), lambda: tattn.attention_fwd(q, q, q),
                 lambda: flash_attention_bwd(q, q, q, q, lse, q)):
        with pytest.raises(ValueError):
            call()


# ---------------------------------------------------------------- on the card

def _cuda_inputs(shape_q, M, seed, dtype):
    return [torch.from_numpy(a).cuda().to(dtype) for a in _inputs(shape_q, M, seed)]


def _gate(got, ref, dtype):
    """(within the gate, relative L2, largest |error| / max(1, |value|))."""
    got, ref = got.float(), ref.float()
    rel = (torch.linalg.norm(got - ref) / torch.linalg.norm(ref)).item()
    scaled = ((got - ref).abs() / ref.abs().clamp(min=1.0)).max().item()
    if dtype == torch.float32:
        return rel <= F32_REL, rel, scaled
    return rel <= BF16_REL and scaled <= BF16_ABS, rel, scaled


@pytest.mark.cuda
@pytest.mark.parametrize("use_kv_len", [False, True])
@pytest.mark.parametrize("dtype,D", [(torch.float32, d) for d in (1, 20, 24, 64, 96, 128, 256)]
                         + [(torch.bfloat16, d) for d in (20, 32, 96, 128, 256)])
def test_cuda_core_kernels_match_plain(dtype, D, use_kv_len):
    """Forward, dq and dk/dv against the plain versions on the same inputs,
    through the dispatcher and autograd; same bits run to run. fp32 runs all
    three on the CUDA cores and never a wgmma kernel; bf16 runs its dq there
    (and dk/dv at D > 128), its forward and its dk/dv at D <= 128 on the
    wgmma kernels (tests/test_torch_attention_wgmma_any_d.py holds those at
    more shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    B, H, N, M = 2, 3, 77, 140
    q, k, v, g = _cuda_inputs((B, H, N, D), M, seed=D, dtype=dtype)
    kvl = torch.tensor([61, M], dtype=torch.int32, device="cuda") if use_kv_len else None
    reset_launch_counts()
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    out = flash_attention(*leaves, kv_len=kvl)
    grads = torch.autograd.grad(out, leaves, g)
    again = torch.autograd.grad(flash_attention(*leaves, kv_len=kvl), leaves, g)
    torch.cuda.synchronize()
    key = (B, H, N, M, D)
    wgmma = {kind: tattn.kernel_variant(dtype, D, kind) == "wgmma" for kind in ("fwd", "dq", "dkv")}
    for kind, on_cores, on_wgmma in (("fwd", attention_fwd_cuda_core, flash_attention_fwd),
                                     ("dq", attention_bwd_dq_cuda_core, flash_attention_bwd_dq),
                                     ("dkv", attention_bwd_dkv_cuda_core, flash_attention_bwd_dkv)):
        assert on_wgmma.launches_by_shape == ({key: 2} if wgmma[kind] else {}), kind
        assert on_cores.launches_by_shape == ({} if wgmma[kind] else {key: 2}), kind
    assert dtype == torch.bfloat16 or not any(wgmma.values())
    ref_out, ref_lse = attention_plain(q, k, v, kvl)
    if dtype == torch.bfloat16:  # the kernels' scores: bf16(q * scale) k^T
        qs = (q.float() * D ** -0.5).to(dtype)
        ref_out = attention_plain(qs.float(), k.float(), v.float(), kvl, 1.0)[0]
    gate = _gate(out, ref_out, dtype)
    assert gate[0], gate
    _, lse = tattn.attention_fwd(q, k, v, kvl)
    ref = attention_bwd_plain(q, k, v, out.detach(), lse, g, kvl)
    for name, a, r, b in zip(("dq", "dk", "dv"), grads, ref, again):
        gate = _gate(a, r, dtype)
        assert torch.isfinite(a).all() and gate[0] and torch.equal(a, b), (name, gate)


# (B, H, N, D) with B * H = 65,552 > 65,535, the most grid.y takes
_MANY_HEADS = [("wgmma", (4097, 16, 64, 64), torch.bfloat16), ("cuda_core", (4097, 16, 6, 24), torch.float32)]


def _worst_head(got, ref, scale=None):
    """The largest relative L2 error of one head, against its own ``scale``
    (default: the reference head's norm): over 65,552 heads a wrong head
    cannot hide in a global norm, and an elementwise gate would trip on one
    bf16 rounding of a rare value above 1 (2^-7 there)."""
    err = torch.linalg.vector_norm((got.float() - ref.float()).flatten(2), dim=-1)
    return (err / (torch.linalg.vector_norm(ref.float().flatten(2), dim=-1) if scale is None else scale)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("variant,shape,dtype", _MANY_HEADS)
def test_cuda_kernels_take_more_than_65535_heads(variant, shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    B, H, N, D = shape
    q, k, v, g = _cuda_inputs(shape, N, seed=3, dtype=dtype)
    reset_launch_counts()
    fwd = flash_attention_fwd if variant == "wgmma" else attention_fwd_cuda_core
    out, lse = fwd(q, k, v)
    got = flash_attention_bwd(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    assert fwd.launches == 1
    ref_out = attention_plain(q, k, v)[0]
    if dtype == torch.bfloat16:
        qs = (q.float() * D ** -0.5).to(dtype)
        ref_out = attention_plain(qs.float(), k.float(), v.float(), None, 1.0)[0]
    tol = F32_REL if dtype == torch.float32 else BF16_REL
    assert _worst_head(out, ref_out) <= tol
    ref = attention_bwd_plain(q, k, v, out, lse, g)
    scale = torch.stack([torch.linalg.vector_norm(r.float().flatten(2), dim=-1) for r in ref]).amax(0)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        err = _worst_head(a, r, scale)
        assert err <= tol, (name, err)
