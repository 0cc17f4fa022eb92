"""GT-pose conditioning in the port vs the JAX package, fp32 on the CPU:
``CameraEnc`` at the small and large head dims (dim_out 384 and 1024, so 16
heads of D = 24 and 64) with shared numpy-made weights; the fp32 attention
it runs against the Pallas kernel in interpret mode at the camera encoder's
head dims; and the dispatch rules of ``flash_attention`` for fp32 inputs
(the plain version on CPU tensors, the CUDA-core kernels on CUDA tensors of
a head dim up to 256, forward and backward, a raise for anything else).

Tolerance: 1e-4 absolute and relative. Both sides compute in fp32; the
readings are ~4e-6 on outputs of size ~4 (sums in another order)."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recondet3d.models.da3.cam import CameraEnc as JCameraEnc
from recondet3d.ops import attention as jattn
from recondet3d_torch.models.da3.cam import CameraEnc
from recondet3d_torch.ops.attention import (
    attention_fwd_cuda_core,
    attention_plain,
    flash_attention,
    flash_attention_fwd,
    kernel_variant,
    reset_launch_counts,
)
from test_torch_da3_net import _poses
from test_torch_weights import load_into_port, random_flax_params, to_np

ATOL, RTOL = 1e-4, 1e-4
IMAGE_HW = (28, 42)


class _JWrap(nn.Module):
    dim_out: int

    @nn.compact
    def __call__(self, ext, ixt):
        return JCameraEnc(dim_out=self.dim_out, name="cam_enc")(ext, ixt, IMAGE_HW)


class _TWrap(torch.nn.Module):
    def __init__(self, dim_out):
        super().__init__()
        self.cam_enc = CameraEnc(dim_out=dim_out, device="cpu")

    def forward(self, ext, ixt):
        return self.cam_enc(ext, ixt, IMAGE_HW)


@pytest.mark.parametrize("dim_out", [384, 1024])  # head dim 24 (da3-small), 64 (da3-large)
def test_camera_encoder_matches_jax(dim_out):
    ext, ixt = _poses(2, 6, seed=dim_out)
    jw = _JWrap(dim_out)
    params = random_flax_params(jax.eval_shape(jw.init, jax.random.PRNGKey(0), jnp.asarray(ext), jnp.asarray(ixt)),
                                seed=dim_out + 1)
    tw = load_into_port(_TWrap(dim_out), params)
    assert tw.cam_enc.trunk[0].attn.num_heads == 16
    ref = jw.apply(params, jnp.asarray(ext), jnp.asarray(ixt))
    reset_launch_counts()
    with torch.no_grad():
        got = tw(torch.from_numpy(ext), torch.from_numpy(ixt))
    assert attention_fwd_cuda_core.launches == 0 and flash_attention_fwd.launches == 0
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 6, dim_out)
    np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("use_kv_len", [False, True])
@pytest.mark.parametrize("D,S", [(24, 6), (48, 6), (96, 6), (24, 37)])
def test_fp32_attention_matches_pallas_interpret(D, S, use_kv_len):
    """The camera encoder's attention: (B, 16, S, D) fp32, the port's fp32
    path against the JAX package's Pallas kernel run in interpret mode."""
    rng = np.random.default_rng(D * 100 + S)
    q, k, v = (rng.normal(size=(2, 16, S, D)).astype(np.float32) for _ in range(3))
    kv_len = np.array([max(1, S // 2), S], np.int32) if use_kv_len else None
    ref = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                kv_len=None if kv_len is None else jnp.asarray(kv_len), impl="pallas")
    t = torch.from_numpy
    out, lse = attention_fwd_cuda_core(t(q), t(k), t(v), None if kv_len is None else t(kv_len))
    assert out.dtype == torch.float32 and lse.shape == (2, 16, S)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    got = flash_attention(t(q), t(k), t(v), kv_len=None if kv_len is None else t(kv_len))
    assert torch.equal(got, out)


def test_fp32_dispatch_on_cpu_runs_the_plain_version_and_launches_nothing():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 16, 6, 96)).astype(np.float32)) for _ in range(3))
    reset_launch_counts()
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    out = flash_attention(*leaves)
    assert torch.equal(out, attention_plain(q, k, v)[0])
    out.sum().backward()  # the CPU backward is the plain one, fp32 included
    assert all(a.grad is not None and torch.isfinite(a.grad).all() for a in leaves)
    assert attention_fwd_cuda_core.launches == 0 and attention_fwd_cuda_core.launches_by_shape == {}
    assert flash_attention_fwd.launches == 0


@pytest.mark.parametrize("dtype,D,variant", [
    (torch.bfloat16, 64, ("wgmma", "wgmma", "wgmma")),
    *[(torch.float32, d, ("cuda_core",) * 3) for d in (8, 24, 48, 64, 96, 128)],
    # the CUDA-core family holds fp32 at any D up to 256; bf16 runs the wgmma forward at any D up to 256, the wgmma
    # dk/dv up to 128 and the wgmma dq at 64 only
    (torch.float32, 20, ("cuda_core",) * 3), (torch.float32, 136, ("cuda_core",) * 3),
    (torch.float32, 4, ("cuda_core",) * 3),
    (torch.bfloat16, 96, ("wgmma", "cuda_core", "wgmma")),
    *[(torch.float32, d, ("cuda_core",) * 3) for d in (1, 256)],
    *[(torch.bfloat16, d, ("wgmma", "cuda_core", "wgmma")) for d in (1, 20, 32, 63, 65, 128)],
    *[(torch.bfloat16, d, ("wgmma", "cuda_core", "cuda_core")) for d in (129, 256)],
])
def test_kernel_variant_takes(dtype, D, variant):
    assert tuple(kernel_variant(dtype, D, kernel) for kernel in ("fwd", "dq", "dkv")) == variant


@pytest.mark.parametrize("dtype,D", [(torch.float16, 64), (torch.float64, 64), (torch.float32, 264),
                                     (torch.bfloat16, 264), (torch.float32, 0), (torch.float16, 32)])
def test_kernel_variant_raises(dtype, D):
    for kernel in ("fwd", "dq", "dkv"):
        with pytest.raises(ValueError, match="no attention kernel"):
            kernel_variant(dtype, D, kernel)


def test_fp32_kernel_wrapper_refuses_what_it_does_not_take():
    """Off the CPU the wrapper launches or raises, never the plain version:
    a meta tensor stands for a device tensor here (it is no CUDA tensor, so
    the wrapper raises before any launch)."""
    q = torch.empty(2, 16, 6, 20, device="meta")
    with pytest.raises(ValueError):
        attention_fwd_cuda_core(q, q, q)
    q = torch.empty(2, 16, 6, 24, device="meta", dtype=torch.float16)
    with pytest.raises(ValueError):
        attention_fwd_cuda_core(q, q, q)
    for dtype in (torch.float32, torch.bfloat16):  # D > 256: the wrapper and the dispatcher raise
        q = torch.empty(2, 16, 6, 264, device="meta", dtype=dtype)
        with pytest.raises(ValueError):
            attention_fwd_cuda_core(q, q, q)
        with pytest.raises(ValueError, match="no attention kernel"):
            flash_attention(q, q, q)
