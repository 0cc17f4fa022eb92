"""GT-pose conditioning differentiated end to end: the da3-small net of both
packages, with shared random weights and GT poses, one scalar of its depth
map, and the gradients of the camera encoder's parameters (whose fp32 trunk
attention runs ``attention_bwd_plain`` here and the CUDA-core dq and dk/dv
kernels on the card) and of the patch embedding (the first layer, which the
gradient reaches through every ViT block) compared leaf by leaf.

Tolerance: relative L2 <= 1e-4 per leaf. Both sides compute in fp32; the
gradient of a 12-block net sums terms in another order at every layer."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from recondet3d.api.weights import _flatten
from recondet3d.models.da3 import build_da3 as j_build
from recondet3d_torch.api.weights import flax_from_named
from recondet3d_torch.models.da3 import build_da3
from test_torch_da3_net import _init_pair, _poses

REL_TOL = 1e-4


def test_small_net_pose_gradients_match_jax():
    jnet = j_build("da3-small", dtype=jnp.float32, attn_impl="xla")
    params, tnet = _init_pair(jnet, build_da3("da3-small", dtype=torch.float32, device="cpu"), (1, 2, 28, 28, 3),
                              seed=30)
    rng = np.random.default_rng(31)
    x = rng.normal(size=(1, 2, 28, 42, 3)).astype(np.float32)
    w = rng.normal(size=(1, 2, 28, 42)).astype(np.float32)
    ext, ixt = _poses(1, 2, 32)

    def jloss(p):
        out = jnet.apply(p, jnp.asarray(x), jnp.asarray(ext), jnp.asarray(ixt))
        return jnp.sum(jnp.log(out["depth"]) * w)

    jgrads = _flatten(jax.jit(jax.grad(jloss))(params))
    out = tnet(torch.from_numpy(x), torch.from_numpy(ext), torch.from_numpy(ixt))
    (torch.log(out["depth"]) * torch.from_numpy(w)).sum().backward()
    probes = {p: g for p, g in jgrads.items() if "/cam_enc/" in p or "/patch_embed/" in p}
    assert sum("/cam_enc/" in p for p in probes) > 10 and sum("/patch_embed/" in p for p in probes) == 2
    got = flax_from_named({n: p.grad for n, p in tnet.named_parameters()}, probes)
    assert set(got) == set(probes)
    for path, ref in probes.items():
        err = np.linalg.norm(got[path] - ref) / np.linalg.norm(ref)
        assert err <= REL_TOL, (path, err)
