"""Ray-based pose recovery and pose alignment, port vs JAX package, on the CPU.

- ``ray_utils.camray_to_caminfo`` on ray fields synthesised from known
  cameras (tests/test_ray_utils.py's model), with noise and random
  confidences, handed the JAX package's RANSAC minimal sets: R, T, focal and
  principal point within 1e-5 of the JAX package's (fp32 roundings of the
  same arithmetic).
- On rays with 15 % outliers at low confidence (tests/test_ray_utils.py),
  where the consensus is unambiguous, the port's own draw (a
  ``torch.Generator`` seeded with 42) and the JAX package's draw recover the
  same camera: within 2e-2 of the truth, as the JAX test holds it.
- ``get_extrinsic_from_camray``'s layout; the net's ``use_ray_pose`` branch
  against the JAX package's with shared weights.
- ``pose_align``: the numpy functions give the JAX package's arrays exactly
  (the same code, the same ``default_rng`` draws); ``batch_umeyama_pose_scales``
  in PyTorch within 1e-5 of the jnp version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recondet3d.models.da3 import build_da3 as j_build
from recondet3d.utils import pose_align as jpa
from recondet3d.utils.ray_utils import camray_to_caminfo as j_caminfo
from recondet3d_torch.models.da3 import build_da3
from recondet3d_torch.utils import pose_align as tpa
from recondet3d_torch.utils import ray_utils
from test_ray_utils import _make_camrays, _rot
from test_torch_da3_api import jax_minimal_sets
from test_torch_weights import load_into_port, random_flax_params


def _scene(seed):
    rng = np.random.default_rng(seed)
    rays = np.concatenate([_make_camrays(_rot([0.3, 1.0, 0.2], t), (0.8 + 0.1 * i, 1.1), (1.05, 0.95 - 0.02 * i),
                                         np.array([0.3, -0.2, 1.4 + i])) for i, t in enumerate((0.0, 0.2, -0.35))], 1)
    rays = rays + rng.normal(scale=0.02, size=rays.shape).astype(np.float32)
    conf = rng.uniform(0.5, 2.0, size=rays.shape[:-1]).astype(np.float32)
    return rays, conf


def test_caminfo_matches_jax_with_its_minimal_sets():
    rays, conf = _scene(0)
    want = j_caminfo(jnp.asarray(rays), jnp.asarray(conf))
    sets = jax_minimal_sets(3, rays.shape[2] * rays.shape[3])
    got = ray_utils.camray_to_caminfo(torch.from_numpy(rays), torch.from_numpy(conf), minimal_sets=sets)
    for name, g, w in zip(("R", "T", "focal", "pp"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, err_msg=name)


def _outlier_rays():
    R = _rot([0, 0, 1.0], 0.3)
    rays = _make_camrays(R, (1.0, 1.0), (1.0, 1.0), np.zeros(3))
    rng = np.random.default_rng(0)
    n = rays.shape[2] * rays.shape[3]
    conf = np.ones((1, 1, rays.shape[2], rays.shape[3]), np.float32)
    idx = rng.choice(n, n * 15 // 100, replace=False)
    flat = rays.reshape(1, 1, -1, 6)
    flat[0, 0, idx, :3] += rng.normal(scale=2.0, size=(len(idx), 3))
    conf.reshape(1, 1, -1)[0, 0, idx] = 0.2
    return R, rays, conf


def test_ransac_rejects_outliers_with_either_draw():
    R, rays, conf = _outlier_rays()
    j_R = np.asarray(j_caminfo(jnp.asarray(rays), jnp.asarray(conf))[0])[0, 0]
    own = ray_utils.camray_to_caminfo(torch.from_numpy(rays), torch.from_numpy(conf))
    jsets = ray_utils.camray_to_caminfo(torch.from_numpy(rays), torch.from_numpy(conf),
                                        minimal_sets=jax_minimal_sets(1, rays.shape[2] * rays.shape[3]))
    for got in (own[0].numpy()[0, 0], jsets[0].numpy()[0, 0], j_R):
        np.testing.assert_allclose(got, R, atol=2e-2)
    np.testing.assert_allclose(jsets[0].numpy()[0, 0], j_R, atol=1e-5)
    # the default draw is the torch generator's, seeded with 42
    a, b = ray_utils.draw_minimal_sets(2, 768), ray_utils.draw_minimal_sets(2, 768)
    assert torch.equal(a, b) and a.shape == (2, ray_utils.N_ITER, ray_utils.N_MINIMAL)
    assert all(len(set(row.tolist())) == ray_utils.N_MINIMAL for row in a.reshape(-1, ray_utils.N_MINIMAL))


def test_minimal_sets_are_drawn_once():
    """The default sets are kept per (views, points, seed, device): a second
    call draws nothing, and sets first drawn under inference mode serve a
    later call under autograd."""
    with torch.inference_mode():
        a = ray_utils.draw_minimal_sets(3, 1000, seed=7)
    assert ray_utils.draw_minimal_sets(3, 1000, seed=7) is a and not a.is_inference()
    assert not torch.equal(ray_utils.draw_minimal_sets(3, 1000, seed=8), a)
    assert int(a.max()) < ray_utils.n_sample_of(1000)


def test_get_extrinsic_shape():
    rays = _make_camrays(np.eye(3), (1.0, 1.0), (1.0, 1.0), np.array([1.0, 2, 3]))
    ext, focal, pp = ray_utils.get_extrinsic_from_camray(torch.from_numpy(rays), torch.ones(1, 1, 24, 32, 1))
    assert ext.shape == (1, 1, 4, 4) and focal.shape == (1, 1, 2) and pp.shape == (1, 1, 2)
    np.testing.assert_allclose(ext[0, 0, 3].numpy(), [0, 0, 0, 1])
    np.testing.assert_allclose(ext[0, 0, :3, 3].numpy(), [1, 2, 3], atol=1e-5)


def test_net_ray_pose_matches_jax(monkeypatch):
    jnet = j_build("da3-small", dtype=jnp.float32, attn_impl="xla")
    tnet = build_da3("da3-small", dtype=torch.float32, device="cpu")
    ext, ixt = jnp.broadcast_to(jnp.eye(4), (1, 2, 4, 4)), jnp.broadcast_to(jnp.eye(3) * 20.0, (1, 2, 3, 3))
    abstract = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros((1, 2, 28, 28, 3)), ext, ixt)
    params = random_flax_params(abstract, 21)
    load_into_port(tnet, params)
    x = np.random.default_rng(22).normal(size=(1, 2, 42, 56, 3)).astype(np.float32)
    jout = jax.jit(lambda p, x: jnet.apply(p, x, use_ray_pose=True))(params, jnp.asarray(x))
    monkeypatch.setattr(ray_utils, "draw_minimal_sets", lambda n, m, seed=42, device="cpu": jax_minimal_sets(n, m, seed))
    with torch.no_grad():
        tout = tnet(torch.from_numpy(x), use_ray_pose=True)
    assert tout["extrinsics"].shape == (1, 2, 3, 4) and "ray" not in tout
    for k in ("extrinsics", "intrinsics", "depth"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), atol=1e-3, rtol=1e-2, err_msg=k)


def _w2c(seed, n):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    ext = np.tile(np.eye(4), (n, 1, 1))
    ext[:, :3, :3] = q * np.sign(np.linalg.det(q))[:, None, None]
    ext[:, :3, 3] = rng.normal(size=(n, 3))
    return ext


@pytest.mark.parametrize("n,ransac", [(4, False), (12, True)])
def test_pose_align_matches_jax_exactly(n, ransac):
    ref = _w2c(1, n)
    est = ref.copy()
    est[:, :3, 3] = 0.5 * est[:, :3, 3] + np.random.default_rng(2).normal(scale=0.05, size=(n, 3))
    est[0, :3, 3] += 3.0  # an outlier
    kw = dict(return_aligned=True, ransac=ransac, random_state=42)
    for g, w in zip(tpa.align_poses_umeyama(ref[:, :3], est, **kw), jpa.align_poses_umeyama(ref[:, :3], est, **kw)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    for g, w in zip(tpa.batch_align_poses_umeyama(ref[None], est[None]), jpa.batch_align_poses_umeyama(ref[None], est[None])):
        np.testing.assert_array_equal(g, w)
    got = tpa.batch_umeyama_pose_scales(torch.from_numpy(ref[None]).float(), torch.from_numpy(est[None]).float())
    want = jpa.batch_umeyama_pose_scales(jnp.asarray(ref[None], jnp.float32), jnp.asarray(est[None], jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
