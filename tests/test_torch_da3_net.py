"""Port vs JAX package for whole DA3 nets, fp32 on the CPU with shared
numpy-made weights: da3-small (without and with GT poses), the DualDPT ray
branch, a metric net (DPT + sky), a nested net built from small trunks, and
``process_tensor_batch`` at the nuScenes camera size. Tolerance 1e-3 / 1e-2
(tests/test_da3_parity.py:122-133)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recondet3d.data.input_processor import process_tensor_batch as j_process
from recondet3d.models.da3 import DPT as JDPT, DepthAnything3Net as JNet, DinoViT as JDinoViT
from recondet3d.models.da3 import NestedDepthAnything3Net as JNested, build_da3 as j_build
from recondet3d.models.da3.presets import _anyview as j_anyview
from recondet3d_torch.data.input_processor import process_tensor_batch
from recondet3d_torch.models.da3 import DPT, DepthAnything3Net, DinoViT, NestedDepthAnything3Net, build_da3
from recondet3d_torch.models.da3.presets import _anyview
from test_torch_weights import load_into_port, random_flax_params, to_np

ATOL, RTOL = 1e-3, 1e-2
SMALL = dict(out_layers=(5, 7, 9, 11), alt_start=4, head_dim_in=768, features=64,
             out_channels=(48, 96, 192, 384), cam_dim=384)


def _poses(B, S, seed):
    """Random w2c extrinsics (B, S, 4, 4) and pinhole intrinsics (B, S, 3, 3)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(B, S, 3, 3)))
    q = q * np.sign(np.linalg.det(q))[..., None, None]
    ext = np.zeros((B, S, 4, 4), np.float32)
    ext[..., :3, :3] = q
    ext[..., :3, 3] = rng.normal(size=(B, S, 3))
    ext[..., 3, 3] = 1.0
    ixt = np.zeros((B, S, 3, 3), np.float32)
    ixt[..., 0, 0] = ixt[..., 1, 1] = 30.0 + rng.uniform(0, 5, size=(B, S))
    ixt[..., 0, 2] = ixt[..., 1, 2] = 14.0
    ixt[..., 2, 2] = 1.0
    return ext, ixt


def _init_pair(jnet, tnet, x_shape, seed, with_poses=True):
    x = jnp.zeros(x_shape)
    args = ()
    if with_poses:
        ext, ixt = _poses(x_shape[0], x_shape[1], 0)
        args = (jnp.asarray(ext), jnp.asarray(ixt))
    abstract = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x, *args)
    params = random_flax_params(abstract, seed)
    return params, load_into_port(tnet, params)


def _compare(tout, jout, keys):
    for k in keys:
        np.testing.assert_allclose(to_np(tout[k]), np.asarray(jout[k]), atol=ATOL, rtol=RTOL, err_msg=k)


def _small_metric_pair():
    kw = dict(name_preset="vits", out_layers=(2, 5, 8, 11), alt_start=-1, qknorm_start=-1,
              rope_start=-1, cat_token=False)
    hk = dict(dim_in=384, output_dim=1, features=64, out_channels=(48, 96, 192, 384))
    jnet = JNet(net=JDinoViT(dtype=jnp.float32, attn_impl="xla", **kw), head=JDPT(**hk))
    tnet = DepthAnything3Net(net=DinoViT(device="cpu", **kw), head=DPT(device="cpu", **hk))
    return jnet, tnet


@pytest.fixture(scope="module")
def small_pair():
    jnet = j_build("da3-small", dtype=jnp.float32, attn_impl="xla")
    tnet = build_da3("da3-small", dtype=torch.float32, device="cpu")
    params, tnet = _init_pair(jnet, tnet, (1, 2, 28, 28, 3), seed=10)
    return jnet, params, tnet


@pytest.mark.parametrize("with_poses", [False, True])
def test_small_net_matches_jax(small_pair, with_poses):
    jnet, params, tnet = small_pair
    x = np.random.default_rng(11).normal(size=(1, 2, 28, 42, 3)).astype(np.float32)
    ext, ixt = _poses(1, 2, 12) if with_poses else (None, None)
    jargs = (jnp.asarray(ext), jnp.asarray(ixt)) if with_poses else (None, None)
    targs = (torch.from_numpy(ext), torch.from_numpy(ixt)) if with_poses else (None, None)
    jout = jax.jit(jnet.apply)(params, jnp.asarray(x), *jargs)
    with torch.no_grad():
        tout = tnet(torch.from_numpy(x), *targs)
    _compare(tout, jout, ["depth", "depth_conf", "extrinsics", "intrinsics"])


def test_dualdpt_ray_branch_matches_jax(small_pair):
    jnet, params, tnet = small_pair
    rng = np.random.default_rng(13)
    H, W = 28, 42
    feats = [(rng.normal(size=(1, 2, 6, 768)).astype(np.float32), rng.normal(size=(1, 2, 768)).astype(np.float32))
             for _ in range(4)]
    jout = jnet.head.apply({"params": params["params"]["head"]}, [tuple(map(jnp.asarray, f)) for f in feats], H, W)
    with torch.no_grad():
        tout = tnet.head([tuple(map(torch.from_numpy, f)) for f in feats], H, W)
    _compare(tout, jout, ["depth", "depth_conf", "ray", "ray_conf"])


def test_metric_net_with_sky_matches_jax():
    jnet, tnet = _small_metric_pair()
    params, tnet = _init_pair(jnet, tnet, (1, 2, 28, 28, 3), seed=20, with_poses=False)
    x = np.random.default_rng(21).normal(size=(1, 2, 42, 28, 3)).astype(np.float32)
    jout = jax.jit(jnet.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        tout = tnet(torch.from_numpy(x))
    _compare(tout, jout, ["sky", "depth"])


def test_nested_small_net_matches_jax():
    jm, tm = _small_metric_pair()
    jnet = JNested(anyview=j_anyview("vits", dtype=jnp.float32, attn_impl="xla", **SMALL), metric=jm)
    tnet = NestedDepthAnything3Net(
        anyview=_anyview("vits", dtype=torch.float32, device="cpu", **SMALL), metric=tm)
    params, tnet = _init_pair(jnet, tnet, (1, 3, 28, 28, 3), seed=30)
    x = np.random.default_rng(31).normal(size=(2, 3, 28, 42, 3)).astype(np.float32)
    jout = jax.jit(jnet.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        tout = tnet(torch.from_numpy(x))
    # no sky value may sit at the 0.3 threshold, or a rounding flip could decide the test
    jsky = np.asarray(jout["sky"])
    assert np.abs(jsky - 0.3).min() > 1e-4
    np.testing.assert_array_equal(to_np(tout["sky"]) < 0.3, jsky < 0.3)
    assert 10 < (jsky < 0.3).sum() < jsky.size - 10
    _compare(tout, jout, ["depth", "depth_conf", "extrinsics", "intrinsics", "sky", "scale_factor"])
    assert int(tout["is_metric"]) == 1


def test_process_tensor_batch_matches_jax():
    rng = np.random.default_rng(40)
    img = rng.uniform(0, 255, size=(1, 2, 900, 1600, 3)).astype(np.float32)
    ixt = np.tile(np.array([[1260.0, 0, 800], [0, 1260.0, 450], [0, 0, 1]], np.float32), (1, 2, 1, 1))
    jx, jk = j_process(jnp.asarray(img), jnp.asarray(ixt), process_res=504)
    tx, tk = process_tensor_batch(torch.from_numpy(img), torch.from_numpy(ixt), process_res=504)
    assert tuple(tx.shape) == (1, 2, 280, 504, 3)
    np.testing.assert_allclose(to_np(tx), np.asarray(jx), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(to_np(tk), np.asarray(jk), atol=ATOL, rtol=RTOL)
