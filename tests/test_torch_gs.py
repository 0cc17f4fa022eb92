"""Gaussian splatting in the port vs the JAX package, fp32 on the CPU.

- ``GSDPT`` and ``GaussianAdapter`` through da3-small with its GS head, from
  shared numpy-made weights, without and with GT poses (the Umeyama scale
  path): every ``Gaussians`` field at ATOL 1e-3 / RTOL 1e-2
  (tests/test_torch_da3_net.py's gate); quaternions up to sign.
- The full-scale layout with the GS head: every parameter of the JAX
  package's ``gs_head`` (the image merger's included) has its port name
  and shape, for da3-giant and the nested net.
- ``build_resdet3d`` and the train CLI's ``build_model_from_cfg`` build no GS
  head: their parameter counts are the ones they had before the head was
  ported (counted on the meta device).
- ``eval_sh_basis`` and ``rotate_sh`` to 1e-5.
- ``render_3dgs`` against the JAX renderer on tests/test_gs_renderer.py's
  cases and on a random scene of 4,096 + 904 gaussians, half of them at one
  depth: rgb and alpha within 1e-4, depth within 1e-4 of its largest value
  (relative), with the same candidate order among equal depths.
- ``camera_traj`` as tests/test_camera_traj.py, and equal to the JAX
  package's arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recondet3d.api.weights import _flatten
from recondet3d.models.da3 import build_da3 as j_build
from recondet3d.models.da3.gs_renderer import render_3dgs as j_render
from recondet3d.specs import Gaussians as JGaussians
from recondet3d.utils import camera_traj as jtraj
from recondet3d.utils.sh import eval_sh_basis as j_eval_sh, rotate_sh as j_rotate_sh
from recondet3d_torch.api.weights import torch_layout_shape, torch_name
from recondet3d_torch.cli.train import build_model_from_cfg
from recondet3d_torch.core.config import load_py_config
from recondet3d_torch.models.da3 import build_da3
from recondet3d_torch.models.da3.gs_renderer import render_3dgs
from recondet3d_torch.models.detect import build_resdet3d
from recondet3d_torch.specs import Gaussians
from recondet3d_torch.utils import camera_traj as ttraj
from recondet3d_torch.utils.sh import SH_C0, eval_sh_basis, rotate_sh
from test_torch_weights import load_into_port, random_flax_params, to_np

ATOL, RTOL = 1e-3, 1e-2
FIELDS = ("means", "scales", "rotations", "harmonics", "opacities")


def _poses(S):
    ext = np.tile(np.eye(4, dtype=np.float32), (1, S, 1, 1))
    ext[0, 1:, 0, 3] = 0.5
    ext[0, 1, :3, :3] = np.array([[0.98, 0.0, 0.199], [0.0, 1.0, 0.0], [-0.199, 0.0, 0.98]], np.float32)
    ixt = np.tile(np.array([[30, 0, 21], [0, 30, 14], [0, 0, 1]], np.float32), (1, S, 1, 1))
    return ext, ixt


@pytest.fixture(scope="module")
def gs_pair():
    jnet = j_build("da3-small", dtype=jnp.float32, attn_impl="xla", with_gs=True)
    tnet = build_da3("da3-small", dtype=torch.float32, device="cpu", with_gs=True)
    ext, ixt = _poses(2)
    abstract = jax.eval_shape(lambda r: jnet.init(r, jnp.zeros((1, 2, 28, 42, 3)), jnp.asarray(ext), jnp.asarray(ixt),
                                                  infer_gs=True), jax.random.PRNGKey(0))
    params = random_flax_params(abstract, 3)
    return jnet, params, load_into_port(tnet, params)


@pytest.mark.parametrize("with_poses", [False, True])
def test_gs_head_and_adapter_match_jax(gs_pair, with_poses):
    jnet, params, tnet = gs_pair
    x = np.random.default_rng(4).normal(size=(1, 2, 28, 42, 3)).astype(np.float32)
    ext, ixt = _poses(2)
    jargs = (jnp.asarray(ext), jnp.asarray(ixt)) if with_poses else (None, None)
    targs = (torch.from_numpy(ext), torch.from_numpy(ixt)) if with_poses else (None, None)
    jout = jax.jit(lambda p, x, e, k: jnet.apply(p, x, e, k, infer_gs=True)["gaussians"].__dict__)(
        params, jnp.asarray(x), *jargs)
    with torch.no_grad():
        tout = tnet(torch.from_numpy(x), *targs, infer_gs=True)["gaussians"]
    for f in FIELDS:
        got, want = to_np(getattr(tout, f)), np.asarray(jout[f])
        assert got.shape == want.shape, f
        if f == "rotations":
            flip = np.abs(got - want).sum(-1, keepdims=True) > np.abs(got + want).sum(-1, keepdims=True)
            got = np.where(flip, -got, got)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=f)
    # the raw head alone, before the adapter
    feats = [(torch.from_numpy(np.random.default_rng(5 + i).normal(size=(1, 2, 6, 768)).astype(np.float32)),
              torch.zeros(1, 2, 768)) for i in range(4)]
    jraw = jnet.gs_head.apply({"params": params["params"]["gs_head"]}, [tuple(map(jnp.asarray, f)) for f in feats],
                              28, 42, images=jnp.asarray(x))
    with torch.no_grad():
        traw = tnet.gs_head(feats, 28, 42, images=torch.from_numpy(x))
    for k in ("raw_gs", "raw_gs_conf"):
        np.testing.assert_allclose(to_np(traw[k]), np.asarray(jraw[k]), atol=ATOL, rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("name", ["da3-giant", "da3nested-giant-large"])
def test_full_scale_gs_layout_matches_jax(name):
    jnet = j_build(name, dtype=jnp.bfloat16, attn_impl="xla")
    ext, ixt = jnp.broadcast_to(jnp.eye(4), (1, 2, 4, 4)), jnp.broadcast_to(jnp.eye(3) * 20.0, (1, 2, 3, 3))
    abstract = jax.eval_shape(lambda r: jnet.init(r, jnp.zeros((1, 2, 28, 28, 3)), ext, ixt, infer_gs=True),
                              jax.random.PRNGKey(0))
    jax_side = {torch_name(p): torch_layout_shape(p, leaf.shape) for p, leaf in _flatten(abstract).items()}
    port_side = {k: tuple(v.shape) for k, v in build_da3(name, device="meta").state_dict().items()}
    assert port_side == jax_side, (sorted(set(port_side) ^ set(jax_side))[:5])
    gs = [k for k in port_side if ".gs_head." in "." + k]
    assert len(gs) == 66 and sum("images_merger" in k for k in gs) == 6


# parameters of the detectors as built before the GS head was ported (meta device)
PARENT_PARAMS = {"da3nested-giant-large": 1_770_876_164, "da3-giant": 1_436_704_770,
                 "configs/resdet3d_centerhead.py": 1_772_398_218,
                 "configs/resdet3d_tiny_centerhead_test.py": 37_120_261}


def test_detectors_build_no_gs_head():
    for preset in ("da3nested-giant-large", "da3-giant"):
        model = build_resdet3d(preset, device="meta", generator=torch.Generator())
        assert not any("gs_head" in n for n, _ in model.named_parameters()), preset
        assert sum(p.numel() for p in model.parameters()) == PARENT_PARAMS[preset], preset
    for cfg in ("configs/resdet3d_centerhead.py", "configs/resdet3d_tiny_centerhead_test.py"):
        model = build_model_from_cfg(load_py_config(cfg), device="meta")
        assert not any("gs_head" in n for n, _ in model.named_parameters()), cfg
        assert sum(p.numel() for p in model.parameters()) == PARENT_PARAMS[cfg], cfg
    # the API's preset default builds it, as the JAX package's build_da3 does
    assert any("gs_head" in n for n, _ in build_da3("da3nested-giant-large", device="meta").named_parameters())


def test_sh_matches_jax():
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(50, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    for deg in (0, 1, 2, 3):
        np.testing.assert_allclose(eval_sh_basis(torch.from_numpy(dirs), deg).numpy(),
                                   np.asarray(j_eval_sh(jnp.asarray(dirs), deg)), atol=1e-5)
    sh = rng.normal(size=(4, 5, 3, 9)).astype(np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(4, 1, 1, 3, 3)))
    R = (q * np.sign(np.linalg.det(q))[..., None, None]).astype(np.float32)
    got = rotate_sh(torch.from_numpy(sh), torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_rotate_sh(jnp.asarray(sh), jnp.asarray(R))), atol=1e-5)
    # the rotated coefficients carry the function through the rotation (tests/test_gs_renderer.py)
    f_rot = np.einsum("nd,...d->...n", eval_sh_basis(torch.from_numpy(dirs), 2).numpy(), got[0, 0])
    f_orig = np.einsum("...nd,...d->...n", eval_sh_basis(torch.from_numpy(dirs @ R[0, 0, 0]), 2).numpy(), sh[0, 0])
    np.testing.assert_allclose(f_rot, f_orig, atol=1e-4)


def _fields(means, colors, scale=0.05, opacity=0.95):
    n = len(means)
    harm = np.zeros((n, 3, 9), np.float32)
    harm[:, :, 0] = (np.asarray(colors) - 0.5) / SH_C0
    return dict(means=np.asarray(means, np.float32), scales=np.full((n, 3), scale, np.float32),
                rotations=np.tile([1.0, 0, 0, 0], (n, 1)).astype(np.float32), harmonics=harm,
                opacities=np.full((n,), opacity, np.float32))


def _random_scene():
    """4,096 + 904 gaussians (two blocks), half of them at depth 4.0 and the
    rest on three depths: many equal keys for the per-tile top-K."""
    rng = np.random.default_rng(0)
    n = 4096 + 904
    means = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.choice([3.0, 4.0, 5.0], n)], 1)
    means[: n // 2, 2] = 4.0
    rot = rng.normal(size=(n, 4))
    return dict(means=means.astype(np.float32), scales=rng.uniform(0.02, 0.2, (n, 3)).astype(np.float32),
                rotations=(rot / np.linalg.norm(rot, axis=1, keepdims=True)).astype(np.float32),
                harmonics=(0.5 * rng.normal(size=(n, 3, 9))).astype(np.float32),
                opacities=rng.uniform(0.1, 0.99, n).astype(np.float32))


SCENES = {
    "single": (_fields([[0.5, -0.2, 4.0]], [[1.0, 0.0, 0.0]], scale=0.08), 192),
    "occlusion": (_fields([[0.0, 0.0, 2.0], [0.0, 0.0, 6.0]], [[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]], scale=0.06), 192),
    "culled": (_fields([[0.0, 0.0, -3.0], [100.0, 0.0, 5.0]], [[1.0, 1.0, 1.0], [1.0, 1.0, 1.0]]), 192),
    "equal_depths": (_random_scene(), 64),
}


@pytest.mark.parametrize("scene", list(SCENES))
def test_renderer_matches_jax(scene):
    fields, k = SCENES[scene]
    W, H, f = 64, 48, 60.0
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)[None]
    E = np.eye(4, dtype=np.float32)[None]
    if scene == "equal_depths":  # a second, rotated view
        E = np.concatenate([E, E])
        E[1, :3, :3] = np.array([[0.98, 0.0, 0.199], [0.0, 1.0, 0.0], [-0.199, 0.0, 0.98]], np.float32)
        E[1, 0, 3] = 0.3
        K = np.concatenate([K, K])
    want = [np.asarray(a) for a in j_render(JGaussians(**fields), E, K, (H, W), max_per_tile=k)]
    got = [a.numpy() for a in render_3dgs(Gaussians(**fields), E, K, (H, W), max_per_tile=k, device="cpu")]
    np.testing.assert_allclose(got[0], want[0], atol=1e-4, err_msg="rgb")
    np.testing.assert_allclose(got[2], want[2], atol=1e-4, err_msg="alpha")
    np.testing.assert_allclose(got[1], want[1], atol=1e-4 * max(1.0, np.abs(want[1]).max()), err_msg="depth")
    if scene == "single":  # the splat lands where the pinhole says (tests/test_gs_renderer.py)
        yy, xx = np.unravel_index(np.argmax(got[2][0]), got[2].shape[1:])
        assert abs(xx - (f * 0.5 / 4.0 + W / 2)) <= 1.5 and abs(yy - (f * -0.2 / 4.0 + H / 2)) <= 1.5
    if scene == "occlusion":
        assert got[0][0, 24, 32, 1] > got[0][0, 24, 32, 0]  # the near green wins
    if scene == "culled":
        assert got[2].max() < 1e-3


def test_renderer_runs_on_the_card_by_default():
    """numpy Gaussians render on the card unless the caller names the CPU;
    tensors render where they lie."""
    fields, _ = SCENES["single"]
    E, K = np.eye(4, dtype=np.float32)[None], np.array([[60.0, 0, 32], [0, 60, 24], [0, 0, 1]], np.float32)[None]
    on_cpu = render_3dgs(Gaussians(**{k: torch.from_numpy(v) for k, v in fields.items()}), E, K, (48, 64))
    assert on_cpu[0].device.type == "cpu" and on_cpu[2].max() > 0.5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            render_3dgs(Gaussians(**fields), E, K, (48, 64))


def _base():
    return np.eye(4, dtype=np.float32), np.array([[400.0, 0, 320], [0, 400, 240], [0, 0, 1]], np.float32)


def test_camera_traj_matches_jax():
    ext0, ixt = _base()
    ext1 = ext0.copy()
    ext1[0, 3] = 2.0
    ext1[:3, :3] = np.array([[0.98, 0.0, 0.199], [0.0, 1.0, 0.0], [-0.199, 0.0, 0.98]], np.float32)
    args = (np.stack([ext0, ext1]), np.stack([ixt, ixt * 1.1]))
    for loop in (False, True):
        got = ttraj.interpolate_camera_path(*args, n_frames=10, loop=loop)
        for g, w in zip(got, jtraj.interpolate_camera_path(*args, n_frames=10, loop=loop)):
            np.testing.assert_array_equal(g, w)
    e, _ = ttraj.interpolate_camera_path(*args, n_frames=10)
    assert abs(e[0, 0, 3]) < 1e-5 and e.shape == (10, 4, 4)
    for fn in ("wander_path", "wobble_path", "dolly_zoom_path"):
        for g, w in zip(getattr(ttraj, fn)(ext0, ixt, n_frames=12), getattr(jtraj, fn)(ext0, ixt, n_frames=12)):
            np.testing.assert_array_equal(g, w)
    e, i = ttraj.dolly_zoom_path(ext0, ixt, n_frames=12)
    assert i[0, 0, 0] > i[-1, 0, 0]  # fov widens -> focal shrinks
    rng = np.random.default_rng(0)
    poses = np.repeat(np.eye(4)[None], 30, 0)
    poses[:, 0, 3] = np.linspace(0, 5, 30) + rng.normal(0, 0.3, 30)
    out = ttraj.stabilization_path(poses, k_size=9)
    np.testing.assert_array_equal(out, jtraj.stabilization_path(poses, k_size=9))
    assert np.var(np.diff(out[:, 0, 3], 2)) < np.var(np.diff(poses[:, 0, 3], 2)) * 0.3
    assert ttraj.stabilization_path(poses[:1]).shape == (1, 4, 4)
    assert ttraj.stabilization_path(poses[:2], k_size=45).shape == (2, 4, 4)
