"""The DA3 public API as a whole, port vs JAX package, fp32 on the CPU.

Both packages run da3-small with its Gaussian-splat head: the JAX package
through ``DepthAnything3.from_pretrained("da3-small", with_gs=True)`` (its
random init), the port through ``DepthAnything3(model)`` on a model that
takes those weights (``state_dict_from_flax``). Two views of 90x160 uint8 at
``process_res=56``, made from a seed with numpy. Tolerance: ATOL 1e-3 /
RTOL 1e-2, as tests/test_torch_da3_net.py.

- The JAX package resizes with cv2; the port's resamplers agree with cv2
  within one level on a small share of pixels
  (tests/test_torch_input_processor.py), and one level at a pixel moves that
  pixel's Gaussian (the GS head reads the image at full resolution) by more
  than the gate. So the cases that compare every field hand the port's
  ``InputProcessor`` cv2's resize; ``test_api_own_resampler_matches_jax``
  runs the port's own resamplers and compares depth, confidence and cameras.
- Quaternions are compared up to sign: q and -q are one rotation, and
  ``standardize_quaternion`` flips at w = 0, where a rounding picks either.
- ``use_ray_pose``: the port's RANSAC is handed the JAX package's minimal
  sets (``jax.random`` from ``PRNGKey(42)``, split per view).
- ``infer_gs``: the JAX API's jitted forward cannot return ``Gaussians``
  (not a pytree); those calls run its forward eagerly.
"""

import os
import types
import zipfile

import jax
import numpy as np
import pytest
import torch

import recondet3d.data.input_processor as j_input_processor
from recondet3d.api import DepthAnything3 as JDepthAnything3
from recondet3d.api.weights import _flatten, convert_torch_state_dict, load_safetensors as j_load_safetensors
from recondet3d.data.export import export as j_export
from recondet3d_torch.api import DepthAnything3
from recondet3d_torch.api.weights import state_dict_from_flax
from recondet3d_torch.data import input_processor as t_input_processor
from recondet3d_torch.data.export import export
from recondet3d_torch.models.da3 import build_da3, gs_renderer
from recondet3d_torch.utils import ray_utils

ATOL, RTOL = 1e-3, 1e-2
RES = 56
GS_FIELDS = ("means", "scales", "rotations", "harmonics", "opacities")


def _images(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (90, 160, 3), np.uint8) for _ in range(2)]


def _poses():
    ext = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    ext[1, 0, 3] = 1.0
    ext[1, :3, :3] = np.array([[0.98, 0.0, 0.199], [0.0, 1.0, 0.0], [-0.199, 0.0, 0.98]], np.float32)
    ixt = np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))
    ixt[:, 0, 0] = ixt[:, 1, 1] = 100.0
    ixt[:, 0, 2], ixt[:, 1, 2] = 80, 45
    return ext, ixt


def jax_minimal_sets(n_views, n_points, seed=42):
    """The JAX package's RANSAC minimal sets (``ray_utils.py:57-59, 123``)."""
    n = ray_utils.n_sample_of(n_points)
    keys = jax.random.split(jax.random.PRNGKey(seed), n_views)
    perm = [jax.vmap(lambda k: jax.random.permutation(k, n)[:ray_utils.N_MINIMAL])(jax.random.split(key, ray_utils.N_ITER))
            for key in keys]
    return torch.from_numpy(np.stack([np.asarray(p) for p in perm]).astype(np.int64))


def use_jax_minimal_sets(monkeypatch):
    monkeypatch.setattr(ray_utils, "draw_minimal_sets",
                        lambda n_views, n_points, seed=42, device="cpu": jax_minimal_sets(n_views, n_points, seed))


def use_cv2_resize(monkeypatch):
    import cv2

    monkeypatch.setattr(t_input_processor, "resize_area",
                        lambda img, hw: cv2.resize(img, hw[::-1], interpolation=cv2.INTER_AREA))
    monkeypatch.setattr(t_input_processor, "resize_cubic",
                        lambda img, hw: cv2.resize(img, hw[::-1], interpolation=cv2.INTER_CUBIC))


def close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL, rtol=RTOL, err_msg=what)


def close_quat(got, want):
    got, want = np.asarray(got), np.asarray(want)
    flip = np.abs(got - want).sum(-1, keepdims=True) > np.abs(got + want).sum(-1, keepdims=True)
    close(np.where(flip, -got, got), want, "rotations (up to sign)")


def compare(tp, jp, gaussians=False, cameras=True):
    for f in ("depth", "conf") + (("extrinsics", "intrinsics") if cameras else ()):
        close(getattr(tp, f), getattr(jp, f), f)
    assert np.array_equal(tp.processed_images.shape, jp.processed_images.shape)
    if gaussians:
        for f in GS_FIELDS:
            if f == "rotations":
                close_quat(tp.gaussians.rotations, jp.gaussians.rotations)
            else:
                close(getattr(tp.gaussians, f), getattr(jp.gaussians, f), f)


def jax_inference(japi, eager=False, **kw):
    if not eager:
        return japi.inference(**kw)
    saved = japi._jax
    japi._jax = types.SimpleNamespace(jit=lambda f: f, device_get=jax.device_get)
    try:
        return japi.inference(**kw)
    finally:
        japi._jax = saved


@pytest.fixture(scope="module")
def pair():
    japi = JDepthAnything3.from_pretrained("da3-small", cache_dir="/nonexistent", with_gs=True)
    model = build_da3("da3-small", dtype=torch.float32, device="cpu", with_gs=True)
    model.load_state_dict(state_dict_from_flax({k: np.asarray(v) for k, v in _flatten(japi.params).items()}),
                          strict=True)
    return japi, DepthAnything3(model, "da3-small")


CASES = {
    "no_poses": dict(),
    "poses": dict(poses=True),
    "infer_gs": dict(infer_gs=True),
    "infer_gs_poses": dict(infer_gs=True, poses=True),
    "ray_pose": dict(use_ray_pose=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_api_matches_jax(pair, case, monkeypatch):
    japi, tapi = pair
    opts = dict(CASES[case])
    kw = dict(image=_images(0), process_res=RES, infer_gs=opts.get("infer_gs", False),
              use_ray_pose=opts.get("use_ray_pose", False))
    if opts.get("poses"):
        kw["extrinsics"], kw["intrinsics"] = _poses()
    use_cv2_resize(monkeypatch)
    use_jax_minimal_sets(monkeypatch)
    jp = jax_inference(japi, eager=kw["infer_gs"], **kw)
    tp = tapi.inference(**kw)
    compare(tp, jp, gaussians=kw["infer_gs"])
    if opts.get("poses"):
        np.testing.assert_allclose(tp.extrinsics, _poses()[0][:, :3], atol=1e-5)
    if kw["infer_gs"]:
        g = tp.gaussians
        assert g.means.shape == (1, 2 * 28 * 56, 3) and g.harmonics.shape == (1, 2 * 28 * 56, 3, 9)
        np.testing.assert_allclose(np.linalg.norm(g.rotations, axis=-1), 1.0, atol=1e-5)
        assert 0.0 <= g.opacities.min() and g.opacities.max() <= 1.0


def test_api_own_resampler_matches_jax(pair):
    japi, tapi = pair
    kw = dict(image=_images(1), process_res=RES)
    jp, tp = japi.inference(**kw), tapi.inference(**kw)
    diff = np.abs(tp.processed_images.astype(int) - jp.processed_images.astype(int))
    assert diff.max() <= 1
    compare(tp, jp)


def _save_safetensors(path, state_dict):
    from safetensors.numpy import save_file

    save_file({k: np.ascontiguousarray(v.detach().float().numpy()) for k, v in state_dict.items()}, path)


def test_upstream_checkpoint_loads_alike(pair, tmp_path, monkeypatch):
    """A safetensors file in the upstream names (the port's own state-dict
    names, ``gs_head.*`` included), with weights neither side has, loaded by
    the port's ``from_pretrained`` and by the JAX package's converter."""
    japi, _ = pair
    src = build_da3("da3-small", dtype=torch.float32, device="cpu", with_gs=True,
                    generator=torch.Generator().manual_seed(5))
    path = str(tmp_path / "model.safetensors")
    _save_safetensors(path, src.state_dict())
    assert any(k.startswith("gs_head.images_merger.") for k in src.state_dict())

    tapi = DepthAnything3.from_pretrained("da3-small", cache_dir=str(tmp_path / "none"), checkpoint=path,
                                          with_gs=True, device="cpu")
    assert not tapi.random_init
    params, unused, unfilled = convert_torch_state_dict(j_load_safetensors(path), japi.params)
    assert not unused and not unfilled, (unused[:5], unfilled[:5])
    for name, t in tapi.model.state_dict().items():
        assert torch.equal(t, src.state_dict()[name]), name

    use_cv2_resize(monkeypatch)
    saved = japi.params
    japi.params = params
    try:
        kw = dict(image=_images(2), process_res=RES, infer_gs=True)
        jp = jax_inference(japi, eager=True, **kw)
    finally:
        japi.params = saved
    compare(tapi.inference(**kw), jp, gaussians=True)


def _same_npz(a, b):
    with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
        assert sorted(za.namelist()) == sorted(zb.namelist())
        for name in za.namelist():
            assert za.read(name) == zb.read(name), name


def test_exports_are_byte_identical(pair, tmp_path, monkeypatch):
    """One Prediction (the port's, with Gaussians and poses) exported by both
    packages. npz files are zip archives stamped with the time of writing:
    their members are compared byte for byte."""
    _, tapi = pair
    ext, ixt = _poses()
    pred = tapi.inference(image=_images(3), extrinsics=ext, intrinsics=ixt, process_res=RES, infer_gs=True)
    fmt = "glb-npz-mini_npz-depth_vis-gs_ply-colmap"
    export(pred, fmt, str(tmp_path / "port"))
    j_export(pred, fmt, str(tmp_path / "jax"))
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "port")
                   for d, _, fs in os.walk(tmp_path / "port") for f in fs)
    assert {"scene.glb", "prediction.npz", "prediction_mini.npz", "depth_000.png", "depth_001.png", "gaussians.ply",
            "colmap/cameras.bin", "colmap/images.bin", "colmap/points3D.bin"} <= set(files)
    with open(tmp_path / "port" / "colmap" / "points3D.bin", "rb") as f:
        assert int.from_bytes(f.read(8), "little") > 0  # the points' bytes are compared too
    for rel in files:
        a, b = str(tmp_path / "port" / rel), str(tmp_path / "jax" / rel)
        if rel.endswith(".npz"):
            _same_npz(a, b)
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel


def test_gs_video_renders_where_the_api_runs(pair, tmp_path, monkeypatch):
    """The API hands its device to the gs_video exporter's renderer; the
    exporter called without one renders on the card."""
    pytest.importorskip("cv2")
    _, tapi = pair
    seen = []
    render = gs_renderer.render_3dgs
    monkeypatch.setattr(gs_renderer, "render_3dgs", lambda *a, device=None, **kw: seen.append(device) or render(
        *a, device=device, **kw))
    pred = tapi.inference(image=_images(4), process_res=RES, infer_gs=True, export_format="gs_video",
                          export_dir=str(tmp_path / "api"))
    assert seen == [torch.device("cpu")] and os.path.getsize(tmp_path / "api" / "gs_video.mp4") > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            export(pred, "gs_video", str(tmp_path / "default"))
