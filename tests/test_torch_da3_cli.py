"""The ``da3`` CLI of the port vs the JAX package's, on the CPU.

Both CLIs load one upstream-named safetensors checkpoint of da3-small from
their ``--cache-dir`` (numpy-made weights) and run at ``--process-res 56``:

- ``da3 auto`` on a directory of two 90x160 PNGs (the port as a user runs
  it, ``python -m recondet3d_torch.cli.da3 ... --device cpu``, in a
  subprocess);
- ``da3 colmap`` on the COLMAP model the port exported for those images,
  with the processed images beside it.

Their ``prediction.npz`` files agree at ATOL 1e-3 / RTOL 1e-2
(tests/test_torch_da3_net.py's gate; the port resizes with its own
resamplers, within one level of cv2's, tests/test_torch_input_processor.py),
and each writes the same set of files. The JAX CLI's model is built once
and reused by its second call (its ``from_pretrained`` jit-compiles an init
of every branch, ~20 s on a CPU). ``backend`` and ``gallery`` call the
port's ``start_server`` / ``serve_gallery`` with their arguments; without
cv2, ``video`` and the ``gs_video`` exporter raise the errors the port
states.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import recondet3d.api as j_api
from recondet3d.cli import da3 as j_cli
from recondet3d_torch.cli import da3 as t_cli
from recondet3d_torch.data.export import export
from recondet3d_torch.data.image_io import write_png
from recondet3d_torch.models.da3 import build_da3
from recondet3d_torch.specs import Gaussians, Prediction

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 1e-3, 1e-2
COMMON = ["--model", "da3-small", "--process-res", "56", "--export-format", "npz-glb"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("da3_cli")
    cache = root / "ckpts"
    (cache / "da3-small").mkdir(parents=True)
    from safetensors.numpy import save_file

    src = build_da3("da3-small", dtype=torch.float32, device="cpu", generator=torch.Generator().manual_seed(7))
    save_file({k: v.numpy() for k, v in src.state_dict().items()}, str(cache / "da3-small" / "model.safetensors"))
    imgs = root / "imgs"
    imgs.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        write_png(str(imgs / f"img_{i}.png"), rng.integers(0, 255, (90, 160, 3), np.uint8))
    return root, str(cache), str(imgs)


@pytest.fixture(scope="module")
def jax_cli_once():
    """The JAX CLI with its model built on the first call and reused after."""
    made = {}
    real = j_api.DepthAnything3.from_pretrained

    def cached(name, cache_dir="ckpts", **kw):
        if name not in made:
            made[name] = real(name, cache_dir=cache_dir, **kw)
        return made[name]

    mp = pytest.MonkeyPatch()
    mp.setattr(j_api.DepthAnything3, "from_pretrained", staticmethod(cached))
    yield j_cli.main
    mp.undo()


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


def _compare_npz(a, b):
    za, zb = np.load(a), np.load(b)
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        if za[k].dtype == np.uint8:  # processed images: one level at most
            assert np.abs(za[k].astype(int) - zb[k].astype(int)).max() <= 1, k
        else:
            np.testing.assert_allclose(za[k], zb[k], atol=ATOL, rtol=RTOL, err_msg=k)


def test_auto_and_colmap_match_jax_cli(setup, jax_cli_once, tmp_path):
    root, cache, imgs = setup
    out_t, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-m", "recondet3d_torch.cli.da3", "auto", imgs, "--cache-dir", cache,
                          "--export-dir", out_t, "--device", "cpu"] + COMMON, cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert jax_cli_once(["auto", imgs, "--cache-dir", cache, "--export-dir", out_j] + COMMON) == 0
    assert _files(out_t) == _files(out_j) == ["prediction.npz", "scene.glb"]
    _compare_npz(os.path.join(out_t, "prediction.npz"), os.path.join(out_j, "prediction.npz"))

    # a COLMAP model exported by the port, laid out as COLMAP does (sparse/0 + images)
    exported = tmp_path / "exported"
    t_cli.main(["images", imgs, "--cache-dir", cache, "--export-dir", str(exported), "--device", "cpu",
                "--model", "da3-small", "--process-res", "56", "--export-format", "colmap-npz"])
    model = tmp_path / "model"
    (model / "images").mkdir(parents=True)
    (model / "sparse").mkdir()
    os.rename(str(exported / "colmap"), str(model / "sparse" / "0"))
    for i, im in enumerate(np.load(str(exported / "prediction.npz"))["processed_images"]):
        write_png(str(model / "images" / f"view_{i:03d}.png"), im)
    assert t_cli.detect_input_type(str(model)) == "colmap"
    out_t, out_j = str(tmp_path / "port_colmap"), str(tmp_path / "jax_colmap")
    assert t_cli.main(["colmap", str(model), "--cache-dir", cache, "--export-dir", out_t, "--device", "cpu"]
                      + COMMON) == 0
    assert jax_cli_once(["colmap", str(model), "--cache-dir", cache, "--export-dir", out_j] + COMMON) == 0
    assert _files(out_t) == _files(out_j)
    _compare_npz(os.path.join(out_t, "prediction.npz"), os.path.join(out_j, "prediction.npz"))
    # with input poses the exported extrinsics are those poses
    got = np.load(os.path.join(out_t, "prediction.npz"))["extrinsics"]
    np.testing.assert_allclose(got, np.load(str(exported / "prediction.npz"))["extrinsics"][:, :3], atol=1e-5)


def test_unported_and_cv2_errors(setup, tmp_path, monkeypatch):
    _, cache, _ = setup
    # backend and gallery hand their arguments to the port's servers (patched here, so that nothing serves)
    from recondet3d_torch.serve import backend, gallery

    calls = []
    monkeypatch.setattr(backend, "start_server", lambda **kw: calls.append(("backend", kw)))
    monkeypatch.setattr(gallery, "serve_gallery", lambda root, **kw: calls.append(("gallery", dict(root=root, **kw))))
    assert t_cli.main(["backend"]) == 0
    assert t_cli.main(["backend", "--model", "da3-small", "--cache-dir", cache, "--host", "0.0.0.0", "--port", "8123",
                       "--workdir", str(tmp_path / "wd"), "--device", "cpu"]) == 0
    assert t_cli.main(["gallery", "--root", str(tmp_path / "wd"), "--port", "8124"]) == 0
    assert calls == [
        ("backend", dict(model_name="depth-anything/DA3NESTED-GIANT-LARGE", cache_dir="ckpts", host="127.0.0.1",
                         port=8000, workdir="da3_backend", device="cuda")),
        ("backend", dict(model_name="da3-small", cache_dir=cache, host="0.0.0.0", port=8123,
                         workdir=str(tmp_path / "wd"), device="cpu")),
        ("gallery", dict(root=str(tmp_path / "wd"), host="127.0.0.1", port=8124)),
    ]
    video = tmp_path / "clip.mp4"
    video.write_bytes(b"\x00" * 64)
    assert t_cli.detect_input_type(str(video)) == "video"
    monkeypatch.setitem(sys.modules, "cv2", None)  # as on a host without OpenCV
    with pytest.raises(ImportError, match="cv2"):
        t_cli.main(["video", str(video), "--cache-dir", cache, "--export-dir", str(tmp_path / "v"), "--device", "cpu"])
    with pytest.raises(ImportError, match="cv2"):
        t_cli.main(["auto", str(video), "--cache-dir", cache, "--export-dir", str(tmp_path / "v"), "--device", "cpu"])
    g = Gaussians(means=np.zeros((1, 1, 3), np.float32), scales=np.ones((1, 1, 3), np.float32),
                  rotations=np.array([[[1.0, 0, 0, 0]]], np.float32), harmonics=np.zeros((1, 1, 3, 9), np.float32),
                  opacities=np.ones((1, 1), np.float32))
    pred = Prediction(depth=np.ones((1, 14, 14), np.float32), extrinsics=np.eye(4, dtype=np.float32)[None, :3],
                      intrinsics=np.eye(3, dtype=np.float32)[None], gaussians=g)
    with pytest.raises(ImportError, match="cv2"):
        export(pred, "gs_video", str(tmp_path / "gs"))
