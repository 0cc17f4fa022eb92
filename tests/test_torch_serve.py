"""The port's HTTP backend, web app, gallery and inference client
(``recondet3d_torch/serve``) on the CPU, beside the JAX package's.

The six cases of tests/test_serve.py run on the port's server with a
``ModelManager("da3-small", device="cpu")`` and two 90x160 views at
process_res 56, plus:

- parity: the same two views through the JAX server and the port's, each
  manager's model slot holding the same da3-small weights (the port's,
  seed 0, carried into the JAX package by ``flax_from_named`` on the leaf
  paths of a ``jax.eval_shape`` of its init: bit-exact, no compiled init).
  ``prediction_mini.npz`` and ``scene.npz`` depth, conf, extrinsics and
  intrinsics at ATOL 1e-3 / RTOL 1e-2, tests/test_torch_da3_api.py's
  tolerance, with the port handed cv2's resize as there;
- the scene store: one prediction saved by each package gives the same
  ``scene.npz`` (keys, dtypes, arrays), and ``scene_meta``,
  ``camera_frusta``, ``scene_points_bin`` and ``measure`` agree to 1e-6,
  ``depth_png`` and ``image_jpg`` byte for byte;
- ``InferenceService`` against the port's server, and locally;
- the 3DGS video of ``POST /scene/<tid>/gs_video`` renders on the manager's
  device;
- the lazy load and ``/reload``;
- a scene with every pixel sky (random weights) exports a GLB of its
  cameras alone, which the gallery lists;
- no fallback: with ``torch.cuda.is_available`` patched to False, a manager
  built without ``device="cpu"`` fails its task with ``resolve_device``'s
  error and never builds a model.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from recondet3d.api import DepthAnything3 as JDepthAnything3
from recondet3d.models.da3.presets import build_da3 as j_build_da3
from recondet3d.serve import backend as j_backend
from recondet3d.serve import scene_store as j_ss
from recondet3d_torch.api import DepthAnything3
from recondet3d_torch.api.weights import flax_from_named
from recondet3d_torch.models.da3 import build_da3, gs_renderer
from recondet3d_torch.serve import scene_store as t_ss
from recondet3d_torch.serve.backend import ModelManager, create_server
from recondet3d_torch.serve.inference_service import InferenceService
from test_torch_da3_api import use_cv2_resize

ATOL, RTOL = 1e-3, 1e-2
SCENE_TOL = 1e-6
FIELDS = ("depth", "conf", "extrinsics", "intrinsics")


def jax_api_from_port(model, name="da3-small", with_gs=True):
    """A JAX ``DepthAnything3`` that holds ``model``'s weights: the leaf
    paths of an ``eval_shape`` of its init (every branch it builds), filled
    by ``flax_from_named``."""
    jmodel = j_build_da3(name, dtype=jnp.float32, with_gs=with_gs)
    x0 = jnp.zeros((1, 2, 28, 28, 3))
    ext0 = jnp.broadcast_to(jnp.eye(4), (1, 2, 4, 4))
    ixt0 = jnp.broadcast_to(jnp.eye(3) * 20.0, (1, 2, 3, 3))
    shapes = jax.eval_shape(lambda r: jmodel.init(r, x0, ext0, ixt0, infer_gs=with_gs), jax.random.PRNGKey(0))
    paths = ["/".join(k) for k in flatten_dict(shapes)]
    flat = flax_from_named(model.state_dict(), paths)
    assert len(flat) == len(paths)
    return JDepthAnything3(jmodel, unflatten_dict({tuple(p.split("/")): jnp.asarray(a) for p, a in flat.items()}),
                           name)


def _serve(manager):
    manager.start()
    srv = create_server(manager, "127.0.0.1", 0) if isinstance(manager, ModelManager) else \
        j_backend.create_server(manager, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def model():
    return build_da3("da3-small", dtype=torch.float32, device="cpu", with_gs=True,
                     generator=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def server(tmp_path_factory, model):
    workdir = str(tmp_path_factory.mktemp("backend"))
    mgr = ModelManager("da3-small", cache_dir="/nonexistent", workdir=workdir, device="cpu")
    mgr._model = DepthAnything3(model, "da3-small")
    srv, url = _serve(mgr)
    yield url, mgr, workdir
    srv.shutdown()
    mgr.stop()


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    import cv2

    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(2):
        p = str(d / f"img{i}.png")
        cv2.imwrite(p, rng.integers(0, 255, (90, 160, 3), np.uint8))
        paths.append(p)
    return paths


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return json.loads(r.read())


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _wait_done(url, tid, timeout=300):
    deadline = time.time() + timeout
    while time.time() < deadline:
        status = _get(f"{url}/status/{tid}")
        if status["status"] in ("done", "failed"):
            return status
        time.sleep(0.05)
    return status


def _infer(url, payload):
    status = _wait_done(url, _post(url + "/inference", payload)["task_id"])
    assert status["status"] == "done", status.get("error")
    return status


def _multipart(files, fields):
    """files: [(field, name, bytes)]"""
    b = b"----recondet3dboundary"
    out = []
    for field, name, data in files:
        out += [b"--" + b, f'Content-Disposition: form-data; name="{field}"; filename="{name}"'.encode(), b"", data]
    for k, v in fields.items():
        out += [b"--" + b, f'Content-Disposition: form-data; name="{k}"'.encode(), b"", str(v).encode()]
    out += [b"--" + b + b"--", b""]
    return b"\r\n".join(out), f"multipart/form-data; boundary={b.decode()}"


def _upload(url, files, fields):
    body, ctype = _multipart(files, fields)
    req = urllib.request.Request(url + "/upload", data=body, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=30) as r:
        return _wait_done(url, json.loads(r.read())["task_id"])


def test_health_and_memory(server):
    url, _, _ = server
    assert _get(url + "/health") == {"status": "ok", "model": "da3-small"}
    mem = _get(url + "/device-memory")
    assert mem == _get(url + "/gpu-memory") == {"bytes_in_use": None, "bytes_limit": None, "platform": "cpu",
                                                "kind": None}


def test_dashboard(server):
    url, _, _ = server
    with urllib.request.urlopen(url + "/dashboard", timeout=10) as r:
        html = r.read().decode()
    assert "recondet3d" in html and "tasks" in html and "platform: cpu" in html


def test_inference_task_roundtrip(server, images):
    url, _, _ = server
    status = _infer(url, dict(images=images, export_format="mini_npz", process_res=56))
    assert status["result"]["num_views"] == 2 and status["result"]["depth_shape"] == [2, 28, 56]
    files = sorted(os.listdir(status["result"]["export_dir"]))
    assert files == ["prediction_mini.npz", "scene.npz"]
    tid = status["id"]
    assert any(e["task_id"] == tid and e["files"] == files for e in _get(url + "/gallery/manifest"))
    assert _get(url + "/tasks")[tid]["status"] == "done"
    with urllib.request.urlopen(f"{url}/files/{tid}/prediction_mini.npz", timeout=10) as r:
        assert r.read(2) == b"PK"


def test_webapp_scene_endpoints(server):
    """Upload through the web app's multipart path, then every scene
    endpoint the page uses (viewer points, depth/image, measure, meta)."""
    import cv2

    url, _, _ = server
    rng = np.random.default_rng(1)
    files = [("images", f"img{i}.png", cv2.imencode(".png", rng.integers(0, 255, (90, 160, 3), np.uint8))[1].tobytes())
             for i in range(2)]
    status = _upload(url, files, dict(export_format="depth_vis", ref_view_strategy="first"))
    assert status["status"] == "done", status.get("error")
    tid = status["id"]

    meta = _get(f"{url}/scene/{tid}/meta")
    assert meta["num_views"] == 2 and meta["height"] > 0 and not meta["has_gs"]
    assert len(meta["frusta"]) == 2 and len(meta["frusta"][0]) == 8

    with urllib.request.urlopen(f"{url}/scene/{tid}/points.bin?max=5000&conf=30", timeout=30) as r:
        pts = np.frombuffer(r.read(), "<f4").reshape(-1, 6)
    assert 0 < len(pts) <= 5000 and np.isfinite(pts).all()

    for ep, magic in [("depth/0.png", b"\x89PNG"), ("image/1.jpg", b"\xff\xd8")]:
        with urllib.request.urlopen(f"{url}/scene/{tid}/{ep}", timeout=30) as r:
            assert r.read(4)[:len(magic)] == magic, ep

    m = _get(f"{url}/scene/{tid}/measure?view=0&u=0.5&v=0.5")
    assert m["view"] == 0 and "depth" in m

    with urllib.request.urlopen(url + "/app", timeout=10) as r:
        html = r.read().decode()
    assert "Point Cloud" in html and "webgl" in html and "measure" in html

    # gs_video on a scene without gaussians must 400, not 500
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{url}/scene/{tid}/gs_video", {})
    assert e.value.code == 400


def test_webapp_video_upload(server, tmp_path):
    """Video upload -> server-side frame extraction -> reconstruction."""
    import cv2

    url, _, _ = server
    vp = str(tmp_path / "clip.mp4")
    w = cv2.VideoWriter(vp, cv2.VideoWriter_fourcc(*"mp4v"), 10, (160, 90))
    rng = np.random.default_rng(2)
    for _ in range(25):
        w.write(rng.integers(0, 255, (90, 160, 3), np.uint8))
    w.release()
    status = _upload(url, [("video", "clip.mp4", open(vp, "rb").read())],
                     dict(s_time_interval=1.0, export_format="mini_npz"))
    assert status["status"] == "done", status.get("error")
    # 25 frames at 10 fps sampled every 1 s -> 3 frames
    assert status["result"]["num_views"] == 3


def test_gallery_server(tmp_path):
    """Group/scene manifests + page + GLB fetch, as tests/test_serve.py."""
    import cv2

    from recondet3d_torch.data.export.glb import write_glb_pointcloud
    from recondet3d_torch.serve.gallery import create_gallery_server

    root = tmp_path / "gal"
    scene = root / "outdoor" / "scene_a"
    scene.mkdir(parents=True)
    rng = np.random.default_rng(0)
    write_glb_pointcloud(str(scene / "scene.glb"), rng.normal(size=(100, 3)).astype(np.float32),
                         colors=rng.random((100, 3)).astype(np.float32))
    cv2.imwrite(str(scene / "scene.jpg"), rng.integers(0, 255, (40, 60, 3), np.uint8))
    (scene / "depth_vis").mkdir()
    cv2.imwrite(str(scene / "depth_vis" / "depth_0.png"), rng.integers(0, 255, (40, 60, 3), np.uint8))

    srv = create_gallery_server(str(root), "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        assert [g["id"] for g in _get(url + "/manifest.json")["groups"]] == ["outdoor"]
        man = _get(url + "/manifest/outdoor.json")
        assert len(man["items"]) == 1
        item = man["items"][0]
        assert item["model"] == "/outdoor/scene_a/scene.glb"
        assert item["thumbnail"] == "/outdoor/scene_a/scene.jpg"
        assert item["depth_images"] == ["/outdoor/scene_a/depth_vis/depth_0.png"]
        with urllib.request.urlopen(url + "/", timeout=10) as r:
            html = r.read().decode()
        assert "loadGLB" in html and "manifest.json" in html
        with urllib.request.urlopen(url + item["model"], timeout=10) as r:
            assert r.read(4) == b"glTF"
        with pytest.raises(urllib.error.HTTPError) as e:  # directory listings disabled
            urllib.request.urlopen(url + "/outdoor/", timeout=10)
        assert e.value.code == 404
    finally:
        srv.shutdown()


def test_server_matches_jax(server, model, images, tmp_path, monkeypatch):
    url, _, _ = server
    mgr = j_backend.ModelManager("da3-small", cache_dir="/nonexistent", workdir=str(tmp_path / "jax"))
    mgr._model = jax_api_from_port(model)
    srv, j_url = _serve(mgr)
    try:
        use_cv2_resize(monkeypatch)
        payload = dict(images=images, export_format="mini_npz", process_res=56)
        t_dir = _infer(url, payload)["result"]["export_dir"]
        j_dir = _infer(j_url, payload)["result"]["export_dir"]
    finally:
        srv.shutdown()
        mgr.stop()
    for name in ("prediction_mini.npz", "scene.npz"):
        tz, jz = np.load(os.path.join(t_dir, name)), np.load(os.path.join(j_dir, name))
        assert sorted(tz.files) == sorted(jz.files), name
        for f in FIELDS:
            np.testing.assert_allclose(tz[f], jz[f], atol=ATOL, rtol=RTOL, err_msg=f"{name}: {f}")
    tz, jz = np.load(os.path.join(t_dir, "scene.npz")), np.load(os.path.join(j_dir, "scene.npz"))
    assert {k: tz[k].dtype for k in tz.files} == {k: jz[k].dtype for k in jz.files}
    np.testing.assert_array_equal(tz["images"], jz["images"])


def test_scene_store_matches_jax(model, images, tmp_path):
    pred = DepthAnything3(model, "da3-small").inference(images, process_res=56, infer_gs=True)
    t_dir, j_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    t_ss.save_scene(t_dir, pred)
    j_ss.save_scene(j_dir, pred)
    tz, jz = np.load(os.path.join(t_dir, "scene.npz")), np.load(os.path.join(j_dir, "scene.npz"))
    assert sorted(tz.files) == sorted(jz.files) and "gs_means" in tz.files
    for k in tz.files:
        assert tz[k].dtype == jz[k].dtype and np.array_equal(tz[k], jz[k]), k

    # the JAX package's scene, read by the port's store, and the same calls on both
    ts, js = t_ss.load_scene(j_dir), j_ss.load_scene(j_dir)
    assert t_ss.load_scene(str(tmp_path / "none")) is None
    tm, jm = t_ss.scene_meta(ts), j_ss.scene_meta(js)
    assert tm.keys() == jm.keys() and tm["has_gs"] and tm["num_views"] == 2
    for k in tm:
        np.testing.assert_allclose(np.asarray(tm[k], float), np.asarray(jm[k], float), atol=SCENE_TOL, err_msg=k)
    np.testing.assert_allclose(t_ss.camera_frusta(ts), j_ss.camera_frusta(js), atol=SCENE_TOL)
    for kw in (dict(), dict(max_points=500, conf_percent=50.0, filter_black_bg=True, filter_white_bg=True)):
        tb, jb = np.frombuffer(t_ss.scene_points_bin(ts, **kw), "<f4"), np.frombuffer(j_ss.scene_points_bin(js, **kw),
                                                                                        "<f4")
        assert tb.size == jb.size > 0
        np.testing.assert_allclose(tb, jb, atol=SCENE_TOL)
    for view, (u, v) in ((0, (0.5, 0.5)), (1, (0.0, 1.0))):
        assert t_ss.measure(ts, view, u, v) == j_ss.measure(js, view, u, v)
        assert t_ss.depth_png(ts, view) == j_ss.depth_png(js, view)
        assert t_ss.image_jpg(ts, view) == j_ss.image_jpg(js, view)


def test_all_sky_scene_exports_and_lists(tmp_path):
    """Every pixel sky (as on random weights): the GLB holds the camera
    frusta alone (glTF has no empty accessor; the JAX exporter raises on an
    empty cloud), and the gallery lists the scene."""
    import struct

    from recondet3d_torch.data.export import export
    from recondet3d_torch.serve.gallery import build_group_list, build_group_manifest
    from recondet3d_torch.specs import Prediction

    ext = np.tile(np.eye(4, dtype=np.float32)[:3], (2, 1, 1))
    ixt = np.tile(np.array([[40.0, 0, 28], [0, 40.0, 14], [0, 0, 1]], np.float32), (2, 1, 1))
    pred = Prediction(depth=np.ones((2, 28, 56), np.float32), conf=np.ones((2, 28, 56), np.float32),
                      sky=np.ones((2, 28, 56), bool), extrinsics=ext, intrinsics=ixt,
                      processed_images=np.zeros((2, 28, 56, 3), np.uint8))
    d = tmp_path / "wd" / "tasks" / "t0"
    export(pred, "glb", str(d))
    data = (d / "scene.glb").read_bytes()
    n_json = struct.unpack("<I", data[12:16])[0]
    gltf = json.loads(data[20:20 + n_json])
    assert struct.unpack("<III", data[:12]) == (0x46546C67, 2, len(data))
    assert [p["mode"] for m in gltf["meshes"] for p in m["primitives"]] == [1, 1]  # two frusta, no POINTS
    assert all(a["count"] > 0 for a in gltf["accessors"])
    root = str(tmp_path / "wd")
    assert build_group_list(root) == {"groups": [{"id": "tasks", "title": "tasks"}]}
    assert [e["id"] for e in build_group_manifest(root, "tasks")["items"]] == ["t0"]


def test_inference_service(server, model, images):
    url, _, _ = server
    res = InferenceService("da3-small", backend_url=url).run_inference(images, process_res=56, poll_interval=0.05)
    assert res["num_views"] == 2 and os.path.isfile(os.path.join(res["export_dir"], "prediction_mini.npz"))
    local = InferenceService("da3-small", cache_dir="/nonexistent", device="cpu")
    local._model = DepthAnything3(model, "da3-small")
    pred = local.run_inference(images, process_res=56)
    assert pred.depth.shape == (2, 28, 56) and local.backend_url is None


def test_gs_video_on_manager_device(server, images, monkeypatch):
    url, mgr, _ = server
    status = _infer(url, dict(images=images, export_format="mini_npz", process_res=56, infer_gs=True))
    tid = status["id"]
    assert _get(f"{url}/scene/{tid}/meta")["has_gs"]
    seen, render = [], gs_renderer.render_3dgs
    monkeypatch.setattr(gs_renderer, "render_3dgs",
                        lambda *a, **kw: (lambda out: seen.append(str(out[0].device)) or out)(render(*a, **kw)))
    out = _post(f"{url}/scene/{tid}/gs_video", {"frames": 4, "traj": "wobble"})
    assert out == {"file": f"/files/{tid}/gs_video.mp4"} and seen == [str(mgr.device)]
    with urllib.request.urlopen(url + out["file"], timeout=30) as r:
        assert len(r.read()) > 0


def test_lazy_load_and_reload(tmp_path, images):
    mgr = ModelManager("da3-small", cache_dir=str(tmp_path / "none"), workdir=str(tmp_path / "wd"), device="cpu")
    srv, url = _serve(mgr)
    try:
        assert mgr._model is None
        assert _infer(url, dict(images=images, process_res=56))["result"]["num_views"] == 2
        first = mgr._model
        assert first is not None and first.random_init and first.device == torch.device("cpu")
        assert _post(url + "/reload", {}) == {"status": "reloading"} and mgr._model is None
        _infer(url, dict(images=images, process_res=56))
        assert mgr._model is not None and mgr._model is not first
    finally:
        srv.shutdown()
        mgr.stop()


def test_no_cpu_fallback(tmp_path, images, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mgr = ModelManager("da3-small", cache_dir=str(tmp_path / "none"), workdir=str(tmp_path / "wd"))
    assert mgr.device == "cuda"
    srv, url = _serve(mgr)
    try:
        status = _wait_done(url, _post(url + "/inference", dict(images=images, process_res=56))["task_id"])
        assert status["status"] == "failed" and "CUDA is not available" in status["error"]
        assert mgr._model is None
        assert "platform" not in _get(url + "/device-memory")  # a failed query, not a CPU answer
    finally:
        srv.shutdown()
        mgr.stop()


def test_launch_counts_and_build_hold_across_threads(monkeypatch):
    """A server's worker and handler threads may launch at once: no count is
    lost, and the kernels build once (fake kernels and a fake build, so that
    this runs without a card; 16 threads, the switch interval shortened)."""
    import sys

    from recondet3d_torch.ops import attention, build

    monkeypatch.setattr(attention, "_kernel_fn", lambda name: (lambda *args: 0))
    monkeypatch.setattr(attention, "_cuda_hooks", lambda: ((lambda: 0), (lambda index: 0)))
    attention.reset_launch_counts()
    builds = []
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_build_and_load", lambda: (builds.append(1), time.sleep(0.05),
                                                           build._libs.update(fake=None)))
    threads, calls = 16, 2000
    device = torch.device("cuda", 0)

    def work():
        assert build.load_kernels() == {"fake": None}
        for _ in range(calls):
            attention._launch(attention.flash_attention_fwd, "fake", (), (), (), device, (1, 1, 1, 1, 64))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    try:
        assert not any(th.is_alive() for th in pool) and builds == [1]
        assert attention.flash_attention_fwd.launches == threads * calls
        assert attention.flash_attention_fwd.launches_by_shape == {(1, 1, 1, 1, 64): threads * calls}
    finally:
        attention.reset_launch_counts()
