"""The training loop's host side in the port: image I/O, the data iterator,
``gt_num_points``, the upstream-named DA3 loader, and the CLIs
(``create_data`` -> ``train`` -> checkpoint -> resume -> ``test``) on the CPU.

- ``image_io`` against cv2 on this host: binary PPM decodes bit-exactly;
  the uint8 bilinear resize gives ``cv2.resize``'s bits (cv2's 11-bit fixed
  point, run by the port).
- Both ``data_iterator``s give the same batches on the structured fixture,
  bit for bit, ``img`` included.
- The upstream-named DA3 loader on a safetensors file written from the
  port's own ``state_dict()`` (a nested net of small trunks: every prefix):
  the port reloads it bit-exactly, the JAX package's
  ``convert_torch_state_dict`` fills the same flax leaves, nothing unused
  or unfilled on either side.
- The short loop, then the slice as a whole: the JAX ``cli/test.py`` from
  its random init at ``PRNGKey(0)`` against the port's ``cli/test.py`` on a
  checkpoint of the same weights (both with ``compute_dtype=float32``).
"""

import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nuscenes_fixture import make_fixture
from recondet3d.api.weights import _flatten, cast_trunk_params_bf16, convert_torch_state_dict
from recondet3d.api.weights import load_safetensors as j_load_safetensors
from recondet3d.cli.create_data import main as j_create_data
from recondet3d.cli.test import main as j_test_main
from recondet3d.cli.train import build_model_from_cfg as j_build_model_from_cfg
from recondet3d.cli.train import data_iterator as j_data_iterator
from recondet3d.core.config import load_py_config as j_load_py_config
from recondet3d.data.nuscenes import NuScenesDataset as JNuScenesDataset
from recondet3d_torch.api import weights as tw
from recondet3d_torch.cli import train as cli_train
from recondet3d_torch.cli.create_data import main as create_data
from recondet3d_torch.cli import test as cli_test
from recondet3d_torch.cli.train import build_model_from_cfg, data_iterator
from recondet3d_torch.core.config import load_py_config
from recondet3d_torch.data.image_io import imread_rgb, resize_bilinear, write_ppm
from recondet3d_torch.data.nuscenes import NuScenesDataset
from recondet3d_torch.train.checkpoints import latest_checkpoint, load_checkpoint
from test_torch_weights import METRIC_HEAD, METRIC_VIT, SMALL, _poses

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "resdet3d_tiny_centerhead_test.py")
PROD_CFG = os.path.join(REPO, "configs", "resdet3d_centerhead.py")
CLASSES = ("car", "truck", "construction_vehicle", "bus", "trailer", "barrier", "motorcycle", "bicycle",
           "pedestrian", "traffic_cone")


# ------------------------------------------------------------------------------------------------------- image_io

@pytest.mark.parametrize("shape", [(90, 160, 3), (7, 5, 3), (1, 1, 3)])
def test_ppm_decodes_bit_exactly(tmp_path, shape):
    import cv2

    rgb = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    ours, theirs = str(tmp_path / "a.jpg"), str(tmp_path / "b.ppm")
    write_ppm(ours, rgb)  # a P6 file under a .jpg name, as the fixture's trees hold it
    assert cv2.imwrite(theirs, np.ascontiguousarray(rgb[..., ::-1]))
    for path in (ours, theirs):
        got = imread_rgb(path)
        assert got.dtype == np.uint8 and np.array_equal(got, rgb)
        assert np.array_equal(cv2.imread(path)[..., ::-1], got)
    with open(ours, "rb") as f:
        data = f.read()
    commented = str(tmp_path / "c.ppm")
    with open(commented, "wb") as f:
        f.write(b"P6\n# a comment\n%d %d\n# another\n255\n" % (shape[1], shape[0]) + data[-rgb.size:])
    assert np.array_equal(imread_rgb(commented), rgb)


def test_imread_never_returns_nothing(tmp_path, monkeypatch):
    import cv2

    short = str(tmp_path / "short.ppm")
    with open(short, "wb") as f:
        f.write(b"P6\n4 4\n255\n" + bytes(10))
    with pytest.raises(ValueError, match="pixel bytes"):
        imread_rgb(short)
    jpg = str(tmp_path / "x.jpg")
    rgb = np.random.default_rng(0).integers(0, 256, (16, 24, 3), dtype=np.uint8)
    cv2.imwrite(jpg, rgb)
    assert np.array_equal(imread_rgb(jpg), cv2.imread(jpg)[..., ::-1])
    broken = str(tmp_path / "broken.jpg")
    with open(broken, "wb") as f:
        f.write(b"\xff\xd8\xff" + bytes(20))
    with pytest.raises(ValueError, match="JPEG"):
        imread_rgb(broken)
    monkeypatch.setitem(sys.modules, "cv2", None)  # a host without OpenCV
    with pytest.raises(ImportError, match="JPEG"):
        imread_rgb(jpg)
    write_ppm(str(tmp_path / "p.ppm"), rgb)
    assert np.array_equal(imread_rgb(str(tmp_path / "p.ppm")), rgb)


@pytest.mark.parametrize("src,dst", [((90, 160), (900, 1600)), ((90, 160), (45, 70)), ((37, 53), (100, 61)),
                                     ((900, 1600), (280, 504)), ((450, 800), (900, 1600))])
def test_resize_within_one_of_cv2(src, dst):
    """uint8: cv2's INTER_LINEAR in its own fixed point, the same bits (the
    fixture's 90x160 -> the loaders' 900x1600, a shrink to the DA3 input,
    2x enlarging); float32 within 1e-2 of cv2's float path (2e-2 at the
    3.2x shrink)."""
    import cv2

    rng = np.random.default_rng(src[0] + dst[0])
    im = rng.integers(0, 256, src + (3,), dtype=np.uint8)
    got = resize_bilinear(im, dst)
    ref = cv2.resize(im, (dst[1], dst[0]))
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    f = resize_bilinear(im.astype(np.float32), dst)
    fref = cv2.resize(im.astype(np.float32), (dst[1], dst[0]))
    # fp32 on both sides, the interpolation weights formed in another order: ~1e-5 of the 0..255 range; cv2's float
    # path places its taps otherwise at the 3.2x shrink (reading 1.5e-2 there, 1.9e-3 at most elsewhere)
    f32_tol = 2e-2 if (src, dst) == ((900, 1600), (280, 504)) else 1e-2
    assert f.dtype == np.float32 and np.abs(f - fref).max() < f32_tol


# --------------------------------------------------------------------------------------------------- the iterator

@pytest.fixture(scope="module")
def structured(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nusc_cli"))
    make_fixture(root, structured=True)
    assert j_create_data(["nuscenes", "--root-path", root, "--extra-tag", "tiny", "--version", "v1.0-mini"]) == 0
    return root


def overrides(root):
    ann = os.path.join(root, "tiny_infos_train.pkl")
    return ["--cfg-options", f"data.train.ann_file={ann}", f"data.train.data_root={root}",
            f"data.test.ann_file={ann}", f"data.test.data_root={root}"]


@pytest.mark.parametrize("max_objs,epochs", [(0, 1), (32, 2)])
def test_data_iterators_give_the_same_batches(structured, max_objs, epochs):
    kw = dict(ann_file=os.path.join(structured, "tiny_infos_train.pkl"), data_root=structured)
    it_kw = dict(num_points_gt=512, img_hw=(900, 1600), n_cams=6, epochs=epochs, max_objs=max_objs)
    ref = list(j_data_iterator(JNuScenesDataset(**kw), **it_kw))
    got = list(data_iterator(NuScenesDataset(**kw), **it_kw))
    assert len(got) == len(ref) == 4 * epochs
    keys = {"img", "cam2lidar_rts", "gt_points"}
    keys |= {"gt_bboxes_3d", "gt_labels_3d", "gt_bboxes_valid"} if max_objs else set()
    for g, r in zip(got, ref):
        assert set(g) == set(r) == keys
        for k in keys:
            assert torch.is_tensor(g[k]) and g[k].numpy().dtype == r[k].dtype and tuple(g[k].shape) == r[k].shape, k
            assert np.array_equal(g[k].numpy(), r[k]), k
    tail = list(data_iterator(NuScenesDataset(**kw), **dict(it_kw, start=3)))
    assert len(tail) == len(got) - 3 and all(torch.equal(a["gt_points"], b["gt_points"]) for a, b in zip(tail, got[3:]))


# ----------------------------------------------------------------------------------------------------- gt_num_points

@pytest.mark.parametrize("cfg,expected", [(TINY_CFG, 512), (PROD_CFG, 40000)])
def test_gt_num_points_reaches_the_data_iterator(structured, tmp_path, monkeypatch, cfg, expected):
    """The config's ``gt_num_points`` (the tiny config's 512, the production
    default of 40,000) sizes every batch's GT points, as in the JAX CLI.
    The model is built on the meta device (shapes only) and the run stops
    at the iterator's first call."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")  # the production config names a hub checkpoint: never ask for it
    monkeypatch.chdir(tmp_path)  # its cache_dir 'ckpts' is relative: an empty place
    jmodel = j_build_model_from_cfg(j_load_py_config(cfg))
    assert jmodel.reconstruction_backbone.gt_num_points == expected
    assert build_model_from_cfg(load_py_config(cfg), device="meta").reconstruction_backbone.gt_num_points == expected
    build = cli_train.build_model_from_cfg
    monkeypatch.setattr(cli_train, "build_model_from_cfg", lambda c, device, generator: build(c, device="meta"))
    seen = {}

    class Stop(Exception):
        pass

    def capture(dataset, num_points_gt, **kw):
        seen.update(num_points_gt=num_points_gt, **kw)
        raise Stop

    monkeypatch.setattr(cli_train, "data_iterator", capture)
    ann = os.path.join(structured, "tiny_infos_train.pkl")
    inner = "data.train.dataset" if cfg == PROD_CFG else "data.train"  # the production config wraps it in CBGS
    with pytest.raises(Stop):
        cli_train.main([cfg, "--work-dir", str(tmp_path / "wd"), "--device", "cpu", "--cfg-options",
                        f"{inner}.ann_file={ann}", f"{inner}.data_root={structured}"])
    assert seen["num_points_gt"] == expected
    assert seen["max_objs"] == load_py_config(cfg)["model"]["pts_bbox_head"]["max_objs"]


# ------------------------------------------------------------------------------------------------- the DA3 loader

@pytest.fixture(scope="module")
def nested_small():
    """(flax params of a nested net of small trunks at PRNGKey(0), the port's
    net carrying them)."""
    from recondet3d.models.da3 import DPT as JDPT, DepthAnything3Net as JNet, DinoViT as JDinoViT
    from recondet3d.models.da3 import NestedDepthAnything3Net as JNested
    from recondet3d.models.da3.presets import _anyview as j_anyview
    from recondet3d_torch.models.da3 import DPT, DepthAnything3Net, DinoViT, NestedDepthAnything3Net
    from recondet3d_torch.models.da3.presets import _anyview

    jnet = JNested(anyview=j_anyview("vits", dtype=jnp.float32, attn_impl="xla", **SMALL),
                   metric=JNet(net=JDinoViT(dtype=jnp.float32, attn_impl="xla", **METRIC_VIT),
                               head=JDPT(**METRIC_HEAD)))
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, 2, 28, 28, 3)), *_poses())

    def port_net(dtype=torch.float32, param_dtype=None):
        return NestedDepthAnything3Net(
            anyview=_anyview("vits", dtype=dtype, device="cpu", param_dtype=param_dtype, **SMALL),
            metric=DepthAnything3Net(net=DinoViT(device="cpu", dtype=dtype, param_dtype=param_dtype, **METRIC_VIT),
                                     head=DPT(device="cpu", **METRIC_HEAD)))

    tnet = port_net()
    tnet.load_state_dict(tw.state_dict_from_flax({k: np.asarray(v) for k, v in _flatten(params).items()}), strict=True)
    return params, tnet, port_net


def test_safetensors_reader_matches_the_library(tmp_path):
    from safetensors.torch import save_file

    rng = np.random.default_rng(0)
    tensors = {"a.weight": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)),
               "b": torch.from_numpy(rng.standard_normal(7)).to(torch.bfloat16),
               "c": torch.arange(6, dtype=torch.int64).reshape(2, 3), "d": torch.ones(2, dtype=torch.float16),
               "e": torch.tensor([True, False])}
    path = str(tmp_path / "lib.safetensors")
    save_file(tensors, path)
    got = tw.load_safetensors(path)
    assert set(got) == set(tensors)
    for k, t in tensors.items():
        want = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()  # bf16 widened to fp32, exactly
        assert got[k].dtype == want.dtype and np.array_equal(got[k], want), k


def test_upstream_named_da3_loader(nested_small, tmp_path):
    from safetensors.torch import save_file

    params, tnet, port_net = nested_small
    sd = tnet.state_dict()
    path = str(tmp_path / "model.safetensors")
    save_file({k: v.contiguous() for k, v in sd.items()}, path)

    fresh = port_net()
    assert not all(torch.equal(fresh.state_dict()[k], v) for k, v in sd.items())  # starts elsewhere
    unused, unfilled = tw.load_da3_state_dict(fresh, tw.load_safetensors(path))
    assert unused == [] and unfilled == []
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, sd[k]), k

    filled, j_unused, j_unfilled = convert_torch_state_dict(j_load_safetensors(path), params)
    assert j_unused == [] and j_unfilled == []
    want = _flatten(params)
    got = _flatten(filled)
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.array_equal(np.asarray(got[k]), np.asarray(v)), k

    # a key no module has, and a missing one, are reported
    extra = dict(tw.load_safetensors(path))
    extra["da3.head.not_a_layer.weight"] = np.zeros(3, np.float32)
    gone = sorted(extra)[0]
    del extra[gone]
    unused, unfilled = tw.load_da3_state_dict(port_net(), extra)
    assert unused == ["da3.head.not_a_layer.weight"] and unfilled == [gone]


def test_find_and_download_checkpoint(tmp_path, monkeypatch):
    cache = tmp_path / "ckpts"
    assert tw.find_checkpoint("depth-anything/DA3-SMALL", str(cache)) is None
    hub = cache / "models--depth-anything--da3-small" / "snapshots" / "abc"
    hub.mkdir(parents=True)
    (hub / "model.safetensors").write_bytes(b"")
    assert tw.find_checkpoint("depth-anything/DA3-SMALL", str(cache)) == str(hub / "model.safetensors")
    (cache / "da3-small.safetensors").write_bytes(b"")
    assert tw.find_checkpoint("da3-small", str(cache)) == str(cache / "da3-small.safetensors")
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")  # no request leaves the host
    assert tw.download_checkpoint("depth-anything/DA3-SMALL", str(cache)) is None


def test_cast_trunk_params_bf16(nested_small):
    """The same leaves as the JAX package's cast, and on a bf16 net the same
    outputs before and after."""
    params, tnet, port_net = nested_small
    jcast = cast_trunk_params_bf16(params)
    j_names = {tw.torch_name(k) for k, v in _flatten(jcast).items() if v.dtype == jnp.bfloat16}
    net = port_net()
    net.load_state_dict(tnet.state_dict())
    assert set(tw.cast_trunk_params_bf16_(net)) == j_names and len(j_names) > 50

    mixed = port_net(dtype=torch.bfloat16, param_dtype=torch.float32)
    mixed.load_state_dict(tnet.state_dict())
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, 2, 28, 28, 3)).astype(np.float32))
    with torch.no_grad():
        before = mixed(x)["depth"]
        cast = tw.cast_trunk_params_bf16_(mixed)
        after = mixed(x)["depth"]
    assert cast and all(dict(mixed.named_parameters())[n].dtype == torch.bfloat16 for n in cast)
    assert torch.equal(before, after)


# -------------------------------------------------------------------------------------------------- the CLIs

def metric_lines(out):
    return {m.group(1): float(m.group(2)) for m in re.finditer(r"pts_bbox_NuScenes/(\S+): ([0-9.]+)", out)}


def test_short_loop_create_train_resume_test(tmp_path, capsys):
    """create_data -> train 3 steps -> checkpoint -> train to 5 (resumes at
    step 3, takes steps 4 and 5) -> test, all on the CPU."""
    root = str(tmp_path / "nusc")
    make_fixture(root, structured=True)
    assert create_data(["nuscenes", "--root-path", root, "--extra-tag", "tiny", "--version", "v1.0-mini"]) == 0
    wd = str(tmp_path / "wd")
    args = [TINY_CFG, "--work-dir", wd, "--device", "cpu"] + overrides(root)
    assert cli_train.main(args[:1] + ["--max-steps", "3"] + args[1:]) == 0
    out = capsys.readouterr().out
    assert [int(s) for s in re.findall(r"^step (\d+):", out, re.M)] == [1, 2, 3]
    losses = [float(m) for m in re.findall(r" loss=([0-9.]+)", out)]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert latest_checkpoint(wd).endswith("step_00000003.pt")

    assert cli_train.main(args[:1] + ["--max-steps", "5"] + args[1:]) == 0
    out = capsys.readouterr().out
    assert "at step 3" in out
    assert [int(s) for s in re.findall(r"^step (\d+):", out, re.M)] == [4, 5]
    ckpt = latest_checkpoint(wd)
    assert ckpt.endswith("step_00000005.pt") and load_checkpoint(ckpt)["step"] == 5
    assert os.path.exists(os.path.join(wd, "checkpoints", "step_00000004.pt"))  # one per epoch (4 samples)

    assert cli_test.main([TINY_CFG, "--checkpoint", ckpt, "--device", "cpu"] + overrides(root)) == 0
    metrics = metric_lines(capsys.readouterr().out)
    assert {f"{c}_AP" for c in CLASSES} | {"mAP", "NDS"} <= set(metrics)
    assert all(np.isfinite(v) for v in metrics.values())


def test_entry_points_run_on_the_card_unless_told(structured, tmp_path):
    args = [TINY_CFG, "--work-dir", str(tmp_path / "wd")] + overrides(structured)
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is available")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_train.main(args)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_test.main([TINY_CFG] + overrides(structured))
    # data parallelism: on CUDA devices unless told (none here), two gloo workers with --device cpu
    with pytest.raises(RuntimeError, match="--num-devices 2 needs 2 CUDA devices, but 0 are visible"):
        cli_train.main(args + ["--num-devices", "2"])
    assert cli_train.main(args + ["--num-devices", "2", "--device", "cpu", "--max-steps", "1",
                                  "--checkpoint-interval", "0"]) == 0
    assert load_checkpoint(latest_checkpoint(str(tmp_path / "wd")))["step"] == 1


@pytest.fixture(scope="module")
def structured_full_res(tmp_path_factory):
    """The structured fixture with its images rewritten at the loaders' 900x1600 (cv2's resize, binary PPM):
    neither package's loader resizes them, so both read the same pixels. The loaders' own resizes give the same
    bits (``test_resize_within_one_of_cv2``); the CLIs are compared here, the resize above."""
    import cv2

    root = str(tmp_path_factory.mktemp("nusc_full_res"))
    make_fixture(root, structured=True)
    for cam in ("CAM_FRONT", "CAM_BACK"):
        folder = os.path.join(root, "samples", cam)
        for name in os.listdir(folder):
            path = os.path.join(folder, name)
            write_ppm(path, cv2.resize(cv2.imread(path), (1600, 900))[..., ::-1])
    assert j_create_data(["nuscenes", "--root-path", root, "--extra-tag", "tiny", "--version", "v1.0-mini"]) == 0
    return root


def test_test_cli_matches_jax_from_the_same_weights(structured_full_res, tmp_path, capsys, monkeypatch):
    """The slice as a whole: the JAX ``cli/test.py`` initialises the tiny
    CenterHead model at ``PRNGKey(0)`` (its ``model.init`` on the first
    batch's shapes); the same variables, made here the same way, go into a
    port checkpoint through ``state_dict_from_flax``, and the port's
    ``cli/test.py`` evaluates it. Both run in fp32 (``compute_dtype``), on
    the same fixture (``structured_full_res``: the same pixels in both). Per
    sample the box counts are equal; the boxes, in score order, agree within
    tests/test_torch_resdet3d_det.py's decode tolerance (1e-3) and every
    printed metric within 1e-3."""
    structured = structured_full_res
    ov = overrides(structured) + ["compute_dtype=float32"]
    captured = {}
    for tag, cls in (("jax", JNuScenesDataset), ("torch", NuScenesDataset)):
        evaluate = cls.evaluate

        def spy(self, results, *a, _tag=tag, _evaluate=evaluate, **kw):
            captured[_tag] = results
            return _evaluate(self, results, *a, **kw)

        monkeypatch.setattr(cls, "evaluate", spy)

    assert j_test_main([TINY_CFG] + ov) in (0, None)
    j_out = capsys.readouterr().out

    cfg = j_load_py_config(TINY_CFG, {"compute_dtype": "float32"})
    jmodel = j_build_model_from_cfg(cfg)
    shape = (1, 2, 900, 1600, 3)  # the fixture's two cameras at the iterator's size
    variables = jax.jit(lambda r: jmodel.init(r, jnp.zeros(shape, jnp.float32), jnp.zeros((1, 2, 4, 4), jnp.float32)))(
        jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten(variables).items()}
    model = build_model_from_cfg(load_py_config(TINY_CFG, {"compute_dtype": "float32"}), device="cpu")
    res = model.load_state_dict(tw.state_dict_from_flax(flat), strict=False)
    assert not res.unexpected_keys and all(".cam_enc." in k for k in res.missing_keys), res  # no poses: unused
    ckpt = str(tmp_path / "from_jax.pt")
    torch.save({"step": 0, "model": model.state_dict()}, ckpt)
    assert cli_test.main([TINY_CFG, "--checkpoint", ckpt, "--device", "cpu"] + ov) == 0
    t_out = capsys.readouterr().out

    count = lambda out: [int(n) for n in re.findall(r"^sample \d+: (\d+) boxes", out, re.M)]  # noqa: E731
    assert count(t_out) == count(j_out) and len(count(t_out)) == 4
    for got, ref in zip(captured["torch"], captured["jax"]):
        # scores of this random head lie close together (fp32 sums in another order reorder near-equal ones), so
        # each of the port's boxes, in score order, is matched to the JAX box of its label nearest in box and score
        gs, rs = np.concatenate([got["boxes_3d"], got["scores_3d"][:, None]], 1), \
            np.concatenate([ref["boxes_3d"], ref["scores_3d"][:, None]], 1)
        free = np.ones(len(rs), bool)
        for i in np.argsort(-got["scores_3d"], kind="stable"):
            cand = np.flatnonzero(free & (ref["labels_3d"] == got["labels_3d"][i]))
            assert len(cand), f"no JAX box of label {got['labels_3d'][i]} left for box {i}"
            j = cand[np.argmin(np.abs(rs[cand] - gs[i]).max(1))]
            free[j] = False
            np.testing.assert_allclose(gs[i], rs[j], atol=1e-3, rtol=1e-3, err_msg=f"box {i}")
    jm, tm = metric_lines(j_out), metric_lines(t_out)
    assert set(tm) == set(jm) and len(tm) == 17
    for k, v in jm.items():
        assert abs(tm[k] - v) <= 1e-3, (k, tm[k], v)


def test_bf16_moves_the_camera_as_far_as_in_jax(structured_full_res):
    """Where the two packages' training runs part: the tiny config's model
    at the JAX package's ``PRNGKey(4)`` weights, on the fixture's first batch
    (the same pixels in both), in fp32 and in the config's bf16. The camera
    decoder's pose encoding (the intrinsics that back-project the depth)
    agrees within 1e-4 between the packages in fp32 (measured 2.6e-6); in
    bf16 each package's rounding moves it from its own fp32 value by about
    1 % (on this host: JAX 0.95 %, the port 1.02 %), and the port is held to
    1.5x the JAX package's move. A 1 % move of the intrinsics shifts every
    back-projected point, so the point path's selections (FPS, ball query)
    and the clouds after it differ between any two bf16 runs, one package's
    included, and the training runs from there part (PERF.md, PR 7)."""
    ds = JNuScenesDataset(ann_file=os.path.join(structured_full_res, "tiny_infos_train.pkl"),
                          data_root=structured_full_res, classes=CLASSES)
    batch = next(j_data_iterator(ds, num_points_gt=8, img_hw=(900, 1600), n_cams=6, epochs=1))
    img, c2l = jnp.asarray(batch["img"]), jnp.asarray(batch["cam2lidar_rts"])
    pose = {}
    for dt in ("float32", "bfloat16"):
        jmodel = j_build_model_from_cfg(j_load_py_config(TINY_CFG, {"compute_dtype": dt}))
        variables = jax.jit(lambda r: jmodel.init(r, img, c2l))(jax.random.PRNGKey(4))
        _, state = jax.jit(lambda v: jmodel.apply(v, img, c2l, mutable=["intermediates"], capture_intermediates=(
            lambda mdl, _: type(mdl).__name__ == "CameraDec")))(variables)
        (jpose,) = jax.tree_util.tree_leaves(state["intermediates"])
        model = build_model_from_cfg(load_py_config(TINY_CFG, {"compute_dtype": dt}), device="cpu").eval()
        model.load_state_dict(tw.state_dict_from_flax({k: np.asarray(v) for k, v in _flatten(variables).items()}),
                              strict=False)
        got = []
        hook = model.reconstruction_backbone.da3.cam_dec.register_forward_hook(lambda m, a, o: got.append(o))
        with torch.no_grad():
            model.simple_test(torch.from_numpy(batch["img"]), torch.from_numpy(batch["cam2lidar_rts"]))
        hook.remove()
        pose[dt] = np.asarray(jpose, np.float64), got[0].double().numpy()
    rel = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)  # noqa: E731
    (j32, t32), (j16, t16) = pose["float32"], pose["bfloat16"]
    assert rel(t32, j32) < 1e-4
    jax_move, port_move = rel(j16, j32), rel(t16, t32)
    print(f"[pose encoding] fp32 port vs JAX {rel(t32, j32):.2e}; bf16 vs fp32: JAX {jax_move:.2e}, port {port_move:.2e}",
          file=sys.__stderr__)
    assert 1e-3 < jax_move < 3e-2, jax_move  # bf16 rounding, not a fault of either package
    assert port_move < 1.5 * jax_move, (port_move, jax_move)
