"""The port's remaining entry points vs the JAX package's, on the CPU:
``inference_nuscenes`` (with ``PointPipeline``), ``inference_mmdet3d``,
``check_model_memory``, ``vis_occupancy`` and ``gt_vis``, plus
``utils/vis.py``.

Weights: both packages hold the same random weights. The port's (seed 0)
reach the JAX package through ``flax_from_named`` on the leaf paths of a
``jax.eval_shape`` of the JAX model's init, which is bit-exact and skips the
compiled init.

Tolerances and what is compared:

- ``inference_nuscenes``: the DA3 predictions of the two packages agree at
  ATOL 1e-3 / RTOL 1e-2 (tests/test_torch_da3_api.py's gate; the port is
  handed cv2's resize, as there). Clouds built from predictions that differ
  at that level are not comparable point for point: a point within 1e-4 m
  of a 0.1 m voxel face lands in another voxel, and an FPS pick then moves.
  So the point stage is held on ONE prediction (the JAX package's), handed
  to both packages' ``run_inference_for_frame``: the voxel stage's valid
  count exactly and its centroids sorted by coordinates at 1e-5 (fp32 means
  summed in another order), the final cloud's size exactly and its points
  sorted by coordinates at ATOL/RTOL. The clouds of each package's own
  prediction are compared by size and range.
- ``inference_mmdet3d``: one checkpoint of the port's seed-0 weights,
  written for each CLI (a ``.pt`` and an orbax tree). The PCD of each CLI:
  the same number of points (FPS fills ``num_points``), the same range at
  0.5 m, and every port point within 0.5 m of a JAX point. DA3 differs
  between the packages at the ATOL above, so FPS picks differ (as above).
- ``check_model_memory``: parameter counts per component and TOTAL equal.
- ``vis_occupancy``, ``gt_vis`` and the drawing helpers: PNG bytes and
  arrays equal.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from nuscenes_fixture import make_fixture
from recondet3d.cli import inference_nuscenes as j_nusc
from recondet3d.data.pipelines import point_pipeline as jpp
from recondet3d_torch.api import DepthAnything3
from recondet3d_torch.api.weights import flax_from_named
from recondet3d_torch.cli import inference_nuscenes as t_nusc
from recondet3d_torch.data.export import read_pcd
from recondet3d_torch.data.pipelines import point_pipeline as tpp
from recondet3d_torch.models.da3 import build_da3
from test_torch_da3_api import use_cv2_resize
from test_torch_serve import jax_api_from_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 1e-3, 1e-2
CENTROID_ATOL = 1e-5
NUSC_ARGS = ["--model", "da3-small", "--max-samples", "1", "--process-res", "56", "--num-points", "256",
             "--anchor-points", "64", "--max-depth", "20"]
TINY_CONFIG = os.path.join(REPO, "configs", "resdet3d_tiny_test.py")


def sort_rows(a):
    a = np.asarray(a)
    return a[np.lexsort(a.T[::-1])]


class Recorder:
    """A DA3 API whose ``inference`` keeps its prediction; or, given
    ``pred``, always returns that prediction."""

    def __init__(self, api=None, pred=None, device="cpu"):
        self.api, self.pred, self.device = api, pred, torch.device(device)

    def inference(self, *args, **kwargs):
        if self.api is not None:
            self.pred = self.api.inference(*args, **kwargs)
        return self.pred


@pytest.fixture(scope="module")
def nusc_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nusc"))
    make_fixture(root)
    from recondet3d_torch.cli.create_data import main as create_data_main

    assert create_data_main(["nuscenes", "--root-path", root, "--extra-tag", "tiny", "--version", "v1.0-mini"]) in (
        0, None)
    return root


def _overrides(root):
    ann = os.path.join(root, "tiny_infos_train.pkl")
    return ["--cfg-options", f"data.train.ann_file={ann}", f"data.train.data_root={root}",
            f"data.test.ann_file={ann}", f"data.test.data_root={root}"]


def test_inference_nuscenes_matches_jax(nusc_root, monkeypatch):
    from recondet3d.data.nuscenes import NuScenesTables as JTables
    from recondet3d_torch.data.nuscenes import NuScenesTables

    targs = t_nusc.parse_args(["--dataroot", nusc_root, "--device", "cpu"] + NUSC_ARGS)
    jargs = j_nusc.parse_args(["--dataroot", nusc_root] + NUSC_ARGS)
    t_tables, j_tables = NuScenesTables(targs.version, nusc_root), JTables(jargs.version, nusc_root)
    t_infos = t_nusc.get_nusc_info(t_tables, t_tables.sample[0])
    j_infos = j_nusc.get_nusc_info(j_tables, j_tables.sample[0])
    assert sorted(t_infos) == sorted(j_infos) == ["CAM_BACK", "CAM_FRONT"]
    for cam in t_infos:
        assert t_infos[cam]["data_path"] == j_infos[cam]["data_path"]
        for key in ("sensor2lidar_rotation", "sensor2lidar_translation"):
            np.testing.assert_array_equal(t_infos[cam][key], j_infos[cam][key])

    model = build_da3("da3-small", dtype=torch.float32, device="cpu", generator=torch.Generator().manual_seed(0))
    t_api, j_api = Recorder(DepthAnything3(model, "da3-small")), Recorder(jax_api_from_port(model, with_gs=False))
    use_cv2_resize(monkeypatch)
    t_own = t_nusc.run_inference_for_frame(t_api, t_infos, targs)
    j_own = j_nusc.run_inference_for_frame(j_api, j_infos, jargs)
    tp, jp = t_api.pred, j_api.pred
    for field in ("depth", "conf", "intrinsics"):
        np.testing.assert_allclose(getattr(tp, field), getattr(jp, field), atol=ATOL, rtol=RTOL, err_msg=field)
    assert tp.sky is None and jp.sky is None
    # each package's own prediction: the same size, the same range
    assert t_own.shape == j_own.shape == (256, 3)
    np.testing.assert_allclose(t_own.min(0), j_own.min(0), atol=0.5)
    np.testing.assert_allclose(t_own.max(0), j_own.max(0), atol=0.5)

    # the point stage on one prediction: the voxel centroids, then the whole stage
    cloud = t_nusc.fuse_views(jp, t_infos, targs)
    buf, valid, cap = t_nusc.pad_points(cloud)
    vox = t_nusc.point_transforms(targs, cap)[0]
    kw = {k: v for k, v in vox.items() if k != "type"}
    tc, tv = tpp.voxel_downsample(torch.from_numpy(buf), torch.from_numpy(valid), **kw)
    jc, jv = jpp.voxel_downsample(jnp.asarray(buf), jnp.asarray(valid), **kw)
    tv, jv = tv.numpy(), np.asarray(jv)
    assert tv.sum() == jv.sum() > 256
    np.testing.assert_allclose(sort_rows(tc.numpy()[tv]), sort_rows(np.asarray(jc)[jv]), atol=CENTROID_ATOL, rtol=0)
    t_pts = t_nusc.run_inference_for_frame(Recorder(pred=jp), t_infos, targs)
    j_pts = j_nusc.run_inference_for_frame(Recorder(pred=jp), j_infos, jargs)
    assert t_pts.shape == j_pts.shape == (256, 3)
    np.testing.assert_allclose(sort_rows(t_pts), sort_rows(j_pts), atol=ATOL, rtol=RTOL)


def test_inference_nuscenes_cli_writes_pcd(nusc_root, tmp_path):
    out = str(tmp_path / "out")
    assert t_nusc.main(["--dataroot", nusc_root, "--out-dir", out, "--cache-dir", str(tmp_path / "none"),
                        "--device", "cpu"] + NUSC_ARGS) == 0
    pts, _ = read_pcd(os.path.join(out, "sample_0_points.pcd"))
    assert pts.shape == (256, 3) and np.isfinite(pts).all()


def _write_checkpoints(config, d):
    """The port's seed-0 weights of ``config`` as a port checkpoint (.pt) and
    as the JAX package's (an orbax tree with params and batch_stats)."""
    import orbax.checkpoint as ocp

    from recondet3d.cli.train import build_model_from_cfg as j_build
    from recondet3d.core.config import load_py_config as j_load
    from recondet3d_torch.cli.train import build_model_from_cfg
    from recondet3d_torch.core.config import load_py_config

    model = build_model_from_cfg(load_py_config(config), device="cpu")
    t_path = os.path.join(d, "port.pt")
    torch.save({"model": model.state_dict()}, t_path)
    jmodel = j_build(j_load(config))
    shapes = jax.eval_shape(lambda r: jmodel.init(r, jnp.zeros((1, 6, 900, 1600, 3)),
                                                  jnp.broadcast_to(jnp.eye(4), (1, 6, 4, 4))), jax.random.PRNGKey(0))
    paths = ["/".join(k) for k in flatten_dict(shapes)]
    flat = flax_from_named(model.state_dict(), paths)
    assert len(flat) == len(paths)
    state = unflatten_dict({tuple(p.split("/")): a for p, a in flat.items()})
    j_path = os.path.join(d, "jax_ckpt")
    ocp.PyTreeCheckpointer().save(j_path, dict(state, step=np.int32(0)), force=True)
    return t_path, j_path


def test_inference_mmdet3d_matches_jax(nusc_root, tmp_path):
    from recondet3d.cli.inference_mmdet3d import main as j_main
    from recondet3d_torch.cli.inference_mmdet3d import main as t_main

    t_ckpt, j_ckpt = _write_checkpoints(TINY_CONFIG, str(tmp_path))
    common = ["--config", TINY_CONFIG, "--max-samples", "1"]
    t_out, j_out = str(tmp_path / "port"), str(tmp_path / "jax")
    assert t_main(common + ["--checkpoint", t_ckpt, "--out-dir", t_out, "--device", "cpu"]
                  + _overrides(nusc_root)) == 0
    assert j_main(common + ["--checkpoint", j_ckpt, "--out-dir", j_out] + _overrides(nusc_root)) == 0
    assert sorted(os.listdir(t_out)) == sorted(os.listdir(j_out)) == ["batch_0_pred_0_points.pcd"]
    tp, _ = read_pcd(os.path.join(t_out, "batch_0_pred_0_points.pcd"))
    jp, _ = read_pcd(os.path.join(j_out, "batch_0_pred_0_points.pcd"))
    assert tp.shape == jp.shape == (256, 3)
    np.testing.assert_allclose(tp.min(0), jp.min(0), atol=0.5)
    np.testing.assert_allclose(tp.max(0), jp.max(0), atol=0.5)
    nearest = np.sqrt(((tp[:, None] - jp[None]) ** 2).sum(-1)).min(1)
    assert nearest.max() < 0.5, nearest.max()


def _table(out):
    rows = {}
    for line in out.splitlines():
        parts = line.split()
        if len(parts) == 3 and parts[1].replace(",", "").isdigit():
            rows[parts[0]] = int(parts[1].replace(",", ""))
    return rows


def test_check_model_memory_matches_jax(capsys):
    from recondet3d.cli.check_model_memory import main as j_main
    from recondet3d_torch.cli.check_model_memory import main as t_main

    assert t_main([TINY_CONFIG, "--device", "cpu"]) == 0
    t_rows = _table(capsys.readouterr().out)
    assert j_main([TINY_CONFIG]) == 0
    j_rows = _table(capsys.readouterr().out)
    assert t_rows == j_rows and t_rows["TOTAL"] == sum(v for k, v in t_rows.items() if k != "TOTAL") > 0


def test_vis_occupancy_matches_jax(tmp_path):
    from recondet3d.cli.vis_occupancy import main as j_main
    from recondet3d_torch.cli.vis_occupancy import main as t_main
    from recondet3d_torch.train.hooks import OccupancyDebugHook

    rng = np.random.default_rng(0)
    dbg = str(tmp_path / "dbg")
    aux = dict(occupancy_logits=torch.from_numpy(rng.normal(size=(1, 20, 20, 8)).astype(np.float32)),
               gt_occupancy_map=rng.uniform(0, 1, (1, 20, 20, 8)).astype(np.float32))
    OccupancyDebugHook(dbg, interval=10, aux_fn=lambda: aux)(10, None, {})
    with open(os.path.join(dbg, "debug_iter_000010.pkl"), "rb") as f:
        assert pickle.load(f)["pseudo_occupancy_map"].shape == (1, 20, 20, 8)
    t_out, j_out = str(tmp_path / "port"), str(tmp_path / "jax")
    assert t_main([dbg, "--out-dir", t_out]) in (0, None)
    assert j_main([dbg, "--out-dir", j_out]) in (0, None)
    names = sorted(os.listdir(t_out))
    assert names == sorted(os.listdir(j_out)) == ["debug_iter_000010_gt.png", "debug_iter_000010_pseudo.png"]
    for n in names:
        assert open(os.path.join(t_out, n), "rb").read() == open(os.path.join(j_out, n), "rb").read(), n


def test_gt_vis_matches_jax(tmp_path):
    from recondet3d.cli.gt_vis import main as j_main
    from recondet3d_torch.cli.gt_vis import main as t_main

    rng = np.random.default_rng(0)
    d = tmp_path / "bins"
    d.mkdir()
    rng.uniform(-30, 30, (5000, 5)).astype(np.float32).tofile(str(d / "000001.bin"))
    rng.uniform(-30, 30, (50, 5)).astype(np.float32).tofile(str(d / "000002.bin"))  # under --min-points
    t_out, j_out = str(tmp_path / "port"), str(tmp_path / "jax")
    assert t_main([str(d), "--out-dir", t_out]) in (0, None)
    assert j_main([str(d), "--out-dir", j_out]) in (0, None)
    assert sorted(os.listdir(t_out)) == sorted(os.listdir(j_out)) == ["000001_bev.png"]
    assert open(os.path.join(t_out, "000001_bev.png"), "rb").read() == \
        open(os.path.join(j_out, "000001_bev.png"), "rb").read()


def test_vis_helpers_match_jax():
    from recondet3d.utils import vis as j_vis
    from recondet3d_torch.utils import vis as t_vis

    rng = np.random.default_rng(1)
    boxes = np.concatenate([rng.uniform(-20, 20, (6, 2)), rng.uniform(-1, 1, (6, 1)), rng.uniform(1, 4, (6, 3)),
                            rng.uniform(-np.pi, np.pi, (6, 1))], 1)
    np.testing.assert_allclose(t_vis.box3d_to_corners(boxes), j_vis.box3d_to_corners(boxes), atol=1e-6)
    img = rng.integers(0, 255, (90, 160, 3), np.uint8)
    lidar2img = np.array([[80.0, -60.0, 0, 0], [45.0, 0, -60.0, 0], [1.0, 0, 0, 0], [0, 0, 0, 1]])
    points = rng.uniform(-20, 20, (200, 3))
    for fn, args in (("draw_bbox3d_on_img", (boxes, img, lidar2img)),
                     ("draw_points_on_img", (points, img, lidar2img)),
                     ("draw_bbox3d_on_bev", (boxes[:3], boxes[3:]))):
        np.testing.assert_array_equal(getattr(t_vis, fn)(*args), getattr(j_vis, fn)(*args), err_msg=fn)
