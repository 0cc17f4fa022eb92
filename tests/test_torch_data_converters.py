"""The KITTI, Waymo, Lyft, indoor (ScanNet / SUN RGB-D / S3DIS) and nuImages
data paths, port vs JAX package, on the CPU, on the synthetic layouts of
tests/data_fixtures.py (the JAX tests' own fixtures).

Every case of tests/test_kitti.py, test_waymo.py, test_lyft.py,
test_indoor.py and test_nuscenes_data.py's nuImages export runs here on the
port with that test's assertions, and the port's output is held to the JAX
package's on the same fixture:

- info pickles field by field: the same keys and the same values, arrays
  equal element for element with the same dtype (both are host numpy);
- the ``points/*.bin`` and mask files the indoor converters write: equal
  byte for byte (SUN RGB-D samples with numpy's generator from its seed);
- metrics: every AP within 1e-6 of the JAX package's, on the fixtures and
  on random scenes with yawed boxes (the rotated IoU runs on
  ``ops/iou3d.py`` in the port, on ``recondet3d/ops/iou3d.py`` there);
- ``python -m recondet3d_torch.cli.create_data`` for every choice against
  the JAX CLI's pickles.

The Waymo TFRecord round trip needs ``waymo_open_dataset`` and
``tensorflow`` and is skipped without them, as in tests/test_waymo.py.
"""

import json
import os
import pickle

import numpy as np
import pytest

import data_fixtures as fx
from recondet3d.cli.create_data import main as j_create_data
from recondet3d.data.indoor import create_indoor_infos as j_create_indoor_infos, indoor_eval as j_indoor_eval
from recondet3d.data.kitti.converter import create_kitti_infos as j_create_kitti_infos
from recondet3d.data.lyft import LyftDataset as JLyftDataset, create_lyft_infos as j_create_lyft_infos, \
    lyft_map as j_lyft_map
from recondet3d.data.nuscenes.nuimage_converter import export_nuimages_to_coco as j_export_nuimages
from recondet3d.data.waymo import create_waymo_infos as j_create_waymo_infos
from recondet3d_torch.cli.create_data import main as create_data
from recondet3d_torch.data.indoor import ScanNetDataset, create_indoor_infos, indoor_eval
from recondet3d_torch.data.indoor.dataset import iou_3d
from recondet3d_torch.data.kitti import create_kitti_infos
from recondet3d_torch.data.lyft import LyftDataset, create_lyft_infos, lyft_map
from recondet3d_torch.data.nuscenes import export_nuimages_to_coco
from recondet3d_torch.data.waymo import create_waymo_infos

AP_TOL = 1e-6


def assert_same(got, ref, where="root"):
    """Nested dicts / lists / tuples / numpy arrays / scalars equal, arrays with the same dtype."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(got) == set(ref), (where, sorted(set(got) ^ set(ref)))
        for k in ref:
            assert_same(got[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert type(got) is type(ref) and len(got) == len(ref), where
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_same(g, r, f"{where}[{i}]")
    elif isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype and got.shape == ref.shape, (
            where, getattr(got, "dtype", None), ref.dtype)
        np.testing.assert_array_equal(got, ref, err_msg=where)
    else:
        assert type(got) is type(ref) and got == ref, (where, got, ref)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _same_pickles(got_paths, ref_paths):
    assert [os.path.basename(p).split("_", 1)[1] for p in got_paths] == \
        [os.path.basename(p).split("_", 1)[1] for p in ref_paths]
    for g, r in zip(got_paths, ref_paths):
        assert_same(_load(g), _load(r), os.path.basename(g))


def _same_metrics(got, ref, tol=AP_TOL):
    assert set(got) == set(ref), sorted(set(got) ^ set(ref))
    bad = {k: (got[k], ref[k]) for k in ref if abs(got[k] - ref[k]) > tol}
    assert not bad, bad


# ---------------------------------------------------------------- KITTI


def test_create_kitti_infos(tmp_path):
    root = fx.write_kitti(str(tmp_path))
    paths = create_kitti_infos(root, info_prefix="kitti")
    train = _load(paths[0])
    assert len(train["infos"]) == 2
    info = train["infos"][0]
    assert os.path.exists(info["lidar_path"])
    assert len(info["gt_boxes"]) == 1  # DontCare filtered
    box = info["gt_boxes"][0]
    np.testing.assert_allclose(box[:3], [10, -2, -1.5], atol=1e-6)
    np.testing.assert_allclose(box[3:6], [4.2, 1.8, 1.5], atol=1e-6)
    assert info["gt_names"][0] == "Car"
    assert info["calib"]["Tr_velo_to_cam"].dtype == np.float64 and box.dtype == np.float64
    _same_pickles(paths, j_create_kitti_infos(root, info_prefix="jkitti"))


# ---------------------------------------------------------------- Waymo


def test_create_waymo_infos(tmp_path):
    root = fx.write_waymo(str(tmp_path))
    paths = create_waymo_infos(root)
    assert len(paths) == 1  # only train.txt exists
    info = _load(paths[0])["infos"][0]
    assert len(info["gt_boxes"]) == 1
    np.testing.assert_allclose(info["gt_boxes"][0, :3], [10, 2, -1], atol=1e-6)
    np.testing.assert_allclose(info["gt_boxes"][0, 3:6], [4.2, 1.8, 1.5])
    assert info["num_lidar_pts"][0] == 100
    assert info["pose"].shape == (4, 4)
    assert len(info["image_paths"]) == 5
    _same_pickles(paths, j_create_waymo_infos(root, info_prefix="jwaymo"))


def test_waymo_points_on_box_faces_count_as_in_the_jax_package(tmp_path):
    """Points on the box's top and bottom faces are inside (inclusive faces)."""
    root = fx.write_waymo(str(tmp_path), n_points=400)
    info = _load(create_waymo_infos(root)[0])["infos"][0]
    assert info["num_lidar_pts"][0] == 220
    _same_pickles(create_waymo_infos(root), j_create_waymo_infos(root, info_prefix="jwaymo"))


def test_tfrecord_stage_gated():
    from recondet3d_torch.data.waymo import convert_tfrecords

    try:
        import waymo_open_dataset  # noqa: F401

        pytest.skip("waymo-open-dataset present; the round trip below runs instead")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="waymo-open-dataset"):
        convert_tfrecords([], "unused")


def test_tfrecord_extraction_roundtrip(tmp_path):
    """TFRecord -> KITTI layout -> info pkl (tests/test_waymo.py's round trip), port vs JAX package."""
    pytest.importorskip("waymo_open_dataset")
    tf = pytest.importorskip("tensorflow")
    from waymo_open_dataset import dataset_pb2, label_pb2

    from recondet3d.data.waymo.converter import convert_tfrecords as j_convert
    from recondet3d_torch.data.waymo import convert_tfrecords

    frame = dataset_pb2.Frame()
    frame.pose.transform.extend(np.eye(4).ravel().tolist())
    cal = frame.context.camera_calibrations.add()
    cal.name = 1
    cal.intrinsic.extend([2000.0, 2000.0, 960.0, 640.0, 0, 0, 0, 0, 0])
    lab = frame.laser_labels.add()
    lab.type = label_pb2.Label.TYPE_VEHICLE
    lab.box.center_x, lab.box.center_y, lab.box.center_z = 10.0, 2.0, -0.25
    lab.box.length, lab.box.width, lab.box.height = 4.2, 1.8, 1.5
    lab.box.heading = 0.3
    rec_path = str(tmp_path / "seg.tfrecord")
    with tf.io.TFRecordWriter(rec_path) as w:
        w.write(frame.SerializeToString())
    pts = np.zeros((50, 6), np.float32)
    pts[:, :3] = [10.0, 2.0, 0.2]
    root, jroot = str(tmp_path / "out"), str(tmp_path / "jout")
    assert convert_tfrecords([rec_path], root, parse_points_fn=lambda f: pts) == ["0000000"]
    j_convert([rec_path], jroot, parse_points_fn=lambda f: pts)
    info = _load(create_waymo_infos(root)[0])["infos"][0]
    np.testing.assert_allclose(info["gt_boxes"][0, :3], [10, 2, -1], atol=1e-4)
    np.testing.assert_allclose(info["gt_boxes"][0, 3:6], [4.2, 1.8, 1.5], atol=1e-4)
    np.testing.assert_allclose(info["gt_boxes"][0, 6], 0.3, atol=1e-4)
    assert info["num_lidar_pts"][0] == 50
    jinfo = _load(j_create_waymo_infos(jroot)[0])["infos"][0]
    for k in ("gt_boxes", "num_lidar_pts", "pose", "gt_names"):
        np.testing.assert_array_equal(info[k], jinfo[k])


# ---------------------------------------------------------------- Lyft


@pytest.fixture(scope="module")
def lyft_root(tmp_path_factory):
    return fx.write_lyft(str(tmp_path_factory.mktemp("lyft")))


def test_create_lyft_infos_and_dataset(lyft_root):
    train_p, val_p = create_lyft_infos(lyft_root, info_prefix="lf", val_scene_names=["scene-0001"])
    assert os.path.exists(train_p) and os.path.exists(val_p)
    ds = LyftDataset(ann_file=train_p)
    assert len(ds) > 0
    assert os.path.exists(ds.get_data_info(0)["pts_filename"])
    assert ds.get_ann_info(0)["gt_bboxes_3d"].shape[1] == 7  # no velocity
    assert set(np.asarray(ds.data_infos[0]["gt_names"]).tolist()) <= set(LyftDataset.CLASSES)
    _same_pickles([train_p, val_p], j_create_lyft_infos(lyft_root, info_prefix="jlf", val_scene_names=["scene-0001"]))
    jds = JLyftDataset(ann_file=train_p)
    for i in range(len(ds)):
        assert_same(ds.get_data_info(i), jds.get_data_info(i))
    # perfect predictions: the kaggle metric averages over all 9 classes, zeros included
    results = {info["token"]: [(b, 0.9, n) for b, n in zip(info["gt_boxes"], info["gt_names"])]
               for info in ds.data_infos}
    got = ds.evaluate(results, device="cpu")
    _same_metrics(got, jds.evaluate(results))
    present = {n for info in ds.data_infos for n in info["gt_names"]}
    assert got["mAP"] == pytest.approx(len(present) / 9)


def test_lyft_map_perfect_and_miss():
    gt = {"s0": {"boxes": np.array([[0, 0, 0, 4, 2, 1.5, 0.0]], np.float32), "names": np.array(["car"])}}
    perfect = {"s0": [(np.array([0, 0, 0, 4, 2, 1.5, 0.0], np.float32), 0.9, "car")]}
    aps, overall = lyft_map(gt, perfect, class_names=("car",), device="cpu")
    assert overall == pytest.approx(1.0)
    shifted = {"s0": [(np.array([3.0, 0, 0, 4, 2, 1.5, 0.0], np.float32), 0.9, "car")]}
    _, overall2 = lyft_map(gt, shifted, class_names=("car",), device="cpu")
    assert overall2 < 0.1
    assert overall2 == pytest.approx(j_lyft_map(gt, shifted, class_names=("car",))[1], abs=AP_TOL)


def test_lyft_map_matches_jax_on_random_scenes():
    gt, res = fx.random_lyft_scene(np.random.default_rng(3), 2, 9, 14)
    aps, overall = lyft_map(gt, res, device="cpu")
    japs, joverall = j_lyft_map(gt, res)
    _same_metrics(aps, japs)
    assert abs(overall - joverall) <= AP_TOL and 0.05 < overall < 0.95


# ---------------------------------------------------------------- indoor


def _two_roots(tmp_path, write, **kw):
    roots = []
    for name in ("port", "jax"):
        r = str(tmp_path / name)
        os.makedirs(r)
        write(r, **kw)
        roots.append(r)
    return roots


def _same_files(root, jroot, subdirs):
    for d in subdirs:
        names = sorted(os.listdir(os.path.join(jroot, d)))
        assert names and sorted(os.listdir(os.path.join(root, d))) == names
        for n in names:
            with open(os.path.join(root, d, n), "rb") as a, open(os.path.join(jroot, d, n), "rb") as b:
                assert a.read() == b.read(), (d, n)


def test_scannet_converter(tmp_path):
    root, jroot = _two_roots(tmp_path, fx.write_scannet)
    paths = create_indoor_infos("scannet", root)
    assert len(paths) == 3
    infos = _load(paths[0])
    assert len(infos) == 1
    a = infos[0]["annos"]
    assert a["gt_num"] == 2 and list(a["name"]) == ["bed", "chair"]
    pts = np.fromfile(os.path.join(root, infos[0]["pts_path"]), np.float32)
    assert pts.size == 500 * 6
    _same_pickles(paths, j_create_indoor_infos("scannet", jroot))
    _same_files(root, jroot, ("points", "instance_mask", "semantic_mask"))


def test_sunrgbd_converter(tmp_path):
    """Also at more depth points than the converter keeps: numpy's generator draws the same 50,000."""
    for n in (1000, 60000):
        root, jroot = _two_roots(tmp_path / str(n), fx.write_sunrgbd, n_points=n)
        paths = create_indoor_infos("sunrgbd", root)
        infos = _load(paths[0])
        a = infos[0]["annos"]
        assert a["gt_num"] == 1 and a["name"][0] == "bed"
        np.testing.assert_allclose(a["dimensions"][0], [2.0, 0.9, 0.6])
        assert a["rotation_y"][0] == pytest.approx(0.0)
        assert infos[0]["calib"]["K"][0, 0] == 500.0
        assert os.path.getsize(os.path.join(root, infos[0]["pts_path"])) == 50000 * 6 * 4
        _same_pickles(paths, j_create_indoor_infos("sunrgbd", jroot))
        _same_files(root, jroot, ("points",))


def test_s3dis_converter(tmp_path):
    roots = []
    for name in ("port", "jax"):
        roots.append(str(tmp_path / name))
        os.makedirs(roots[-1])
        pts = fx.write_s3dis(roots[-1])
    root, jroot = roots
    paths = create_indoor_infos("s3dis", root)
    assert len(paths) == 1
    a = _load(paths[0])[0]["annos"]
    assert a["gt_num"] == 1 and a["name"][0] == "chair"
    mn, mx = pts[:50, :3].min(0), pts[:50, :3].max(0)
    np.testing.assert_allclose(a["gt_boxes_upright_depth"][0, 3:6], mx - mn, rtol=1e-6)
    _same_pickles(paths, j_create_indoor_infos("s3dis", jroot))
    _same_files(root, jroot, ("points", "instance_mask", "semantic_mask"))


def test_scannet_dataset_and_indoor_eval(tmp_path):
    from recondet3d.data.indoor import ScanNetDataset as JScanNetDataset

    root = fx.write_scannet(str(tmp_path))
    paths = create_indoor_infos("scannet", root)
    ds = ScanNetDataset(ann_file=paths[0], data_root=root)
    jds = JScanNetDataset(ann_file=paths[0], data_root=root)
    assert len(ds) == 1
    info = ds.get_data_info(0)
    assert os.path.exists(info["pts_filename"])
    assert_same(info, jds.get_data_info(0))
    ann = ds.get_ann_info(0)
    assert len(ann["gt_bboxes_3d"]) == 2
    results = [dict(boxes_3d=ann["gt_bboxes_3d"], labels_3d=ann["gt_labels_3d"],
                    scores_3d=np.full(len(ann["gt_labels_3d"]), 0.9))]
    m = ds.evaluate(results, device="cpu")
    assert m["mAP_0.25"] == pytest.approx(1.0) and m["mAP_0.50"] == pytest.approx(1.0)
    _same_metrics(m, jds.evaluate(results))
    shifted = ann["gt_bboxes_3d"].copy()
    shifted[:, 0] += 0.45  # dims are 1.0 cubes -> IoU ~0.38
    results2 = [dict(boxes_3d=shifted, labels_3d=ann["gt_labels_3d"], scores_3d=np.full(2, 0.9))]
    m2 = ds.evaluate(results2, device="cpu")
    assert m2["mAP_0.25"] == pytest.approx(1.0) and m2["mAP_0.50"] == 0.0
    _same_metrics(m2, jds.evaluate(results2))


@pytest.mark.parametrize("yawed,width", [(True, 7), (False, 7), (False, 6)], ids=["yawed", "yaw0", "six"])
def test_indoor_eval_matches_jax(yawed, width):
    """Random scenes: yawed boxes (the rotated IoU), yaw-free 7-wide and 6-wide ones (the numpy path), and a scene
    with one yawed prediction among axis-aligned ones (both paths in one matrix)."""
    gts, dts = fx.random_indoor_scenes(np.random.default_rng(5), 3, 8, 16, 3, yawed=yawed, width=width)
    if not yawed and width == 7:
        dts[0]["boxes_3d"][3, 6] = 0.4
    labels = dict(enumerate("abc"))
    got = indoor_eval(gts, dts, metric=(0.25, 0.5), label2cat=labels, device="cpu")
    _same_metrics(got, j_indoor_eval(gts, dts, metric=(0.25, 0.5), label2cat=labels))
    assert 0.05 < got["mAP_0.25"] < 0.99


def test_iou_3d_columns_match_the_jax_package():
    from recondet3d.data.indoor.dataset import _iou_3d as j_iou_3d

    gts, dts = fx.random_indoor_scenes(np.random.default_rng(6), 1, 8, 6, 2, yawed=False)
    g, p = gts[0]["gt_boxes_upright_depth"], dts[0]["boxes_3d"].copy()
    p[::2, 6] = 0.3
    got = iou_3d(g, p, device="cpu")
    ref = np.concatenate([np.asarray(j_iou_3d(g, p[j:j + 1])) for j in range(len(p))], 1)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


# ---------------------------------------------------------------- nuImages


def test_nuimages_coco_export(tmp_path):
    root = fx.write_nuimages(str(tmp_path))
    out = export_nuimages_to_coco(root)
    with open(out) as f:
        coco = json.load(f)
    assert len(coco["images"]) == 1 and len(coco["annotations"]) == 1
    a = coco["annotations"][0]
    assert a["bbox"] == [10, 20, 100, 50]
    assert a["segmentation"]["counts"] == "abc"
    assert coco["categories"][a["category_id"]]["name"] == "car"
    with open(j_export_nuimages(root, extra_tag="jnuimages")) as f:
        assert json.load(f) == coco


# ---------------------------------------------------------------- the CLI


def _rebase(tree, old, new):
    """``tree`` with ``old`` replaced by ``new`` in every string (the infos of kitti, waymo and lyft hold absolute
    paths)."""
    if isinstance(tree, dict):
        return {k: _rebase(v, old, new) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebase(v, old, new) for v in tree)
    return tree.replace(old, new) if isinstance(tree, str) else tree


WRITERS = dict(kitti=fx.write_kitti, waymo=fx.write_waymo, lyft=fx.write_lyft, scannet=fx.write_scannet,
               sunrgbd=fx.write_sunrgbd, s3dis=fx.write_s3dis)


@pytest.mark.parametrize("dataset", sorted(WRITERS))
def test_create_data_cli_matches_the_jax_cli(dataset, tmp_path, capsys):
    root, jroot = _two_roots(tmp_path, WRITERS[dataset])
    assert create_data([dataset, "--root-path", root]) == 0
    written = [ln.split(" ", 1)[1] for ln in capsys.readouterr().out.splitlines() if ln.startswith("wrote ")]
    assert j_create_data([dataset, "--root-path", jroot]) == 0
    jwritten = [ln.split(" ", 1)[1] for ln in capsys.readouterr().out.splitlines() if ln.startswith("wrote ")]
    assert written and [os.path.relpath(p, root) for p in written] == [os.path.relpath(p, jroot) for p in jwritten]
    for p, jp in zip(written, jwritten):
        assert_same(_rebase(_load(p), root, jroot), _load(jp), os.path.basename(p))


def test_create_data_cli_waymo_without_a_layout(tmp_path):
    with pytest.raises(FileNotFoundError, match="no ImageSets"):
        create_data(["waymo", "--root-path", str(tmp_path)])
