"""nuScenes data preparation, port vs JAX package, on the synthetic fixture
(mirrors tests/test_nuscenes_data.py and tests/test_gt_database.py).

Both ``create_data`` CLIs write info pickles from the same tables; they must
be equal (keys, strings and types exact, arrays bit-equal). The datasets
over them must give equal ``get_data_info`` / ``get_ann_info`` for every
index, ``CBGSDataset`` the same indices, ``create_groundtruth_database`` the
same database files and ``ObjectSample`` the same pasted scene for a seed.
All of it is host numpy in both packages: equality is exact."""

import os
import pickle

import numpy as np
import pytest

from nuscenes_fixture import make_fixture
from recondet3d.cli.create_data import main as j_create_data
from recondet3d.data.nuscenes import CBGSDataset as JCBGSDataset
from recondet3d.data.nuscenes import NuScenesDataset as JNuScenesDataset
from recondet3d.data.nuscenes.gt_database import ObjectSample as JObjectSample
from recondet3d.data.nuscenes.gt_database import create_groundtruth_database as j_create_gt_database
from recondet3d.data.pipelines.transforms import Compose as JCompose
from recondet3d.data.pipelines.transforms import LoadAnnotations3D as JLoadAnnotations3D
from recondet3d.data.pipelines.transforms import LoadPointsFromFile as JLoadPointsFromFile
from recondet3d_torch.cli.create_data import main as create_data
from recondet3d_torch.core.registry import DATASETS, PIPELINES
from recondet3d_torch.data.nuscenes import CBGSDataset, NuScenesDataset, NuScenesTables, quat_wxyz_to_matrix
from recondet3d_torch.data.nuscenes.gt_database import ObjectSample, create_groundtruth_database
from recondet3d_torch.data.pipelines.transforms import Compose, LoadAnnotations3D, LoadPointsFromFile

FIXTURES = {"default": {}, "structured": dict(structured=True), "all_classes": dict(all_classes=True)}


def assert_same(a, b, where="root"):
    """Deep equality: dict keys in order, sequence lengths, scalar types and
    values, numpy dtypes, shapes and bytes."""
    assert type(a) is type(b), f"{where}: {type(a)} vs {type(b)}"
    if isinstance(a, dict):
        assert list(a) == list(b), f"{where}: keys {list(a)} vs {list(b)}"
        for k in a:
            assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), f"{where}: length {len(a)} vs {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, f"{where}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}"
        assert a.tobytes() == b.tobytes(), f"{where}: arrays differ"
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), where
    else:
        assert a == b, f"{where}: {a!r} vs {b!r}"


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Each fixture tree with the info pickles of both CLIs ('j_*' and 't_*')."""
    out = {}
    for name, kw in FIXTURES.items():
        root = str(tmp_path_factory.mktemp(f"nusc_{name}"))
        make_fixture(root, **kw)
        for cli, tag in ((j_create_data, "j"), (create_data, "t")):
            assert cli(["nuscenes", "--root-path", root, "--extra-tag", tag, "--version", "v1.0-mini"]) == 0
        out[name] = root
    return out


def load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("name", ["default", "structured"])
def test_create_data_writes_the_same_info_pickles(roots, name, split):
    root = roots[name]
    j = load(os.path.join(root, f"j_infos_{split}.pkl"))
    t = load(os.path.join(root, f"t_infos_{split}.pkl"))
    assert_same(j, t)
    if split == "train":
        assert len(t["infos"]) == 4 and set(t["infos"][0]["cams"]) == {"CAM_FRONT", "CAM_BACK"}


def test_create_data_other_datasets_name_the_roadmap_item(tmp_path):
    with pytest.raises(NotImplementedError, match="15b"):
        create_data(["kitti", "--root-path", str(tmp_path)])


@pytest.mark.parametrize("test_mode", [False, True])
@pytest.mark.parametrize("name", ["default", "structured", "all_classes"])
def test_dataset_items_match(roots, name, test_mode):
    root = roots[name]
    kw = dict(ann_file=os.path.join(root, "t_infos_train.pkl"), data_root=root, test_mode=test_mode)
    j, t = JNuScenesDataset(**kw), NuScenesDataset(**kw)
    assert len(j) == len(t) == 4 and j.CLASSES == t.CLASSES
    for i in range(len(t)):
        assert_same(j.get_data_info(i), t.get_data_info(i), f"data_info {i}")
        assert_same(j.get_ann_info(i), t.get_ann_info(i), f"ann_info {i}")


def test_dataset_options_match(roots):
    root = roots["structured"]
    kw = dict(ann_file=os.path.join(root, "t_infos_train.pkl"), data_root=root, load_interval=2,
              with_velocity=False, bug_compatible_cam2lidar=True, classes=("car", "pedestrian"))
    j, t = JNuScenesDataset(**kw), NuScenesDataset(**kw)
    assert len(t) == 2
    for i in range(len(t)):
        assert_same(j.get_data_info(i), t.get_data_info(i), f"data_info {i}")
    assert DATASETS.get("NuScenesDataset") is NuScenesDataset and DATASETS.get("CBGSDataset") is CBGSDataset


def test_sensor2lidar_consistency(roots):
    """cam->lidar from the port's converter equals the direct chain
    lidar <- ego <- global <- ego' <- cam computed independently."""
    root = roots["default"]
    nusc = NuScenesTables("v1.0-mini", root)
    sample = nusc.sample[0]

    def sensor_to_global(sd):
        cs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
        pose = nusc.get("ego_pose", sd["ego_pose_token"])
        T = np.eye(4)
        T[:3, :3] = quat_wxyz_to_matrix(pose["rotation"]) @ quat_wxyz_to_matrix(cs["rotation"])
        T[:3, 3] = quat_wxyz_to_matrix(pose["rotation"]) @ np.asarray(cs["translation"]) + pose["translation"]
        return T

    cam2lidar = np.linalg.inv(sensor_to_global(nusc.get("sample_data", sample["data"]["LIDAR_TOP"]))) \
        @ sensor_to_global(nusc.get("sample_data", sample["data"]["CAM_FRONT"]))
    info = load(os.path.join(root, "t_infos_train.pkl"))["infos"]
    cam = next(i for i in info if i["token"] == sample["token"])["cams"]["CAM_FRONT"]
    np.testing.assert_allclose(cam["sensor2lidar_rotation"], cam2lidar[:3, :3], atol=1e-8)
    np.testing.assert_allclose(cam["sensor2lidar_translation"], cam2lidar[:3, 3], atol=1e-8)


@pytest.mark.parametrize("name", ["default", "structured", "all_classes"])
def test_cbgs_gives_the_same_indices(roots, name):
    root = roots[name]
    kw = dict(ann_file=os.path.join(root, "t_infos_train.pkl"), data_root=root)
    j, t = JCBGSDataset(JNuScenesDataset(**kw)), CBGSDataset(NuScenesDataset(**kw))
    assert [int(i) for i in j.sample_indices] == [int(i) for i in t.sample_indices]
    assert len(t) > 0 and len(t) == len(j)
    built = CBGSDataset(dict(type="NuScenesDataset", **kw))
    assert [int(i) for i in built.sample_indices] == [int(i) for i in t.sample_indices]
    assert_same(j.get_ann_info(0), t.get_ann_info(0))


@pytest.fixture(scope="module")
def gt_databases(roots, tmp_path_factory):
    root = roots["structured"]
    kw = dict(ann_file=os.path.join(root, "t_infos_train.pkl"), data_root=root)
    out = {}
    for tag, ds, create in (("j", JNuScenesDataset(**kw), j_create_gt_database),
                            ("t", NuScenesDataset(**kw), create_groundtruth_database)):
        d = str(tmp_path_factory.mktemp(f"db_{tag}"))
        out[tag] = (d, ds, create(ds, d, info_prefix="x"))
    return out


def test_gt_database_writes_the_same_files(gt_databases):
    (jd, _, jpkl), (td, _, tpkl) = gt_databases["j"], gt_databases["t"]
    jdb, tdb = load(jpkl), load(tpkl)
    for db, d in ((jdb, jd), (tdb, td)):  # paths differ by directory only
        for infos in db.values():
            for info in infos:
                assert info["path"].startswith(d)
                info["path"] = os.path.relpath(info["path"], d)
    assert_same(jdb, tdb)
    assert {"car", "pedestrian", "traffic_cone"} <= set(tdb)
    files = sorted(os.listdir(os.path.join(td, "x_gt_database")))
    assert files == sorted(os.listdir(os.path.join(jd, "x_gt_database"))) and len(files) == 32
    for f in files:
        with open(os.path.join(jd, "x_gt_database", f), "rb") as a:
            with open(os.path.join(td, "x_gt_database", f), "rb") as b:
                assert a.read() == b.read(), f
    assert sum(i["num_points_in_gt"] for infos in tdb.values() for i in infos) > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_object_sample_pastes_the_same_scene(gt_databases, seed):
    outs = []
    for tag, compose, load_pts, load_ann, sampler in (
            ("j", JCompose, JLoadPointsFromFile, JLoadAnnotations3D, JObjectSample),
            ("t", Compose, LoadPointsFromFile, LoadAnnotations3D, ObjectSample)):
        _, ds, pkl = gt_databases[tag]
        data = compose([load_pts(load_dim=5, use_dim=(0, 1, 2)), load_ann()])(ds.get_data_info(seed))
        out = sampler(pkl, sample_groups=dict(car=5, pedestrian=5, traffic_cone=3), classes=list(ds.CLASSES),
                      seed=seed)(data)
        outs.append((out["gt_bboxes_3d"].tensor, out["gt_labels_3d"], out["points"]))
    for a, b in zip(*outs):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    assert PIPELINES.get("ObjectSample") is ObjectSample


def test_object_sample_fading_disables_it(gt_databases):
    _, ds, pkl = gt_databases["t"]
    data = Compose([LoadPointsFromFile(load_dim=5, use_dim=(0, 1, 2)), LoadAnnotations3D()])(ds.get_data_info(0))
    sampler = ObjectSample(pkl, sample_groups=dict(car=5, pedestrian=5), classes=list(ds.CLASSES), seed=1)
    out = sampler(data)
    assert len(out["gt_labels_3d"]) == len(out["gt_bboxes_3d"])
    sampler.enabled = False
    assert len(sampler(dict(out))["gt_bboxes_3d"]) == len(out["gt_bboxes_3d"])
