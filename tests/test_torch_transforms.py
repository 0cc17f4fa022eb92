"""Host pipeline transforms, port vs JAX package (mirrors
tests/test_transforms.py).

Each case builds the same transforms from both packages' modules, with the
same numpy seeds, and applies them to the same sample of the synthetic
fixture as each package's dataset and loaders give it; the outputs must be
equal (arrays bit-equal, boxes compared through their arrays, metadata
exact). Both sides are host numpy (and cv2 where the JAX transform uses
it), so nothing is allowed to differ."""

import os
import types

import numpy as np
import pytest

import recondet3d.data.pipelines.transforms as jt
import recondet3d_torch.data.pipelines.transforms as tt
from nuscenes_fixture import make_fixture
from recondet3d.core.registry import PIPELINES as J_PIPELINES
from recondet3d.data.nuscenes import NuScenesDataset as JNuScenesDataset
from recondet3d.data.nuscenes import create_nuscenes_infos
from recondet3d_torch.core.registry import PIPELINES
from recondet3d_torch.data.image_io import write_ppm
from recondet3d_torch.data.nuscenes import NuScenesDataset

PKGS = {"jax": types.SimpleNamespace(T=jt, DS=JNuScenesDataset),
        "torch": types.SimpleNamespace(T=tt, DS=NuScenesDataset)}
PCR = (-54, -54, -5, 54, 54, 3)


def assert_same(a, b, where="root"):
    if hasattr(a, "tensor"):
        assert type(a).__name__ == type(b).__name__, where
        return assert_same(a.tensor, b.tensor, f"{where}.tensor")
    if isinstance(a, dict):
        assert list(a) == list(b), f"{where}: keys {list(a)} vs {list(b)}"
        for k in a:
            assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, f"{where}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}"
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), f"{where}: arrays differ"
    else:
        assert type(a) is type(b) and a == b, f"{where}: {a!r} vs {b!r}"


@pytest.fixture(scope="module", params=["jpeg", "ppm"])
def root(request, tmp_path_factory):
    """The fixture tree, its images as JPEG (cv2) or as binary PPM."""
    import nuscenes_fixture

    root = str(tmp_path_factory.mktemp(f"nusc_tf_{request.param}"))
    if request.param == "ppm":
        saved = nuscenes_fixture._write_jpeg
        nuscenes_fixture._write_jpeg = write_ppm
        try:
            make_fixture(root)
        finally:
            nuscenes_fixture._write_jpeg = saved
    else:
        make_fixture(root)
    create_nuscenes_infos(root, info_prefix="x", val_scene_names=[])
    return root


def run_both(root, build, index=0):
    """``build(pkg, sample)`` -> output, for each package on its own copy of
    sample ``index``."""
    outs = []
    for pkg in PKGS.values():
        ds = pkg.DS(ann_file=os.path.join(root, "x_infos_train.pkl"))
        outs.append(build(pkg, ds.get_data_info(index)))
    assert_same(*outs)
    return outs[1]


def test_train_pipeline(root):
    def build(p, s):
        return p.T.Compose([
            p.T.LoadPointsFromFile(load_dim=5, use_dim=(0, 1, 2)), p.T.LoadAnnotations3D(),
            p.T.LoadMultiViewImageFromFiles(to_float32=True), p.T.PointsRangeFilter(point_cloud_range=PCR),
            p.T.ObjectNameFilter(classes=p.DS.CLASSES), p.T.DefaultFormatBundle3D(),
            p.T.Collect3D(keys=["points", "img", "gt_bboxes_3d", "gt_labels_3d"],
                          meta_keys=("lidar2img", "cam2lidar_rts", "img_shape"))])(s)

    out = run_both(root, build)
    assert out["img"].shape == (2, 90, 160, 3) and out["points"].shape[1] == 3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_geometry_transforms(root, seed):
    def build(p, s):
        return p.T.Compose([
            p.T.LoadPointsFromFile(load_dim=5, use_dim=(0, 1, 2)), p.T.LoadAnnotations3D(),
            p.T.GlobalRotScaleTrans(rot_range=(-0.785, 0.785), scale_ratio_range=(0.9, 1.1),
                                    translation_std=(0.2, 0.2, 0.1), seed=seed),
            p.T.RandomFlip3D(flip_ratio_bev_horizontal=0.5, flip_ratio_bev_vertical=0.5, seed=seed),
            p.T.ObjectRangeFilter(point_cloud_range=(-30, -30, -5, 30, 30, 3)), p.T.PointShuffle(seed=seed),
            p.T.MyFlip3D(flip_ratio_bev_horizontal=1.0, seed=seed)])(s)

    out = run_both(root, build, index=seed)
    assert "pcd_rotation" in out and out["pcd_horizontal_flip"] in (True, False)


@pytest.mark.parametrize("seed", [0, 3])
def test_image_aug3d_and_my_resize(root, seed):
    def build(p, s):
        data = p.T.LoadMultiViewImageFromFiles(to_float32=True)(s)
        aug = p.T.ImageAug3D(final_dim=(48, 80), resize_lim=(0.5, 0.7), rot_lim=(-5.0, 5.0), rand_flip=True,
                             is_train=True, seed=seed)(dict(data))
        test = p.T.ImageAug3D(final_dim=(48, 80), resize_lim=(0.5, 0.7), is_train=False)(dict(data))
        r = p.T.Compose([p.T.MyResize(img_scale=(80, 45)), p.T.MyNormalize(mean=[1.0, 2.0, 3.0], std=[2.0, 3.0, 4.0]),
                         p.T.MyPad(size_divisor=16)])(dict(data))
        return aug, test, r

    aug, _, r = run_both(root, build)
    assert all(i.shape[:2] == (48, 80) for i in aug["img"]) and r["img"][0].shape[:2] == (48, 80)


def test_image_transforms(root):
    def build(p, s):
        return p.T.Compose([
            p.T.LoadMultiViewImageFromFiles(to_float32=True), p.T.ScaleImageMultiViewImage(scales=0.5),
            p.T.NormalizeMultiviewImage(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375]),
            p.T.PadMultiViewImage(size_divisor=32), p.T.PadMultiViewImage(size=(96, 192)),
            p.T.ScaleImageMultiViewImage(scales=(100, 50))])(s)

    out = run_both(root, build)
    assert out["img"][0].shape[:2] == (50, 100)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_photometric_distortion(root, seed):
    def build(p, s):
        data = p.T.LoadMultiViewImageFromFiles(to_float32=True)(s)
        return p.T.PhotoMetricDistortionMultiViewImage(seed=seed)(data)

    run_both(root, build)


@pytest.mark.parametrize("test_mode", [False, True])
def test_load_points_from_multi_sweeps(root, tmp_path, test_mode):
    rng = np.random.default_rng(0)
    sweeps = []
    for i in range(4):
        p = tmp_path / f"sweep{i}.bin"
        rng.uniform(-20, 20, (50, 5)).astype(np.float32).tofile(p)
        th = 0.1 * i
        sweeps.append(dict(data_path=str(p), sensor2lidar_rotation=np.array(
            [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]]),
            sensor2lidar_translation=np.array([1.0, 0.5 * i, 0]), timestamp=None))

    def build(p, s):
        data = p.T.LoadPointsFromFile(load_dim=5, use_dim=(0, 1, 2, 3, 4))(s)
        data["sweeps"] = [dict(sw, timestamp=(data["timestamp"] - 0.5 * (i + 1)) * 1e6) for i, sw in enumerate(sweeps)]
        return p.T.LoadPointsFromMultiSweeps(sweeps_num=2, remove_close=True, test_mode=test_mode, seed=4)(data)

    out = run_both(root, build)
    assert out["points"].shape[1] == 4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_object_noise(seed):
    rng = np.random.default_rng(seed)
    boxes = np.array([[5.0, 0.0, 0.0, 2.0, 2.0, 2.0, 0.0], [5.0, 3.0, 0.0, 2.0, 4.0, 1.5, 0.4],
                      [-6.0, -2.0, 0.0, 1.0, 1.0, 2.0, 1.0]])
    pts = np.concatenate([rng.uniform(-0.8, 0.8, (50, 3)) + [5.0, 0.0, 1.0], rng.uniform(-10, 10, (200, 3))])
    outs = []
    for pkg in PKGS.values():
        res = dict(points=pts.astype(np.float32), gt_bboxes_3d=pkg.T.LiDARBoxes3D(boxes.copy()))
        outs.append(pkg.T.ObjectNoise(translation_std=(1.0, 1.0, 0.2), seed=seed)(res))
        outs.append(pkg.T.ObjectNoise(translation_std=(0.5, 0.5, 0.0), seed=seed)(
            dict(points=pts.astype(np.float32), gt_bboxes_3d=boxes.copy())))
    assert_same(outs[:2], outs[2:])


def test_multi_scale_flip_aug3d(root):
    def build(p, s):
        data = p.T.LoadPointsFromFile(load_dim=5, use_dim=(0, 1, 2))(s)
        data = p.T.LoadAnnotations3D()(dict(data, ann_info=s["ann_info"]))
        return p.T.MultiScaleFlipAug3D(transforms=[p.T.RandomFlip3D(sync_2d=False)],
                                       img_scale=[(1333, 800), (640, 360)], pts_scale_ratio=[1.0, 1.1], flip=True,
                                       pcd_horizontal_flip=True, pcd_vertical_flip=True)(data)

    out = run_both(root, build)
    assert len(out["points"]) == 16  # 2 scales x 2 point scales x 2 x 2 flips


def test_waymo_loader_pads_views(root):
    def build(p, s):
        return p.T.LoadMultiViewImageFromFilesWaymo(to_float32=True, img_scale=(120, 160))(s)

    out = run_both(root, build)
    assert out["img"][0].shape == (120, 160, 3)


def test_every_transform_is_registered():
    names = set(jt.__all__) - {"Compose"} | {"ImageAug3D", "MyResize", "MyNormalize", "MyPad", "MyFlip3D"}
    assert names <= set(PIPELINES.keys()) and names <= set(J_PIPELINES.keys())
    for name in names:
        assert PIPELINES.get(name) is getattr(tt, name)
