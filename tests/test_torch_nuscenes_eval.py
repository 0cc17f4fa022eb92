"""Devkit-free nuScenes evaluation (mAP / NDS), port vs JAX package
(mirrors the evaluation cases of tests/test_box3d_eval.py).

The same boxes go through both ``evaluate_nuscenes``: the golden scenes of
the JAX tests, and GT boxes jittered, dropped and duplicated from a seed.
Both are float64 numpy, so every metric (mAP, NDS, per-class and
per-threshold AP, TP errors) must agree to 1e-12; ``accumulate`` /
``calc_ap`` / ``calc_tp`` are compared on their curves. Through the
datasets, ``NuScenesDataset.evaluate`` must give the same
``pts_bbox_NuScenes/*`` dict."""

import os

import numpy as np
import pytest

from nuscenes_fixture import make_fixture
from recondet3d.data.nuscenes import NuScenesDataset as JNuScenesDataset
from recondet3d.data.nuscenes import create_nuscenes_infos as j_create_nuscenes_infos
from recondet3d.train.eval import nuscenes_eval as jeval
from recondet3d_torch.data.nuscenes import NuScenesDataset
from recondet3d_torch.train.eval import nuscenes_eval as teval

TOL = 1e-12
CLASSES = ("car", "truck", "construction_vehicle", "bus", "trailer", "barrier", "motorcycle", "bicycle",
           "pedestrian", "traffic_cone")


def boxes(mod, spec):
    """spec rows: (token, xy, name, score, yaw, size, vel, attr)."""
    return [mod.DetectionBox(tok, [*xy, 0.0], size, yaw, vel, name, detection_score=score, attribute_name=attr)
            for tok, xy, name, score, yaw, size, vel, attr in spec]


def row(token, xy, name, score=0.5, yaw=0.0, size=(2.0, 4.0, 1.5), vel=(1.0, 0.0), attr="x.attr"):
    return (token, tuple(xy), name, score, yaw, size, vel, attr)


# the golden scenes of tests/test_box3d_eval.py: (gts, preds, classes)
GOLDEN = {
    "perfect_single": ([row("s0", (0, 0), "car")], [row("s0", (0, 0), "car", 0.9)], ["car"]),
    "recall_at_min_bin": ([row("s0", (10 * i, 0), "car") for i in range(10)], [row("s0", (0, 0), "car", 0.9)],
                          ["car"]),
    "two_live_grid_points": ([row("s0", (8 * i, 0), "car") for i in range(25)],
                             [row("s0", (8 * i, 0), "car", 0.9 - 0.1 * i) for i in range(3)], ["car"]),
    "conf_interpolated": ([row("s0", (0, 0), "car"), row("s0", (10, 0), "car")],
                          [row("s0", (0.2, 0), "car", 0.9), row("s0", (10.4, 0), "car", 0.5)], ["car"]),
    "fp_before_tp": ([row("s0", (0, 0), "car")], [row("s0", (30, 30), "car", 0.9), row("s0", (0, 0), "car", 0.8)],
                     ["car"]),
    "barrier": ([row("s0", (0, 0), "barrier")], [row("s0", (0, 0), "barrier", 0.9, yaw=np.pi - 0.1)], ["barrier"]),
    "scale": ([row("s0", (0, 0), "car", size=(2, 4, 2))], [row("s0", (0, 0), "car", 0.9, size=(2, 4, 1))], ["car"]),
    "zero_gt_class": ([row("s0", (0, 0), "car")], [row("s0", (0, 0), "car", 0.9)], ["car", "truck"]),
    "cross_sample": ([row("s0", (0, 0), "car")], [row("s1", (0, 0), "car", 0.9)], ["car"]),
    "empty_attribute": ([row("s0", (0, 0), "car", attr="")], [row("s0", (0, 0), "car", 0.9, attr="")], ["car"]),
    "false_positives": ([row("s0", (0, 0), "car")],
                        [row("s0", (0, 0), "car", 0.9)] + [row("s0", (30 + i, 30), "car", 0.95) for i in range(5)],
                        ["car"]),
    "offset_and_missing": ([row("s0", (0, 0), "car"), row("s0", (10, 0), "car")], [row("s0", (1.5, 0), "car", 0.9)],
                           ["car"]),
}


def random_scene(seed, n_samples=6):
    """GT of every class in several samples; predictions are the GT jittered
    in position, size, yaw and velocity, a share dropped, some duplicated
    and some false positives, with random scores and attributes."""
    rng = np.random.default_rng(seed)
    gts, preds = [], []
    attrs = ["", "vehicle.moving", "vehicle.parked"]
    for s in range(n_samples):
        tok = f"s{s}"
        for _ in range(rng.integers(3, 15)):
            name = CLASSES[rng.integers(len(CLASSES))]
            xy = rng.uniform(-30, 30, 2)
            size = tuple(rng.uniform(0.4, 5.0, 3))
            yaw, vel = rng.uniform(-np.pi, np.pi), tuple(rng.normal(size=2))
            attr = attrs[rng.integers(3)]
            gts.append(row(tok, xy, name, 1.0, yaw, size, vel, attr))
            if rng.random() < 0.2:
                continue  # missed
            for _ in range(1 + (rng.random() < 0.15)):  # some duplicated
                preds.append(row(tok, xy + rng.normal(0, 0.8, 2), name, float(rng.random()),
                                 yaw + rng.normal(0, 0.3), tuple(np.asarray(size) * rng.uniform(0.8, 1.2, 3)),
                                 tuple(np.asarray(vel) + rng.normal(0, 0.5, 2)), attrs[rng.integers(3)]))
        for _ in range(rng.integers(0, 4)):  # false positives
            preds.append(row(tok, rng.uniform(-30, 30, 2), CLASSES[rng.integers(len(CLASSES))],
                             float(rng.random())))
    return gts, preds, list(CLASSES)


def assert_metrics_equal(a, b, where=""):
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            assert_metrics_equal(a[k], b[k], f"{where}/{k}")
    else:
        assert a == pytest.approx(b, abs=TOL, nan_ok=True), f"{where}: {a} vs {b}"


SCENES = dict(GOLDEN, **{f"random_{s}": random_scene(s) for s in range(4)})


@pytest.mark.parametrize("eval_vel_attr", [True, False])
@pytest.mark.parametrize("scene", list(SCENES))
def test_evaluate_nuscenes_matches(scene, eval_vel_attr):
    gts, preds, classes = SCENES[scene]
    ref = jeval.evaluate_nuscenes(boxes(jeval, gts), boxes(jeval, preds), classes, eval_vel_attr=eval_vel_attr)
    got = teval.evaluate_nuscenes(boxes(teval, gts), boxes(teval, preds), classes, eval_vel_attr=eval_vel_attr)
    assert_metrics_equal(ref, got)
    if scene == "random_0":
        assert 0.1 < got["mAP"] < 0.9  # the scene exercises partial matches, not a degenerate corner


@pytest.mark.parametrize("dist_th", jeval.DIST_THRESHOLDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_accumulate_curves_match(seed, dist_th):
    gts, preds, _ = random_scene(seed)
    for cls in ("car", "barrier", "traffic_cone"):
        jmd = jeval.accumulate([b for b in boxes(jeval, gts) if b.detection_name == cls],
                               [b for b in boxes(jeval, preds) if b.detection_name == cls], dist_th)
        tmd = teval.accumulate([b for b in boxes(teval, gts) if b.detection_name == cls],
                               [b for b in boxes(teval, preds) if b.detection_name == cls], dist_th)
        for key in ("precision", "confidence"):
            np.testing.assert_allclose(getattr(tmd, key), getattr(jmd, key), rtol=0, atol=TOL, err_msg=key)
        for key in jeval.TP_METRICS:
            np.testing.assert_allclose(tmd.errors[key], jmd.errors[key], rtol=0, atol=TOL, err_msg=key)
            assert teval.calc_tp(tmd, key) == pytest.approx(jeval.calc_tp(jmd, key), abs=TOL, nan_ok=True)
        assert teval.calc_ap(tmd) == pytest.approx(jeval.calc_ap(jmd), abs=TOL)


@pytest.fixture(scope="module")
def all_classes_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nusc_eval"))
    make_fixture(root, all_classes=True)
    j_create_nuscenes_infos(root, info_prefix="e", val_scene_names=[])
    return root


@pytest.mark.parametrize("seed", [None, 0, 1, 2])
def test_dataset_evaluate_matches(all_classes_root, seed):
    """Perfect predictions (seed None) and the GT jittered, dropped and
    duplicated from a seed, through both datasets' ``evaluate``."""
    kw = dict(ann_file=os.path.join(all_classes_root, "e_infos_train.pkl"), data_root=all_classes_root)
    j, t = JNuScenesDataset(**kw), NuScenesDataset(**kw)
    rng = np.random.default_rng(seed)
    results = []
    for i in range(len(t)):
        ann = t.get_ann_info(i)
        b, lab = np.asarray(ann["gt_bboxes_3d"], np.float64), np.asarray(ann["gt_labels_3d"])
        score = np.full(len(b), 0.9)
        if seed is not None:
            keep = rng.random(len(b)) > 0.2
            dup = rng.random(len(b)) < 0.2
            b = np.concatenate([b[keep], b[dup]])
            lab = np.concatenate([lab[keep], lab[dup]])
            b = b + np.concatenate([rng.normal(0, 0.5, (len(b), 3)), rng.normal(0, 0.1, (len(b), 4)),
                                    rng.normal(0, 0.3, (len(b), 2))], 1)
            score = rng.random(len(b))
        results.append(dict(boxes_3d=b, scores_3d=score, labels_3d=lab))
    ref, got = j.evaluate(results), t.evaluate(results)
    assert_metrics_equal(ref, got)
    assert len(got) == 17 and set(got) == set(ref)
    if seed is None:
        assert got["pts_bbox_NuScenes/mAP"] > 0.95
