"""Synthetic on-disk layouts of KITTI, Waymo (KITTI format), Lyft, ScanNet,
SUN RGB-D, S3DIS and nuImages, for tests/test_torch_data_converters.py and
``chip_smoke.py`` phase 24. At their defaults they write what the JAX
package's own tests write (tests/test_kitti.py, test_waymo.py, test_lyft.py,
test_indoor.py, test_nuscenes_data.py); the size arguments scale a sample
up to a real one (a KITTI scan of ~120,000 points, a SUN RGB-D depth above
the converter's 50,000 samples). Imports numpy and the standard library
only, so the chip script can use it without JAX.
"""

import base64
import json
import os
import shutil

import numpy as np

from nuscenes_fixture import make_fixture

__all__ = ["write_kitti", "write_waymo", "write_lyft", "write_scannet", "write_sunrgbd", "write_s3dis",
           "write_nuimages", "random_lyft_scene", "random_indoor_scenes"]

LYFT_CLASSES = ("car", "truck", "bus", "emergency_vehicle", "other_vehicle", "motorcycle", "bicycle", "pedestrian",
                "animal")
_VELO_TO_CAM = "0 -1 0 0 0 0 -1 0 1 0 0 0"  # x_cam = -y_velo, y_cam = -z_velo, z_cam = x_velo


def write_kitti(root, ids=("000000", "000001"), n_points=128, seed=0):
    """root/training/{velodyne,label_2,calib,image_2} + ImageSets/{train,val}.txt: one Car and one DontCare a
    sample (tests/test_kitti.py's fixture at ``n_points`` points a scan)."""
    for sub in ("velodyne", "label_2", "calib", "image_2"):
        os.makedirs(os.path.join(root, "training", sub), exist_ok=True)
    os.makedirs(os.path.join(root, "ImageSets"), exist_ok=True)
    rng = np.random.default_rng(seed)
    for sid in ids:
        rng.normal(size=(n_points, 4)).astype(np.float32).tofile(
            os.path.join(root, "training", "velodyne", f"{sid}.bin"))
        with open(os.path.join(root, "training", "calib", f"{sid}.txt"), "w") as f:
            P2 = "7.2e2 0 6.0e2 0 0 7.2e2 1.7e2 0 0 0 1 0"
            f.write(f"P0: {P2}\nP1: {P2}\nP2: {P2}\nP3: {P2}\n")
            f.write("R0_rect: 1 0 0 0 1 0 0 0 1\n")
            f.write(f"Tr_velo_to_cam: {_VELO_TO_CAM}\n")
        with open(os.path.join(root, "training", "label_2", f"{sid}.txt"), "w") as f:
            f.write("Car 0.0 0 0.0 500 150 560 200 1.5 1.8 4.2 2.0 1.5 10.0 0.0\n")
            f.write("DontCare -1 -1 -10 0 0 50 50 -1 -1 -1 -1000 -1000 -1000 -10\n")
    with open(os.path.join(root, "ImageSets", "train.txt"), "w") as f:
        f.write("\n".join(ids))
    with open(os.path.join(root, "ImageSets", "val.txt"), "w") as f:
        f.write(ids[-1])
    return root


def write_waymo(root, ids=("0000000",), n_points=200):
    """tests/test_waymo.py's KITTI-format layout: a Car and a DontCare; half the points inside the car, some on its
    faces when ``n_points`` > 200 (the counter's faces are inclusive)."""
    t = os.path.join(root, "training")
    for d in ("velodyne", "calib", "label_all", "pose"):
        os.makedirs(os.path.join(t, d), exist_ok=True)
    os.makedirs(os.path.join(root, "ImageSets"), exist_ok=True)
    with open(os.path.join(root, "ImageSets", "train.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    for sid in ids:
        with open(os.path.join(t, "calib", f"{sid}.txt"), "w") as f:
            P = "1 0 0 0 0 1 0 0 0 0 1 0"
            for i in range(4):
                f.write(f"P{i}: {P}\n")
            f.write("R0_rect: 1 0 0 0 1 0 0 0 1\n")
            f.write(f"Tr_velo_to_cam: {_VELO_TO_CAM}\n")
        with open(os.path.join(t, "label_all", f"{sid}.txt"), "w") as f:
            f.write("Car 0 0 0 0 0 50 50 1.5 1.8 4.2 -2.0 1.0 10.0 0.1\n")
            f.write("DontCare 0 0 0 0 0 1 1 1 1 1 0 0 0 0\n")
        np.savetxt(os.path.join(t, "pose", f"{sid}.txt"), np.eye(4))
        pts = np.zeros((n_points, 6), np.float32)
        half = n_points // 2
        pts[:half, :3] = [10.0, 2.0, 0.2]
        pts[half:, 0] = 40.0
        if n_points > 200:
            pts[half:half + 10, :3] = [10.0, 2.0, -1.0]  # on the bottom face: inside
            pts[half + 10:half + 20, :3] = [10.0, 2.0, 0.5]  # on the top face: inside
        pts.tofile(os.path.join(t, "velodyne", f"{sid}.bin"))
    return root


def write_lyft(root, **fixture_kw):
    """tests/test_lyft.py's layout: the nuScenes fixture under root/v1.01-train with its tables at
    root/v1.01-train/v1.01-train and Lyft's flat class names."""
    inner = os.path.join(root, "v1.01-train")
    make_fixture(inner, **fixture_kw)
    shutil.move(os.path.join(inner, "v1.0-mini"), os.path.join(inner, "v1.01-train"))
    cat_path = os.path.join(inner, "v1.01-train", "category.json")
    with open(cat_path) as f:
        cats = json.load(f)
    renames = {"vehicle.car": "car", "human.pedestrian.adult": "pedestrian"}
    for c in cats:
        c["name"] = renames.get(c["name"], c["name"])
    with open(cat_path, "w") as f:
        json.dump(cats, f)
    return root


def write_scannet(root, n_points=500):
    """tests/test_indoor.py's ``_write_scannet`` at ``n_points`` points a scene."""
    inst = os.path.join(root, "scannet_instance_data")
    meta = os.path.join(root, "meta_data")
    os.makedirs(inst), os.makedirs(meta)
    rng = np.random.default_rng(0)
    for split, scans in (("train", ["scene0000_00"]), ("val", ["scene0001_00"]), ("test", [])):
        with open(os.path.join(meta, f"scannetv2_{split}.txt"), "w") as f:
            f.write("\n".join(scans))
    for scan in ("scene0000_00", "scene0001_00"):
        np.save(os.path.join(inst, f"{scan}_vert.npy"), rng.normal(size=(n_points, 6)).astype(np.float32))
        np.save(os.path.join(inst, f"{scan}_ins_label.npy"), rng.integers(0, 4, n_points))
        np.save(os.path.join(inst, f"{scan}_sem_label.npy"), rng.integers(0, 40, n_points))
        boxes = np.zeros((2, 7))
        boxes[:, 3:6] = 1.0
        boxes[:, 6] = [4, 5]  # nyu40 ids: bed, chair
        np.save(os.path.join(inst, f"{scan}_aligned_bbox.npy"), boxes)
        np.save(os.path.join(inst, f"{scan}_unaligned_bbox.npy"), boxes)
        np.save(os.path.join(inst, f"{scan}_axis_align_matrix.npy"), np.eye(4))
    return root


def write_sunrgbd(root, n_points=1000):
    """tests/test_indoor.py's SUN RGB-D layout (a bed and an unknown class a sample) at ``n_points`` depth points."""
    tv = os.path.join(root, "sunrgbd_trainval")
    for d in ("depth", "label", "calib", "image"):
        os.makedirs(os.path.join(tv, d))
    rng = np.random.default_rng(1)
    for split, ids in (("train", [1]), ("val", [2])):
        with open(os.path.join(tv, f"{split}_data_idx.txt"), "w") as f:
            f.write("\n".join(str(i) for i in ids))
    for i in (1, 2):
        np.save(os.path.join(tv, "depth", f"{i:06d}.npy"), rng.normal(size=(n_points, 6)).astype(np.float32))
        with open(os.path.join(tv, "label", f"{i:06d}.txt"), "w") as f:
            f.write("bed 1 2 30 40 0.5 2.0 0.4 0.45 1.0 0.3 1.0 0.0\n")
            f.write("unknown_cls 1 2 3 4 0 0 0 1 1 1 1 0\n")
        with open(os.path.join(tv, "calib", f"{i:06d}.txt"), "w") as f:
            f.write(" ".join(["1", "0", "0", "0", "1", "0", "0", "0", "1"]) + "\n")
            f.write(" ".join(["500", "0", "0", "0", "500", "0", "320", "240", "1"]) + "\n")
    return root


def write_s3dis(root, n_points=300):
    """tests/test_indoor.py's S3DIS room: one chair instance of 50 points."""
    d = os.path.join(root, "s3dis_data")
    os.makedirs(d)
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(n_points, 6)).astype(np.float32)
    ins = np.zeros(n_points, np.int64)
    sem = np.zeros(n_points, np.int64)
    ins[:50] = 1
    sem[:50] = 8  # chair
    np.save(os.path.join(d, "Area_1_office_1_point.npy"), pts)
    np.save(os.path.join(d, "Area_1_office_1_ins_label.npy"), ins)
    np.save(os.path.join(d, "Area_1_office_1_sem_label.npy"), sem)
    return pts


def write_nuimages(root):
    """tests/test_nuscenes_data.py's nuImages tables: a key frame with a car (RLE mask) and an unmapped class, and a
    sweep."""
    tdir = os.path.join(root, "v1.0-mini")
    os.makedirs(tdir)
    cats = [dict(token="c1", name="vehicle.car"), dict(token="c2", name="static_object.bicycle_rack")]
    sds = [dict(token="sd1", filename="samples/CAM_FRONT/a.jpg", is_key_frame=True, width=1600, height=900),
           dict(token="sd2", filename="sweeps/CAM_FRONT/b.jpg", is_key_frame=False)]
    counts = base64.b64encode(b"abc").decode()
    anns = [dict(token="a1", sample_data_token="sd1", category_token="c1", bbox=[10, 20, 110, 70],
                 mask=dict(counts=counts, size=[900, 1600])),
            dict(token="a2", sample_data_token="sd1", category_token="c2", bbox=[0, 0, 5, 5], mask=None)]
    for name, rows in (("category", cats), ("sample_data", sds), ("object_ann", anns)):
        with open(os.path.join(tdir, f"{name}.json"), "w") as f:
            json.dump(rows, f)
    return root


def random_lyft_scene(rng, n_samples, n_gt, n_pred):
    """Ground truth of the 9 classes and predictions near it (yawed, some missed, some false): token -> annos,
    token -> [(box, score, name)]."""
    gt, res = {}, {}
    for s in range(n_samples):
        boxes = np.concatenate([rng.uniform(-40, 40, (n_gt, 2)), rng.uniform(-2, 0, (n_gt, 1)),
                                rng.uniform(1, 5, (n_gt, 3)), rng.uniform(-np.pi, np.pi, (n_gt, 1))], 1)
        names = rng.choice(LYFT_CLASSES, n_gt)
        gt[f"t{s}"] = dict(boxes=boxes.astype(np.float32), names=names)
        src = rng.integers(0, n_gt, n_pred)
        pred = boxes[src] + rng.normal(0, 1, (n_pred, 7)) * np.array([0.3, 0.3, 0.1, 0.2, 0.2, 0.1, 0.15])
        pred[:, 3:6] = np.abs(pred[:, 3:6]) + 0.1
        far = rng.random(n_pred) < 0.2
        pred[far, :2] += 30.0
        names_p = np.where(rng.random(n_pred) < 0.9, names[src], rng.choice(LYFT_CLASSES, n_pred))
        res[f"t{s}"] = [(pred[j].astype(np.float32), float(rng.random()), str(names_p[j])) for j in range(n_pred)]
    res["unknown"] = [(np.zeros(7, np.float32) + 1, 0.5, "car")]  # a token without ground truth
    return gt, res


def random_indoor_scenes(rng, n_scenes, n_gt, n_pred, n_classes, yawed=True, width=7):
    """SUN RGB-D-like ground truth (depth frame, bottom-centred) and predictions near it."""
    gts, dts = [], []
    for _ in range(n_scenes):
        g = np.concatenate([rng.uniform(-3, 3, (n_gt, 2)), rng.uniform(0, 1, (n_gt, 1)),
                            rng.uniform(0.3, 2.0, (n_gt, 3)),
                            rng.uniform(-np.pi, np.pi, (n_gt, 1)) if yawed else np.zeros((n_gt, 1))], 1)
        gc = rng.integers(0, n_classes, n_gt)
        src = rng.integers(0, n_gt, n_pred)
        p = g[src] + rng.normal(0, 1, (n_pred, 7)) * np.array([0.15, 0.15, 0.05, 0.1, 0.1, 0.1, 0.2 if yawed else 0])
        p[:, 3:6] = np.abs(p[:, 3:6]) + 0.05
        lab = np.where(rng.random(n_pred) < 0.85, gc[src], rng.integers(0, n_classes, n_pred))
        gts.append(dict(gt_boxes_upright_depth=g[:, :width], **{"class": gc}))
        dts.append(dict(boxes_3d=p[:, :width], labels_3d=lab, scores_3d=rng.random(n_pred)))
    return gts, dts
