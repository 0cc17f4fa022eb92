"""Detection in the port vs the JAX package, on the CPU in fp32: the
CenterHead (forward maps in eval and train mode with the running
statistics, targets, loss, decode), the Anchor3DHead (forward, targets,
loss, get_bboxes), rotated IoU and the NMS family, the multi-class box NMS,
the test-time-augmentation merge, and the weight bridge for the heads.
Weights and batch statistics are made with numpy and carried across by
``api/weights.py``.

Tolerances. Maps, losses, IoUs and boxes: relative 1e-5 (``rel`` below:
relative L2, or elementwise rtol 1e-5 with an atol of 1e-6 for values that
are ~0), fp32 sums in another order. Heatmap targets: relative L2 1e-6.
Integer outputs (indices, masks, labels, keep masks) and the NMS results:
identical. Scores are tie-free (continuous random values), so the sorts
and the greedy NMS walk the same order in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recondet3d.api.weights import _flatten
from recondet3d.core.post_processing import box3d_multiclass_nms as j_multiclass_nms
from recondet3d.models.detect import merge_augs as jmerge
from recondet3d.models.detect.anchor3d_head import Anchor3DHead as JAnchor3DHead
from recondet3d.models.detect.centerhead import CenterHead as JCenterHead
from recondet3d.ops import iou3d as jiou
from recondet3d_torch.api.weights import flax_from_named, state_dict_from_flax
from recondet3d_torch.core.post_processing import box3d_multiclass_nms
from recondet3d_torch.models.detect import merge_augs as tmerge
from recondet3d_torch.models.detect.anchor3d_head import Anchor3DHead
from recondet3d_torch.models.detect.centerhead import CenterHead
from recondet3d_torch.ops import iou3d as tiou
from test_torch_refinement import random_variables

HEAD = dict(in_channels=16, share_ch=16, point_cloud_range=(-8.0, -8.0, -2.0, 8.0, 8.0, 2.0),
            voxel_size=(0.1, 0.1, 0.1), out_size_factor=8, tasks=(("car",), ("pedestrian", "traffic_cone")),
            max_objs=8)
CLASSES = ("car", "truck", "pedestrian", "traffic_cone")
GRID = 20  # 160 / 8


def t(a):
    return torch.from_numpy(np.array(a, order="C"))


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def load(module, variables):
    flat = {k: np.asarray(v) for k, v in _flatten(variables).items()}
    module.load_state_dict(state_dict_from_flax(flat), strict=True)
    return module.eval()


def random_boxes(rng, n, lo=-7.0, hi=7.0):
    """(n, 9) [x y z dx dy dz yaw vx vy] inside the head's range."""
    return np.concatenate([rng.uniform(lo, hi, (n, 2)), rng.uniform(-1.5, 0.0, (n, 1)), rng.uniform(0.5, 4.0, (n, 3)),
                           rng.uniform(-np.pi, np.pi, (n, 1)), rng.normal(size=(n, 2))], -1).astype(np.float32)


@pytest.fixture(scope="module")
def centerhead():
    x = np.random.default_rng(0).normal(size=(2, GRID, GRID, 16)).astype(np.float32)
    jhead = JCenterHead(**HEAD)
    variables = random_variables(jax.eval_shape(jhead.init, jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    return jhead, variables, load(CenterHead(**HEAD, device="cpu"), variables), x


def _gt(seed):
    rng = np.random.default_rng(seed)
    boxes = random_boxes(rng, 8)
    labels = np.array([[0, 2, 3, 1, 0, 3, -1, -1], [2, 2, 0, 3, 1, -1, -1, -1]], np.int64)
    boxes = np.stack([boxes, random_boxes(rng, 8)])
    boxes[0, 5, :2] = [9.0, 0.0]  # outside the grid
    return boxes, labels, labels >= 0


def test_centerhead_forward_matches_jax_in_eval_and_train_mode(centerhead):
    jhead, variables, head, x = centerhead
    ref = jhead.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = head.eval()(t(x))
    assert len(got) == 2 and set(got[0]) == {"heatmap", "reg", "height", "dim", "rot", "vel"}
    for g, r in zip(got, ref):
        for key in r:
            assert tuple(g[key].shape) == r[key].shape and rel(g[key].numpy(), r[key]) <= 1e-5, key
    ref, mut = jhead.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = head.train()(t(x))
    head.eval()
    for g, r in zip(got, ref):
        for key in r:
            assert rel(g[key].numpy(), r[key]) <= 1e-5, key
    stats = _flatten({"batch_stats": mut["batch_stats"]})
    new = flax_from_named(head.state_dict(), stats)
    assert set(new) == set(stats)
    for path in stats:
        assert rel(new[path], stats[path]) <= 1e-5, path
    load(head, variables)  # back to the fixture's statistics


def test_centerhead_targets_match_jax(centerhead):
    jhead, _, head, _ = centerhead
    boxes, labels, valid = _gt(3)
    ref = jhead.get_targets(jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(valid), CLASSES)
    got = head.get_targets(t(boxes), t(labels), t(valid), CLASSES)
    for g, r in zip(got, ref):
        assert g["heatmap"].shape == r["heatmap"].shape and rel(g["heatmap"].numpy(), r["heatmap"]) <= 1e-6
        assert np.asarray(r["heatmap"]).max() == pytest.approx(1.0)
        np.testing.assert_array_equal(g["inds"].numpy(), np.asarray(r["inds"]))
        np.testing.assert_array_equal(g["mask"].numpy(), np.asarray(r["mask"]))
        np.testing.assert_allclose(g["anno"].numpy(), np.asarray(r["anno"]), rtol=1e-6, atol=1e-6)
    assert got[1]["mask"].sum() > 2 and not got[0]["mask"][0, 5]  # truck is no task's; the box off the grid drops


def test_centerhead_loss_matches_jax(centerhead):
    jhead, variables, head, x = centerhead
    boxes, labels, valid = _gt(4)
    jpreds = jhead.apply(variables, jnp.asarray(x))
    ref = jhead.loss(jpreds, jhead.get_targets(jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(valid), CLASSES))
    preds = [{k: t(np.asarray(v)) for k, v in p.items()} for p in jpreds]
    got = head.loss(preds, head.get_targets(t(boxes), t(labels), t(valid), CLASSES))
    assert set(got) == set(ref) and len(got) == 4
    for k in ref:
        assert abs(got[k].item() - float(ref[k])) <= 1e-5 * abs(float(ref[k])), k


def test_centerhead_decode_matches_jax(centerhead):
    jhead, variables, head, x = centerhead
    jpreds = jhead.apply(variables, jnp.asarray(x))
    preds = [{k: t(np.asarray(v)) for k, v in p.items()} for p in jpreds]
    kw = dict(max_per_task=24, score_threshold=0.12, nms_thresh=0.1)
    ref = jhead.decode(jpreds, class_names=CLASSES, **kw)
    got = head.decode(preds, class_names=CLASSES, **kw)
    for g, r in zip(got, ref):
        assert 3 <= len(r["boxes_3d"]) < 3 * 24, len(r["boxes_3d"])  # some boxes pass the threshold, NMS drops some
        np.testing.assert_array_equal(g["labels_3d"], r["labels_3d"])
        np.testing.assert_allclose(g["scores_3d"], r["scores_3d"], rtol=1e-5)
        np.testing.assert_allclose(g["boxes_3d"], r["boxes_3d"], rtol=1e-5, atol=1e-5)


def test_head_weights_cross_the_bridge_bit_exact(centerhead):
    _, variables, head, _ = centerhead
    flat = {k: np.asarray(v) for k, v in _flatten(variables).items()}
    sd = state_dict_from_flax(flat)
    assert set(sd) == set(head.state_dict())
    back = flax_from_named(head.state_dict(), flat)
    assert set(back) == set(flat)
    for k in flat:  # port -> flax
        np.testing.assert_array_equal(back[k], flat[k])
    for name, v in head.state_dict().items():  # flax -> port
        assert torch.equal(sd[name], v.float())


# ---------------------------------------------------------------- iou3d

def _bev_boxes(rng, n):
    return np.concatenate([rng.uniform(-4, 4, (n, 2)), rng.uniform(0.8, 3.0, (n, 2)),
                           rng.uniform(-np.pi, np.pi, (n, 1))], -1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_ious_match_jax(seed):
    rng = np.random.default_rng(seed)
    a, b = _bev_boxes(rng, 30), _bev_boxes(rng, 25)
    for fn in ("boxes_overlap_bev", "boxes_iou_bev"):
        ref = np.asarray(getattr(jiou, fn)(jnp.asarray(a), jnp.asarray(b)))
        got = getattr(tiou, fn)(t(a), t(b)).numpy()
        assert (ref > 0).sum() > 20, fn
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6, err_msg=fn)
    a7, b7 = random_boxes(rng, 30)[:, :7], random_boxes(rng, 25)[:, :7]
    a7[:, :2] /= 2
    b7[:, :2] /= 2
    for fn in ("boxes_iou_3d", "nearest_bev_iou"):
        ref = np.asarray(getattr(jiou, fn)(jnp.asarray(a7), jnp.asarray(b7)))
        got = getattr(tiou, fn)(t(a7), t(b7)).numpy()
        assert (ref > 0).sum() > 20, fn
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6, err_msg=fn)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_keep_masks_match_jax(seed):
    rng = np.random.default_rng(seed)
    boxes = _bev_boxes(rng, 60)
    scores = rng.random(60).astype(np.float32)
    for fn, args in (("nms_bev", (0.2,)), ("nms_normal_bev", (0.2,))):
        ref = np.asarray(getattr(jiou, fn)(jnp.asarray(boxes), jnp.asarray(scores), *args))
        got = getattr(tiou, fn)(t(boxes), t(scores), *args).numpy()
        assert 5 < ref.sum() < 60, fn
        np.testing.assert_array_equal(got, ref, err_msg=fn)
    ref = np.asarray(jiou.circle_nms(jnp.asarray(boxes[:, :2]), jnp.asarray(scores), thresh=1.0, post_max_size=20))
    got = tiou.circle_nms(t(boxes[:, :2]), t(scores), 1.0, post_max_size=20).numpy()
    assert ref.sum() == 20
    np.testing.assert_array_equal(got, ref)
    lo = rng.uniform(-3, 3, (40, 3)).astype(np.float32)
    aabb = np.concatenate([lo, lo + rng.uniform(0.5, 2.5, (40, 3)).astype(np.float32)], -1)
    classes = rng.integers(0, 3, 40)
    ref = np.asarray(jiou.aligned_3d_nms(jnp.asarray(aabb), jnp.asarray(scores[:40]), jnp.asarray(classes), 0.1))
    got = tiou.aligned_3d_nms(t(aabb), t(scores[:40]), t(classes), 0.1).numpy()
    assert 3 < ref.sum() < 40
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("use_rotate", [True, False])
def test_multiclass_nms_matches_jax(use_rotate):
    rng = np.random.default_rng(7)
    boxes = random_boxes(rng, 80)
    boxes[:, :2] /= 2
    scores = np.concatenate([rng.random((80, 3)), np.zeros((80, 1))], -1).astype(np.float32)
    dirs = rng.integers(0, 2, 80).astype(np.float32)
    args = (boxes, boxes[:, [0, 1, 3, 4, 6]], scores, 0.3, 40, dict(use_rotate_nms=use_rotate, nms_thr=0.2))
    ref = j_multiclass_nms(*args, mlvl_dir_scores=dirs)
    got = box3d_multiclass_nms(*args, mlvl_dir_scores=dirs)
    assert len(got) == len(ref) == 4 and len(ref[0]) == 40
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_merge_aug_bboxes_matches_jax():
    rng = np.random.default_rng(9)
    results, metas = [], []
    for i, meta in enumerate([dict(), dict(pcd_horizontal_flip=True, pcd_scale_factor=1.1),
                              dict(pcd_vertical_flip=True, pcd_rotation=[[np.cos(0.3), -np.sin(0.3), 0],
                                                                         [np.sin(0.3), np.cos(0.3), 0], [0, 0, 1]])]):
        b = random_boxes(rng, 30)
        b[:, :2] /= 2
        results.append(dict(boxes_3d=b, scores_3d=rng.random(30).astype(np.float32),
                            labels_3d=rng.integers(0, 4, 30)))
        metas.append(meta)
    ref = jmerge.merge_aug_bboxes_3d(results, metas, nms_thresh=0.2, max_num=50)
    got = tmerge.merge_aug_bboxes_3d(results, metas, nms_thresh=0.2, max_num=50)
    assert 10 < len(ref["boxes_3d"]) <= 50
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# ---------------------------------------------------------------- Anchor3DHead

ANCHOR = dict(num_classes=2, in_channels=16, anchor_ranges=((-8, -8, -1.0, 8, 8, -1.0), (-8, -8, -0.6, 8, 8, -0.6)),
              anchor_sizes=((3.9, 1.6, 1.56), (0.8, 0.6, 1.7)), pos_iou_thr=(0.6, 0.5), neg_iou_thr=(0.45, 0.35),
              anchor_custom_values=2)


@pytest.fixture(scope="module")
def anchorhead():
    x = np.random.default_rng(10).normal(size=(2, 12, 12, 16)).astype(np.float32)
    jhead = JAnchor3DHead(**ANCHOR)
    variables = random_variables(jax.eval_shape(jhead.init, jax.random.PRNGKey(0), jnp.asarray(x)), 11)
    return jhead, variables, load(Anchor3DHead(**ANCHOR, device="cpu"), variables), x


def test_anchor_head_forward_targets_loss_match_jax(anchorhead):
    jhead, variables, head, x = anchorhead
    jpreds = jhead.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        preds = head(t(x))
    for k in jpreds:
        assert rel(preds[k].numpy(), jpreds[k]) <= 1e-5, k
    rng = np.random.default_rng(12)
    gt = np.stack([random_boxes(rng, 6), random_boxes(rng, 6)])
    gt[..., 3:6] = np.where(np.arange(6)[None, :, None] % 2 == 0, [3.9, 1.6, 1.56], [0.8, 0.6, 1.7])
    labels = np.tile(np.arange(6) % 2, (2, 1))
    mask = np.array([[1, 1, 1, 1, 1, 0], [1, 1, 1, 0, 0, 0]], bool)
    anchors = jhead.anchors_for((12, 12))
    np.testing.assert_array_equal(head.anchors_for((12, 12)).numpy(), np.asarray(anchors))
    jt = jhead.get_targets(anchors, jnp.asarray(gt), jnp.asarray(labels), jnp.asarray(mask))
    tt = head.get_targets(t(np.asarray(anchors)), t(gt), t(labels), t(mask))
    assert int(np.asarray(jt["bbox_weights"]).sum()) >= 8
    for k in ("labels", "label_weights", "bbox_weights", "dir_targets"):
        np.testing.assert_array_equal(tt[k].numpy(), np.asarray(jt[k]), err_msg=k)
    np.testing.assert_allclose(tt["bbox_targets"].numpy(), np.asarray(jt["bbox_targets"]), rtol=1e-5, atol=1e-6)
    ref = jhead.loss(jpreds, jt)
    got = head.loss({k: t(np.asarray(v)) for k, v in jpreds.items()}, tt)
    assert set(got) == set(ref) == {"loss_cls", "loss_bbox", "loss_dir"}
    for k in ref:
        assert abs(got[k].item() - float(ref[k])) <= 1e-5 * abs(float(ref[k])), k


def test_anchor_head_get_bboxes_matches_jax(anchorhead):
    jhead, variables, head, x = anchorhead
    jpreds = jhead.apply(variables, jnp.asarray(x))
    kw = dict(score_thr=0.3, max_num=30, nms_thr=0.2)
    ref = jhead.get_bboxes(jpreds, **kw)
    got = head.get_bboxes({k: t(np.asarray(v)) for k, v in jpreds.items()}, **kw)
    for (gb, gs, gl), (rb, rs, rl) in zip(got, ref):
        assert 3 <= len(rb) <= 30
        np.testing.assert_array_equal(gl, rl)
        np.testing.assert_allclose(gs, rs, rtol=1e-5)
        np.testing.assert_allclose(gb, rb, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- bbox: coder, costs, assigners

def test_bbox_coder_and_assigners_match_jax():
    """The TransFusion coder on numpy and on torch, the match costs and both
    assigners (Hungarian through scipy on the host, as in the JAX package)."""
    from recondet3d.models.detect import bbox as jbbox
    from recondet3d_torch.models.detect import bbox as tbbox

    rng = np.random.default_rng(21)
    boxes = random_boxes(rng, 12)
    kw = dict(pc_range=[-8.0, -8.0, -2.0, 8.0, 8.0, 2.0], out_size_factor=8, voxel_size=[0.1, 0.1, 0.1],
              code_size=10, score_threshold=0.2, post_center_range=[-7.0, -7.0, -3.0, 7.0, 7.0, 3.0])
    jc, tc = jbbox.TransFusionBBoxCoder(**kw), tbbox.TransFusionBBoxCoder(**kw)
    enc = jc.encode(boxes)
    np.testing.assert_array_equal(tc.encode(boxes), enc)
    np.testing.assert_allclose(tc.encode(t(boxes)).numpy(), enc, rtol=1e-5, atol=1e-6)
    args = (enc[:, 6:8], enc[:, 3:6], enc[:, :2], enc[:, 2:3], enc[:, 8:10])
    dec = jc.decode_box(*args)
    np.testing.assert_array_equal(tc.decode_box(*args), dec)
    np.testing.assert_allclose(tc.decode_box(*(t(a) for a in args)).numpy(), dec, rtol=1e-5, atol=1e-5)
    scores = rng.random(12)
    np.testing.assert_array_equal(tc.filter_decoded(dec, scores), jc.filter_decoded(dec, scores))

    queries, gts = random_boxes(rng, 20)[:, :7], random_boxes(rng, 6)[:, :7]
    cls_pred, labels = rng.random((20, 4)), rng.integers(0, 4, 6)
    cfg = dict(point_cloud_range=kw["pc_range"])
    for name, cargs in (("BBox3DL1Cost", (queries, gts)), ("BBoxBEVL1Cost", (queries, gts, cfg)),
                        ("FocalLossCost", (cls_pred, labels))):
        np.testing.assert_allclose(getattr(tbbox, name)()(*cargs), getattr(jbbox, name)()(*cargs), rtol=1e-6,
                                   err_msg=name)
    ref = jbbox.HungarianAssigner3D().assign(queries, gts, labels, cls_pred, cfg)
    got = tbbox.HungarianAssigner3D().assign(queries, gts, labels, cls_pred, cfg)
    np.testing.assert_array_equal(got.gt_inds, ref.gt_inds)
    np.testing.assert_array_equal(got.labels, ref.labels)
    np.testing.assert_allclose(got.max_overlaps, ref.max_overlaps, rtol=1e-5, atol=1e-6)
    assert (got.gt_inds > 0).sum() == 6
    ref = jbbox.HeuristicAssigner3D(dist_thre=3.0).assign(queries, gts, gt_labels=labels)
    got = tbbox.HeuristicAssigner3D(dist_thre=3.0).assign(queries, gts, gt_labels=labels)
    np.testing.assert_array_equal(got.gt_inds, ref.gt_inds)
    np.testing.assert_allclose(got.max_overlaps, ref.max_overlaps, rtol=1e-5, atol=1e-6)
