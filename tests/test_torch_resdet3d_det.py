"""ResDet3D with the CenterHead, port vs JAX package, on the shapes of
``configs/resdet3d_tiny_centerhead_test.py`` (CPU, fp32): the model of
tests/test_torch_resdet3d_train.py (a cut-depth any-view DA3 and the tiny
refinement) with the config's head on the refinement's BEV features, the
weights and batch statistics of every part made with numpy and carried
across by ``api/weights.py``. ``forward_train``'s reconstruction and
detection losses in train mode, ``simple_test``'s ``det_preds`` in eval
mode and their decode; a ``Trainer`` step that moves the head's parameters;
and ``build_model_from_cfg`` on every shipped config with its refusals of
unknown keys, in both packages.

The point path makes the same selections in both packages on these seeds
(the valid masks are compared), so the BEV features are those of the same
cloud; detection maps are dense (B, H, W, C), so no row order enters.
Tolerance: losses rtol 1e-5 (fp32 sums in another order; the refinement's
batch statistics over a few hundred voxels are the most sensitive part, and
the total of tests/test_torch_resdet3d_train.py holds to the same 1e-5);
maps atol 2e-4 / rtol 2e-3, the refinement's output gate."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recondet3d.cli.train import build_model_from_cfg as j_build_model_from_cfg
from recondet3d.core.config import load_py_config as j_load_py_config
from recondet3d.models.detect import ResDet3D as JResDet3D
from recondet3d.models.detect.centerhead import CenterHead as JCenterHead
from recondet3d_torch.cli.train import build_model_from_cfg
from recondet3d_torch.core.config import load_py_config
from recondet3d_torch.models.da3 import NestedDepthAnything3Net
from recondet3d_torch.models.detect import CenterHead, ResDet3D
from recondet3d_torch.train import Trainer
from test_torch_refinement import ATOL, RTOL
from test_torch_resdet3d_train import build_pair, load_model_variables, make_batch, random_model_variables

CONFIG = "configs/resdet3d_tiny_centerhead_test.py"
CONFIGS = ["configs/resdet3d_centerhead.py", "configs/resdet3d_nuscenes_mini.py", CONFIG,
           "configs/resdet3d_tiny_test.py"]


def head_cfg(in_channels):
    """The config's head at the BEV width of the refinement (the flax head infers it and reads no
    ``in_channels``; the config's 32 is not the tiny refinement's 16, see ``build_model_from_cfg``)."""
    cfg = dict(load_py_config(CONFIG)["model"]["pts_bbox_head"])
    cfg.pop("type")
    return dict(cfg, tasks=tuple(tuple(t) for t in cfg["tasks"]), point_cloud_range=tuple(cfg["point_cloud_range"]),
                voxel_size=tuple(cfg["voxel_size"]), in_channels=in_channels)


def det_batch(seed):
    batch = make_batch(seed)
    rng = np.random.default_rng(seed + 100)
    B, M = 2, 32
    boxes = np.concatenate([rng.uniform(-7, 7, (B, M, 2)), rng.uniform(-1.5, 0, (B, M, 1)),
                            rng.uniform(0.5, 4.0, (B, M, 3)), rng.uniform(-np.pi, np.pi, (B, M, 1)),
                            rng.normal(size=(B, M, 2))], -1).astype(np.float32)
    labels = rng.integers(0, 10, (B, M))
    labels[:, 20:] = -1
    return dict(batch, gt_bboxes_3d=boxes, gt_labels_3d=labels)


@pytest.fixture(scope="module")
def det_pair():
    classes = tuple(load_py_config(CONFIG)["class_names"])
    jbase, tbase = build_pair(freeze_da3=True)
    width = tbase.reconstruction_backbone.refinement.middle_encoder.bev_channels
    jmodel = JResDet3D(reconstruction_backbone=jbase.reconstruction_backbone,
                       pts_bbox_head=JCenterHead(**head_cfg(width)), class_names=classes)
    tmodel = ResDet3D(tbase.reconstruction_backbone, CenterHead(**head_cfg(width), device="cpu"), class_names=classes)
    batch = det_batch(2)
    variables = random_model_variables(jmodel, batch, 1)
    return jmodel, load_model_variables(tmodel, variables), variables, batch


def test_forward_train_with_the_head_matches_jax(det_pair):
    jmodel, tmodel, variables, batch = det_pair
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jlosses, jaux), _ = jax.jit(lambda v: jmodel.apply(v, return_loss=True, train=True, mutable=["batch_stats"],
                                                         **jb))(variables)
    tmodel.train()
    with torch.no_grad():
        losses, aux = tmodel(return_loss=True, **{k: torch.from_numpy(v) for k, v in batch.items()})
    load_model_variables(tmodel, variables).eval()  # the train-mode forward moved the statistics
    np.testing.assert_array_equal(aux["pseudo_valid"].numpy(), np.asarray(jaux["pseudo_valid"]))
    assert set(losses) == set(jlosses) and len(losses) == 5  # occupancy + two tasks' heatmap and box losses
    for k, v in jlosses.items():
        np.testing.assert_allclose(losses[k].item(), float(v), rtol=1e-5, err_msg=k)
    assert len(aux["det_preds"]) == 2 and tuple(aux["det_preds"][1]["heatmap"].shape) == (2, 20, 20, 2)


def test_simple_test_det_preds_and_decode_match_jax(det_pair):
    jmodel, tmodel, variables, batch = det_pair
    jout = jax.jit(lambda v: jmodel.apply(v, jnp.asarray(batch["img"]), jnp.asarray(batch["cam2lidar_rts"])))(variables)
    out = tmodel.eval().simple_test(torch.from_numpy(batch["img"]), torch.from_numpy(batch["cam2lidar_rts"]))
    np.testing.assert_array_equal(out["pseudo_valid"].numpy(), np.asarray(jout["pseudo_valid"]))
    for g, r in zip(out["det_preds"], jout["det_preds"]):
        for key in r:
            np.testing.assert_allclose(g[key].numpy(), np.asarray(r[key]), atol=ATOL, rtol=RTOL, err_msg=key)
    # decode: the maps agree to ~1e-4 here, enough to swap two close scores in the top-K order and then the NMS
    # walk, so only the best box of each scene is compared (decode itself is held exactly in test_torch_detection)
    kw = dict(max_per_task=16, score_threshold=0.0, nms_thresh=0.2, class_names=tmodel.class_names)
    ref = jmodel.pts_bbox_head.decode(jout["det_preds"], **kw)
    got = tmodel.pts_bbox_head.decode(out["det_preds"], **kw)
    for g, r in zip(got, ref):
        assert len(g["boxes_3d"]) > 3 and np.isfinite(g["boxes_3d"]).all() and g["boxes_3d"].shape[1] == 9
        assert set(g["labels_3d"]) <= {tmodel.class_names.index(c) for c in tmodel.pts_bbox_head.task_class_names()}
        gi, ri = int(np.argmax(g["scores_3d"])), int(np.argmax(r["scores_3d"]))
        assert g["labels_3d"][gi] == r["labels_3d"][ri]
        np.testing.assert_allclose(g["boxes_3d"][gi], r["boxes_3d"][ri], atol=1e-3, rtol=1e-3)


def test_trainer_step_trains_the_head(det_pair):
    _, src, _, batch = det_pair
    tmodel = copy.deepcopy(src)
    head_before = {n: p.detach().clone() for n, p in tmodel.pts_bbox_head.named_parameters()}
    trainer = Trainer(model=tmodel, total_steps=10, lr=1e-2)  # DA3 frozen
    assert any(n.startswith("pts_bbox_head.") for n in trainer.optimizer.names)
    state, history = trainer.run(trainer.init_state(), [{k: torch.from_numpy(v) for k, v in batch.items()}],
                                 max_steps=1)
    assert state.step == 1 and np.isfinite(history[0]["loss"])
    assert {"task0_loss_heatmap", "task1_loss_bbox", "reconstruction_loss_occupancy"} <= set(history[0])
    moved = [n for n, p in tmodel.pts_bbox_head.named_parameters() if not torch.equal(p.detach(), head_before[n])]
    assert len(moved) == len(head_before)


@pytest.mark.parametrize("path", CONFIGS)
def test_every_shipped_config_builds(path):
    cfg = load_py_config(path)
    model = build_model_from_cfg(cfg, device="meta")
    jmodel = j_build_model_from_cfg(j_load_py_config(path))
    has_head = cfg["model"].get("pts_bbox_head") is not None
    assert (model.pts_bbox_head is not None) == has_head == (jmodel.pts_bbox_head is not None)
    if has_head:
        assert model.pts_bbox_head.tasks == tuple(jmodel.pts_bbox_head.tasks)
        assert len(model.pts_bbox_head.branches) == len(cfg["model"]["pts_bbox_head"]["tasks"])
        width = model.reconstruction_backbone.refinement.middle_encoder.bev_channels
        assert model.pts_bbox_head.shared_conv.in_channels == width
    nested = "NESTED" in cfg["model"]["reconstruction_backbone"]["pretrained"]
    assert isinstance(model.reconstruction_backbone.da3, NestedDepthAnything3Net) == nested
    assert model.class_names == tuple(cfg["class_names"])
    bk, jbk = model.reconstruction_backbone, jmodel.reconstruction_backbone
    for key in ("process_res", "num_points", "bq_anchor_points", "max_depth", "voxel_pre_reduce", "freeze_da3"):
        assert getattr(bk, key) == getattr(jbk, key), key
    assert bk.refinement.voxel_size == tuple(jbk.refinement.voxel_size)


@pytest.mark.parametrize("where,key,match", [
    ("refinement", "max_voxel", "unknown refinement config keys"),
    ("backbone", "num_point", "unknown reconstruction_backbone config keys"),
    ("head", "AnchorHead", "unsupported pts_bbox_head type"),
])
def test_unknown_config_keys_raise_in_both_packages(where, key, match):
    cfgs = []
    for load in (load_py_config, j_load_py_config):
        cfg = load(CONFIG)
        rb = cfg["model"]["reconstruction_backbone"]
        if where == "refinement":
            rb["refinement"][key] = 1
        elif where == "backbone":
            rb[key] = 1
        else:
            cfg["model"]["pts_bbox_head"]["type"] = key
        cfgs.append(cfg)
    with pytest.raises(ValueError, match=match):
        build_model_from_cfg(cfgs[0], device="meta")
    with pytest.raises(ValueError, match=match):
        j_build_model_from_cfg(cfgs[1])
