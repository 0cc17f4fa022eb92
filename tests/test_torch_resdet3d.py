"""The ResDet3D inference path after depth (the training path:
tests/test_torch_resdet3d_train.py), port vs JAX package, on the shapes of
``configs/resdet3d_tiny_test.py`` (CPU, fp32): one depth map, intrinsics
and rig go through both packages' ``points_from_depth`` and refinement,
with the refinement's weights and batch statistics carried by the weight
bridge under their full ``reconstruction_backbone/refinement/`` paths.
DA3 itself is held by tests/test_torch_da3_net.py and is not compiled
again on the JAX side.

The selected point set (rows, order and mask) and the voxel coordinates
must be equal: depths are multiples of 1/4 m, focal lengths 16 and 32 px,
rotations axis permutations and translations multiples of 1/2, so every
coordinate that survives the +-8 m range filter is a multiple of 1/128 and
the FPS arithmetic is exact in both packages (three squares of at most
2048/128 each sum below 2^24 units of 2^-14). Random quarter-metre depths
keep the cloud off a lattice: on one (whole-metre depths) exact-distance
ties occur at once, and the two packages may break them differently (on
the CPU the JAX dispatcher scans in original order, the port in
cell-sorted order), after which every later row would differ. Occupancy logits within atol 2e-4 / rtol 2e-3 (fp32 sums in
another order over ~25 layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recondet3d.api.weights import _flatten
from recondet3d.models.da3 import build_da3 as j_build_da3
from recondet3d.models.detect import ReconstructionBackbone as JBackbone
from recondet3d.models.refine.refinement import SparseRefinement as JRefinement
from recondet3d_torch.api.weights import state_dict_from_flax
from recondet3d_torch.models.detect import ResDet3D, build_resdet3d
from test_torch_refinement import ATOL, RTOL, TINY, random_variables

# configs/resdet3d_tiny_test.py, the backbone part
BACKBONE = dict(process_res=56, ref_view_strategy="first", use_ray_pose=False, max_depth=20.0,
                filter_range=(-8.0, -8.0, -2.0, 8.0, 8.0, 2.0), bq_anchor_points=128, bq_max_radius=0.5,
                bq_sample_num=8, num_points=256)
B, V, H, W, h, w = 2, 2, 60, 80, 32, 48


def _inputs(seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (B, V, H, W, 3)).astype(np.float32)
    depth = (rng.integers(4, 41, (B, V, h, w)) / 4.0).astype(np.float32)
    depth[rng.random(depth.shape) < 0.1] = 0.0    # holes
    depth[rng.random(depth.shape) < 0.05] = 32.0  # beyond max_depth
    intr = np.tile(np.array([[16.0, 0, 24.0], [0, 32.0, 16.0], [0, 0, 1.0]], np.float32), (B, V, 1, 1))
    c2l = np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1))
    cam2veh = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)  # x right, y down, z forward -> x forward, y left, z up
    back = np.diag([-1.0, -1.0, 1.0]).astype(np.float32)
    c2l[:, 0, :3, :3] = cam2veh
    c2l[:, 1, :3, :3] = back @ cam2veh
    c2l[:, 0, 3, :3] = [1.0, 0.0, 0.5]
    c2l[:, 1, 3, :3] = [-1.0, 0.0, 0.5]
    return img, depth, intr, c2l


@pytest.fixture(scope="module")
def pair():
    jref = JRefinement(**TINY)
    pts0 = jnp.zeros((B, BACKBONE["num_points"], 3))
    variables = random_variables(jax.eval_shape(jref.init, jax.random.PRNGKey(0), pts0), 1)
    port = build_resdet3d("da3-small", dtype=torch.float32, device="cpu", refinement=dict(TINY), **BACKBONE)
    flat = {k.replace("/", "/reconstruction_backbone/refinement/", 1): np.asarray(v)
            for k, v in _flatten(variables).items()}
    res = port.load_state_dict(state_dict_from_flax(flat), strict=False)
    assert not res.unexpected_keys
    assert res.missing_keys and all(k.startswith("reconstruction_backbone.da3.") for k in res.missing_keys)
    return jref, variables, port


@pytest.mark.parametrize("pre_reduce", [0.0, 0.25])
def test_points_and_refinement_match_jax(pair, pre_reduce):
    jref, variables, port = pair
    img, depth, intr, c2l = _inputs(2)
    jbk = JBackbone(da3=j_build_da3("da3-small", dtype=jnp.float32, attn_impl="xla"), refinement=jref,
                    voxel_pre_reduce=pre_reduce, bq_grid_dim=16, **BACKBONE)
    jpts, jmsk = jbk.apply({}, jnp.asarray(depth), jnp.asarray(intr), jnp.asarray(img), jnp.asarray(c2l),
                           method="points_from_depth")
    _, _, jaux = jax.jit(jref.apply)(variables, jpts, jmsk)

    bk = port.reconstruction_backbone
    bk.voxel_pre_reduce, bk.bq_grid_dim = pre_reduce, 16
    tpts, tmsk = bk.points_from_depth(*(torch.from_numpy(a) for a in (depth, intr, img, c2l)))
    jmsk_np = np.asarray(jmsk)
    assert tuple(tpts.shape) == (B, 256, 3)
    np.testing.assert_array_equal(tmsk.numpy(), jmsk_np)
    np.testing.assert_array_equal(tpts.numpy()[jmsk_np], np.asarray(jpts)[jmsk_np])
    counts = {k: [int(c) for c in v] for k, v in bk.last_stage_counts.items()}
    for a, b, c in zip(counts["pre_reduce"], counts["union"], counts["final"]):
        if pre_reduce == 0.0:  # the union exceeds num_points: the last FPS chose every row
            assert a > b > c == 256 and jmsk_np.all(), counts
        else:
            assert a > b >= c == min(b, 256), counts
    if pre_reduce > 0.0:  # one scene's union stays under num_points (compaction branch), the other's exceeds it
        assert min(counts["union"]) < 256 < max(counts["union"]), counts

    with torch.no_grad():
        _, _, aux = bk.refinement(tpts, tmsk)
    np.testing.assert_array_equal(aux["pseudo_coors"].numpy(), np.asarray(jaux["pseudo_coors"]))
    logits = aux["occupancy_logits"]
    assert tuple(logits.shape) == (B, 20, 20, 8) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jaux["occupancy_logits"]), atol=ATOL, rtol=RTOL)


def test_bridge_names_a_whole_resdet3d_tree(pair):
    """DA3 leaves under ``reconstruction_backbone/da3`` and the refinement's two
    collections all land on keys of the port's state dict."""
    from recondet3d_torch.api.weights import torch_name

    keys = set(pair[2].state_dict())
    for path in ("params/reconstruction_backbone/da3/net/blocks_3/attn/qkv/kernel",
                 "params/reconstruction_backbone/refinement/middle_encoder/encoder_layer2_down/kernel",
                 "batch_stats/reconstruction_backbone/refinement/bev_height_occupancy/dec1_bn2/BatchNorm_0/var"):
        assert torch_name(path) in keys, (path, torch_name(path))


def test_simple_test_and_pipelined_step_agree(pair):
    """The entry points: ``depth_override`` drives the point path while DA3 still
    runs; the pipelined step returns what ``simple_test`` returns."""
    _, _, port = pair
    img, depth, intr, c2l = (torch.from_numpy(a) for a in _inputs(3))
    bk = port.reconstruction_backbone
    bk.voxel_pre_reduce, bk.bq_grid_dim = 0.25, 16
    out = port(img, c2l, depth_override=depth)
    assert set(out) == {"pseudo_points", "pseudo_valid", "aux"}
    assert tuple(out["pseudo_points"].shape) == (B, 256, 3) and torch.isfinite(out["pseudo_points"]).all()
    assert tuple(out["aux"]["occupancy_logits"].shape) == (B, 20, 20, 8)
    assert torch.isfinite(out["aux"]["occupancy_logits"]).all()
    assert tuple(out["aux"]["da3"]["depth"].shape) == (B, V, 42, 56)  # DA3 ran at process_res 56

    da3_depth, da3_intr, _ = bk.predict_depth(img)
    torch.testing.assert_close(da3_depth, out["aux"]["da3"]["depth"].float())
    pts, msk = bk.points_from_depth(depth, da3_intr, img, c2l)
    torch.testing.assert_close(pts, out["pseudo_points"], rtol=0, atol=0)
    (depth_t, intr_t), prev = port.pipelined_test_step(depth, da3_intr, img, img, c2l)
    torch.testing.assert_close(depth_t, da3_depth)
    torch.testing.assert_close(intr_t, da3_intr)
    torch.testing.assert_close(prev["pseudo_points"], out["pseudo_points"], rtol=0, atol=0)
    torch.testing.assert_close(prev["aux"]["occupancy_logits"], out["aux"]["occupancy_logits"])
    # without an override the predicted depth drives the points
    own = port.simple_test(img, c2l)
    assert tuple(own["pseudo_points"].shape) == (B, 256, 3)


def test_use_color_carries_rgb_through_the_pipeline():
    port = build_resdet3d("da3-small", dtype=torch.float32, device="cpu",
                          refinement=dict(TINY, use_color=True), **BACKBONE)
    img, depth, intr, c2l = _inputs(4)
    jref = JRefinement(**dict(TINY, use_color=True))
    jbk = JBackbone(da3=j_build_da3("da3-small", dtype=jnp.float32, attn_impl="xla"), refinement=jref,
                    bq_grid_dim=16, **BACKBONE)
    jpts, jmsk = jbk.apply({}, jnp.asarray(depth), jnp.asarray(intr), jnp.asarray(img), jnp.asarray(c2l),
                           method="points_from_depth")
    bk = port.reconstruction_backbone
    bk.bq_grid_dim = 16
    tpts, tmsk = bk.points_from_depth(*(torch.from_numpy(a) for a in (depth, intr, img, c2l)))
    assert tuple(tpts.shape) == (B, 256, 6)
    np.testing.assert_array_equal(tmsk.numpy(), np.asarray(jmsk))
    np.testing.assert_array_equal(tpts.numpy()[..., :3], np.asarray(jpts)[..., :3])
    # colours: bilinear resize of the image, F.interpolate vs resize_2d (fp32, values in [0, 1])
    np.testing.assert_allclose(tpts.numpy()[..., 3:], np.asarray(jpts)[..., 3:], atol=1e-5)


def test_unported_parts_raise_and_device_rule():
    # detection heads are ported (tests/test_torch_resdet3d_det.py): ResDet3D holds one as a submodule
    head = torch.nn.Identity()
    assert ResDet3D(None, pts_bbox_head=head).pts_bbox_head is head
    port = build_resdet3d("da3-small", dtype=torch.float32, device="cpu", refinement=False, **BACKBONE)
    assert port.reconstruction_backbone.refinement is None and not port.training
    img, depth, intr, c2l = (torch.from_numpy(a) for a in _inputs(5))
    # the training route is ported (tests/test_torch_resdet3d_train.py); without a refinement it has no loss
    losses, aux = port.forward_train(img, c2l, torch.zeros(B, 8, 3))
    assert losses == {} and tuple(aux["pseudo_points"].shape) == (B, 256, 3)
    assert port(img, c2l, gt_points=torch.zeros(B, 8, 3), return_loss=True)[0] == {}
    # the rematerialisation policies other than 'block' build and run (held to JAX in test_torch_remat.py)
    tuned = build_resdet3d("da3-small", dtype=torch.float32, device="cpu", refinement=False, freeze_da3=False,
                           remat_policy="dots", **BACKBONE)
    assert tuned.reconstruction_backbone.da3.backbone.pretrained.remat_policy == "dots"
    losses, aux = tuned.forward_train(img, c2l, torch.zeros(B, 8, 3))
    assert losses == {} and aux["pseudo_points"].requires_grad
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_resdet3d("da3-small")


def test_anchor_scene_matches_the_jax_benchmark_inputs():
    """The port's numpy copy of the benchmark's rig and rendered depth maps
    (``bench.py`` ``make_inputs`` geometry and ``make_anchor_depth``): equal
    arrays from the same seed."""
    import importlib.util
    import os

    from recondet3d_torch.data.anchor_scene import anchor_depth, rig_cam2lidar

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("jax_bench", os.path.join(repo, "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    c2l = rig_cam2lidar(2)
    assert c2l.shape == (2, 6, 4, 4) and c2l.dtype == np.float32
    for i, th in enumerate(bench._RIG_YAWS):
        rz = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]], np.float32)
        np.testing.assert_array_equal(c2l[1, i, :3, :3], rz @ bench._R_CAM2VEH)
        np.testing.assert_array_equal(c2l[1, i, 3, :3], np.array([np.cos(th), np.sin(th), 1.5], np.float32))
    ref = bench.make_anchor_depth(c2l, 70, 126, batch=2)
    pts = np.load(os.path.join(repo, "assets", "bench_sample", "reference_points.npz"))["points"]
    got = anchor_depth(pts, c2l, 70, 126, batch=2)
    assert got.dtype == np.float32 and 0.05 < (got > 0).mean() < 0.5
    np.testing.assert_array_equal(got, ref)
