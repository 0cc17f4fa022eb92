"""Port vs JAX package for the LiDAR point ops, on the CPU with the same
numpy-seeded inputs: grouping and 3-NN, knn, FPS on a distance matrix,
ball query's 'any' selection and its dispatch, PAConv's score assembly,
points in boxes, RoI-aware pooling, the voxelization wrappers and the numpy
voxel generator, ``DynamicScatter``, the occupancy VFEs, and the sparse
convolution's pair form, gather form and id lookups.

Indices must be equal. Clouds are quantised to multiples of 1/64 within
+-16 (every squared distance exact in fp32, as tests/test_torch_point_ops.py
explains), and ties are either absent or placed on purpose (three_nn, knn:
both packages order equal distances by index). Features: atol 1e-5 / rtol
1e-5 for a few fp32 products or a mean; 2e-5 for the sparse convolutions
(one fp32 sum over at most 27 x Cin products taken in another order);
gradients the same bounds against ``jax.grad``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recondet3d.ops import sparse_conv as jsc
from recondet3d_torch.models.refine.vfe import (
    HardSimpleVFE,
    HardVoxelOccupancyVFE,
    SoftVoxelOccupancyVFE,
    hard_voxel_occupancy_vfe,
)
from recondet3d_torch.ops import (
    DynamicScatter,
    Voxelization,
    ball_query,
    furthest_point_sample_with_dist,
    gather_points,
    group_points,
    knn,
    three_interpolate,
    three_nn,
    voxel_centers,
)
from recondet3d_torch.ops import sparse_conv as tsc
from recondet3d_torch.ops.cell_sort import cell_sort
from recondet3d_torch.ops.paconv import assign_score_withk
from recondet3d_torch.ops.points_in_boxes import points_in_boxes, points_in_boxes_batch
from recondet3d_torch.ops.roiaware_pool3d import roiaware_pool3d
from recondet3d_torch.ops.voxelize import VoxelGenerator, voxelize
from test_torch_sparse_conv import _active_set, _pair

# the package's __init__ re-exports functions under their modules' names
j_bq, j_cs, j_grp, j_knn, j_pac, j_pib, j_roi, j_smp, j_sct, j_vox = (
    importlib.import_module(f"recondet3d.ops.{m}") for m in (
        "ball_query", "cell_sort", "grouping", "knn", "paconv", "points_in_boxes", "roiaware_pool3d", "sampling",
        "scatter", "voxelize"))
j_vfe = importlib.import_module("recondet3d.models.refine.vfe")

ATOL = 1e-5
SC_ATOL = 2e-5


def t(a):
    return torch.from_numpy(np.array(a, order="C"))


def _quantised(n, seed, span=16.0, valid_share=0.85):
    rng = np.random.default_rng(seed)
    pts = (np.round(rng.uniform(-span, span, (n, 3)) * 64) / 64).astype(np.float32)
    return pts, rng.random(n) < valid_share


def test_gather_group_and_three_interpolate_match_jax():
    rng = np.random.default_rng(0)
    f = rng.normal(size=(6, 50)).astype(np.float32)
    i1 = rng.integers(0, 50, 17)
    i2 = rng.integers(0, 50, (9, 4))
    np.testing.assert_array_equal(gather_points(t(f), t(i1)).numpy(), np.asarray(j_grp.gather_points(f, i1)))
    np.testing.assert_array_equal(group_points(t(f), t(i2)).numpy(), np.asarray(j_grp.group_points(f, i2)))
    idx = rng.integers(0, 50, (20, 3))
    w = rng.random((20, 3)).astype(np.float32)
    g = rng.normal(size=(6, 20)).astype(np.float32)
    ref = j_grp.three_interpolate(f, idx, w)
    tf, tw = t(f).requires_grad_(), t(w).requires_grad_()
    got = three_interpolate(tf, t(idx), tw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=1e-5)
    jdf, jdw = jax.grad(lambda f, w: jnp.sum(j_grp.three_interpolate(f, idx, w) * g), argnums=(0, 1))(f, w)
    df, dw = torch.autograd.grad(got, (tf, tw), t(g))
    np.testing.assert_allclose(df.numpy(), np.asarray(jdf), atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), atol=ATOL, rtol=1e-5)


def test_three_nn_matches_jax_with_a_tie():
    pts, _ = _quantised(300, 1)
    q, _ = _quantised(40, 2)
    # a deliberate tie: query 0 is equidistant from points 7 and 3 (mirror images), nearer than any other
    q[0] = (0.5, 0.5, 0.5)
    pts[7], pts[3] = (0.5, 0.5, 0.25), (0.5, 0.5, 0.75)
    d, i = three_nn(t(q), t(pts))
    jd, ji = j_grp.three_nn(jnp.asarray(q), jnp.asarray(pts))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=ATOL, rtol=1e-6)
    assert i[0, :2].tolist() == [3, 7]  # the lower index first, as top_k orders it


@pytest.mark.parametrize("k,block,chunk,valid_share", [(8, 64, 16, 0.85), (16, 40, 7, 1.0), (6, 32, 16, 0.02)])
def test_knn_matches_jax(k, block, chunk, valid_share):
    """Several point blocks and query chunks, with padding; the last case has
    fewer valid points than k (index 0 fills the rest in both packages)."""
    pts, valid = _quantised(250, 3, valid_share=valid_share)
    q, _ = _quantised(70, 4)
    q[0], pts[10], pts[20], pts[30] = (1.0, 1.0, 1.0), (1.0, 1.0, 1.5), (1.0, 1.5, 1.0), (1.5, 1.0, 1.0)  # a 3-way tie
    valid[[10, 20, 30]] = True
    ref = j_knn.knn(k, jnp.asarray(pts), jnp.asarray(q), jnp.asarray(valid), chunk=chunk, block=block)
    got = knn(k, t(pts), t(q), t(valid), chunk=chunk, block=block)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.dtype == torch.int64 and got.shape == (70, k)
    np.testing.assert_array_equal(knn(k, t(pts), t(q), t(valid)).numpy(), np.asarray(ref))  # the knobs move no index


@pytest.mark.parametrize("k", [1, 24, 60])
def test_furthest_point_sample_with_dist_matches_jax(k):
    pts, _ = _quantised(60, 5)
    d = ((pts[:, None] - pts[None]) ** 2).sum(-1).astype(np.float32)
    np.testing.assert_array_equal(furthest_point_sample_with_dist(t(d), k).numpy(),
                                  np.asarray(j_smp.furthest_point_sample_with_dist(jnp.asarray(d), k)))


def _dense_cloud(n, seed):
    """Quantised points packed densely (many in-radius neighbours) with invalid rows."""
    rng = np.random.default_rng(seed)
    pts = (np.round(rng.uniform(-4, 4, (n, 3)) * 64) / 64).astype(np.float32)
    pts[:, 2] *= 0.25
    return pts, rng.random(n) < 0.9


@pytest.mark.parametrize("route", ["scan", "grid", "structure"])
def test_ball_query_any_matches_jax(route):
    """'any' ranks sorted positions on the grid route (given impl='grid' or a
    shared structure) and falls back to 'first' on the scan route, as the
    JAX dispatch does."""
    pts, valid = _dense_cloud(3000, 6)
    rng = np.random.default_rng(7)
    centers = pts[rng.choice(np.flatnonzero(valid), 96, replace=False)]
    args = (0.0, 0.5, 8)
    kw = dict(grid_dim=16)
    if route == "structure":
        jkw = dict(kw, structure=j_cs.cell_sort(jnp.asarray(pts), jnp.asarray(valid), grid_dim=16, min_cell=0.5))
        tkw = dict(kw, structure=cell_sort(t(pts), t(valid), grid_dim=16, min_cell=0.5))
    else:
        jkw = tkw = dict(kw, impl=route)
    ref = j_bq.ball_query(*args, jnp.asarray(pts), jnp.asarray(centers), jnp.asarray(valid), selection="any", **jkw)
    got = ball_query(*args, t(pts), t(centers), t(valid), selection="any", **tkw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    first = ball_query(*args, t(pts), t(centers), t(valid), **tkw).numpy()
    if route == "scan":
        np.testing.assert_array_equal(got.numpy(), first)
    else:
        assert (got.numpy() != first).any(), "the case must tell the two selections apart"
    with pytest.raises(ValueError):
        ball_query(*args, t(pts), t(centers), t(valid), selection="nearest")


def test_ball_query_any_auto_routes_by_size():
    """impl='auto' takes the grid route from 65,536 points on: there 'any'
    holds (the centers' own grid, as the JAX package builds it)."""
    rng = np.random.default_rng(8)
    n = 65536
    pts = (np.round(rng.uniform(-16, 16, (n, 3)) * 64) / 64).astype(np.float32)
    pts[:, 2] *= 0.1
    valid = rng.random(n) < 0.9
    centers = pts[np.flatnonzero(valid)[:48]]
    ref = j_bq.ball_query(0.0, 0.6, 6, jnp.asarray(pts), jnp.asarray(centers), jnp.asarray(valid), selection="any")
    got = ball_query(0.0, 0.6, 6, t(pts), t(centers), t(valid), selection="any")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got.numpy() != ball_query(0.0, 0.6, 6, t(pts), t(centers), t(valid)).numpy()).any()


def test_assign_score_withk_matches_jax():
    rng = np.random.default_rng(9)
    N, K, M, C = 30, 5, 4, 6
    scores, pf, cf = (rng.normal(size=s).astype(np.float32) for s in ((N, K, M), (N, M, C), (N, M, C)))
    idx = rng.integers(0, N, (N, K))
    ref = j_pac.assign_score_withk(jnp.asarray(scores), jnp.asarray(pf), jnp.asarray(cf), jnp.asarray(idx))
    got = assign_score_withk(t(scores), t(pf), t(cf), t(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=1e-5)
    with pytest.raises(ValueError):
        assign_score_withk(t(scores), t(pf), t(cf), t(idx), aggregate="max")


def _boxes(m, seed, span=14.0):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-span, span, (m, 2)), rng.uniform(-3, 1, (m, 1)),
                           rng.uniform(1.0, 6.0, (m, 3)), rng.uniform(-np.pi, np.pi, (m, 1))], 1).astype(np.float32)


def test_points_in_boxes_matches_jax():
    pts, _ = _quantised(4000, 10)
    pts[:, 2] *= 0.2
    boxes = _boxes(24, 11)
    boxes[1] = boxes[0]  # overlapping boxes: the first one wins
    inside = points_in_boxes_batch(t(pts), t(boxes)).numpy()
    np.testing.assert_array_equal(inside, np.asarray(j_pib.points_in_boxes_batch(jnp.asarray(pts),
                                                                                 jnp.asarray(boxes))))
    got = points_in_boxes(t(pts), t(boxes)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_pib.points_in_boxes(jnp.asarray(pts), jnp.asarray(boxes))))
    assert (got == 0).sum() > 0 and (got == 1).sum() == 0 and (got == -1).sum() > 0 and len(set(got)) > 5


@pytest.mark.parametrize("mode", ["max", "avg"])
def test_roiaware_pool3d_matches_jax(mode, monkeypatch):
    """Several RoI groups (the pair bound lowered so that 30 RoIs take four)."""
    import recondet3d_torch.ops.roiaware_pool3d as mod

    monkeypatch.setattr(mod, "_PAIRS_PER_GROUP", 8 * 3000)
    pts, _ = _quantised(3000, 12, span=8.0)
    pts[:, 2] *= 0.25
    feats = np.random.default_rng(13).normal(size=(3000, 5)).astype(np.float32)
    rois = _boxes(30, 14, span=6.0)
    rois[:, 2] -= 1.0
    ref = j_roi.roiaware_pool3d(jnp.asarray(rois), jnp.asarray(pts), jnp.asarray(feats), out_size=(4, 3, 5),
                                mode=mode)
    got = roiaware_pool3d(t(rois), t(pts), t(feats), out_size=(4, 3, 5), mode=mode)
    assert got.shape == (30, 4, 3, 5, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=1e-5)
    assert (got.numpy() != 0).any(axis=-1).sum() > 100  # cells that pooled points


def test_voxel_wrappers_and_generator_match_jax():
    """Voxelization's train / test caps, voxel_centers, and the numpy
    VoxelGenerator against the JAX package's and against voxelize
    (tests/test_voxelize.py's two cases)."""
    pts = np.random.default_rng(15).uniform(-50, 50, (400, 4)).astype(np.float32)
    pts[:, 2] = np.clip(pts[:, 2] / 20, -4.9, 2.9)
    kw = dict(voxel_size=[0.075, 0.075, 0.2], point_cloud_range=[-54.0, -54.0, -5.0, 54.0, 54.0, 3.0],
              max_num_points=10, max_voxels=(120, 160))
    layer, jlayer = Voxelization(**kw), j_vox.Voxelization(**kw)
    assert layer.grid_size == jlayer.grid_size == (1440, 1440, 40) and repr(layer) == repr(jlayer)
    for training in (True, False):
        got, ref = layer(t(pts), training=training), jlayer(jnp.asarray(pts), training=training)
        assert got[0].shape == ((120 if training else 160), 10, 4)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    coors = got[1][: int(got[3])]
    np.testing.assert_array_equal(voxel_centers(coors, kw["point_cloud_range"], kw["voxel_size"]).numpy(),
                                  np.asarray(j_vox.voxel_centers(jnp.asarray(coors.numpy()), kw["point_cloud_range"],
                                                                 kw["voxel_size"])))

    pts = np.random.default_rng(0).uniform(-3, 3, (500, 4)).astype(np.float32)
    gkw = dict(voxel_size=(0.5, 0.5, 0.5), point_cloud_range=(-2, -2, -2, 2, 2, 2), max_num_points=5, max_voxels=128)
    v_np, c_np, n_np = VoxelGenerator(**gkw).generate(pts)
    jv, jc, jn = j_vox.VoxelGenerator(**gkw).generate(pts)
    for a, b in ((v_np, jv), (c_np, jc), (n_np, jn)):
        np.testing.assert_array_equal(a, b)
    gen = VoxelGenerator(**gkw)
    assert tuple(gen.grid_size) == (8, 8, 8) and gen.max_num_points_per_voxel == 5
    v, c, n, nv = voxelize(t(pts), point_cloud_range=(-2, -2, -2, 2, 2, 2), voxel_size=(0.5, 0.5, 0.5), max_points=5,
                           max_voxels=128)
    m = int(nv)
    assert m == len(c_np)
    np.testing.assert_array_equal(c.numpy()[:m], c_np)
    np.testing.assert_array_equal(n.numpy()[:m], n_np)
    np.testing.assert_allclose(v.numpy()[:m], v_np, atol=1e-6)


@pytest.mark.parametrize("average", [True, False])
def test_dynamic_scatter_wrapper_matches_jax(average):
    rng = np.random.default_rng(16)
    pts = rng.uniform(-8, 8, (800, 4)).astype(np.float32)
    kw = dict(voxel_size=(1.0, 1.0, 4.0), point_cloud_range=(-8, -8, -2, 8, 8, 2), average_points=average,
              max_voxels=150)
    coors = j_vox.dynamic_voxelize(jnp.asarray(pts), point_cloud_range=kw["point_cloud_range"],
                                   voxel_size=kw["voxel_size"])
    ref = j_sct.DynamicScatter(**kw)(jnp.asarray(pts), coors)
    got = DynamicScatter(**kw)(t(pts), t(coors))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=ATOL, rtol=1e-5)
    for a, b in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_occupancy_vfes_and_wrappers_match_jax():
    rng = np.random.default_rng(17)
    vox = rng.normal(size=(40, 6, 4)).astype(np.float32)
    num = rng.integers(0, 7, 40).astype(np.int32)
    vox[np.arange(6)[None] >= num[:, None]] = 0
    np.testing.assert_array_equal(hard_voxel_occupancy_vfe(t(vox), t(num)).numpy(),
                                  np.asarray(j_vfe.hard_voxel_occupancy_vfe(vox, num)))
    for port, ref in ((HardSimpleVFE(4), j_vfe.HardSimpleVFE(4)), (HardVoxelOccupancyVFE(), j_vfe.HardVoxelOccupancyVFE()),
                      (SoftVoxelOccupancyVFE(0.2, 4.0), j_vfe.SoftVoxelOccupancyVFE(0.2, 4.0))):
        np.testing.assert_allclose(port(t(vox), t(num)).numpy(), np.asarray(ref(jnp.asarray(vox), jnp.asarray(num))),
                                   atol=1e-6, rtol=1e-5)
    from recondet3d_torch.core.registry import VOXEL_ENCODERS

    assert VOXEL_ENCODERS.get("HardVoxelOccupancyVFE") is HardVoxelOccupancyVFE


def test_subm_conv_pair_form_matches_full_and_jax():
    """The pair form against the full form and JAX's pair form, forward and
    gradients (features and weights) against ``jax.grad``."""
    co, feats, rng = _active_set(21)
    jst, tst = _pair(co, feats)
    w = rng.normal(size=(27, 5, 7)).astype(np.float32)
    b = rng.normal(size=(7,)).astype(np.float32)
    g = rng.normal(size=(len(co), 7)).astype(np.float32)
    g[co[:, 0] < 0] = 0
    nbr = jsc.build_neighbor_map(jst, 3)
    tnbr = tsc.build_neighbor_map(tst, 3)
    f = lambda form: lambda x, w: jnp.sum(jsc.subm_conv_apply(x, nbr, w, jnp.asarray(b), form=form) * g)
    jout = jax.jit(lambda x, w: jsc.subm_conv_apply(x, nbr, w, jnp.asarray(b), form="pair"))(jst.features,
                                                                                           jnp.asarray(w))
    jdf, jdw = jax.jit(jax.grad(f("pair"), argnums=(0, 1)))(jst.features, jnp.asarray(w))
    tf, tw = tst.features.clone().requires_grad_(), t(w).requires_grad_()
    out = tsc.subm_conv_apply(tf, tnbr, tw, t(b), form="pair")
    df, dw = torch.autograd.grad(out, (tf, tw), t(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=SC_ATOL, rtol=1e-5)
    np.testing.assert_allclose(df.numpy(), np.asarray(jdf), atol=SC_ATOL, rtol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), atol=10 * SC_ATOL, rtol=1e-5)
    # the full form gives the same values and gradients
    tf2, tw2 = tst.features.clone().requires_grad_(), t(w).requires_grad_()
    full = tsc.subm_conv_apply(tf2, tnbr, tw2, t(b))
    df2, dw2 = torch.autograd.grad(full, (tf2, tw2), t(g))
    np.testing.assert_allclose(out.detach().numpy(), full.detach().numpy(), atol=SC_ATOL, rtol=1e-5)
    np.testing.assert_allclose(df.numpy(), df2.numpy(), atol=SC_ATOL, rtol=1e-5)
    np.testing.assert_allclose(dw.numpy(), dw2.numpy(), atol=10 * SC_ATOL, rtol=1e-5)
    with pytest.raises(ValueError):
        tsc.subm_conv_apply(tst.features, tnbr, t(w), form="half")


def test_gathered_conv_and_lookups_match_jax():
    """The gather form on an asymmetric map (with its autograd gradient
    against ``jax.grad``), and the id lookups the sparse U-Net uses."""
    co, feats, rng = _active_set(22)
    n = len(co)
    gmap = rng.integers(0, n + 1, (90, 27))
    w = rng.normal(size=(27, 5, 4)).astype(np.float32)
    g = rng.normal(size=(90, 4)).astype(np.float32)
    jconv = lambda x, w: jsc.gathered_conv_apply(x, jnp.asarray(gmap), w)
    jout = jax.jit(jconv)(jnp.asarray(feats), jnp.asarray(w))
    jgrads = jax.jit(jax.grad(lambda x, w: jnp.sum(jconv(x, w) * g), argnums=(0, 1)))(jnp.asarray(feats),
                                                                                       jnp.asarray(w))
    tf, tw = t(feats).requires_grad_(), t(w).requires_grad_()
    out = tsc.gathered_conv_apply(tf, t(gmap), tw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=SC_ATOL, rtol=1e-5)
    for a, b in zip(torch.autograd.grad(out, (tf, tw), t(g)), jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=10 * SC_ATOL, rtol=1e-5)

    grid, bsz = (8, 20, 20), 2
    ids_j = jsc._linear_ids(jnp.asarray(co), grid, bsz)
    ids_t = tsc._linear_ids(t(co), grid, bsz)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    sentinel = bsz * 8 * 20 * 20
    q = np.concatenate([np.asarray(ids_j)[rng.permutation(n)[:200]], rng.integers(0, sentinel, 300),
                        np.full(10, sentinel)]).astype(np.int32)
    ref = np.asarray(jsc._lookup_rows(ids_j, jnp.asarray(q), jnp.int32(sentinel)))
    np.testing.assert_array_equal(ref, np.asarray(jsc._dense_lookup_rows(ids_j, jnp.asarray(q), jnp.int32(sentinel),
                                                                         sentinel)))
    np.testing.assert_array_equal(tsc._lookup_rows(ids_t, t(q).long(), sentinel).numpy(), ref)
    assert (ref < n).sum() >= 200 and (ref == n).sum() >= 10
