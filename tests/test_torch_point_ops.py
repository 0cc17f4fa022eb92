"""Port vs JAX package for the point ops: voxelize, dynamic scatter, cell
sort, ball query and furthest-point sampling, on the CPU with the same
numpy-seeded inputs.

Integer outputs (voxel coords, slots, sort permutations, ball-query
indices) must be equal; float outputs within 1e-6 (a mean over at most a
few points). FPS is chaotic (one different pick changes all later ones),
so its inputs are quantised to multiples of 1/64 within +-16: every
squared distance is then exact in fp32 (three squares of at most 2048/64
each sum below 2^24 units of 2^-12) and rounding cannot differ between
XLA and torch. Against ``furthest_point_sample_xla`` (same tie rule: first
maximum) the sequences must be equal; against the Pallas kernel in
interpret mode, whose exact-distance ties may break differently, a replay
validator checks that each sequence is a furthest-point selection, and the
sequences must be equal whenever the replay met no tie.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recondet3d.ops.fps_pallas import furthest_point_sample_pallas
from recondet3d_torch.ops.ball_query import ball_query
from recondet3d_torch.ops.cell_sort import cell_sort
from recondet3d_torch.ops.sampling import furthest_point_sample, furthest_point_sample_plain
from recondet3d_torch.ops.scatter import dynamic_scatter
from recondet3d_torch.ops.voxelize import compute_grid_size, dynamic_voxelize, voxelize

# the package's __init__ re-exports functions under their modules' names
j_bq, j_cs, j_fps, j_scatter, j_vox = (importlib.import_module(f"recondet3d.ops.{m}")
                                       for m in ("ball_query", "cell_sort", "sampling", "scatter", "voxelize"))

PCR = (-8.0, -8.0, -2.0, 8.0, 8.0, 2.0)
VS = (0.5, 0.5, 0.5)


def _cloud(n, seed, span=9.0, valid_share=0.8):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-span, span, (n, 4)).astype(np.float32)
    pts[:, 2] *= 0.25
    return pts, rng.random(n) < valid_share


def _quantised(n, seed, span=16.0, valid_share=0.85):
    rng = np.random.default_rng(seed)
    pts = (np.round(rng.uniform(-span, span, (n, 3)) * 64) / 64).astype(np.float32)
    return pts, rng.random(n) < valid_share


def t(a):
    return torch.from_numpy(np.array(a, order="C"))


@pytest.mark.parametrize("use_mask,max_points,max_voxels", [(False, 4, 4096), (True, 4, 4096), (True, 2, 300)])
def test_voxelize_matches_jax(use_mask, max_points, max_voxels):
    """Appearance order, per-voxel cap and the max_voxels overflow (300 < occupied voxels)."""
    pts, valid = _cloud(5000, 0)
    kw = dict(point_cloud_range=PCR, voxel_size=VS, max_points=max_points, max_voxels=max_voxels)
    jv, jc, jn, jnum = j_vox.voxelize(jnp.asarray(pts), jnp.asarray(valid) if use_mask else None, **kw)
    tv, tc, tn, tnum = voxelize(t(pts), t(valid) if use_mask else None, **kw)
    if max_voxels == 300:
        assert int(jnum) == 300  # the overflow branch is what runs
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert int(tnum) == int(jnum)
    assert compute_grid_size(PCR, VS) == j_vox.compute_grid_size(PCR, VS)


def test_dynamic_voxelize_matches_jax():
    pts, _ = _cloud(3000, 1)
    pts[5] = np.nan
    got = dynamic_voxelize(t(pts), point_cloud_range=PCR, voxel_size=VS)
    ref = j_vox.dynamic_voxelize(jnp.asarray(pts), point_cloud_range=PCR, voxel_size=VS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("reduce,max_voxels", [("mean", 4096), ("max", 4096), ("sum", 200)])
def test_dynamic_scatter_matches_jax(reduce, max_voxels):
    pts, _ = _cloud(3000, 2)
    grid = compute_grid_size(PCR, VS)
    coors = j_vox.dynamic_voxelize(jnp.asarray(pts), point_cloud_range=PCR, voxel_size=VS)
    jf, jc, jp2v, jn = j_scatter.dynamic_scatter(jnp.asarray(pts), coors, grid=grid, max_voxels=max_voxels,
                                                 reduce=reduce)
    tf, tc, tp2v, tn = dynamic_scatter(t(pts), t(np.asarray(coors)), grid=grid, max_voxels=max_voxels, reduce=reduce)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tp2v.numpy(), np.asarray(jp2v))
    assert int(tn) == int(jn)
    # sums of a few fp32 values taken in another order
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("use_mask", [False, True])
def test_cell_sort_matches_jax(use_mask):
    pts, valid = _cloud(4000, 3)
    jcs = j_cs.cell_sort(jnp.asarray(pts), jnp.asarray(valid) if use_mask else None, grid_dim=16, min_cell=0.5)
    tcs = cell_sort(t(pts), t(valid) if use_mask else None, grid_dim=16, min_cell=0.5)
    assert tcs.grid_dim == jcs.grid_dim == 16 and tcs.min_cell == 0.5
    for name in ("sorig", "scell", "cell_start", "sval", "spts"):
        np.testing.assert_array_equal(getattr(tcs, name).numpy(), np.asarray(getattr(jcs, name)), err_msg=name)
    np.testing.assert_allclose(tcs.lo.numpy(), np.asarray(jcs.lo), rtol=1e-6)
    np.testing.assert_allclose(tcs.cell.numpy(), np.asarray(jcs.cell), rtol=1e-6)


def test_ball_query_always_checks_min_cell():
    """The JAX check is lost under jit; the port's holds everywhere."""
    pts, valid = _cloud(500, 4)
    cs = cell_sort(t(pts), t(valid), grid_dim=8, min_cell=0.25)
    with pytest.raises(ValueError, match="min_cell"):
        ball_query(0.0, 0.5, 4, t(pts[:, :3]), t(pts[:10, :3]), t(valid), structure=cs)


@pytest.mark.parametrize("impl,min_radius,shared", [("scan", 0.0, False), ("grid", 0.0, True), ("scan", 0.3, True)])
def test_ball_query_matches_jax(impl, min_radius, shared):
    pts, valid = _cloud(6000, 5)
    xyz = pts[:, :3].copy()
    centers = xyz[np.flatnonzero(valid)[:400]].copy()
    centers[-1] = [100.0, 100.0, 100.0]  # no neighbour: a row of zeros
    ref = np.asarray(j_bq.ball_query(min_radius, 1.0, 8, jnp.asarray(xyz), jnp.asarray(centers), jnp.asarray(valid),
                                     impl=impl))
    structure = cell_sort(t(xyz), t(valid), grid_dim=16, min_cell=1.0) if shared else None
    got = ball_query(min_radius, 1.0, 8, t(xyz), t(centers), t(valid), grid_dim=16, structure=structure, chunk=96)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref[-1] == 0).all() and (ref[:-1].max(axis=1) > 0).all()


def validate_fps_sequence(points, valid_mask, idx):
    """Replay an index sequence and raise ``AssertionError`` unless it is a
    furthest-point selection of (points, valid_mask): the first pick is the
    first valid point, and every later pick attains the running maximum of
    the min-distances (float64 on exact inputs). Any tie-break passes and
    nothing else does."""
    pts = points[:, :3].double()
    valid = valid_mask.bool() if valid_mask is not None else torch.ones(pts.shape[0], dtype=torch.bool)
    pts = torch.where(valid[:, None], pts, torch.zeros_like(pts))
    idx = idx.long()
    first = int(torch.argmax(valid.to(torch.uint8)))
    assert int(idx[0]) == first, f"first pick {int(idx[0])} is not the first valid point {first}"
    min_dist = torch.where(valid, 1e10, float("-inf")).double()
    for i in range(1, idx.shape[0]):
        min_dist = torch.minimum(min_dist, ((pts - pts[idx[i - 1]]) ** 2).sum(-1))
        got, best = float(min_dist[idx[i]]), float(min_dist.max())
        assert got == best, f"pick {i} (index {int(idx[i])}) has min-distance {got}, the maximum is {best}"


def _replay_ties(pts, valid, idx):
    """Number of steps of the replay at which the maximum was not unique."""
    p = np.where(valid[:, None], pts, 0).astype(np.float64)
    md = np.where(valid, 1e10, -np.inf)
    ties = 0
    for i in range(1, len(idx)):
        md = np.minimum(md, ((p - p[idx[i - 1]]) ** 2).sum(-1))
        ties += int((md == md.max()).sum() > 1)
    return ties


@pytest.mark.parametrize("case", ["unmasked", "masked", "fewer_valid_than_k"])
def test_fps_plain_matches_jax(case):
    n, k = 2048, 96
    pts, valid = _quantised(n, 6)
    if case == "unmasked":
        valid = None
    elif case == "fewer_valid_than_k":
        valid = np.zeros(n, bool)
        valid[np.random.default_rng(7).choice(n, 40, replace=False)] = True
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else t(valid)
    got = furthest_point_sample(t(pts), k, tv).numpy()
    np.testing.assert_array_equal(got, furthest_point_sample_plain(t(pts), k, tv).numpy())
    ref_xla = np.asarray(j_fps.furthest_point_sample_xla(jnp.asarray(pts), k, jv))
    np.testing.assert_array_equal(got, ref_xla)  # same tie rule, exact arithmetic

    vmask = np.ones(n, bool) if valid is None else valid
    if case != "fewer_valid_than_k":
        ref_pallas = np.asarray(furthest_point_sample_pallas(jnp.asarray(pts), k, jv, interpret=True))
        validate_fps_sequence(t(pts), tv, t(ref_pallas))
        validate_fps_sequence(t(pts), tv, t(got))
        if _replay_ties(pts, vmask, got) == 0:
            np.testing.assert_array_equal(got, ref_pallas)
    else:
        # once the 40 valid points are used up every min-distance is 0 or -inf: still never an invalid pick
        assert vmask[got].all() and len(set(got[:40].tolist())) == 40


def test_fps_presorted_maps_back_through_sorig():
    pts, valid = _quantised(3000, 8)
    cs = cell_sort(t(pts), t(valid), grid_dim=8, min_cell=0.5)
    got = furthest_point_sample(t(pts), 64, t(valid), presorted=cs).numpy()
    bare = furthest_point_sample(t(pts), 64, t(valid), presorted=(cs.spts, cs.sval, cs.sorig)).numpy()
    np.testing.assert_array_equal(got, bare)
    assert got[0] == np.flatnonzero(valid)[0]
    validate_fps_sequence(t(pts), t(valid), t(got))
    jcs = j_cs.cell_sort(jnp.asarray(pts), jnp.asarray(valid), grid_dim=8, min_cell=0.5)
    ref = np.asarray(furthest_point_sample_pallas(jnp.asarray(pts), 64, jnp.asarray(valid), interpret=True,
                                                  presorted=jcs))
    validate_fps_sequence(t(pts), t(valid), t(ref))
    if _replay_ties(pts, valid, got) == 0:
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="presorted rows"):
        furthest_point_sample(t(pts[:100]), 8, None, presorted=cs)


def test_fps_validator_rejects_a_wrong_sequence():
    pts, valid = _quantised(500, 9)
    idx = furthest_point_sample_plain(t(pts), 20, t(valid))
    validate_fps_sequence(t(pts), t(valid), idx)
    bad = idx.clone()
    bad[7] = idx[15]
    with pytest.raises(AssertionError):
        validate_fps_sequence(t(pts), t(valid), bad)
    with pytest.raises(ValueError, match="unknown FPS impl"):
        furthest_point_sample(t(pts), 4, None, impl="pallas")
