"""Port vs JAX package for the pseudo-LiDAR point pipeline
(``data/pipelines/point_pipeline.py``) on the CPU, same numpy-seeded
inputs. Masks, selected rows and their order must be equal: coordinates
are multiples of 1/64 within +-9, so the FPS inside the stages is exact in fp32 in
both packages (see tests/test_torch_point_ops.py), and everything else is
integer work. Rows whose mask is False are not compared."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recondet3d.data.pipelines import point_pipeline as jpp
from recondet3d_torch.data.pipelines import point_pipeline as tpp

RANGE = (-8.0, -8.0, -2.0, 8.0, 8.0, 2.0)


def _cloud(n, seed, channels=3, valid_share=0.8):
    rng = np.random.default_rng(seed)
    pts = (np.round(rng.uniform(-9.0, 9.0, (n, channels)) * 64) / 64).astype(np.float32)
    pts[:, 2] = np.round(pts[:, 2] * 16) / 64  # a flat slab, still multiples of 1/64
    return pts, rng.random(n) < valid_share


def t(a):
    return torch.from_numpy(np.array(a, order="C"))


def _same(tp, tv, jp, jv):
    jp, jv = np.asarray(jp), np.asarray(jv)
    assert tuple(tp.shape) == jp.shape and tuple(tv.shape) == jv.shape
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(tp.numpy()[jv], jp[jv])
    return int(jv.sum())


def test_filter_and_compact_match_jax():
    pts, valid = _cloud(3000, 0)
    tp, tv = tpp.filter_point_by_range(t(pts), t(valid), RANGE)
    jp, jv = jpp.filter_point_by_range(jnp.asarray(pts), jnp.asarray(valid), RANGE)
    assert 0 < _same(tp, tv, jp, jv) < valid.sum()
    for out_size in (4096, 1000):  # padded passthrough and truncation
        tc, tcv = tpp.compact_points(tp, tv, out_size)
        jc, jcv = jpp.compact_points(jp, jv, out_size)
        _same(tc, tcv, jc, jcv)


@pytest.mark.parametrize("max_out,channels", [(6000, 3), (700, 6)])
def test_voxel_pre_reduce_matches_jax(max_out, channels):
    """First valid point per voxel, ascending voxel id; 700 < occupied voxels is the overflow case."""
    pts, valid = _cloud(6000, 1, channels)
    kw = dict(voxel_size=0.25, point_cloud_range=RANGE, max_out=max_out)
    tp, tv = tpp.voxel_pre_reduce(t(pts), t(valid), **kw)
    jp, jv = jpp.voxel_pre_reduce(jnp.asarray(pts), jnp.asarray(valid), **kw)
    n = _same(tp, tv, jp, jv)
    assert n == 700 if max_out == 700 else 700 < n < 6000
    # past the leaders the JAX buffer holds the other points in sorted order; the port's does too
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("share_sort,compact,anchors", [(True, True, 128), (False, True, 128), (False, False, 128),
                                                        (True, True, 1000)])
def test_ball_query_downsample_matches_jax(share_sort, compact, anchors):
    """anchors = 1000 > n_valid (of 1200 rows) is the passthrough branch."""
    pts, valid = _cloud(1200 if anchors == 1000 else 5000, 2, channels=6)
    kw = dict(anchor_points=anchors, max_radius=0.5, sample_num=8, compact=compact, grid_dim=16,
              share_sort=share_sort)
    tp, tv = tpp.ball_query_downsample(t(pts), t(valid), **kw)
    jp, jv = jpp.ball_query_downsample(jnp.asarray(pts), jnp.asarray(valid), **kw)
    n = _same(tp, tv, jp, jv)
    if anchors == 1000:
        assert n == valid.sum() < anchors
    else:
        assert anchors <= n < valid.sum()
    if share_sort:
        # the original-order-first selected point leads the spatially sorted buffer
        first = pts[np.flatnonzero(valid)[0]] if anchors == 1000 else None
        if first is not None:
            np.testing.assert_array_equal(tp.numpy()[0], first)


@pytest.mark.parametrize("num_points,presorted", [(256, False), (256, True), (1024, False)])
def test_fps_downsample_matches_jax(num_points, presorted):
    """num_points = 1024 > n_valid (about 600 of 3000 rows) is the compaction branch."""
    pts, valid = _cloud(3000, 3, channels=6, valid_share=0.8 if num_points == 256 else 0.2)
    kw = dict(num_points=num_points, input_spatially_sorted=presorted)
    tp, tv = tpp.fps_downsample(t(pts), t(valid), **kw)
    jp, jv = jpp.fps_downsample(jnp.asarray(pts), jnp.asarray(valid), **kw)
    n = _same(tp, tv, jp, jv)
    assert n == (num_points if num_points == 256 else valid.sum()) <= num_points


def test_pipeline_chain_matches_jax():
    """pre-reduce -> shared-sort ball-query union -> FPS, the order the backbone runs them in."""
    pts, valid = _cloud(8000, 4)
    tp, tv = t(pts), t(valid)
    jp, jv = jnp.asarray(pts), jnp.asarray(valid)
    counts = []
    for name, kw in (
        ("voxel_pre_reduce", dict(voxel_size=0.125, point_cloud_range=RANGE, max_out=4096)),
        ("ball_query_downsample", dict(anchor_points=256, max_radius=0.5, sample_num=8, compact=True, grid_dim=32,
                                       share_sort=True)),
        ("fps_downsample", dict(num_points=512, input_spatially_sorted=True)),
    ):
        tp, tv = getattr(tpp, name)(tp, tv, **kw)
        jp, jv = getattr(jpp, name)(jp, jv, **kw)
        counts.append(_same(tp, tv, jp, jv))
    assert counts[0] > counts[1] > counts[2] == 512


def _sorted_rows(a):
    return a[np.lexsort(a.T[::-1])]


@pytest.mark.parametrize("n,max_voxels,channels", [(3000, 4096, 3), (20000, 1500, 6)])
def test_voxel_downsample_matches_jax(n, max_voxels, channels):
    """Voxel centroids of every channel; 1,500 < occupied voxels truncates.
    The packages may order rows otherwise (ROADMAP §1), so the valid counts
    are compared exactly and the centroids sorted by coordinates, at 1e-5
    (fp32 means summed in another order). Coordinates at 0.1 m voxels,
    continuous: the port scales by the fp32 reciprocal as XLA does."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(-9.0, 9.0, (n, channels)).astype(np.float32)
    pts[:, 2] *= 0.1
    valid = rng.random(n) < 0.8
    kw = dict(voxel_size=(0.1, 0.1, 0.1), point_cloud_range=RANGE, max_voxels=max_voxels)
    tc, tv = tpp.voxel_downsample(t(pts), t(valid), **kw)
    jc, jv = jpp.voxel_downsample(jnp.asarray(pts), jnp.asarray(valid), **kw)
    tv, jv = tv.numpy(), np.asarray(jv)
    assert tc.shape == (max_voxels, channels) and tv.shape == jv.shape
    assert tv.sum() == jv.sum() == (max_voxels if max_voxels == 1500 else tv.sum()) > 0
    if max_voxels == 1500:  # appearance order: the same voxels survive the cut
        np.testing.assert_allclose(tc.numpy()[tv], np.asarray(jc)[jv], atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(_sorted_rows(tc.numpy()[tv]), _sorted_rows(np.asarray(jc)[jv]), atol=1e-5, rtol=0)


def test_point_pipeline_matches_jax():
    """All four transform types in one PointPipeline (``enabled`` ignored),
    and KeyError on an unknown type, in both packages."""
    pts, valid = _cloud(6000, 6)
    transforms = [
        dict(type="FilterPointByRange", point_cloud_range=RANGE, enabled=True),
        dict(type="VoxelDownsample", voxel_size=(0.25, 0.25, 0.25), point_cloud_range=RANGE, max_voxels=4096),
        dict(type="BallQueryDownsample", anchor_points=256, max_radius=0.5, sample_num=8, grid_dim=16),
        dict(type="FPSDownsample", num_points=512, enabled=False),
    ]
    tp, tv = tpp.PointPipeline(transforms)(t(pts), t(valid))
    jp, jv = jpp.PointPipeline(transforms)(jnp.asarray(pts), jnp.asarray(valid))
    assert _same(tp, tv, jp, jv) == 512
    for pipeline, arrays in ((tpp.PointPipeline, (t(pts), t(valid))),
                             (jpp.PointPipeline, (jnp.asarray(pts), jnp.asarray(valid)))):
        with pytest.raises(KeyError, match="Unknown"):
            pipeline([dict(type="Unknown")])(*arrays)


def test_stages_pass_small_buffers_through():
    """A buffer of at most K rows: the ball-query stage passes it through and
    the FPS stage compacts it and pads it to K rows with invalid zero rows,
    without an FPS call (the JAX package raises there: its FPS output and its
    compacted buffer differ in length)."""
    pts, valid = _cloud(100, 7)
    n = valid.sum()
    bp, bv = tpp.ball_query_downsample(t(pts), t(valid), anchor_points=100)
    np.testing.assert_array_equal(bv.numpy(), valid)
    np.testing.assert_array_equal(bp.numpy(), pts)
    bp, bv = tpp.ball_query_downsample(t(pts), t(valid), anchor_points=100, compact=True)
    assert bv[:n].all() and not bv[n:].any()
    np.testing.assert_array_equal(bp.numpy()[:n], pts[valid])
    fp, fv = tpp.fps_downsample(t(pts), t(valid), num_points=256)
    assert fp.shape == (256, 3) and fv.sum() == n
    np.testing.assert_array_equal(fp.numpy()[:n], pts[valid])
    assert not fv[n:].any() and not fp[100:].any()  # the invalid rows, then the padding
