"""Port vs JAX package for the sparse convolution ops on the CPU, same
numpy-seeded active sets. Neighbour maps and output coordinates must be
equal (both packages rank strided-conv outputs by ascending (b, y, x, z)
id); features within 2e-5: one fp32 sum over at most 27 x Cin products
taken in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recondet3d.ops import sparse_conv as jsc
from recondet3d_torch.ops import sparse_conv as tsc

B, GRID = 2, (8, 20, 20)
ATOL = 2e-5


def _active_set(seed, n=600, n_pad=40, channels=5):
    rng = np.random.default_rng(seed)
    co = np.stack([rng.integers(0, B, n), rng.integers(0, GRID[0], n), rng.integers(0, GRID[1], n),
                   rng.integers(0, GRID[2], n)], 1)
    _, first = np.unique(co, axis=0, return_index=True)
    co = np.concatenate([co[np.sort(first)], -np.ones((n_pad, 4), np.int64)]).astype(np.int32)
    rng.shuffle(co)
    feats = rng.normal(size=(len(co), channels)).astype(np.float32)
    feats[co[:, 0] < 0] = 0
    return co, feats, rng


def _pair(co, feats):
    return (jsc.SparseTensor(jnp.asarray(feats), jnp.asarray(co), GRID, B),
            tsc.SparseTensor(torch.from_numpy(feats.copy()), torch.from_numpy(co.copy()), GRID, B))


def test_sort_by_column_and_neighbor_map_match_jax():
    co, feats, _ = _active_set(0)
    jst, tst = _pair(co, feats)
    np.testing.assert_array_equal(tsc.build_neighbor_map(tst, 3).numpy(), np.asarray(jsc.build_neighbor_map(jst, 3)))
    jcol, tcol = jsc.sort_by_column(jst), tsc.sort_by_column(tst)
    np.testing.assert_array_equal(tcol.coords.numpy(), np.asarray(jcol.coords))
    np.testing.assert_array_equal(tcol.features.numpy(), np.asarray(jcol.features))
    nbr = tsc.build_neighbor_map(tcol, 3).numpy()
    np.testing.assert_array_equal(nbr, np.asarray(jsc.build_neighbor_map(jcol, 3, order="col")))
    n = len(co)
    assert (nbr[co[np.argsort(np.asarray(jsc._yxz_ids(jnp.asarray(co), GRID, B)))][:, 0] < 0] == n).all()
    assert 0 < (nbr < n).sum() < nbr.size


@pytest.mark.parametrize("with_bias", [False, True])
def test_subm_conv_matches_jax(with_bias):
    co, feats, rng = _active_set(1)
    jst, tst = _pair(co, feats)
    w = rng.normal(size=(27, 5, 7)).astype(np.float32)
    b = rng.normal(size=(7,)).astype(np.float32) if with_bias else None
    nbr = jsc.build_neighbor_map(jst, 3)
    ref = jsc.subm_conv_apply(jst.features, nbr, jnp.asarray(w), None if b is None else jnp.asarray(b))
    got = tsc.subm_conv_apply(tst.features, tsc.build_neighbor_map(tst, 3), torch.from_numpy(w),
                              None if b is None else torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("padding,max_out", [((1, 1, 1), 2048), ((0, 1, 1), 100), ((0, 0, 0), 2048)])
def test_downsample_and_dense_bev_match_jax(padding, max_out):
    """k3/s2 downsample (max_out = 100 < output cells: the overflow case), then the
    depth-collapsing (3,1,1)/(2,1,1) conv and the dense BEV fold."""
    co, feats, rng = _active_set(2)
    jst, tst = _pair(co, feats)
    jst, tst = jsc.sort_by_column(jst), tsc.sort_by_column(tst)
    w = rng.normal(size=(27, 5, 7)).astype(np.float32)
    jo = jsc.sparse_conv_downsample(jst, jnp.asarray(w), None, kernel=3, stride=2, padding=padding,
                                    max_out=max_out, order="col")
    to = tsc.sparse_conv_downsample(tst, torch.from_numpy(w), None, kernel=3, stride=2, padding=padding,
                                    max_out=max_out)
    assert to.grid == jo.grid
    np.testing.assert_array_equal(to.coords.numpy(), np.asarray(jo.coords))
    np.testing.assert_allclose(to.features.numpy(), np.asarray(jo.features), atol=ATOL, rtol=1e-5)
    n_out = int(to.valid.sum())
    assert n_out == 100 if max_out == 100 else 100 < n_out < max_out
    # the generic (unsorted-input) ranking of the JAX package gives the same rows
    ja = jsc.sparse_conv_downsample(jsc.SparseTensor(*_pair(co, feats)[0]), jnp.asarray(w), None, kernel=3, stride=2,
                                    padding=padding, max_out=max_out)
    np.testing.assert_array_equal(to.coords.numpy(), np.asarray(ja.coords))

    w2 = rng.normal(size=(3, 7, 4)).astype(np.float32)
    kw = dict(kernel=(3, 1, 1), stride=(2, 1, 1), padding=0, max_out=512)
    jo2 = jsc.sparse_conv_downsample(jo, jnp.asarray(w2), None, order="col", **kw)
    to2 = tsc.sparse_conv_downsample(to, torch.from_numpy(w2), None, **kw)
    np.testing.assert_array_equal(to2.coords.numpy(), np.asarray(jo2.coords))
    dense = tsc.to_dense_bev(to2)
    ref = np.asarray(jsc.to_dense_bev(jo2))
    assert tuple(dense.shape) == ref.shape == (B, to2.grid[1], to2.grid[2], 4 * to2.grid[0])
    np.testing.assert_allclose(dense.numpy(), ref, atol=5 * ATOL, rtol=1e-5)
    assert np.abs(ref).max() > 0


def test_sparse_tensor_from_voxels_and_bf16_matmul():
    """bf16 features multiply bf16-cast weights, as the JAX package's dtype argument does."""
    co, feats, rng = _active_set(3)
    st = tsc.sparse_tensor_from_voxels(torch.from_numpy(feats).to(torch.bfloat16), torch.from_numpy(co).long(), GRID, B)
    assert st.coords.dtype == torch.int32 and st.grid == GRID and int(st.valid.sum()) == (co[:, 0] >= 0).sum()
    w = torch.from_numpy(rng.normal(size=(27, 5, 3)).astype(np.float32))
    out = tsc.subm_conv_apply(st.features, tsc.build_neighbor_map(st, 3), w)
    ref = tsc.subm_conv_apply(st.features.float(), tsc.build_neighbor_map(st, 3), w.to(torch.bfloat16).float())
    assert out.dtype == torch.bfloat16
    # bf16 keeps 8 bits: relative 2^-8 per product, sums of up to 135 terms of size ~1
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=0.1, rtol=2e-2)
