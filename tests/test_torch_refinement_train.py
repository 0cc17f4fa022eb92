"""Training path of the sparse refinement, port vs JAX package, on the CPU in
fp32: sparse-conv gradients (features and weights, submanifold and strided)
against ``jax.grad``; ``MaskedBatchNorm`` and the U-Net's batch norm in train
mode (outputs and running statistics); the soft occupancy VFE and the GT
occupancy map; ``OccupancyLoss`` (bce, focal, dice, bce_dice) with its
gradient; and the whole refinement's loss, gradient tree and new batch
statistics at the sizes of ``configs/resdet3d_tiny_test.py``. Weights go
across with ``state_dict_from_flax``, gradients and statistics come back
with ``flax_from_named``.

Tolerances. Single ops: atol 2e-5 / rtol 1e-5 to 1e-4 (fp32 sums in another
order). A gradient tree: per leaf, max |difference| <= 2e-3 of the leaf's
largest |gradient| (+ 1e-5 of the tree's largest, for leaves that are zero
up to rounding). The whole refinement in train mode is held to 5e-2 per leaf
and 1e-2 relative L2 over the tree instead: batch statistics over a few
dozen active voxels followed by ReLUs make the gradient ill-conditioned
(the JAX package's own gradients move by 0.2 % to 14 % of a leaf's largest
value when its parameters are perturbed by 1e-7 relative); the loss itself
agrees to 1e-5 relative and the new running statistics to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recondet3d.api.weights import _flatten
from recondet3d.models.losses.occupancy_loss import OccupancyLoss as JOccupancyLoss
from recondet3d.models.refine.bev_unet import BEVHeightOccupancy as JBEV
from recondet3d.models.refine.refinement import SparseRefinement as JRefinement
from recondet3d.models.refine.sparse_encoder import MaskedBatchNorm as JMaskedBN
from recondet3d.models.refine.vfe import soft_voxel_occupancy_vfe as j_soft_vfe
from recondet3d.ops import sparse_conv as jsc
from recondet3d_torch.api.weights import flax_from_named, state_dict_from_flax
from recondet3d_torch.models.losses.occupancy_loss import OccupancyLoss
from recondet3d_torch.models.refine import BEVHeightOccupancy, MaskedBatchNorm, SparseRefinement
from recondet3d_torch.models.refine.vfe import soft_voxel_occupancy_vfe
from recondet3d_torch.ops import sparse_conv as tsc
from test_torch_refinement import TINY, load_variables, random_variables, t, tiny_cloud
from test_torch_sparse_conv import _active_set, _pair

ATOL = 2e-5


def assert_tree_close(got, ref, rel=2e-3, floor=1e-5):
    """Leaf by leaf: max |got - ref| <= rel * max |ref leaf| + floor * max |ref tree|.
    The floor is for leaves whose true value is zero (a bias in front of a
    batch norm in train mode): both sides hold rounding noise there."""
    assert set(got) == set(ref), sorted(set(got) ^ set(ref))
    top = max(np.abs(np.asarray(r)).max() for r in ref.values())
    bad = []
    for k in ref:
        r, g = np.asarray(ref[k]), got[k]
        assert g.shape == r.shape, (k, g.shape, r.shape)
        if np.abs(g - r).max() > rel * np.abs(r).max() + floor * top:
            bad.append((k, float(np.abs(g - r).max()), float(np.abs(r).max())))
    assert not bad, (top, bad)


def test_subm_conv_gradients_match_jax():
    co, feats, rng = _active_set(11)
    jst, tst = _pair(co, feats)
    w = rng.normal(size=(27, 5, 7)).astype(np.float32)
    g = rng.normal(size=(len(co), 7)).astype(np.float32)
    nbr = jsc.build_neighbor_map(jst, 3)
    jdf, jdw = jax.grad(lambda f, w: jnp.sum(jsc.subm_conv_apply(f, nbr, w) * g), argnums=(0, 1))(
        jst.features, jnp.asarray(w))
    tf, tw = tst.features.clone().requires_grad_(), torch.from_numpy(w).requires_grad_()
    out = tsc.subm_conv_apply(tf, tsc.build_neighbor_map(tst, 3), tw)
    df, dw = torch.autograd.grad(out, (tf, tw), torch.from_numpy(g))
    np.testing.assert_allclose(df.numpy(), np.asarray(jdf), atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), atol=10 * ATOL, rtol=1e-5)
    # the gather-form backward equals autograd's own derivative of the gather + product
    tf2, tw2 = tst.features.clone().requires_grad_(), torch.from_numpy(w).requires_grad_()
    ref = torch.autograd.grad(tsc._gather_matmul(tf2, tsc.build_neighbor_map(tst, 3), tw2), (tf2, tw2),
                              torch.from_numpy(g))
    np.testing.assert_allclose(df.numpy(), ref[0].numpy(), atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(dw.numpy(), ref[1].numpy(), atol=10 * ATOL, rtol=1e-5)


@pytest.mark.parametrize("padding,max_out", [((1, 1, 1), 2048), ((0, 1, 1), 100)])
def test_downsample_gradients_match_jax(padding, max_out):
    """max_out = 100 is below the number of output cells: rows beyond the cap read and return nothing."""
    co, feats, rng = _active_set(12)
    jst, tst = _pair(co, feats)
    jst, tst = jsc.sort_by_column(jst), tsc.sort_by_column(tst)
    w = rng.normal(size=(27, 5, 7)).astype(np.float32)
    g = rng.normal(size=(max_out, 7)).astype(np.float32)
    kw = dict(kernel=3, stride=2, padding=padding, max_out=max_out)

    def jloss(f, w):
        out = jsc.sparse_conv_downsample(jsc.SparseTensor(f, jst.coords, jst.grid, jst.batch_size), w, None,
                                         order="col", **kw)
        return jnp.sum(out.features * g)

    jdf, jdw = jax.grad(jloss, argnums=(0, 1))(jst.features, jnp.asarray(w))
    tf, tw = tst.features.clone().requires_grad_(), torch.from_numpy(w).requires_grad_()
    out = tsc.sparse_conv_downsample(tsc.SparseTensor(tf, tst.coords, tst.grid, tst.batch_size), tw, None, **kw)
    df, dw = torch.autograd.grad(out.features, (tf, tw), torch.from_numpy(g))
    assert np.abs(np.asarray(jdf)).max() > 0
    np.testing.assert_allclose(df.numpy(), np.asarray(jdf), atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), atol=10 * ATOL, rtol=1e-5)


def test_masked_batch_norm_train_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(50, 6)).astype(np.float32) * 2 + 1
    mask = rng.random(50) < 0.8
    g = rng.normal(size=(50, 6)).astype(np.float32)
    jbn = JMaskedBN()
    init = lambda key: jbn.init(key, jnp.asarray(x), jnp.asarray(mask), False)
    variables = random_variables(jax.eval_shape(init, jax.random.PRNGKey(0)), 2)

    def jloss(params, x):
        y, mut = jbn.apply({"params": params, "batch_stats": variables["batch_stats"]}, x, jnp.asarray(mask), True,
                           mutable=["batch_stats"])
        return jnp.sum(y * g), (y, mut["batch_stats"])

    (_, (ref, jstats)), (jdp, jdx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    bn = load_variables(MaskedBatchNorm(6), variables).train()
    tx = t(x).requires_grad_()
    y = bn(tx, t(mask))
    y.backward(t(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), atol=ATOL, rtol=1e-4)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(jdp["scale"]), atol=ATOL, rtol=1e-4)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(jdp["bias"]), atol=ATOL, rtol=1e-4)
    # running statistics: 0.99 * old + 0.01 * (masked batch mean, biased variance)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(jstats["mean"]), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(jstats["var"]), atol=1e-6, rtol=1e-6)
    assert not np.allclose(bn.running_mean.numpy(), np.asarray(variables["batch_stats"]["mean"]))
    # eval mode reads the statistics and leaves them alone
    before = bn.running_mean.clone()
    bn.eval()(t(x))
    assert torch.equal(bn.running_mean, before)


def test_bev_unet_train_mode_matches_jax():
    """Batch statistics in every norm: logits, the gradient tree and the new running statistics."""
    x = np.random.default_rng(5).normal(size=(2, 20, 20, 16)).astype(np.float32)
    g = np.random.default_rng(6).normal(size=(2, 20, 20, 8)).astype(np.float32)
    kw = dict(in_channels=16, unet_channels=TINY["unet_channels"], occ_feature_shape=TINY["occ_feature_shape"])
    jnet = JBEV(**kw)
    variables = random_variables(jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.asarray(x)), 6)

    def jloss(params):
        y, mut = jnet.apply({"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
        return jnp.sum(y * g), (y, mut["batch_stats"])

    (_, (ref, jstats)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(variables["params"])
    net = load_variables(BEVHeightOccupancy(**kw), variables).train()
    y = net(t(x))
    y.backward(t(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), atol=2e-4, rtol=2e-3)
    jflat = _flatten({"params": jgrads})
    got = flax_from_named({n: p.grad for n, p in net.named_parameters()}, jflat)
    assert_tree_close(got, jflat)
    sflat = _flatten({"batch_stats": jstats})
    assert_tree_close(flax_from_named(net.state_dict(), sflat), sflat, rel=1e-4)


def test_soft_vfe_and_gt_occupancy_map_match_jax():
    pts, valid = tiny_cloud(2, 400, 21)
    jref = JRefinement(**TINY)
    ref_map = jref.apply({}, jnp.asarray(pts), jnp.asarray(valid), method="generate_gt_occupancy_map")
    port = SparseRefinement(**TINY)
    got = port.generate_gt_occupancy_map(t(pts), t(valid))
    assert tuple(got.shape) == (2, 20, 20, 8) and not got.requires_grad
    assert 50 < (np.asarray(ref_map) > 0).sum() < ref_map.size
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_map), atol=1e-6, rtol=1e-5)
    # without a mask every point counts
    np.testing.assert_allclose(port.generate_gt_occupancy_map(t(pts)).numpy(),
                               np.asarray(jref.apply({}, jnp.asarray(pts), method="generate_gt_occupancy_map")),
                               atol=1e-6, rtol=1e-5)
    rng = np.random.default_rng(22)
    vox = rng.normal(size=(30, 5, 4)).astype(np.float32)
    nums = rng.integers(0, 6, 30).astype(np.int32)
    np.testing.assert_allclose(soft_voxel_occupancy_vfe(t(vox), t(nums), 0.3, 5.0).numpy(),
                               np.asarray(j_soft_vfe(jnp.asarray(vox), jnp.asarray(nums), 0.3, 5.0)),
                               atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
@pytest.mark.parametrize("loss_type", ["bce", "focal", "dice", "bce_dice"])
def test_occupancy_loss_matches_jax(loss_type, reduction):
    rng = np.random.default_rng(30)
    logits = (3 * rng.normal(size=(2, 6, 5, 4))).astype(np.float32)
    target = (rng.random((2, 6, 5, 4)) * (rng.random((2, 6, 5, 4)) < 0.3)).astype(np.float32)
    kw = dict(loss_type=loss_type, reduction=reduction, loss_weight=10.0, channel_weights=(1.0, 0.5, 2.0, 1.5))
    jl = JOccupancyLoss(**kw)
    ref, jgrad = jax.value_and_grad(lambda x: jl(x, jnp.asarray(target)))(jnp.asarray(logits))
    tl = t(logits).requires_grad_()
    got = OccupancyLoss(**kw)(tl, t(target))
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jgrad), atol=1e-6 * (1 if reduction == "mean" else 100),
                               rtol=1e-4)
    # probabilities in, and no reduction
    prob = 1 / (1 + np.exp(-logits))
    np.testing.assert_allclose(
        OccupancyLoss(**kw)(t(prob), t(target), reduction_override="none", use_logits=False).numpy(),
        np.asarray(jl(jnp.asarray(prob), jnp.asarray(target), reduction_override="none", use_logits=False)),
        atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def refinement_pair():
    pts, valid = tiny_cloud(2, 256, 7)
    gt, gt_valid = tiny_cloud(2, 300, 8, valid_share=0.95)
    jref = JRefinement(**TINY)
    variables = random_variables(
        jax.eval_shape(jref.init, jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(valid)), 8)
    return jref, variables, (pts, valid, gt, gt_valid)


@pytest.mark.parametrize("train", [True, False])
def test_refinement_loss_and_gradient_tree_match_jax(refinement_pair, train):
    """train=True: batch statistics in all norms and new running statistics;
    train=False: the loss under running statistics, which stay as they were."""
    jref, variables, (pts, valid, gt, gt_valid) = refinement_pair

    def jloss(params, p):
        (_, losses, aux), mut = jref.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, p, jnp.asarray(valid),
            gt_points=jnp.asarray(gt), gt_valid=jnp.asarray(gt_valid), return_loss=True, train=train,
            mutable=["batch_stats"])
        return losses["loss_occupancy"], mut["batch_stats"]

    (ref, jstats), (jgrads, jdp) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        variables["params"], jnp.asarray(pts))
    port = load_variables(SparseRefinement(**TINY), variables).train(train)
    tp = t(pts).requires_grad_()
    _, losses, aux = port(tp, t(valid), gt_points=t(gt), gt_valid=t(gt_valid), return_loss=True)
    loss = losses["loss_occupancy"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    jflat = _flatten({"params": jgrads})
    got = flax_from_named({n: p.grad for n, p in port.named_parameters()}, jflat)
    assert len(got) == len(jflat) == len(list(port.parameters()))
    assert_tree_close(got, jflat, rel=5e-2 if train else 2e-3)
    err = np.sqrt(sum(np.sum((got[k] - np.asarray(jflat[k])) ** 2) for k in jflat))
    assert err <= 1e-2 * np.sqrt(sum(np.sum(np.asarray(v) ** 2) for v in jflat.values()))
    # the gradient reaches the points through the mean VFE
    assert np.abs(np.asarray(jdp)).max() > 0
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jdp),
                               atol=(5e-2 if train else 2e-3) * np.abs(np.asarray(jdp)).max(), rtol=0)
    sflat = _flatten({"batch_stats": jstats})
    assert_tree_close(flax_from_named(port.state_dict(), sflat), sflat, rel=1e-4)
    moved = not np.allclose(port.state_dict()["middle_encoder.conv_input_norm.running_mean"].numpy(),
                            np.asarray(variables["batch_stats"]["middle_encoder"]["conv_input_norm"]["mean"]))
    assert moved == train


def test_flax_from_named_inverts_state_dict_from_flax(refinement_pair):
    _, variables, _ = refinement_pair
    flat = {k: np.asarray(v) for k, v in _flatten(variables).items()}
    back = flax_from_named(state_dict_from_flax(flat), flat)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    assert flax_from_named({}, flat) == {}  # tensors that are missing (no gradient) are left out
