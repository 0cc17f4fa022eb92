"""Port vs JAX package for the sparse refinement's inference path on the CPU
in fp32 (its training path: tests/test_torch_refinement_train.py): VFE,
``MaskedBatchNorm`` (running statistics), ``SparseEncoder`` (through the
dense BEV map, so row order does not matter), the BEV U-Net with both
values of ``bug_compatible_relu_logits``, ``batch_voxelize`` and the whole
``SparseRefinement`` at the sizes of ``configs/resdet3d_tiny_test.py``.
Weights and batch statistics are made with numpy and carried into the port
by ``state_dict_from_flax`` (``params`` and ``batch_stats``).

Tolerance: atol 2e-4, rtol 2e-3 on fp32 activations of size ~1 after ~25
layers of convolutions summed in another order; integer outputs equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recondet3d.api.weights import _flatten
from recondet3d.models.refine.bev_unet import BEVHeightOccupancy as JBEV
from recondet3d.models.refine.refinement import SparseRefinement as JRefinement, batch_voxelize as j_batch_voxelize
from recondet3d.models.refine.sparse_encoder import MaskedBatchNorm as JMaskedBN, SparseEncoder as JEncoder
from recondet3d.models.refine.vfe import hard_simple_vfe as j_vfe
from recondet3d_torch.api.weights import state_dict_from_flax
from recondet3d_torch.models.refine import (
    BEVHeightOccupancy,
    MaskedBatchNorm,
    SparseEncoder,
    SparseRefinement,
    batch_voxelize,
    hard_simple_vfe,
)
from recondet3d_torch.models.refine.vfe import soft_voxel_occupancy_vfe

ATOL, RTOL = 2e-4, 2e-3
# configs/resdet3d_tiny_test.py, the refinement part
TINY = dict(point_cloud_range=(-8.0, -8.0, -2.0, 8.0, 8.0, 2.0), voxel_size=(0.1, 0.1, 0.1), max_voxels=1024,
            occ_max_voxels=512, occ_feature_shape=(20, 20, 8), sparse_shape=(40, 160, 160),
            unet_channels=(32, 48, 64, 96), stage_caps=(1024, 512, 384, 256), encoder_out_channels=16)


def random_variables(abstract, seed):
    """Fill a flax variable tree (``params`` and ``batch_stats``) of
    ``jax.ShapeDtypeStruct`` leaves with fp32 numpy values: kernels
    N(0, 1/fan_in), scales near 1, variances in [0.5, 1.5], small means and
    biases."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name, shape = str(path[-1].key), tuple(x.shape)
        z = rng.standard_normal(shape).astype(np.float32)
        if name == "kernel":
            return (z / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.1 * z
        if name == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return 0.1 * z

    return jax.tree_util.tree_map_with_path(leaf, abstract)


def load_variables(module, variables):
    """Flax variables -> the port module through the weight bridge (strict)."""
    flat = {k: np.asarray(v) for k, v in _flatten(variables).items()}
    module.load_state_dict(state_dict_from_flax(flat), strict=True)
    return module.eval()


def tiny_cloud(B, n, seed, valid_share=0.9):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.0, 1.0, (B, n, 3)).astype(np.float32) * np.array([7.5, 7.5, 1.9], np.float32)
    # a dense patch, so that strided convs find neighbours and voxels hold several points
    pts[:, : n // 2] = pts[:, : n // 2] * np.array([0.15, 0.15, 0.3], np.float32)
    return pts, rng.random((B, n)) < valid_share


def t(a):
    return torch.from_numpy(np.array(a, order="C"))


def test_hard_simple_vfe_and_batch_voxelize_match_jax():
    pts, valid = tiny_cloud(2, 600, 0)
    kw = dict(point_cloud_range=TINY["point_cloud_range"], voxel_size=(0.4, 0.4, 0.4), max_points=3, max_voxels=256)
    jv, jc, jn = j_batch_voxelize(jnp.asarray(pts), jnp.asarray(valid), **kw)
    tv, tc, tn = batch_voxelize(t(pts), t(valid), **kw)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert (np.asarray(jc)[:256, 0] == 0).sum() > 50 and (np.asarray(jc)[256:, 0] == 1).sum() > 50
    np.testing.assert_allclose(hard_simple_vfe(tv, tn).numpy(), np.asarray(j_vfe(jv, jn)), atol=1e-6, rtol=1e-6)


def test_masked_batch_norm_eval_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(50, 6)).astype(np.float32)
    mask = rng.random(50) < 0.8
    jbn = JMaskedBN()
    init = lambda key: jbn.init(key, jnp.asarray(x), jnp.asarray(mask), False)
    variables = random_variables(jax.eval_shape(init, jax.random.PRNGKey(0)), 2)
    ref = jbn.apply(variables, jnp.asarray(x), jnp.asarray(mask), False)
    bn = load_variables(MaskedBatchNorm(6), variables)
    np.testing.assert_allclose(bn(t(x)).detach().numpy(), np.asarray(ref), atol=1e-6, rtol=1e-5)
    assert bn(t(x).to(torch.bfloat16)).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="validity mask"):  # batch statistics need the mask of the rows
        bn.train()(t(x))


@pytest.mark.parametrize("caps", [(1024, 512, 384, 256), (1024, 200, 100, 60)])
def test_sparse_encoder_matches_jax(caps):
    """Second case: every stage cap below its active count (the lowest (b, y, x, z) ids are kept)."""
    pts, valid = tiny_cloud(2, 700, 3)
    kw = dict(point_cloud_range=TINY["point_cloud_range"], voxel_size=TINY["voxel_size"], max_points=5,
              max_voxels=512)
    jv, jc, jn = j_batch_voxelize(jnp.asarray(pts), jnp.asarray(valid), **kw)
    feats = j_vfe(jv, jn)
    enc_kw = dict(in_channels=3, sparse_shape=TINY["sparse_shape"], output_channels=16, stage_caps=caps)
    jenc = JEncoder(**enc_kw)
    variables = random_variables(jax.eval_shape(lambda key: jenc.init(key, feats, jc, 2), jax.random.PRNGKey(0)), 4)
    ref = np.asarray(jax.jit(jenc.apply, static_argnums=(3,))(variables, feats, jc, 2))
    enc = load_variables(SparseEncoder(**enc_kw), variables)
    with torch.no_grad():
        got = enc(t(np.asarray(feats)), t(np.asarray(jc)), 2).numpy()
    assert got.shape == ref.shape == (2, 20, 20, 16) and enc.bev_channels == 16
    assert (np.abs(ref).sum(-1) > 0).sum() > 20
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("bug_compatible", [False, True])
def test_bev_unet_matches_jax(bug_compatible):
    x = np.random.default_rng(5).normal(size=(2, 20, 20, 16)).astype(np.float32)
    kw = dict(in_channels=16, unet_channels=TINY["unet_channels"], occ_feature_shape=TINY["occ_feature_shape"],
              bug_compatible_relu_logits=bug_compatible)
    jnet = JBEV(**kw)
    variables = random_variables(jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.asarray(x)), 6)
    ref = np.asarray(jax.jit(jnet.apply)(variables, jnp.asarray(x)))
    net = load_variables(BEVHeightOccupancy(**kw), variables)
    with torch.no_grad():
        got = net(t(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (2, 20, 20, 8)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)
    assert (ref.min() >= 0) == bug_compatible  # the reference quirk: ReLU'd logits


def test_sparse_refinement_matches_jax_and_bridge_carries_batch_stats():
    pts, valid = tiny_cloud(2, 256, 7)
    jref = JRefinement(**TINY)
    variables = random_variables(
        jax.eval_shape(jref.init, jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(valid)), 8)
    flat = _flatten(variables)
    assert any(k.startswith("batch_stats/") for k in flat) and any(k.startswith("params/") for k in flat)
    _, _, jaux = jax.jit(jref.apply)(variables, jnp.asarray(pts), jnp.asarray(valid))

    ref = load_variables(SparseRefinement(**TINY), variables)
    sd = ref.state_dict()
    assert len(sd) == len(flat)
    np.testing.assert_array_equal(
        sd["middle_encoder.conv_input_norm.running_var"].numpy(),
        np.asarray(variables["batch_stats"]["middle_encoder"]["conv_input_norm"]["var"]))
    np.testing.assert_array_equal(
        sd["bev_height_occupancy.enc1_conv1.weight"].numpy(),
        np.transpose(np.asarray(variables["params"]["bev_height_occupancy"]["enc1_conv1"]["kernel"]), (3, 2, 0, 1)))
    with torch.no_grad():
        out_pts, losses, aux = ref(t(pts), t(valid))
    assert out_pts.shape == (2, 256, 3) and losses == {}
    np.testing.assert_array_equal(aux["pseudo_coors"].numpy(), np.asarray(jaux["pseudo_coors"]))
    np.testing.assert_allclose(aux["bev_features"].numpy(), np.asarray(jaux["bev_features"]), atol=ATOL, rtol=RTOL)
    logits = aux["occupancy_logits"]
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (2, 20, 20, 8)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jaux["occupancy_logits"]), atol=ATOL, rtol=RTOL)


def test_training_parts_raise_naming_the_roadmap_item():
    """The training parts of the refinement are ported and answer; what is
    still to port of training raises naming its ROADMAP item."""
    ref = SparseRefinement(**TINY).eval()
    pts, valid = tiny_cloud(1, 64, 9)
    _, losses, aux = ref(t(pts), t(valid), gt_points=t(pts))
    assert losses == {} and tuple(aux["gt_occupancy_map"].shape) == (1, 20, 20, 8)
    _, losses, _ = ref(t(pts), t(valid), gt_points=t(pts), return_loss=True)
    assert set(losses) == {"loss_occupancy"} and losses["loss_occupancy"].requires_grad
    assert tuple(ref.generate_gt_occupancy_map(t(pts)).shape) == (1, 20, 20, 8)
    assert tuple(soft_voxel_occupancy_vfe(torch.zeros(4, 3, 3), torch.tensor([0, 1, 2, 3])).shape) == (4, 1)
    from recondet3d_torch.models.da3 import build_da3
    from recondet3d_torch.models.losses.occupancy_loss import OccupancyLoss

    assert OccupancyLoss().loss_type == "bce"
    with pytest.raises(ValueError):
        OccupancyLoss(loss_type="hinge")
    for policy in ("dots", "global", "attn"):  # the policies build and run (held to JAX in test_torch_remat.py)
        vit = build_da3("da3-small", device="cpu", remat=True, remat_policy=policy).backbone.pretrained
        feats, _ = vit(torch.zeros(1, 2, 28, 28, 3))
        sum(f.float().square().sum() for pair in feats for f in pair).backward()
        assert vit.remat_policy == policy and vit.blocks[-1].attn.qkv.weight.grad is not None
