"""Port vs JAX package for the LiDAR model zoo on the CPU in fp32: PointNet++
set abstraction and feature propagation, the SECOND trunk with its FPN neck,
the PointPillars scatter and the learned VFEs, the sparse U-Net (with its
children map), the three compositions the card runs at full width
(``chip_smoke.py`` phase 23) at cut widths, the weight bridge's round trip
on every new tree, and ``bq_selection="any"`` through the port's
``ReconstructionBackbone`` on the tiny config. Weights and batch statistics
are made with numpy (``random_variables``) and carried into the port by
``state_dict_from_flax``; every JAX model is built once per module.

Indices (FPS, ball query, voxel and children rows) must be equal: clouds
are quantised to multiples of 1/64 (exact squared distances in fp32).
Tolerances, for fp32 products and batch statistics summed in another
order: activations atol 2e-5 / rtol 1e-4 in eval mode, atol 5e-5 / rtol
1e-4 in train mode and for the new running statistics; gradients per leaf
within 1e-4 of the leaf's largest value (``assert_tree_close``). The train
steps here read at most 9e-6 absolute on the outputs and 3.2e-6 of a
leaf's largest gradient; a wrong norm form (the unbiased variance, the
masked slots left out of a PFN layer's statistics) moves them by 1e-3 or
more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recondet3d.api.weights import _flatten
from recondet3d.models.detect import ReconstructionBackbone as JBackbone
from recondet3d.models.refine import pointnet_modules as jpn
from recondet3d.models.refine import second as jsec
from recondet3d.models.refine import sparse_unet as jsu
from recondet3d.models.refine.vfe import hard_simple_vfe as j_hard_simple_vfe
from recondet3d.ops import sparse_conv as jsc
from recondet3d.ops.roiaware_pool3d import roiaware_pool3d as j_roiaware
from recondet3d.ops.voxelize import Voxelization as JVoxelization, voxel_centers as j_voxel_centers
from recondet3d_torch.api.weights import flax_from_named, state_dict_from_flax
from recondet3d_torch.models.detect import ReconstructionBackbone
from recondet3d_torch.models.refine.pointnet_modules import PointFPModule, PointSAModule, PointSAModuleMSG
from recondet3d_torch.models.refine.second import SECOND, SECONDFPN, DynamicVFE, HardVFE, PointPillarsScatter
from recondet3d_torch.models.refine.sparse_unet import SparseUNet, _children_map
from recondet3d_torch.models.refine.vfe import hard_simple_vfe
from recondet3d_torch.ops import Voxelization, dynamic_voxelize, voxel_centers
from recondet3d_torch.ops import sparse_conv as tsc
from recondet3d_torch.ops.roiaware_pool3d import roiaware_pool3d
from test_torch_refinement import random_variables
from test_torch_refinement_train import assert_tree_close
from test_torch_resdet3d import BACKBONE, _inputs

ATOL, RTOL = 2e-5, 1e-4
TRAIN_ATOL, TRAIN_RTOL, GRAD_REL = 5e-5, 1e-4, 1e-4


def t(a):
    return torch.from_numpy(np.array(a, order="C"))


def flat_of(variables):
    return {k: np.asarray(v) for k, v in _flatten(variables).items()}


def load(module, variables):
    """Flax variables -> the port module (strict), with the bridge's round trip
    checked bit for bit on the way."""
    flat = flat_of(variables)
    module.load_state_dict(state_dict_from_flax(flat), strict=True)
    back = flax_from_named(dict(module.state_dict()), flat)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    return module.eval()


def params_grads(module, flat):
    """The port's parameter gradients under the flax paths of ``params``."""
    named = {n: p.grad for n, p in module.named_parameters()}
    return flax_from_named(named, [k for k in flat if k.startswith("params/")])


def jax_params_grads(grads):
    return {"params/" + k: np.asarray(v) for k, v in _flatten(grads).items()}


def quantised_cloud(n, seed, span=4.0):
    rng = np.random.default_rng(seed)
    pts = (np.round(rng.uniform(-span, span, (n, 3)) * 64) / 64).astype(np.float32)
    pts[:, 2] *= 0.25
    return pts


# ---------------------------------------------------------------------------------------------------------------------
# PointNet++

SA_KW = dict(num_point=48, radii=(0.8, 1.6), sample_nums=(8, 12), mlp_channels=((8, 16), (8, 12)))


@pytest.fixture(scope="module")
def sa_pair():
    pts = quantised_cloud(400, 0)
    feats = np.random.default_rng(1).normal(size=(400, 5)).astype(np.float32)
    jsa = jpn.PointSAModuleMSG(**SA_KW)
    variables = random_variables(jax.eval_shape(lambda k: jsa.init(k, jnp.asarray(pts), jnp.asarray(feats)),
                                                 jax.random.PRNGKey(0)), 2)
    port = load(PointSAModuleMSG(**SA_KW, in_channels=5, device="cpu"), variables)
    return jsa, variables, port, pts, feats


def test_sa_msg_eval_matches_jax(sa_pair):
    jsa, variables, port, pts, feats = sa_pair
    valid = np.random.default_rng(3).random(400) < 0.9
    jx, jf, ji = jax.jit(jsa.apply)(variables, jnp.asarray(pts), jnp.asarray(feats), jnp.asarray(valid))
    with torch.no_grad():
        x, f, i = port(t(pts), t(feats), t(valid))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    assert f.shape == (48, 28)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=ATOL, rtol=RTOL)


def test_sa_msg_train_step_matches_jax(sa_pair):
    jsa, variables, port, pts, feats = sa_pair
    g = np.random.default_rng(4).normal(size=(48, 28)).astype(np.float32)

    def loss(params, x):
        (_, f, _), upd = jsa.apply({"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(pts), x,
                                   train=True, mutable=["batch_stats"])
        return jnp.sum(f * g), (f, upd)

    (_, (jf, jupd)), (jgp, jgx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        variables["params"], jnp.asarray(feats))
    port.train()
    port.zero_grad()
    tf = t(feats).requires_grad_()
    _, f, _ = port(t(pts), tf)
    (f * t(g)).sum().backward()
    port.eval()
    np.testing.assert_allclose(f.detach().numpy(), np.asarray(jf), atol=TRAIN_ATOL, rtol=TRAIN_RTOL)
    stats = flax_from_named(dict(port.state_dict()), [k for k in flat_of(variables) if k.startswith("batch_stats/")])
    for k, v in flat_of({"batch_stats": jupd["batch_stats"]}).items():
        np.testing.assert_allclose(stats[k], v, atol=TRAIN_ATOL, rtol=TRAIN_RTOL, err_msg=k)
    flat = flat_of(variables)
    assert_tree_close(params_grads(port, flat), jax_params_grads(jgp), rel=GRAD_REL)
    assert_tree_close({"x": tf.grad.numpy()}, {"x": np.asarray(jgx)}, rel=GRAD_REL)
    load(port, variables)  # back to the stored statistics for the other tests


def test_sa_single_and_fp_match_jax():
    pts = quantised_cloud(300, 5)
    jsa = jpn.PointSAModule.single(num_point=40, radius=1.2, sample_num=10, mlp=(8, 8))
    sv = random_variables(jax.eval_shape(lambda k: jsa.init(k, jnp.asarray(pts)), jax.random.PRNGKey(0)), 6)
    port = load(PointSAModule.single(num_point=40, radius=1.2, sample_num=10, mlp=(8, 8), device="cpu"), sv)
    assert isinstance(port, PointSAModule) and port.radii == (1.2,)
    jx, jf, ji = jax.jit(jsa.apply)(sv, jnp.asarray(pts))  # no features: the xyz offsets alone
    with torch.no_grad():
        x, f, i = port(t(pts))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=ATOL, rtol=RTOL)

    tf = np.random.default_rng(7).normal(size=(300, 4)).astype(np.float32)
    jfp = jpn.PointFPModule(mlp_channels=(16, 8))
    fv = random_variables(jax.eval_shape(lambda k: jfp.init(k, jnp.asarray(pts), jx, jnp.asarray(tf), jf),
                                          jax.random.PRNGKey(0)), 8)
    fp = load(PointFPModule((16, 8), in_channels=4 + 8, device="cpu"), fv)
    ref = jfp.apply(fv, jnp.asarray(pts), jx, jnp.asarray(tf), jf)
    with torch.no_grad():
        got = fp(t(pts), x, t(tf), f)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    fp0 = load(PointFPModule((8,), in_channels=8, device="cpu"),
               random_variables(jax.eval_shape(lambda k: jpn.PointFPModule((8,)).init(k, jnp.asarray(pts), jx, None, jf),
                                               jax.random.PRNGKey(0)), 9))
    assert fp0(t(pts), x, None, f).shape == (300, 8)


# ---------------------------------------------------------------------------------------------------------------------
# SECOND, SECONDFPN, pillars, VFEs

SECOND_KW = dict(in_channels=6, out_channels=(8, 12, 16), layer_nums=(1, 2, 1), layer_strides=(2, 2, 2))
FPN_KW = dict(in_channels=(8, 12, 16), out_channels=(6, 6, 6), upsample_strides=(1, 2, 4))


@pytest.fixture(scope="module")
def second_pair():
    x = np.random.default_rng(10).normal(size=(2, 24, 24, 6)).astype(np.float32)
    jsecond, jfpn = jsec.SECOND(**SECOND_KW), jsec.SECONDFPN(**FPN_KW)
    sv = random_variables(jax.eval_shape(lambda k: jsecond.init(k, jnp.asarray(x)), jax.random.PRNGKey(0)), 11)
    fv = random_variables(jax.eval_shape(lambda k: jfpn.init(k, jsecond.apply(sv, jnp.asarray(x))),
                                         jax.random.PRNGKey(0)), 12)
    return (jsecond, sv, load(SECOND(**SECOND_KW, device="cpu"), sv),
            jfpn, fv, load(SECONDFPN(**FPN_KW, device="cpu"), fv), x)


def test_second_fpn_eval_matches_jax_and_bridge_layouts(second_pair):
    jsecond, sv, second, jfpn, fv, fpn, x = second_pair
    jouts = jsecond.apply(sv, jnp.asarray(x))
    jup = jfpn.apply(fv, jouts)
    with torch.no_grad():
        outs = second(t(x))
        up = fpn(outs)
    for a, b in zip(outs, jouts):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=RTOL)
    assert up.shape == (2, 12, 12, 18)
    np.testing.assert_allclose(up.numpy(), np.asarray(jup), atol=ATOL, rtol=RTOL)
    # the bridge: stride-2 and stride-4 deblock kernels arrive as they are stored, the stride-1 conv in OIHW
    flat = flat_of(fv)
    sd = state_dict_from_flax(flat)
    for i in (1, 2):
        np.testing.assert_array_equal(sd[f"deblock{i}.up.weight"].numpy(), flat[f"params/deblock{i}/kernel"])
    np.testing.assert_array_equal(sd["deblock0.Conv_0.weight"].numpy(),
                                  np.transpose(flat["params/deblock0/Conv_0/kernel"], (3, 2, 0, 1)))
    assert sd["deblock0.running_var"].shape == (6,) and "deblock2.weight" in sd  # the norm's scale


def test_second_fpn_train_step_matches_jax(second_pair):
    jsecond, sv, second, jfpn, fv, fpn, x = second_pair
    g = np.random.default_rng(13).normal(size=(2, 12, 12, 18)).astype(np.float32)

    def loss(sp, fp):
        outs, su = jsecond.apply({"params": sp, "batch_stats": sv["batch_stats"]}, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
        up, fu = jfpn.apply({"params": fp, "batch_stats": fv["batch_stats"]}, outs, train=True,
                            mutable=["batch_stats"])
        return jnp.sum(up * g), (up, su, fu)

    (_, (jup, jsu_, jfu)), (jgs, jgf) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        sv["params"], fv["params"])
    second.train(), fpn.train()
    second.zero_grad(), fpn.zero_grad()
    up = fpn(second(t(x)))
    (up * t(g)).sum().backward()
    second.eval(), fpn.eval()
    np.testing.assert_allclose(up.detach().numpy(), np.asarray(jup), atol=TRAIN_ATOL, rtol=TRAIN_RTOL)
    for mod, variables, upd, grads in ((second, sv, jsu_, jgs), (fpn, fv, jfu, jgf)):
        flat = flat_of(variables)
        stats = flax_from_named(dict(mod.state_dict()), [k for k in flat if k.startswith("batch_stats/")])
        for k, v in flat_of({"batch_stats": upd["batch_stats"]}).items():
            np.testing.assert_allclose(stats[k], v, atol=TRAIN_ATOL, rtol=TRAIN_RTOL, err_msg=k)
        assert_tree_close(params_grads(mod, flat), jax_params_grads(grads), rel=GRAD_REL)
        load(mod, variables)


def test_downsampling_deblock_matches_jax():
    """A deblock of stride 1/2 (a strided conv with flax's 'SAME' padding) on
    an odd-sized map."""
    x = np.random.default_rng(14).normal(size=(1, 9, 7, 4)).astype(np.float32)
    j = jsec.SECONDFPN(in_channels=(4,), out_channels=(5,), upsample_strides=(0.5,))
    v = random_variables(jax.eval_shape(lambda k: j.init(k, (x,)), jax.random.PRNGKey(0)), 15)
    port = load(SECONDFPN(in_channels=(4,), out_channels=(5,), upsample_strides=(0.5,), device="cpu"), v)
    with torch.no_grad():
        got = port((t(x),))
    ref = j.apply(v, (jnp.asarray(x),))
    assert got.shape == ref.shape == (1, 5, 4, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


PILLAR = dict(voxel_size=(1.0, 1.0, 8.0), point_cloud_range=(-8.0, -8.0, -5.0, 8.0, 8.0, 3.0))


def pillar_inputs(seed, n=900, max_points=6, max_voxels=300):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([(np.round(rng.uniform(-7.9, 7.9, (n, 2)) * 64) / 64), rng.uniform(-4, 2, (n, 1)),
                          rng.uniform(0, 1, (n, 1))], 1).astype(np.float32)
    pts[: n // 2, :2] *= 0.3  # a dense patch: voxels that overflow max_points
    vox = JVoxelization(PILLAR["voxel_size"], PILLAR["point_cloud_range"], max_points, max_voxels)
    v, c, num, nv = vox(jnp.asarray(pts))
    coors = np.concatenate([np.where(np.asarray(c)[:, :1] >= 0, 0, -1), np.asarray(c)], 1).astype(np.int32)
    return pts, np.asarray(v), np.asarray(num), coors


@pytest.mark.parametrize("train", [False, True])
def test_hard_vfe_and_pillar_scatter_match_jax(train):
    pts, v, num, coors = pillar_inputs(16)
    assert (num == 6).any() and (num == 0).any()
    kw = dict(in_channels=4, feat_channels=(8, 8), **PILLAR)
    j = jsec.HardVFE(**kw)
    var = random_variables(jax.eval_shape(lambda k: j.init(k, v, num, coors), jax.random.PRNGKey(0)), 17)
    port = load(HardVFE(**kw, device="cpu"), var)
    g = np.random.default_rng(18).normal(size=(len(num), 8)).astype(np.float32)
    if train:
        def loss(params):
            out, upd = j.apply({"params": params, "batch_stats": var["batch_stats"]}, v, num, coors, train=True,
                               mutable=["batch_stats"])
            return jnp.sum(out * g), out
        (_, ref), jg = jax.value_and_grad(loss, has_aux=True)(var["params"])
        port.train()
        port.zero_grad()
        got = port(t(v), t(num), t(coors))
        (got * t(g)).sum().backward()
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=TRAIN_ATOL, rtol=TRAIN_RTOL)
        assert_tree_close(params_grads(port, flat_of(var)), jax_params_grads(jg), rel=GRAD_REL)
        load(port, var)
        return
    ref = j.apply(var, v, num, coors)
    with torch.no_grad():
        got = port(t(v), t(num), t(coors))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    canvas = PointPillarsScatter(8, (16, 16))(got, t(coors), 1)
    jcanvas = jsec.PointPillarsScatter(8, (16, 16))(ref, jnp.asarray(coors), 1)
    np.testing.assert_allclose(canvas.numpy(), np.asarray(jcanvas), atol=ATOL, rtol=RTOL)


def test_dynamic_vfe_matches_jax():
    pts, _, _, _ = pillar_inputs(19)
    kw = dict(in_channels=4, feat_channels=(8, 6), max_voxels=200, **PILLAR)
    coors = dynamic_voxelize(t(pts), point_cloud_range=PILLAR["point_cloud_range"],
                             voxel_size=PILLAR["voxel_size"]).numpy()
    j = jsec.DynamicVFE(**kw)
    var = random_variables(jax.eval_shape(lambda k: j.init(k, pts, coors), jax.random.PRNGKey(0)), 20)
    port = load(DynamicVFE(**kw, device="cpu"), var)
    jf, jc = j.apply(var, jnp.asarray(pts), jnp.asarray(coors))
    with torch.no_grad():
        f, c = port(t(pts), t(coors))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------------------------------------------------
# the sparse U-Net

UNET_KW = dict(in_channels=4, sparse_shape=(21, 32, 32), base_channels=8, output_channels=16,
               encoder_channels=((8,), (16, 16), (32, 32)), decoder_channels=((32, 32), (16, 16), (8, 8)),
               stage_caps=(512, 384, 256))


def unet_inputs(seed, N=512, n=400):
    rng = np.random.default_rng(seed)
    coords = np.full((N, 4), -1, np.int32)
    co = np.stack([rng.integers(0, 2, n), rng.integers(0, 21, n), rng.integers(0, 32, n), rng.integers(0, 32, n)], 1)
    _, first = np.unique(co, axis=0, return_index=True)
    co = co[np.sort(first)]
    coords[: len(co)] = co
    feats = rng.normal(size=(N, 4)).astype(np.float32)
    feats[coords[:, 0] < 0] = 0
    return feats, coords


@pytest.fixture(scope="module")
def unet_pair():
    feats, coords = unet_inputs(21)
    j = jsu.SparseUNet(**UNET_KW)
    var = random_variables(jax.eval_shape(lambda k: j.init(k, feats, coords, 2), jax.random.PRNGKey(0)), 22)
    return j, var, load(SparseUNet(**UNET_KW, device="cpu"), var), feats, coords


def test_sparse_unet_eval_matches_jax(unet_pair):
    j, var, port, feats, coords = unet_pair
    jseg, jbev = jax.jit(j.apply, static_argnums=3)(var, jnp.asarray(feats), jnp.asarray(coords), 2)
    with torch.no_grad():
        seg, bev = port(t(feats), t(coords), 2)
    assert seg.shape == (512, port.seg_channels) == jseg.shape and bev.shape[-1] == port.bev_channels
    np.testing.assert_allclose(seg.numpy(), np.asarray(jseg), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(bev.numpy(), np.asarray(jbev), atol=ATOL, rtol=RTOL)
    assert np.abs(seg.numpy()).max() > 0.1


def test_sparse_unet_train_step_matches_jax(unet_pair):
    j, var, port, feats, coords = unet_pair
    rng = np.random.default_rng(23)
    g_seg = rng.normal(size=(512, port.seg_channels)).astype(np.float32)
    jseg0, jbev0 = jax.eval_shape(lambda: j.apply(var, feats, coords, 2))
    g_bev = rng.normal(size=jbev0.shape).astype(np.float32)

    def loss(params, f):
        (seg, bev), upd = j.apply({"params": params, "batch_stats": var["batch_stats"]}, f, jnp.asarray(coords), 2,
                                  train=True, mutable=["batch_stats"])
        return jnp.sum(seg * g_seg) + jnp.sum(bev * g_bev), (seg, upd)

    (_, (jseg, jupd)), (jg, jgf) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        var["params"], jnp.asarray(feats))
    port.train()
    port.zero_grad()
    tf = t(feats).requires_grad_()
    seg, bev = port(tf, t(coords), 2)
    ((seg * t(g_seg)).sum() + (bev * t(g_bev)).sum()).backward()
    np.testing.assert_allclose(seg.detach().numpy(), np.asarray(jseg), atol=TRAIN_ATOL, rtol=TRAIN_RTOL)
    flat = flat_of(var)
    stats = flax_from_named(dict(port.state_dict()), [k for k in flat if k.startswith("batch_stats/")])
    for k, v in flat_of({"batch_stats": jupd["batch_stats"]}).items():
        np.testing.assert_allclose(stats[k], v, atol=TRAIN_ATOL, rtol=TRAIN_RTOL, err_msg=k)
    assert_tree_close(params_grads(port, flat), jax_params_grads(jg), rel=GRAD_REL)
    assert_tree_close({"f": tf.grad.numpy()}, {"f": np.asarray(jgf)}, rel=GRAD_REL)
    load(port, var)


def test_children_map_matches_jax():
    """The inverse conv's rows on a real (fine, coarse) pair: the U-Net's first downsample."""
    feats, coords = unet_inputs(24)
    grid = UNET_KW["sparse_shape"]
    fine_t = tsc.SparseTensor(t(feats), t(coords), grid, 2)
    w = np.random.default_rng(25).normal(size=(27, 4, 3)).astype(np.float32)
    coarse_t = tsc.sparse_conv_downsample(fine_t, t(w), kernel=3, stride=2, padding=1, max_out=4096)
    fine_j = jsc.SparseTensor(jnp.asarray(feats), jnp.asarray(coords), grid, 2)
    coarse_j = jsc.SparseTensor(jnp.asarray(coarse_t.features.numpy()), jnp.asarray(coarse_t.coords.numpy()),
                                coarse_t.grid, 2)
    got = _children_map(coarse_t, fine_t).numpy()
    np.testing.assert_array_equal(got, np.asarray(jsu._children_map(coarse_j, fine_j)))
    # uncapped, every fine voxel is some coarse voxel's child
    assert set(got[got < 512].tolist()) == set(np.flatnonzero(coords[:, 0] >= 0).tolist())


# ---------------------------------------------------------------------------------------------------------------------
# the card's three compositions (chip_smoke.py phase 23) at cut widths, end to end


def test_pointnet2_ssg_composition_matches_jax():
    """(a): two set abstractions and one feature propagation on a cloud with
    VoteNet's height feature."""
    pts = quantised_cloud(700, 26, span=6.0)
    height = (pts[:, 2:3] - pts[:, 2].min()).astype(np.float32)
    sa_cfg = [(96, 1.0, 12, (8, 8, 16)), (24, 2.0, 8, (16, 16, 16))]
    jmods, tmods, cin = [], [], 1
    for i, (npt, r, k, mlp) in enumerate(sa_cfg):
        jmods.append(jpn.PointSAModule.single(npt, r, k, mlp))
        tmods.append(PointSAModule.single(npt, r, k, mlp, in_channels=cin, device="cpu"))
        cin = mlp[-1]
    jfp, tfp = jpn.PointFPModule((16, 12)), PointFPModule((16, 12), in_channels=32, device="cpu")

    xyz, f, jx, jf = jnp.asarray(pts), jnp.asarray(height), [], []
    for i, m in enumerate(jmods):
        v = random_variables(jax.eval_shape(lambda k: m.init(k, xyz, f), jax.random.PRNGKey(0)), 30 + i)
        load(tmods[i], v)
        xyz, f, _ = jax.jit(m.apply)(v, xyz, f)
        jx.append(xyz), jf.append(f)
    fv = random_variables(jax.eval_shape(lambda k: jfp.init(k, jx[0], jx[1], jf[0], jf[1]), jax.random.PRNGKey(0)),
                          40)
    load(tfp, fv)
    ref = jfp.apply(fv, jx[0], jx[1], jf[0], jf[1])

    with torch.no_grad():
        x, feat, outs = t(pts), t(height), []
        for m in tmods:
            x, feat, idx = m(x, feat)
            outs.append((x, feat))
        got = tfp(outs[0][0], outs[1][0], outs[0][1], outs[1][1])
    for (a, b), xa, fa in zip(outs, jx, jf):
        np.testing.assert_array_equal(a.numpy(), np.asarray(xa))
        np.testing.assert_allclose(b.numpy(), np.asarray(fa), atol=ATOL, rtol=RTOL)
    assert got.shape == (96, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_pointpillars_composition_matches_jax():
    """(b): voxelization -> HardVFE -> pillar scatter -> SECOND -> SECONDFPN."""
    pts, _, _, _ = pillar_inputs(41, n=1200, max_points=8, max_voxels=300)
    vox_kw = dict(voxel_size=PILLAR["voxel_size"], point_cloud_range=PILLAR["point_cloud_range"], max_num_points=8,
                  max_voxels=(200, 300))
    tv, tc, tn, _ = Voxelization(**vox_kw)(t(pts), training=False)
    jv, jc, jn, _ = JVoxelization(**vox_kw)(jnp.asarray(pts), training=False)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    coors = np.concatenate([np.where(np.asarray(jc)[:, :1] >= 0, 0, -1), np.asarray(jc)], 1).astype(np.int32)
    vfe_kw = dict(in_channels=4, feat_channels=(8, 8), **PILLAR)
    sec_kw = dict(in_channels=8, out_channels=(8, 8, 16), layer_nums=(1, 1, 1), layer_strides=(2, 2, 2))
    fpn_kw = dict(in_channels=(8, 8, 16), out_channels=(8, 8, 8), upsample_strides=(1, 2, 4))
    jvfe, jsecond, jfpn = jsec.HardVFE(**vfe_kw), jsec.SECOND(**sec_kw), jsec.SECONDFPN(**fpn_kw)
    vv = random_variables(jax.eval_shape(lambda k: jvfe.init(k, jv, jn, coors), jax.random.PRNGKey(0)), 42)
    pf = jvfe.apply(vv, jv, jn, coors)
    canvas = jsec.PointPillarsScatter(8, (16, 16))(pf, jnp.asarray(coors), 1)
    sv = random_variables(jax.eval_shape(lambda k: jsecond.init(k, canvas), jax.random.PRNGKey(0)), 43)
    maps = jsecond.apply(sv, canvas)
    fv = random_variables(jax.eval_shape(lambda k: jfpn.init(k, maps), jax.random.PRNGKey(0)), 44)
    ref = jfpn.apply(fv, maps)

    vfe, second, fpn = (load(m, v) for m, v in ((HardVFE(**vfe_kw, device="cpu"), vv),
                                                (SECOND(**sec_kw, device="cpu"), sv),
                                                (SECONDFPN(**fpn_kw, device="cpu"), fv)))
    with torch.no_grad():
        got = fpn(second(PointPillarsScatter(8, (16, 16))(vfe(tv, tn, t(coors)), t(coors), 1)))
    assert got.shape == (1, 8, 8, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_part_a2_composition_matches_jax(unet_pair):
    """(c): voxelization -> HardSimpleVFE -> SparseUNet -> RoI-aware pooling
    (max and avg) of the per-voxel features at the voxel centers."""
    j, var, port, _, _ = unet_pair
    rng = np.random.default_rng(45)
    pcr, vs = (0.0, -8.0, -3.0, 16.0, 8.0, 1.0), (0.5, 0.5, 0.2)  # grid (32, 32, 20): the U-Net's (21, 32, 32)
    pts = np.concatenate([rng.uniform(0, 16, (1500, 1)), rng.uniform(-8, 8, (1500, 1)), rng.uniform(-3, 1, (1500, 1)),
                          np.zeros((1500, 1))], 1).astype(np.float32)
    vox = dict(voxel_size=vs, point_cloud_range=pcr, max_num_points=5, max_voxels=(400, 512))
    tv, tc, tn, _ = Voxelization(**vox)(t(pts), training=False)
    jv, jc, jn, _ = JVoxelization(**vox)(jnp.asarray(pts), training=False)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    coors = np.concatenate([np.where(np.asarray(jc)[:, :1] >= 0, 0, -1), np.asarray(jc)], 1).astype(np.int32)
    jseg, _ = jax.jit(j.apply, static_argnums=3)(var, j_hard_simple_vfe(jv, jn, 4), jnp.asarray(coors), 1)
    with torch.no_grad():
        seg, _ = port(hard_simple_vfe(tv, tn, 4), t(coors), 1)
    np.testing.assert_allclose(seg.numpy(), np.asarray(jseg), atol=ATOL, rtol=RTOL)
    valid = coors[:, 0] >= 0
    centers = voxel_centers(t(coors[valid, 1:]), pcr, vs)
    np.testing.assert_array_equal(centers.numpy(), np.asarray(j_voxel_centers(jnp.asarray(coors[valid, 1:]), pcr, vs)))
    rois = np.concatenate([rng.uniform(2, 14, (12, 1)), rng.uniform(-6, 6, (12, 1)), np.full((12, 1), -2.5),
                           rng.uniform(2, 5, (12, 2)), rng.uniform(1.5, 3, (12, 1)),
                           rng.uniform(-np.pi, np.pi, (12, 1))], 1).astype(np.float32)
    for mode in ("max", "avg"):
        got = roiaware_pool3d(t(rois), centers, seg[t(valid)], out_size=(6, 6, 6), mode=mode)
        ref = j_roiaware(jnp.asarray(rois), jnp.asarray(centers.numpy()), jseg[valid], out_size=(6, 6, 6), mode=mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
        assert (got.numpy() != 0).any()


# ---------------------------------------------------------------------------------------------------------------------
# bq_selection through the backbone; the card's FPS inside set abstraction


def test_backbone_bq_selection_any_matches_jax():
    """``bq_selection="any"`` on the tiny config's point path (shared sort: the
    grid route): the same points and mask as the JAX backbone, and another
    selection than 'first'."""
    _, depth, intr, c2l = _inputs(2)
    img = np.zeros((2, 2, 60, 80, 3), np.float32)
    jbk = JBackbone(da3=None, refinement=None, bq_selection="any", bq_grid_dim=16, **BACKBONE)
    jpts, jmsk = jax.jit(lambda *a: jbk.apply({}, *a, method="points_from_depth"))(
        *(jnp.asarray(a) for a in (depth, intr, img, c2l)))
    outs = {}
    for sel in ("any", "first"):  # 'first' is held to the JAX package in tests/test_torch_resdet3d.py
        bk = ReconstructionBackbone(torch.nn.Identity(), None, bq_selection=sel, bq_grid_dim=16, **BACKBONE)
        outs[sel] = bk.points_from_depth(*(t(a) for a in (depth, intr, img, c2l)))
    np.testing.assert_array_equal(outs["any"][1].numpy(), np.asarray(jmsk))
    np.testing.assert_array_equal(outs["any"][0].numpy(), np.asarray(jpts))
    assert not torch.equal(outs["any"][0], outs["first"][0])


@pytest.mark.cuda
def test_sa_module_fps_launches_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the FPS kernel is CUDA only")
    from recondet3d_torch.ops.fps import furthest_point_sample_cuda, reset_launch_counts
    from recondet3d_torch.ops.sampling import furthest_point_sample

    pts = t(quantised_cloud(5000, 50, span=20.0)).cuda()
    sa = PointSAModule.single(512, 1.0, 16, (16, 32), device="cuda").eval()
    reset_launch_counts()
    with torch.no_grad():
        x, f, idx = sa(pts)
    assert furthest_point_sample_cuda.launches == 1
    np.testing.assert_array_equal(idx.cpu().numpy(), furthest_point_sample(pts, 512, impl="plain").cpu().numpy())
    assert torch.isfinite(f).all() and f.shape == (512, 32)
