"""``ResDet3D.forward_train``, port vs JAX package, on the shapes of
``configs/resdet3d_tiny_test.py`` (CPU, fp32), frozen and unfrozen: the
losses, and the gradient tree against ``jax.grad`` leaf by leaf, the patch
embedding, the position embedding, a local and a global block's qkv, a
head convolution and a refinement convolution among them. The DA3 net is an
any-view net with a four-block, 128-wide trunk (two heads of 64; blocks 0-2
local, block 3 global with QK-norm and RoPE): ``jax.grad`` of the whole
model then compiles in ~20 s. Weights are made with numpy and carried into
the port by ``state_dict_from_flax``; gradients come back with
``flax_from_named``.

``forward_train`` takes no depth override, so the cloud comes from DA3's own
depth and every selection of the point path (range filter, ball query, FPS,
voxelization) is made on floats that differ by rounding between the two
packages. The seeds below give clouds on which both make the same
selections (the valid masks are compared), so the gradients are those of
the same function.

Tolerance: per leaf, max |difference| <= 2e-3 of the leaf's largest
|gradient| + 1e-5 of the tree's largest (fp32 through ~40 layers); losses
rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recondet3d.api.weights import _flatten
from recondet3d.models.da3 import vit as jvit
from recondet3d.models.da3.presets import _anyview as j_anyview
from recondet3d.models.detect import ReconstructionBackbone as JBackbone, ResDet3D as JResDet3D
from recondet3d.models.refine.refinement import SparseRefinement as JRefinement
from recondet3d_torch.api.weights import flax_from_named, state_dict_from_flax
from recondet3d_torch.models.da3 import vit as tvit
from recondet3d_torch.models.da3.presets import _anyview
from recondet3d_torch.models.detect import ReconstructionBackbone, ResDet3D, build_resdet3d
from recondet3d_torch.models.refine.refinement import SparseRefinement
from test_torch_refinement import TINY
from test_torch_refinement_train import assert_tree_close
from test_torch_resdet3d import BACKBONE, _inputs
from test_torch_weights import random_flax_params

VIT = dict(embed_dim=128, depth=4, num_heads=2)
NET = dict(out_layers=(0, 1, 2, 3), alt_start=2, head_dim_in=256, features=32, out_channels=(16, 32, 64, 64),
           cam_dim=128)
DA3 = "params/reconstruction_backbone/da3/"
REFINE = "params/reconstruction_backbone/refinement/"
# leaves the gradient must reach when DA3 is not frozen
NAMED_LEAVES = [
    DA3 + "net/patch_embed/proj/kernel",
    DA3 + "net/pos_embed",
    DA3 + "net/blocks_1/attn/qkv/kernel",  # a local block
    DA3 + "net/blocks_3/attn/qkv/kernel",  # the global block
    DA3 + "head/refinenet1/out_conv/kernel",
    REFINE + "middle_encoder/encoder_layer1_block0/conv1/kernel",
]


def build_pair(freeze_da3, remat=False, port_only=False):
    """(JAX ResDet3D, port ResDet3D) over the cut-depth any-view net and the tiny refinement."""
    jvit.VIT_PRESETS["vit-test"] = VIT
    tvit.VIT_PRESETS["vit-test"] = VIT
    tda3 = _anyview("vit-test", dtype=torch.float32, device="cpu", remat=remat, **NET)
    tmodel = ResDet3D(ReconstructionBackbone(da3=tda3, refinement=SparseRefinement(**TINY), freeze_da3=freeze_da3,
                                             bq_grid_dim=16, **BACKBONE))
    if port_only:
        return None, tmodel
    jda3 = j_anyview("vit-test", dtype=jnp.float32, attn_impl="xla", remat=remat, **NET)
    jmodel = JResDet3D(reconstruction_backbone=JBackbone(
        da3=jda3, refinement=JRefinement(**TINY), freeze_da3=freeze_da3, bq_grid_dim=16, **BACKBONE))
    return jmodel, tmodel


def make_batch(seed):
    img, _, _, c2l = _inputs(seed)
    rng = np.random.default_rng(seed)
    gt = (rng.uniform(-1, 1, (img.shape[0], 300, 3)) * np.array([7.5, 7.5, 1.9])).astype(np.float32)
    return dict(img=img, cam2lidar_rts=c2l, gt_points=gt)


def random_model_variables(jmodel, batch, seed):
    """Numpy-made ``params`` and ``batch_stats`` for the JAX model (running variances in [0.5, 1.5])."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    abstract = jax.eval_shape(lambda r: jmodel.init(r, return_loss=True, train=False, **jb), jax.random.PRNGKey(0))
    variables = random_flax_params(abstract, seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: 0.5 + np.abs(x) % 1.0 if str(p[-1].key) == "var" else x, variables)


def load_model_variables(tmodel, variables):
    """Into the port. Its camera encoder has no counterpart in a flax tree
    initialised without poses and keeps its own values: nothing here runs it."""
    flat = {k: np.asarray(v) for k, v in _flatten(variables).items()}
    res = tmodel.load_state_dict(state_dict_from_flax(flat), strict=False)
    assert not res.unexpected_keys and all(".cam_enc." in k for k in res.missing_keys), res
    return tmodel


def jax_loss_and_grads(jmodel, variables, batch, train=True):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        (losses, aux), mut = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                          return_loss=True, train=train, mutable=["batch_stats"], **jb)
        return sum(losses.values()), (losses, aux["pseudo_valid"], mut["batch_stats"])

    (total, (losses, valid, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return float(total), {k: float(v) for k, v in losses.items()}, np.asarray(valid), stats, _flatten({"params": grads})


def port_loss_and_grads(tmodel, batch):
    tmodel.train()
    for p in tmodel.parameters():
        p.grad = None
    losses, aux = tmodel(return_loss=True, **{k: torch.from_numpy(v) for k, v in batch.items()})
    total = sum(losses.values())
    total.backward()
    return total.item(), losses, aux, {n: p.grad for n, p in tmodel.named_parameters()}


@pytest.fixture(scope="module")
def unfrozen():
    batch = make_batch(2)
    jmodel, tmodel = build_pair(freeze_da3=False)
    variables = random_model_variables(jmodel, batch, 1)
    return jmodel, load_model_variables(tmodel, variables), variables, batch


def test_forward_train_unfrozen_matches_jax(unfrozen):
    jmodel, tmodel, variables, batch = unfrozen
    jtotal, jlosses, jvalid, _, jflat = jax_loss_and_grads(jmodel, variables, batch)
    total, losses, aux, grads = port_loss_and_grads(tmodel, batch)
    assert set(losses) == set(jlosses) == {"reconstruction_loss_occupancy"}
    np.testing.assert_array_equal(aux["pseudo_valid"].numpy(), jvalid)  # the same selections in both packages
    np.testing.assert_allclose(total, jtotal, rtol=1e-5)
    assert {"pseudo_points", "pseudo_valid", "da3", "occupancy_logits", "gt_occupancy_map"} <= set(aux)
    got = flax_from_named(grads, jflat)
    # what the port leaves without a gradient is what JAX gives an exact zero: the DualDPT ray branch, unused
    # when a camera decoder gives the pose
    for k in set(jflat) - set(got):
        assert "_aux" in k and not np.asarray(jflat[k]).any(), k
    jflat = {k: v for k, v in jflat.items() if k in got}
    for k in NAMED_LEAVES:
        assert np.abs(np.asarray(jflat[k])).max() > 1e-6 and np.abs(got[k]).max() > 1e-6, k
    assert_tree_close(got, jflat)


def test_forward_train_frozen_matches_jax(unfrozen):
    """The same weights and batch with ``freeze_da3=True`` in both packages."""
    _, _, variables, batch = unfrozen
    jmodel, tmodel = build_pair(freeze_da3=True)
    load_model_variables(tmodel, variables)
    jtotal, _, jvalid, jstats, jflat = jax_loss_and_grads(jmodel, variables, batch)
    total, _, aux, grads = port_loss_and_grads(tmodel, batch)
    np.testing.assert_array_equal(aux["pseudo_valid"].numpy(), jvalid)
    np.testing.assert_allclose(total, jtotal, rtol=1e-5)
    # stop_gradient on the DA3 outputs: zeros in the JAX tree, no gradient at all in the port
    for k, v in jflat.items():
        if k.startswith(DA3):
            assert not np.asarray(v).any(), k
    assert all(g is None for n, g in grads.items() if ".da3." in n)
    assert not aux["da3"]["depth"].requires_grad
    refine = {k: v for k, v in jflat.items() if k.startswith(REFINE)}
    got = flax_from_named(grads, refine)
    assert len(got) == len(refine)
    assert_tree_close(got, refine, rel=5e-2)  # batch statistics in train mode: see test_torch_refinement_train.py
    sflat = _flatten({"batch_stats": jstats})
    assert_tree_close(flax_from_named(tmodel.state_dict(), sflat), sflat, rel=1e-4)


def test_eval_mode_loss_matches_jax(unfrozen):
    """train=False: running statistics in the norms, the DA3 gradient still flows."""
    jmodel, tmodel, variables, batch = unfrozen
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jlosses, _ = jax.jit(lambda v: jmodel.apply(v, return_loss=True, train=False, **jb))(variables)
    load_model_variables(tmodel, variables).eval()  # a train-mode forward of another test moved the statistics
    losses, _ = tmodel.forward_train(**{k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(losses["reconstruction_loss_occupancy"].item(),
                               float(jlosses["reconstruction_loss_occupancy"]), rtol=1e-5)
    assert losses["reconstruction_loss_occupancy"].requires_grad


def test_checkpointed_and_plain_forward_give_the_same_gradients(unfrozen):
    _, tmodel, _, batch = unfrozen
    _, remat_model = build_pair(freeze_da3=False, remat=True, port_only=True)
    remat_model.load_state_dict(tmodel.state_dict())
    assert all(m.remat for m in remat_model.modules() if isinstance(m, tvit.DinoViT))
    total, _, _, grads = port_loss_and_grads(tmodel, batch)
    total_r, _, _, grads_r = port_loss_and_grads(remat_model, batch)
    assert total == total_r
    for (n, a), b in zip(grads.items(), grads_r.values()):
        assert (a is None) == (b is None), n
        if a is not None:  # the recomputed block repeats the same CPU arithmetic
            torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-9, msg=n)


def test_eval_step_eval_uses_the_new_position_embedding(unfrozen):
    """The resized position embedding is kept between graph-free forwards;
    an optimizer step (in place on the parameter) must not leave the old
    one in use, nor must a state dict loaded over the model."""
    from recondet3d_torch.train import Trainer

    _, src, _, batch = unfrozen
    _, tmodel = build_pair(freeze_da3=False, port_only=True)
    tmodel.load_state_dict(src.state_dict())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    vit = tmodel.reconstruction_backbone.da3.backbone.pretrained

    def eval_depth():
        tmodel.eval()
        return tmodel.simple_test(tb["img"], tb["cam2lidar_rts"])["aux"]["da3"]["depth"].clone()

    d0 = eval_depth()
    assert len(vit._pe_cache) == 1 and torch.equal(eval_depth(), d0)  # kept, and used again
    pe0 = vit.pos_embed.detach().clone()
    trainer = Trainer(model=tmodel, total_steps=10, lr=1e-2, frozen_patterns=())
    state, history = trainer.run(trainer.init_state(), [tb], max_steps=1)
    assert state.step == 1 and np.isfinite(history[0]["loss"]) and history[0]["grad_norm"] > 0
    assert not torch.equal(vit.pos_embed.detach(), pe0)
    d1 = eval_depth()
    vit._pe_cache.clear()
    assert torch.equal(eval_depth(), d1)  # the kept copy after the step is the one a fresh resize gives
    assert not torch.equal(d1, d0)
    # a state dict loaded over the model drops the kept copy as well
    eval_depth()
    tmodel.load_state_dict(src.state_dict())
    assert len(vit._pe_cache) == 0 and torch.equal(eval_depth(), d0)
    # a forward under inference mode, then a training step: nothing made there enters the graph
    with torch.inference_mode():
        tmodel.simple_test(tb["img"], tb["cam2lidar_rts"])
    total, _, _, grads = port_loss_and_grads(tmodel, batch)
    assert np.isfinite(total) and grads["reconstruction_backbone.da3.backbone.pretrained.pos_embed"] is not None


def test_fine_tune_build_holds_fp32_master_parameters():
    """``freeze_da3=False``: fp32 parameters computing in bf16, blocks under
    checkpointing; the default build keeps bf16 parameters, no checkpointing."""
    kw = dict(dtype=torch.bfloat16, device="cpu", refinement=dict(TINY), **BACKBONE)
    tuned = build_resdet3d("da3-small", freeze_da3=False, **kw)
    plain = build_resdet3d("da3-small", **kw)
    tv, pv = (m.reconstruction_backbone.da3.backbone.pretrained for m in (tuned, plain))
    assert tv.remat and not pv.remat
    assert not tuned.reconstruction_backbone.freeze_da3 and plain.reconstruction_backbone.freeze_da3
    assert {p.dtype for p in tv.parameters()} == {torch.float32}
    assert pv.blocks[0].attn.qkv.weight.dtype == torch.bfloat16 and pv.cls_token.dtype == torch.bfloat16
    assert tv.blocks[0].attn.qkv.compute_dtype == torch.bfloat16
    batch = make_batch(6)
    total, _, _, grads = port_loss_and_grads(tuned, batch)
    assert np.isfinite(total)
    g = grads["reconstruction_backbone.da3.backbone.pretrained.blocks.5.attn.qkv.weight"]
    assert g.dtype == torch.float32 and torch.isfinite(g).all() and g.abs().max() > 0


def test_colorize_gt_points_matches_jax():
    """First visible camera wins, zeros where none sees the point or the point is invalid."""
    rng = np.random.default_rng(9)
    B, V, H, W, M = 2, 3, 12, 16, 200
    img = rng.uniform(0, 255, (B, V, H, W, 3)).astype(np.float32)
    gt = rng.uniform(-6, 6, (B, M, 3)).astype(np.float32)
    gt_valid = rng.random((B, M)) < 0.9
    K = np.array([[10.0, 0, 8.0, 0], [0, 10.0, 6.0, 0], [0, 0, 1.0, 0], [0, 0, 0, 1.0]], np.float32)
    lidar2img = np.zeros((B, V, 4, 4), np.float32)
    for v, (axis, sign) in enumerate([(0, 1.0), (0, -1.0), (1, 1.0)]):  # cameras looking along +x, -x, +y
        ext = np.eye(4, dtype=np.float32)
        ext[:3, :3] = 0
        ext[2, axis] = sign
        ext[0, (axis + 1) % 3] = 1.0
        ext[1, (axis + 2) % 3] = 1.0
        lidar2img[:, v] = K @ ext
    jmodel, tmodel = build_pair(freeze_da3=True)
    ref = jmodel.reconstruction_backbone.apply(
        {}, jnp.asarray(gt), jnp.asarray(gt_valid), jnp.asarray(img), jnp.asarray(lidar2img),
        method="colorize_gt_points")
    got = tmodel.reconstruction_backbone.colorize_gt_points(*(torch.from_numpy(a) for a in (gt, gt_valid, img, lidar2img)))
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape == (B, M, 6)
    coloured = (ref[..., 3:] > 0).any(-1)
    assert 20 < coloured.sum() < B * M - 20  # some points are seen, some are not
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    got_all = tmodel.reconstruction_backbone.colorize_gt_points(
        torch.from_numpy(gt), None, torch.from_numpy(img), torch.from_numpy(lidar2img))
    ref_all = jmodel.reconstruction_backbone.apply(
        {}, jnp.asarray(gt), None, jnp.asarray(img), jnp.asarray(lidar2img), method="colorize_gt_points")
    np.testing.assert_allclose(got_all.numpy(), np.asarray(ref_all), atol=1e-6)
