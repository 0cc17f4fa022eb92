"""Port vs JAX package: ``resize_2d``, the ViT ``Block`` and ``DinoViT``,
fp32 on the CPU with shared numpy-made weights (tolerance 2e-4 / 2e-3, the
fp32 bar of tests/test_da3_parity.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recondet3d.models.da3.layers import Block as JBlock, rope_tables as j_rope_tables
from recondet3d.models.da3.vit import DinoViT as JDinoViT
from recondet3d.utils.interpolation import resize_2d as j_resize_2d
from recondet3d_torch.models.da3.layers import Block, rope_2d, rope_tables
from recondet3d_torch.models.da3.vit import DinoViT
from recondet3d_torch.utils.interpolation import resize_2d
from test_torch_weights import load_into_port, random_flax_params, to_np

ATOL, RTOL = 2e-4, 2e-3


@pytest.mark.parametrize(
    "hw,size,mode,align_corners,scale",
    [
        ((900, 160), (283, 50), "bilinear", False, None),
        ((9, 7), (20, 15), "bilinear", False, None),
        ((12, 13), (29, 31), "bilinear", True, None),
        ((37, 37), (2, 3), "bicubic", False, ((2 + 0.1) / 37, (3 + 0.1) / 37)),
        ((37, 37), (20, 36), "bicubic", False, ((20 + 0.1) / 37, (36 + 0.1) / 37)),
        ((283, 50), (280, 50), "area", False, None),
        ((17, 23), (5, 7), "area", False, None),
    ],
)
def test_resize_2d_matches_jax(hw, size, mode, align_corners, scale):
    x = np.random.default_rng(0).normal(size=(2, *hw, 3)).astype(np.float32)
    ref = np.asarray(j_resize_2d(jnp.asarray(x), size, mode=mode, align_corners=align_corners, scale=scale))
    got = to_np(resize_2d(torch.from_numpy(x), size, mode=mode, align_corners=align_corners, scale=scale))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def test_rope_closed_form_matches_tables():
    rng = np.random.default_rng(1)
    tok = torch.from_numpy(rng.normal(size=(2, 3, 7, 16)).astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, 9, size=(2, 7, 2)))
    cos, sin = rope_tables(pos, 16)
    from recondet3d_torch.models.da3.layers import apply_rope_tables

    torch.testing.assert_close(rope_2d(tok, pos), apply_rope_tables(tok, cos[:, None], sin[:, None]))
    jc, js = j_rope_tables(jnp.asarray(pos.numpy()), 16)
    np.testing.assert_allclose(to_np(cos), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(to_np(sin), np.asarray(js), atol=1e-6)


@pytest.mark.parametrize(
    "ffn,qk_norm,rope",
    [("mlp", False, None), ("swiglufused", True, "tables"), ("mlp", True, "pos")],
)
def test_block_matches_jax(ffn, qk_norm, rope):
    B, N, C, H = 2, 10, 64, 2
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    pos = rng.integers(0, 5, size=(B, N, 2)).astype(np.int32)
    jblk = JBlock(num_heads=H, ffn_layer=ffn, qk_norm=qk_norm, use_rope=rope is not None, attn_impl="xla")
    kwargs = {}
    tkwargs = {}
    if rope == "tables":
        tabs = j_rope_tables(jnp.asarray(pos), C // H)
        kwargs["rope_tabs"] = tuple(t[:, None] for t in tabs)
        ttabs = rope_tables(torch.from_numpy(pos), C // H)
        tkwargs["rope_tabs"] = tuple(t[:, None] for t in ttabs)
    elif rope == "pos":
        kwargs["pos"] = jnp.asarray(pos)
        tkwargs["pos"] = torch.from_numpy(pos)
    abstract = jax.eval_shape(jblk.init, jax.random.PRNGKey(0), jnp.asarray(x), **kwargs)
    params = random_flax_params(abstract, seed=3)
    ref = np.asarray(jax.jit(lambda p, x: jblk.apply(p, x, **kwargs))(params, jnp.asarray(x)))

    blk = Block(C, H, ffn_layer=ffn, qk_norm=qk_norm, use_rope=rope is not None, device="cpu")
    load_into_port(blk, params)
    with torch.no_grad():
        got = to_np(blk(torch.from_numpy(x), **tkwargs))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


VIT_KW = dict(name_preset="vits", out_layers=(5, 7, 9, 11), alt_start=4, qknorm_start=4, rope_start=4,
              cat_token=True)


@pytest.fixture(scope="module")
def vit_pair():
    jnet = JDinoViT(dtype=jnp.float32, attn_impl="xla", **VIT_KW)
    abstract = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros((1, 2, 28, 28, 3)))
    params = random_flax_params(abstract, seed=4)
    tnet = load_into_port(DinoViT(dtype=torch.float32, device="cpu", **VIT_KW), params)
    return jnet, params, tnet


@pytest.mark.parametrize("S,hw", [(2, (28, 28)), (2, (56, 42)), (6, (28, 28))])
def test_dinovit_matches_jax(vit_pair, S, hw):
    """S=6 runs reference-view selection with the reorder / restore path."""
    jnet, params, tnet = vit_pair
    x = np.random.default_rng(5 + S).normal(size=(1, S, *hw, 3)).astype(np.float32)
    jfeats, jaux = jax.jit(lambda p, x: jnet.apply(p, x, export_feat_layers=(11,)))(params, jnp.asarray(x))
    with torch.no_grad():
        tfeats, taux = tnet(torch.from_numpy(x), export_feat_layers=(11,))
    assert len(tfeats) == len(jfeats) == 4
    for i, ((t_tok, t_cam), (j_tok, j_cam)) in enumerate(zip(tfeats, jfeats)):
        np.testing.assert_allclose(to_np(t_tok), np.asarray(j_tok), atol=ATOL, rtol=RTOL, err_msg=f"layer {i}")
        np.testing.assert_allclose(to_np(t_cam), np.asarray(j_cam), atol=ATOL, rtol=RTOL, err_msg=f"cam {i}")
    np.testing.assert_allclose(to_np(taux[0]), np.asarray(jaux[0]), atol=ATOL, rtol=RTOL)
