"""The four rematerialization policies of the DA3 trunk (``remat_policy``
``block``, ``global``, ``attn``, ``dots``), port vs JAX package on the CPU.

A ``DinoViT("vits")`` with ``alt_start=2, rope_start=2`` (blocks 3, 5, 7, 9
and 11 global) on three 56x56 views, the shapes of the JAX package's own
policy test (tests/test_training.py ``test_remat_policies_equivalent``).
Weights are made with numpy and carried into the port; the loss is the sum
of squares of every returned feature. Per policy:

- the port's loss and gradients against ``jax.value_and_grad`` of the JAX
  model built with the same policy: loss rtol 1e-5, gradients leaf by leaf
  max |difference| <= 2e-3 of the leaf's largest |gradient| + 1e-5 of the
  tree's (fp32 through twelve blocks and the LayerNorms);
- against the port without rematerialization: loss and gradients
  bit-identical (a recomputed forward is the same arithmetic on the CPU);
- the attention forwards one backward runs again: every block's under
  ``block``, ``attn`` and ``dots``, only the global blocks' under ``global``.

The build functions take the four names and refuse any other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recondet3d.api.weights import _flatten
from recondet3d.models.da3.vit import DinoViT as JDinoViT
from recondet3d_torch.api.weights import flax_from_named
from recondet3d_torch.models.da3 import build_da3
from recondet3d_torch.models.da3.vit import REMAT_POLICIES, DinoViT
from recondet3d_torch.models.detect import build_resdet3d
from recondet3d_torch.ops import attention as port_attention
from test_torch_refinement_train import assert_tree_close
from test_torch_weights import load_into_port, random_flax_params

KW = dict(name_preset="vits", out_layers=(3, 5, 11), alt_start=2, rope_start=2)
X = np.random.default_rng(0).uniform(0, 1, (1, 3, 56, 56, 3)).astype(np.float32)
GLOBAL_BLOCKS = [i for i in range(12) if i >= 2 and i % 2 == 1]


@pytest.fixture(scope="module")
def params():
    abstract = jax.eval_shape(JDinoViT(attn_impl="xla", **KW).init, jax.random.PRNGKey(0), jnp.asarray(X))
    return random_flax_params(abstract, seed=3)


def _feature_loss(feats):
    return sum((t.float() ** 2).sum() for pair in feats for t in pair)


def port_loss_and_grads(params, remat, policy="block"):
    """Loss, gradients by name, and the attention forwards the backward ran."""
    model = load_into_port(DinoViT(dtype=torch.float32, device="cpu", remat=remat, remat_policy=policy, **KW),
                           params)
    feats, _ = model(torch.from_numpy(X))
    loss = _feature_loss(feats)
    calls = []
    fwd = port_attention.attention_fwd

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return fwd(*args, **kwargs)

    port_attention.attention_fwd = counted
    try:
        loss.backward()
    finally:
        port_attention.attention_fwd = fwd
    return loss.item(), {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None}, calls


@pytest.fixture(scope="module")
def plain(params):
    return port_loss_and_grads(params, remat=False)


@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_policy_matches_jax_and_the_port_without_remat(params, plain, policy):
    jmodel = JDinoViT(attn_impl="xla", remat=True, remat_policy=policy, **KW)

    def jloss(p):
        feats, _ = jmodel.apply(p, jnp.asarray(X))
        return sum(jnp.sum(t.astype(jnp.float32) ** 2) for t in jax.tree_util.tree_leaves(feats))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    loss, grads, recomputed = port_loss_and_grads(params, remat=True, policy=policy)
    np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
    jflat = {k: np.asarray(v) for k, v in _flatten(jg).items()}
    got = flax_from_named({k: torch.from_numpy(v) for k, v in grads.items()}, jflat)
    assert_tree_close({k: np.asarray(v) for k, v in got.items()}, jflat)

    plain_loss, plain_grads, plain_calls = plain
    assert loss == plain_loss and plain_calls == []
    assert set(grads) == set(plain_grads)
    for name, g in grads.items():
        np.testing.assert_array_equal(g, plain_grads[name], err_msg=name)
    # one recomputed forward a checkpointed block: local blocks run (3, 6, 17, 64), global ones (1, 6, 51, 64)
    n_global = sum(1 for s in recomputed if s[2] == 3 * 17)
    expected_global = len(GLOBAL_BLOCKS)
    expected_local = 0 if policy == "global" else 12 - len(GLOBAL_BLOCKS)
    assert (n_global, len(recomputed) - n_global) == (expected_global, expected_local), recomputed


def test_build_functions_take_the_four_policies_and_refuse_others():
    for policy in REMAT_POLICIES:
        vit = build_da3("da3-small", device="meta", remat=True, remat_policy=policy).backbone.pretrained
        assert vit.remat_policy == policy
        assert all(b.remat_attn == (policy == "attn") for b in vit.blocks)
    with pytest.raises(ValueError, match="block, global, attn, dots"):
        build_da3("da3-small", device="meta", remat_policy="full")
    with pytest.raises(ValueError, match="block, global, attn, dots"):
        build_resdet3d("da3-small", device="cpu", refinement=False, freeze_da3=False, remat_policy="everything")
