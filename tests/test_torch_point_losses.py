"""The point losses (``EMDLoss``, ``SmoothnessLoss``, ``ColorLoss``,
``SimpleL2Loss``), port vs JAX package on the CPU: values and gradients
with and without ``gt_valid``, at a chunk size that does not divide the
number of predicted points (37 of 100), under each reduction, and the
registry. Tolerance: values rtol 1e-5, gradients max |difference| <= 1e-5
of the largest (fp32 sums in another order).

The JAX package's own checks of these losses (tests/test_resdet3d.py
``test_point_losses``) hold for the port too: identical clouds give a tiny
EMD, zero smoothness and zero L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recondet3d.models.losses import point_losses as jl
from recondet3d_torch.core.registry import LOSSES
from recondet3d_torch.models.losses import ColorLoss, EMDLoss, SimpleL2Loss, SmoothnessLoss, emd_loss

M, N, CHUNK = 100, 80, 37


def _inputs(seed):
    rng = np.random.default_rng(seed)
    pred = rng.normal(size=(2, M, 3)).astype(np.float32)
    gt = rng.normal(size=(2, N, 3)).astype(np.float32)
    valid = rng.random((2, N)) < 0.7
    return pred, gt, valid


def _close(got, ref, rel=1e-5):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max(), float(np.abs(got - ref).max())


def _port_value_and_grads(loss, *arrays, **kw):
    ts = [torch.from_numpy(a).requires_grad_(a.dtype == np.float32) for a in arrays]
    value = loss(*ts, **kw)
    value.sum().backward()
    return value.detach().numpy(), [t.grad.numpy() for t in ts if t.requires_grad]


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["EMDLoss", "ColorLoss"])
def test_chunked_losses_match_jax(name, masked, reduction):
    pred, gt, valid = _inputs(1)
    kw = dict(chunk_size=CHUNK, reduction=reduction, loss_weight=1.5)
    jloss, tloss = getattr(jl, name)(**kw), {"EMDLoss": EMDLoss, "ColorLoss": ColorLoss}[name](**kw)
    vkw = dict(gt_valid=valid) if masked else {}

    def jfn(p, g):
        return jnp.sum(jloss(p, g, **{k: jnp.asarray(v) for k, v in vkw.items()}))

    jvalue = jloss(jnp.asarray(pred), jnp.asarray(gt), **{k: jnp.asarray(v) for k, v in vkw.items()})
    jgrads = jax.grad(jfn, argnums=(0, 1))(jnp.asarray(pred), jnp.asarray(gt))
    value, grads = _port_value_and_grads(tloss, pred, gt, **{k: torch.from_numpy(v) for k, v in vkw.items()})
    np.testing.assert_allclose(value, np.asarray(jvalue), rtol=1e-5)
    for g, jg in zip(grads, jgrads):
        _close(g, jg)
    if masked:  # the masked-out GT points get no gradient
        assert not grads[1][~valid].any()


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_aligned_losses_match_jax(reduction):
    pred, gt, _ = _inputs(2)
    ref = pred + np.random.default_rng(3).normal(0, 0.1, pred.shape).astype(np.float32)
    for name, cls in (("SmoothnessLoss", SmoothnessLoss), ("SimpleL2Loss", SimpleL2Loss)):
        jloss = getattr(jl, name)(reduction=reduction, loss_weight=2.0)
        jvalue = jloss(jnp.asarray(pred), jnp.asarray(ref))
        jgrads = jax.grad(lambda a, b: jnp.sum(jloss(a, b)), argnums=(0, 1))(jnp.asarray(pred), jnp.asarray(ref))
        value, grads = _port_value_and_grads(cls(reduction=reduction, loss_weight=2.0), pred, ref)
        np.testing.assert_allclose(value, np.asarray(jvalue), rtol=1e-5, err_msg=name)
        for g, jg in zip(grads, jgrads):
            _close(g, jg)


def test_emd_function_registry_and_the_jax_checks():
    pred, gt, valid = _inputs(4)
    np.testing.assert_allclose(
        jl.emd_loss(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(valid), 0.2, 16),
        emd_loss(torch.from_numpy(pred), torch.from_numpy(gt), torch.from_numpy(valid), 0.2, 16).numpy(), rtol=1e-5)
    assert all(LOSSES.get(n) is c for n, c in (("EMDLoss", EMDLoss), ("SmoothnessLoss", SmoothnessLoss),
                                              ("ColorLoss", ColorLoss), ("SimpleL2Loss", SimpleL2Loss)))
    assert isinstance(LOSSES.build(dict(type="EMDLoss", chunk_size=32)), EMDLoss)
    a, b = torch.from_numpy(pred[:, :64]), torch.from_numpy(gt)
    assert float(EMDLoss(chunk_size=32)(a, b)) > 0
    assert float(SmoothnessLoss()(a, a)) == 0
    assert float(SimpleL2Loss()(a, a)) == 0
    assert float(ColorLoss(chunk_size=32)(a, b)) > 0
    assert float(EMDLoss(chunk_size=32)(a, a)) < 0.05
