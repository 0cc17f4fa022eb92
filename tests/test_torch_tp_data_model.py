"""Tensor parallelism at ``data = 2 x model = 2`` in the port, on the CPU:
four gloo ranks of ``tests/tp_worker.py``, started once for the module
(the ``1 x 2`` cases are tests/test_torch_tp.py's).

One step at ``2 x 2`` (B = 2, one sample a data rank) against the
one-process B = 2 step, at tests/test_torch_ddp.py's tolerances
(``ddp_worker.compare_with_one_process``): the batch norms, the
CenterHead's normalisers and the sparse caps' quotas reduce over ``data``
only. ``MaskedBatchNorm``, ``FlaxBatchNorm2d`` and the nested
net's quantiles and least-squares scale run at ``2 x 2`` against one
process on the global batch: values rtol 1e-5, gradients max |difference|
<= 1e-4 of the largest.
"""

import copy
import os

import numpy as np
import pytest
import torch

import ddp_worker
import tp_worker
from recondet3d_torch.models.refine import MaskedBatchNorm
from recondet3d_torch.models.refine.bev_unet import FlaxBatchNorm2d
from recondet3d_torch.utils import alignment
from test_torch_ddp import _align_inputs, _bn_inputs
from test_torch_tp import STEP, Recorded, _as_compared, det, set_remat  # noqa: F401 (det: a fixture)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, det):
    model, batch = det
    rng = np.random.default_rng(0)
    x, mask, w, x2, w2 = _bn_inputs(rng)
    mbn, fbn = MaskedBatchNorm(8), FlaxBatchNorm2d(8, momentum=0.99, eps=1e-3)
    with torch.no_grad():
        for bn in (mbn, fbn):
            bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 8).astype(np.float32)))
            bn.bias.copy_(torch.from_numpy(rng.normal(size=8).astype(np.float32)))
    ax, amask, aa, ab = _align_inputs(rng)
    stats = dict(masked_bn=dict(module=mbn, x=torch.from_numpy(x), mask=torch.from_numpy(mask), w=torch.from_numpy(w)),
                 flax_bn=dict(module=fbn, x=torch.from_numpy(x2), w=torch.from_numpy(w2)),
                 alignment_fns=dict(x=torch.from_numpy(ax), mask=torch.from_numpy(amask), a=torch.from_numpy(aa),
                                    b=torch.from_numpy(ab)))
    jobs = dict(step=dict(kind="trainer_step", module=set_remat(copy.deepcopy(model), "block"), batch=batch, steps=1,
                          trainer=STEP),
                stats=dict(kind="batch_stats", jobs=stats),
                one=dict(kind="one_process", module=set_remat(copy.deepcopy(model), "block"), batch=batch, steps=1,
                         trainer=STEP))
    out = str(tmp_path_factory.mktemp("tp4"))
    job_file = os.path.join(out, "jobs.pt")
    torch.save(jobs, job_file)
    return ddp_worker.spawn_ranks(4, job_file, out, target=tp_worker.run, extra=(2, 2)), stats


def test_data_times_model_step_is_batch_global(four_ranks):
    ranks, _ = four_ranks
    one = ranks[0]["one"]
    results = [r["step"] for r in ranks]
    found = ddp_worker.compare_with_one_process(_as_compared(results[0], results[3]), Recorded(one), one["history"],
                                                STEP["lr"])
    assert found["ok"], found
    for r in results[1:]:
        for k, v in results[0]["state"]["model"].items():
            assert torch.equal(v, r["state"]["model"][k]), k


def _grad_close(got, ref, err_msg=""):
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max(), (err_msg, float(np.abs(got - ref).max()))


def test_batch_statistics_reduce_over_data_only(four_ranks):
    ranks, stats = four_ranks
    data_ranks = [ranks[0]["stats"], ranks[2]["stats"]]  # model index 0 of data 0 and 1
    assert torch.equal(ranks[1]["stats"]["masked_bn"]["y"], ranks[0]["stats"]["masked_bn"]["y"])  # model ranks
    for name in ("masked_bn", "flax_bn"):
        job = stats[name]
        bn = copy.deepcopy(job["module"]).train()
        xin = job["x"].clone().requires_grad_(True)
        y = bn(xin, job["mask"]) if name == "masked_bn" else bn(xin)
        (y * job["w"]).sum().backward()
        got_y = torch.cat([r[name]["y"] for r in data_ranks])
        np.testing.assert_allclose(got_y.numpy(), y.detach().numpy(), rtol=1e-5, atol=1e-5, err_msg=name)
        _grad_close(torch.cat([r[name]["x_grad"] for r in data_ranks]).numpy(), xin.grad.numpy(), name)
        for r in data_ranks:
            np.testing.assert_allclose(r[name]["running_mean"].numpy(), bn.running_mean.numpy(), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(r[name]["running_var"].numpy(), bn.running_var.numpy(), rtol=1e-5, atol=1e-6)
    job = stats["alignment_fns"]
    x, a, b = (job[k].clone().requires_grad_(True) for k in ("x", "a", "b"))
    q50 = alignment.masked_quantile(x, job["mask"], 0.5)
    q99 = alignment.masked_quantile(x, job["mask"], 0.99)
    scale = alignment.least_squares_scale_scalar(a, b, mask=job["mask"])
    (q50 + 2 * q99 + 3 * scale).backward()
    for r in data_ranks:
        got = r["alignment_fns"]
        np.testing.assert_allclose(got["q50"].item(), q50.item(), rtol=1e-5)
        np.testing.assert_allclose(got["q99"].item(), q99.item(), rtol=1e-5)
        np.testing.assert_allclose(got["scale"].item(), scale.item(), rtol=1e-5)
    for key, ref in (("x_grad", x.grad), ("a_grad", a.grad), ("b_grad", b.grad)):
        # each data rank's loss is the global one: its gradient rows over the data extent are the global gradient's
        _grad_close(torch.cat([r["alignment_fns"][key] for r in data_ranks]).numpy() / 2, ref.numpy(), key)
