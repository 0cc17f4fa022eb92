"""Tensor parallelism (``parallel/tp.py``) in the port, on the CPU: gloo
ranks of ``tests/tp_worker.py`` over a ``(data, model)`` mesh, started once
for the module at ``1 x 2`` (two ranks; the ``2 x 2`` mesh of four ranks is
tests/test_torch_tp_data_model.py's). The one-process steps they are held
to run in rank 0 after the group's jobs, alone (``Mesh(1, 1)``): torch in a
process without JAX runs these steps many times faster.

- ViT-S (6 heads, 3 a rank) at ``model = 2`` against the JAX package's
  ``shard_params`` + ``jax.jit(vit.apply)`` on its ``(4, 2)`` mesh
  (tests/test_training.py ``test_tp_param_shardings``), every returned
  feature at that test's ``atol 2e-5, rtol 1e-4``; the layout leaf by leaf
  against ``da3_param_shardings``' specs of the JAX package, transposed to
  ``(out, in)``, and every rank holding its shard's shape. Column-parallel
  biases are split with their weights in the port and replicated in JAX
  (which annotates kernels only).
- The divergence at ``t = 4``: ViT-S's 6 heads do not split into whole heads
  over 4 ranks, so the port replicates the attention layers JAX shards
  (``3C % 4 == 0``); the FFN is sharded in both. A layout check, no
  processes.
- One ``Trainer`` step of the tiny CenterHead ResDet3D fine-tuned (DA3 in
  the graph, ``frozen_patterns=()``) at ``1 x 2`` under each of the four
  remat policies (``dots`` recomputes under a dispatch mode that sees
  every op, the all-reduces included; the recompute issues them again in
  the same order on both ranks), against the port's one-process step:
  loss and grad norm rtol 1e-6; gradients (the shards gathered) and the
  state after the step at tests/test_torch_ddp.py's tolerances
  (``ddp_worker.compare_with_one_process``: gradients within 1e-4 of the
  leaf's largest + 1e-6 of the tree's, parameters rtol 1e-5 / atol 1e-7 but
  for Adam's rounding-noise elements, at most 2 * lr apart); both ranks
  hold the same full state.
- A checkpoint saved at ``1 x 2`` holds full tensors and loads bit for bit
  into one process; loaded back onto a ``1 x 2`` layout, every rank's
  shards are cut from it.
"""

import copy
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddp_worker
import tp_worker
from recondet3d.models.da3.vit import DinoViT as JDinoViT
from recondet3d.parallel import make_mesh as j_make_mesh
from recondet3d.parallel.tp import da3_param_shardings as j_da3_param_shardings, shard_params as j_shard_params
from recondet3d_torch.models.da3.vit import DinoViT
from recondet3d_torch.parallel import Mesh, da3_param_shardings
from recondet3d_torch.parallel.tp import Layout, shard_full
from recondet3d_torch.train import Trainer
from recondet3d_torch.train.checkpoints import load_checkpoint
from test_torch_ddp import TRAINER, _det_model
from test_torch_weights import load_into_port, random_flax_params

VIT = dict(name_preset="vits", out_layers=(5, 7, 9, 11))
POLICIES = ("block", "dots", "global", "attn")
STEP = dict(TRAINER, frozen_patterns=())


def set_remat(model, policy):
    """Fine-tune DA3 (in the graph) with ``policy``: the build's switches, set on a model already made."""
    model.reconstruction_backbone.freeze_da3 = False
    for m in model.modules():
        if isinstance(m, DinoViT):
            m.remat, m.remat_policy = True, policy
            for blk in m.blocks:
                blk.remat_attn = policy == "attn"
    return model


def _vit_params():
    x = np.random.default_rng(7).uniform(0, 1, (1, 2, 28, 28, 3)).astype(np.float32)
    jvit = JDinoViT(dtype=jnp.float32, attn_impl="xla", alt_start=2, rope_start=2, qknorm_start=2, **VIT)
    params = random_flax_params(jax.eval_shape(jvit.init, jax.random.PRNGKey(0), jnp.asarray(x)), seed=11)
    port = load_into_port(DinoViT(dtype=torch.float32, device="cpu", alt_start=2, rope_start=2, qknorm_start=2,
                                  **VIT), params)
    return jvit, params, port, x


@pytest.fixture(scope="module")
def det():
    _, model, _, batch = _det_model()
    return model, {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def vit():
    return _vit_params()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, det, vit):
    model, batch = det
    out = str(tmp_path_factory.mktemp("tp2"))
    jobs = dict(vit=dict(kind="forward", module=vit[2], x=torch.from_numpy(vit[3])))
    for p in POLICIES:
        jobs[f"step_{p}"] = dict(kind="trainer_step", module=set_remat(copy.deepcopy(model), p), batch=batch, steps=1,
                                 trainer=STEP, checkpoint_dir=os.path.join(out, "wd") if p == "block" else None)
    for p in POLICIES:  # after every collective job: rank 0 alone
        jobs[f"one_{p}"] = dict(kind="one_process", module=set_remat(copy.deepcopy(model), p), batch=batch, steps=1,
                                trainer=STEP)
    job_file = os.path.join(out, "jobs.pt")
    torch.save(jobs, job_file)
    return ddp_worker.spawn_ranks(2, job_file, out, target=tp_worker.run, extra=(1, 2))


class Recorded:
    """A one-process step's result (``tp_worker.one_process``) read as ``ddp_worker.compare_with_one_process`` reads
    the model it took."""

    def __init__(self, result):
        self.result = result

    def named_parameters(self):
        return [(n, types.SimpleNamespace(grad=g)) for n, g in self.result["grads"].items()]

    def state_dict(self):
        return self.result["state"]


def _as_compared(result, other):
    """A tp_worker trainer_step result in ddp_worker.compare_with_one_process's form."""
    return dict(result, other_state=other["state"]["model"], state=result["state"]["model"])


def test_vit_forward_matches_jax_tensor_parallel(two_ranks, vit):
    jvit, params, port, x = vit
    mesh = j_make_mesh(data=4, model=2)
    sharded = j_shard_params(params, mesh)
    with mesh:
        jout, _ = jax.jit(lambda p, xx: jvit.apply(p, xx))(sharded, jnp.asarray(x))
    for r in two_ranks:
        feats, _ = r["vit"]["out"]
        assert len(feats) == len(jout) == 4
        for (pt, ct), (jpt, jct) in zip(feats, jout):
            np.testing.assert_allclose(pt.numpy(), np.asarray(jpt), atol=2e-5, rtol=1e-4)
            np.testing.assert_allclose(ct.numpy(), np.asarray(jct), atol=2e-5, rtol=1e-4)


def _jax_specs(params, mesh):
    """JAX's ``da3_param_shardings`` by the port's names; a kernel's (in, out) spec read over the weight's (out, in)."""
    from recondet3d.api.weights import _flatten
    from recondet3d_torch.api.weights import torch_name

    shardings = _flatten(j_da3_param_shardings(params, mesh))
    return {torch_name(k): tuple(reversed(tuple(s.spec))) if k.endswith("kernel") else tuple(s.spec)
            for k, s in shardings.items()}


def test_layout_matches_jax_leaf_by_leaf(two_ranks, vit):
    _, params, port, _ = vit
    jspecs = _jax_specs(params, j_make_mesh(data=4, model=2))
    got = two_ranks[0]["vit"]["specs"]
    assert set(got) == set(jspecs)
    sharded = 0
    for name, spec in got.items():
        if name.endswith(".bias") and spec:  # column-parallel biases: split here, replicated in JAX
            assert name.endswith((".qkv.bias", ".fc1.bias", ".w12.bias")) and jspecs[name] in ((), (None,)), name
            continue
        assert spec == jspecs[name] or (not spec and not any(jspecs[name])), (name, spec, jspecs[name])
        sharded += bool(spec)
    assert sharded == 12 * 4  # qkv, proj, fc1, fc2 of each block
    full = dict(port.named_parameters())
    for r, res in enumerate(two_ranks):
        for name, shape in res["vit"]["local_shapes"].items():
            spec = got[name]
            want = list(full[name].shape)
            if spec:
                want[spec.index("model")] //= 2
            assert list(shape) == want, (r, name)


def test_heads_that_do_not_split_are_replicated_at_four_ranks(vit):
    """ViT-S's 6 heads over t = 4: JAX shards qkv (3C = 1152 divides by 4) and proj, the port keeps whole heads and
    replicates the attention; both shard the FFN (hidden 1536)."""
    _, params, port, _ = vit
    got = da3_param_shardings(port, Mesh(data=1, model=4))
    jspecs = _jax_specs(params, j_make_mesh(data=2, model=4))
    for name in got:
        if ".attn.qkv.weight" in name or ".attn.proj.weight" in name:
            assert got[name] == () and any(jspecs[name]), name
        elif ".mlp.fc1.weight" in name or ".mlp.fc2.weight" in name:
            assert got[name] == jspecs[name] and got[name], name
        elif name.endswith(".mlp.fc1.bias"):
            assert got[name] == ("model",)
        else:
            assert got[name] == () and not any(jspecs[name]), name
    assert set(da3_param_shardings(port, Mesh(data=4, model=1)).values()) == {()}


@pytest.mark.parametrize("policy", POLICIES)
def test_tensor_parallel_step_matches_one_process(two_ranks, det, policy):
    model, _ = det
    one = two_ranks[0][f"one_{policy}"]
    r0, r1 = (r[f"step_{policy}"] for r in two_ranks)
    h, oh = r0["history"][0], one["history"][0]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(h[k], oh[k], rtol=1e-6, err_msg=k)
    found = ddp_worker.compare_with_one_process(_as_compared(r0, r1), Recorded(one), one["history"], STEP["lr"])
    assert found["ok"], found
    assert r0["names"] == one["names"]
    # the DA3 blocks are sharded on each rank: qkv holds half the heads
    full = dict(model.named_parameters())
    qkv = [n for n in r0["local_shapes"] if n.endswith("blocks.1.attn.qkv.weight")][0]
    assert r0["local_shapes"][qkv][0] * 2 == full[qkv].shape[0]
    for k in ("mu", "nu"):
        for n, v in r0["state"]["optimizer"][k].items():
            assert torch.equal(v, r1["state"]["optimizer"][k][n]), (k, n)
            assert v.shape == full[n].shape, (k, n)


def test_checkpoint_saved_tensor_parallel_loads_in_one_process(two_ranks, det):
    model, _ = det
    r0 = two_ranks[0]["step_block"]
    path = r0["checkpoint"]
    ckpt = load_checkpoint(path)
    state = r0["state"]
    assert ckpt["step"] == 1
    for k, v in state["model"].items():
        assert torch.equal(ckpt["model"][k], v), k
    one = set_remat(copy.deepcopy(model), "block")
    trainer = Trainer(model=one, **STEP)
    target = load_checkpoint(path, target=trainer.init_state())
    assert target.step == 1
    for k, v in one.state_dict().items():
        assert torch.equal(v, ckpt["model"][k]), k
    for k in ("mu", "nu"):
        for n, v in trainer.optimizer.state_dict()[k].items():
            assert torch.equal(v, ckpt["optimizer"][k][n]), (k, n)


def test_shard_and_gather_are_inverse():
    """The cut of a fused qkv / w12 weight: each rank takes its slice of every chunk; gathering the slices (one
    process standing in for each rank) gives the full tensor back, bit for bit, -0.0 included."""
    full = torch.arange(24.0).reshape(12, 2)
    full[0, 0] = -0.0
    lay = [Layout(0, 3, 2, r) for r in range(2)]
    parts = [shard_full(full, lay[r]) for r in range(2)]
    assert parts[0][:, 0].tolist() == [-0.0, 2.0, 8.0, 10.0, 16.0, 18.0]
    back = torch.cat([torch.cat([p.chunk(3)[k] for p in parts]) for k in range(3)])
    assert torch.equal(back.view(torch.int32), full.view(torch.int32))
