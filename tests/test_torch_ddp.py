"""Data-parallel training in the port against the JAX package's global
batch, on the CPU: two gloo ranks (``tests/ddp_worker.py``, started once
for the module), one sample a rank, against the JAX value over the batch of
two in one process (GSPMD does not change the arithmetic) and against the
port's own one-process step at B=2.

- A ``Trainer`` step of the tiny CenterHead model of
  tests/test_torch_resdet3d_det.py: against the JAX ``Trainer``'s step at
  B=2, loss rtol 1e-5 and grad_norm rtol 2e-2 (tests/test_torch_training.py's
  first-step tolerances, from the JAX trainer's own sensitivity); against
  the port's one-process B=2 step (the same arithmetic, its sums split
  between two ranks): loss, every loss and grad_norm rtol 1e-6; the
  averaged gradients leaf by leaf within 1e-4 of the leaf's largest + 1e-6
  of the tree's (biases in front of a train-mode batch norm have a true
  gradient of zero and hold rounding noise); every parameter and batch
  statistic after the step rtol 1e-5 / atol 1e-7, but for the elements
  whose gradient is rounding noise (below 1e-5 of the tree's largest),
  which Adam's first update, lr * g / (|g| + 1e-8), moves by up to lr in
  either direction, so two summation orders put them up to 2 * lr apart.
  The two ranks hold the
  same bits after the step, and DA3 (frozen) is out of autograd on both.
- The statistics that reduce over the batch, each across the two ranks
  against the JAX value over the whole batch: ``MaskedBatchNorm`` (rank 1
  holds few valid rows) and ``FlaxBatchNorm2d`` (outputs, running
  statistics, input and parameter gradients); the CenterHead's normalisers
  (rank 1 has no positive of one task; the mean of the ranks' losses is the
  global loss and a rank's gradient over the rank count is the global
  gradient's rows); the nested net's quantiles and least-squares scale, as
  functions (values and gradients) and in the small nested net of
  tests/test_torch_da3_net.py at B=2. Values rtol 1e-5 (quantiles of the
  same values 1e-6), gradients max |difference| <= 1e-4 of the largest; the
  nested net at tests/test_torch_da3_net.py's 1e-3 / 1e-2.
- ``cli/train --device cpu --num-devices 2``: two steps on the structured
  fixture, one log line a step, one checkpoint, written by rank 0, that
  loads; with CUDA asked for and fewer devices visible than asked, it raises
  naming both counts; under a launcher it holds the launcher's processes on
  this host (``LOCAL_WORLD_SIZE``) to the devices visible here, so a group
  across hosts trains.
"""

import copy
import os
import re
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ddp_worker
from nuscenes_fixture import make_fixture
from recondet3d.models.da3 import NestedDepthAnything3Net as JNested
from recondet3d.models.da3.presets import _anyview as j_anyview
from recondet3d.models.detect import ResDet3D as JResDet3D
from recondet3d.models.detect.centerhead import CenterHead as JCenterHead
from recondet3d.models.refine.sparse_encoder import MaskedBatchNorm as JMaskedBN
from recondet3d.parallel.mesh import make_mesh as j_make_mesh
from recondet3d.train.trainer import Trainer as JTrainer, TrainState as JTrainState
from recondet3d.utils import alignment as jalign
from recondet3d_torch.cli import train as cli_train
from recondet3d_torch.cli.create_data import main as create_data
from recondet3d_torch.models.da3 import NestedDepthAnything3Net
from recondet3d_torch.models.da3.presets import _anyview
from recondet3d_torch.models.detect import CenterHead, ResDet3D
from recondet3d_torch.models.refine import MaskedBatchNorm
from recondet3d_torch.models.refine.bev_unet import FlaxBatchNorm2d
from recondet3d_torch.train import Trainer
from recondet3d_torch.train.checkpoints import latest_checkpoint, load_checkpoint
from test_torch_da3_net import SMALL, _init_pair, _small_metric_pair
from test_torch_resdet3d_det import CONFIG, det_batch, head_cfg
from test_torch_resdet3d_train import build_pair, load_model_variables, random_model_variables
from recondet3d_torch.core.config import load_py_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINER = dict(total_steps=1000, lr=1e-3)
NESTED_KEYS = ["depth", "depth_conf", "extrinsics", "sky", "scale_factor"]


def _close(got, ref, rel=1e-4, err_msg=""):
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (err_msg, got.shape, ref.shape)
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max(), (err_msg, float(np.abs(got - ref).max()))


def _np(t):
    return t.detach().numpy()


def _det_model():
    """The tiny CenterHead model of tests/test_torch_resdet3d_det.py, its variables and a batch of two."""
    classes = tuple(load_py_config(CONFIG)["class_names"])
    jbase, tbase = build_pair(freeze_da3=True)
    width = tbase.reconstruction_backbone.refinement.middle_encoder.bev_channels
    jmodel = JResDet3D(reconstruction_backbone=jbase.reconstruction_backbone,
                       pts_bbox_head=JCenterHead(**head_cfg(width)), class_names=classes)
    tmodel = ResDet3D(tbase.reconstruction_backbone, CenterHead(**head_cfg(width), device="cpu"), class_names=classes)
    batch = det_batch(2)
    variables = random_model_variables(jmodel, batch, 1)
    return jmodel, load_model_variables(tmodel, variables), variables, batch


def _bn_inputs(rng):
    x = rng.normal(1.5, 2.0, (80, 8)).astype(np.float32)
    mask = rng.random(80) < 0.8
    mask[40:] = rng.random(40) < 0.1  # rank 1: a few valid rows
    w = rng.normal(size=(80, 8)).astype(np.float32)
    x2 = rng.normal(0.5, 1.5, (2, 8, 5, 6)).astype(np.float32)  # NCHW, one sample a rank
    w2 = rng.normal(size=(2, 8, 5, 6)).astype(np.float32)
    return x, mask, w, x2, w2


def _head_inputs(rng, head):
    """Predictions and targets for the head's two tasks at B=2 on an 8x8 map; rank 1 has no positive of task 1."""
    preds, targets = [], []
    B, H, W, M = 2, 8, 8, 6
    for ti, classes in enumerate(head.tasks):
        c = len(classes)
        preds.append({k: rng.normal(size=(B, H, W, n)).astype(np.float32)
                      for k, n in (("heatmap", c), ("reg", 2), ("height", 1), ("dim", 3), ("rot", 2), ("vel", 2))})
        hm = rng.uniform(0, 0.9, (B, H, W, c)).astype(np.float32)
        inds = rng.integers(0, H * W, (B, M))
        mask = rng.random((B, M)) < 0.7
        for b in range(B):
            if ti == 1 and b == 1:
                mask[b] = False
            for m in np.flatnonzero(mask[b]):
                hm[b, inds[b, m] // W, inds[b, m] % W, m % c] = 1.0
        targets.append(dict(heatmap=hm, anno=rng.normal(size=(B, M, 10)).astype(np.float32),
                            inds=inds.astype(np.int64), mask=mask))
    return preds, targets


def _align_inputs(rng):
    x = rng.gamma(2.0, 3.0, (2, 3, 7, 9)).astype(np.float32)
    mask = rng.random(x.shape) < 0.6
    mask[1] &= rng.random(x.shape[1:]) < 0.3
    a = rng.uniform(1, 40, x.shape).astype(np.float32)
    b = (a * 0.7 + rng.normal(0, 2, x.shape)).astype(np.float32)
    return x, mask, a, b


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.asarray(tree))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(0)
    jdet, tdet, det_vars, det_b = _det_model()
    x, mask, w, x2, w2 = _bn_inputs(rng)
    mbn = MaskedBatchNorm(8)
    fbn = FlaxBatchNorm2d(8, momentum=0.99, eps=1e-3)
    with torch.no_grad():
        for bn in (mbn, fbn):
            bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 8).astype(np.float32)))
            bn.bias.copy_(torch.from_numpy(rng.normal(size=8).astype(np.float32)))
            bn.running_mean.copy_(torch.from_numpy(rng.normal(size=8).astype(np.float32)))
            bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 8).astype(np.float32)))
    head = tdet.pts_bbox_head
    preds, targets = _head_inputs(rng, head)
    ax, amask, aa, ab = _align_inputs(rng)
    jm, tm = _small_metric_pair()
    jnest = JNested(anyview=j_anyview("vits", dtype=jnp.float32, attn_impl="xla", **SMALL), metric=jm)
    tnest = NestedDepthAnything3Net(anyview=_anyview("vits", dtype=torch.float32, device="cpu", **SMALL), metric=tm)
    nest_params, tnest = _init_pair(jnest, tnest, (1, 3, 28, 28, 3), seed=30)
    nx = np.random.default_rng(31).normal(size=(2, 3, 28, 42, 3)).astype(np.float32)
    jobs = dict(
        masked_bn=dict(module=mbn, x=torch.from_numpy(x), mask=torch.from_numpy(mask), w=torch.from_numpy(w)),
        flax_bn=dict(module=fbn, x=torch.from_numpy(x2), w=torch.from_numpy(w2)),
        centerhead=dict(module=head, preds=_to_torch(preds), targets=_to_torch(targets)),
        alignment_fns=dict(x=torch.from_numpy(ax), mask=torch.from_numpy(amask), a=torch.from_numpy(aa),
                           b=torch.from_numpy(ab)),
        nested=dict(module=tnest.eval(), x=torch.from_numpy(nx), keys=NESTED_KEYS),
        trainer_step=dict(module=tdet, batch={k: torch.from_numpy(v) for k, v in det_b.items()}, trainer=TRAINER,
                          steps=1),
    )
    out = str(tmp_path_factory.mktemp("ddp"))
    job_file = os.path.join(out, "jobs.pt")
    torch.save(jobs, job_file)
    ranks = ddp_worker.spawn_ranks(2, job_file, out)
    return dict(ranks=ranks, jobs=jobs, inputs=dict(bn=(x, mask, w, x2, w2), head=(preds, targets),
                                                    align=(ax, amask, aa, ab), nest=(jnest, nest_params, nx),
                                                    det=(jdet, det_vars, det_b)))


def test_two_rank_trainer_step_matches_jax_and_one_process(setup):
    ranks, jobs = setup["ranks"], setup["jobs"]
    jmodel, variables, batch = setup["inputs"]["det"]
    jtrainer = JTrainer(model=jmodel, mesh=j_make_mesh(devices=jax.devices()[:1], data=1, model=1), **TRAINER)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                         opt_state=jtrainer.optimizer.init(params))
    _, jhistory = jtrainer.run(jstate, iter([batch]))

    one = copy.deepcopy(jobs["trainer_step"]["module"])
    trainer = Trainer(model=one, **TRAINER)
    _, history = trainer.run(trainer.init_state(), iter([jobs["trainer_step"]["batch"]]))

    got = dict(ranks[0]["trainer_step"], other_state=ranks[1]["trainer_step"]["state"])
    h, jh = got["history"][0], jhistory[0]
    assert set(h) == set(jh) == set(history[0]) and len(h) == 8  # loss, grad_norm, five losses, steps_per_sec
    np.testing.assert_allclose(h["loss"], jh["loss"], rtol=1e-5)
    np.testing.assert_allclose(h["grad_norm"], jh["grad_norm"], rtol=2e-2)
    found = ddp_worker.compare_with_one_process(got, one, history, TRAINER["lr"])
    assert found["ok"], found
    state = got["state"]
    assert got["names"] == list(trainer.optimizer.names) and got["frozen_requires_grad"] == []
    moved = [k for k, v in jobs["trainer_step"]["module"].state_dict().items() if not torch.equal(state[k], v)]
    assert any(k.startswith("pts_bbox_head.") for k in moved) and any(".refinement." in k for k in moved)


def test_batch_norms_are_batch_global(setup):
    ranks, jobs = setup["ranks"], setup["jobs"]
    x, mask, w, x2, w2 = setup["inputs"]["bn"]
    mbn, fbn = jobs["masked_bn"]["module"], jobs["flax_bn"]["module"]

    def stats(bn):
        return dict(mean=jnp.asarray(_np(bn.running_mean)), var=jnp.asarray(_np(bn.running_var)))

    jm = JMaskedBN(momentum=0.99, epsilon=1e-3)
    mp = dict(scale=jnp.asarray(_np(mbn.weight)), bias=jnp.asarray(_np(mbn.bias)))

    def jmasked(p, xx):
        y, upd = jm.apply({"params": p, "batch_stats": stats(mbn)}, xx, jnp.asarray(mask), True,
                          mutable=["batch_stats"])
        return jnp.sum(y * w), (y, upd["batch_stats"])

    jf = fnn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3, dtype=jnp.float32)
    fp = dict(scale=jnp.asarray(_np(fbn.weight)), bias=jnp.asarray(_np(fbn.bias)))

    def jflax(p, xx):  # NHWC
        y, upd = jf.apply({"params": p, "batch_stats": stats(fbn)}, xx, mutable=["batch_stats"])
        return jnp.sum(y * w2.transpose(0, 2, 3, 1)), (y, upd["batch_stats"])

    for name, fn, xin, to_port in (("masked_bn", jmasked, x, lambda a: a),
                                   ("flax_bn", jflax, x2.transpose(0, 2, 3, 1), lambda a: a.transpose(0, 3, 1, 2))):
        params = mp if name == "masked_bn" else fp
        (_, (y, upd)), (gp, gx) = jax.value_and_grad(fn, argnums=(0, 1), has_aux=True)(params, jnp.asarray(xin))
        got = [r[name] for r in ranks]
        y_ref, gx_ref = to_port(np.asarray(y)), to_port(np.asarray(gx))
        np.testing.assert_allclose(np.concatenate([_np(g["y"]) for g in got]), y_ref, rtol=1e-5, atol=1e-5)
        _close(np.concatenate([_np(g["x_grad"]) for g in got]), gx_ref, err_msg=f"{name} input grad")
        for tname, jname in (("weight", "scale"), ("bias", "bias")):
            _close(sum(_np(g["grads"][tname]) for g in got), gp[jname], err_msg=f"{name} {tname} grad")
        for g in got:
            np.testing.assert_allclose(_np(g["running_mean"]), np.asarray(upd["mean"]), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(_np(g["running_var"]), np.asarray(upd["var"]), rtol=1e-5, atol=1e-6)


def test_centerhead_normalisers_are_batch_global(setup):
    ranks, jobs = setup["ranks"], setup["jobs"]
    preds, targets = setup["inputs"]["head"]
    jhead = JCenterHead(**head_cfg(jobs["centerhead"]["module"].shared_conv.in_channels))

    def jloss(p):
        losses = jhead.loss(p, jax.tree_util.tree_map(jnp.asarray, targets))
        return sum(losses.values()), losses

    (_, jlosses), jgrads = jax.value_and_grad(jloss, has_aux=True)(jax.tree_util.tree_map(jnp.asarray, preds))
    got = [r["centerhead"] for r in ranks]
    assert float(np.asarray(targets[1]["mask"][1]).sum()) == 0  # rank 1: no positive of task 1
    for k, v in jlosses.items():
        # DDP averages the ranks: the mean of their losses is the global batch's loss
        np.testing.assert_allclose(np.mean([g["losses"][k].item() for g in got]), float(v), rtol=1e-5, err_msg=k)
    for ti, jg in enumerate(jgrads):
        for k, v in jg.items():
            _close(np.concatenate([_np(g["grads"][ti][k]) for g in got]) / 2, v, err_msg=f"task {ti} {k}")


def test_nested_alignment_is_batch_global(setup):
    ranks = setup["ranks"]
    x, mask, a, b = setup["inputs"]["align"]

    def jfn(xx, aa, bb):
        q50 = jalign.masked_quantile(xx, jnp.asarray(mask), 0.5)
        q99 = jalign.masked_quantile(xx, jnp.asarray(mask), 0.99)
        scale = jalign.least_squares_scale_scalar(aa, bb, mask=jnp.asarray(mask))
        return q50 + 2 * q99 + 3 * scale, (q50, q99, scale)

    (_, (q50, q99, scale)), grads = jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b))
    for g in (r["alignment_fns"] for r in ranks):  # one number for the global batch on both ranks
        np.testing.assert_allclose(g["q50"].item(), float(q50), rtol=1e-6)
        np.testing.assert_allclose(g["q99"].item(), float(q99), rtol=1e-6)
        np.testing.assert_allclose(g["scale"].item(), float(scale), rtol=1e-5)
    for key, ref in zip(("x_grad", "a_grad", "b_grad"), grads):  # each rank's loss is the global one: see the head's
        _close(np.concatenate([_np(r["alignment_fns"][key]) for r in ranks]) / 2, ref, err_msg=key)

    jnet, params, nx = setup["inputs"]["nest"]
    jout = jax.jit(jnet.apply)(params, jnp.asarray(nx))
    jsky = np.asarray(jout["sky"])
    assert np.abs(jsky - 0.3).min() > 1e-4 and 10 < (jsky < 0.3).sum() < jsky.size - 10
    for key in NESTED_KEYS:
        got = [_np(r["nested"][key]) for r in ranks]
        if key == "scale_factor":
            assert got[0] == got[1]  # one scale for the batch, not one a rank
            got = got[0]
        else:
            got = np.concatenate(got)
        np.testing.assert_allclose(got, np.asarray(jout[key]), atol=1e-3, rtol=1e-2, err_msg=key)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nusc_ddp"))
    make_fixture(root, structured=True)
    assert create_data(["nuscenes", "--root-path", root, "--extra-tag", "tiny", "--version", "v1.0-mini"]) == 0
    ann = os.path.join(root, "tiny_infos_train.pkl")
    return ["--cfg-options", f"data.train.ann_file={ann}", f"data.train.data_root={root}",
            f"data.test.ann_file={ann}", f"data.test.data_root={root}"]


def test_cli_trains_on_two_cpu_workers(fixture_root, tmp_path):
    wd = str(tmp_path / "wd")
    cmd = [sys.executable, "-m", "recondet3d_torch.cli.train", os.path.join(REPO, "configs",
           "resdet3d_tiny_centerhead_test.py"), "--work-dir", wd, "--device", "cpu", "--num-devices", "2",
           "--max-steps", "2", "--checkpoint-interval", "0"] + fixture_root
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=REPO, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    assert [int(s) for s in re.findall(r"^step (\d+):", res.stdout, re.M)] == [1, 2]  # rank 0 alone logs
    assert len(re.findall(r"^saved ", res.stdout, re.M)) == 1
    files = sorted(os.listdir(os.path.join(wd, "checkpoints")))
    assert files == ["step_00000002.meta.json", "step_00000002.pt"]
    ckpt = load_checkpoint(latest_checkpoint(wd))
    assert ckpt["step"] == 2 and not any(k.startswith("module.") for k in ckpt["model"])
    assert set(ckpt["optimizer"]["mu"]) and all(".da3." not in k for k in ckpt["optimizer"]["mu"])


def test_cli_refuses_more_cuda_devices_than_visible(fixture_root, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    args = [os.path.join(REPO, "configs", "resdet3d_tiny_centerhead_test.py"), "--work-dir", str(tmp_path),
            "--num-devices", "2"] + fixture_root
    with pytest.raises(RuntimeError, match="--num-devices 2 needs 2 CUDA devices, but 1 are visible"):
        cli_train.main(args)


def test_cli_under_a_launcher_checks_this_hosts_devices(tmp_path, monkeypatch):
    """torchrun across two hosts of two cards: world 4, 2 processes here."""
    joined = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(cli_train, "init_distributed", lambda device: joined.append(device))
    monkeypatch.setattr(cli_train, "_train", lambda args: 0)
    monkeypatch.setattr(torch.distributed, "destroy_process_group", lambda: None)
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    args = [os.path.join(REPO, "configs", "resdet3d_tiny_centerhead_test.py"), "--work-dir", str(tmp_path)]
    assert cli_train.main(args + ["--num-devices", "4"]) == 0 and joined == ["cuda"]
    with pytest.raises(ValueError, match="--num-devices 2 under a launcher of 4 processes"):
        cli_train.main(args + ["--num-devices", "2"])
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    with pytest.raises(RuntimeError, match="needs 3 CUDA devices \\(3 of them on this host\\), but 2 are visible"):
        cli_train.main(args)
    assert joined == ["cuda"]
