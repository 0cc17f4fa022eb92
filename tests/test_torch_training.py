"""The port's training loop vs the JAX package on the CPU: the cyclic
schedules; ten optimizer steps on a fixed gradient sequence against the
optax chain (clip active in two steps, one frozen subtree, one leaf that
gets no gradient in the port and a zero gradient in JAX); three ``Trainer``
steps on the tiny ResDet3D of tests/test_torch_resdet3d_train.py against
the JAX ``Trainer`` on a one-device mesh (loss and grad_norm per step);
checkpoint save / latest / load; the four hooks.

Tolerances: schedules rtol 1e-6 + 1e-6 of the peak (fp32 cosines in JAX,
fp64 here); optimizer parameters rtol 2e-5 / atol 1e-7 after ten steps (fp32
moments updated in another operation order); Trainer steps: loss rtol 1e-5
at the first step and 5e-3 later, grad_norm rtol 2e-2 at the first step and
0.2 later. These follow the JAX trainer's own sensitivity on this model:
with its parameters perturbed by 1e-7 relative its three losses move by
4e-6, 2e-5 and 1.3e-3 relative and its grad_norms by 5e-3, 4e-2 and 9e-2
(batch statistics over a few dozen voxels in train mode; and Adam's first
update is lr * g / (|g| + 1e-8), about lr * sign(g), so an element whose
gradient is rounding noise moves up to 2 * lr apart).
"""

import logging
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recondet3d.parallel.mesh import make_mesh
from recondet3d.train.optim import build_optimizer as j_build_optimizer, cyclic_schedule as j_cyclic_schedule
from recondet3d.train.trainer import Trainer as JTrainer, TrainState as JTrainState
from recondet3d_torch.train import Trainer, TrainState, build_optimizer, cyclic_schedule
from recondet3d_torch.train.checkpoints import latest_checkpoint, load_checkpoint, save_checkpoint
from recondet3d_torch.train.hooks import DeviceMemoryLoggerHook, FadingHook, OccupancyDebugHook, TimingHook
from recondet3d_torch.train.optim import is_frozen
from test_torch_resdet3d_train import build_pair, load_model_variables, make_batch, random_model_variables

MOMENTUM = (0.8947368421052632, 1.0)


@pytest.mark.parametrize("total_steps", [10, 1000, 7])
@pytest.mark.parametrize("base,ratio", [(1e-3, (10.0, 1e-4)), (0.9, MOMENTUM)])
def test_cyclic_schedule_matches_jax(base, ratio, total_steps):
    js = j_cyclic_schedule(base, total_steps, target_ratio=ratio)
    ts = cyclic_schedule(base, total_steps, target_ratio=ratio)
    steps = sorted({0, 1, 2, int(total_steps * 0.4) - 1, int(total_steps * 0.4), total_steps // 2,
                    total_steps - 2, total_steps - 1, total_steps, total_steps + 50})
    for step in steps:
        # atol: JAX's fp32 1 + cos(x) cancels near the end of an arc
        np.testing.assert_allclose(ts(step), float(js(jnp.asarray(step))), rtol=1e-6, atol=1e-6 * base * ratio[0],
                                   err_msg=str(step))
    up = int(total_steps * 0.4)
    np.testing.assert_allclose(ts(0), base, rtol=1e-12)
    np.testing.assert_allclose(ts(up), base * ratio[0], rtol=1e-12)  # the peak, reached after int(0.4 * total) steps
    assert ts(total_steps + 50) == ts(total_steps - 1)  # clamped at the last step


class _Tree(torch.nn.Module):
    """Parameters named like the model's: a ``da3`` subtree and a ``refinement`` subtree."""

    def __init__(self, values):
        super().__init__()
        self.da3 = torch.nn.ParameterDict({"w": torch.nn.Parameter(torch.from_numpy(values["da3"]["w"].copy()))})
        self.refinement = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in values["refinement"].items()})


@pytest.mark.parametrize("frozen", [("da3",), ()])
def test_ten_optimizer_steps_match_optax(frozen):
    rng = np.random.default_rng(0)
    values = {"da3": {"w": rng.normal(size=(5, 4)).astype(np.float32)},
              "refinement": {"a": rng.normal(size=(7, 3)).astype(np.float32),
                             "b": rng.normal(size=(6,)).astype(np.float32),
                             "unused": rng.normal(size=(4,)).astype(np.float32)}}
    # gradient scales per step: steps 3 and 7 exceed the clip norm of 100
    scales = [1.0, 0.1, 5.0, 400.0, 1e-3, 2.0, 1.0, 150.0, 0.5, 1.0]
    grads = [jax.tree_util.tree_map(lambda v: (s * rng.normal(size=v.shape)).astype(np.float32), values)
             for s in scales]
    for g in grads:
        g["refinement"]["unused"] = np.zeros(4, np.float32)
    kw = dict(lr=1e-3, weight_decay=0.01, total_steps=10, grad_clip=100.0)
    jopt = j_build_optimizer(frozen_patterns=frozen, **kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, values)
    jstate = jopt.init(jparams)

    model = _Tree(values)
    opt = build_optimizer(model.named_parameters(), frozen_patterns=frozen, **kw)
    assert len(opt.mu) == len(opt.params) == (3 if frozen else 4)  # frozen leaves get no moments
    clipped = 0
    for step, g in enumerate(grads):
        jg = jax.tree_util.tree_map(jnp.asarray, g)
        updates, jstate = jopt.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        model.da3["w"].grad = torch.from_numpy(g["da3"]["w"].copy())
        model.refinement["a"].grad = torch.from_numpy(g["refinement"]["a"].copy())
        model.refinement["b"].grad = torch.from_numpy(g["refinement"]["b"].copy())
        model.refinement["unused"].grad = None  # no gradient counts as a zero gradient: the weights still decay
        norm = opt.step()
        jnorm = float(optax.global_norm(jg))  # the clip and the metric see every gradient, frozen ones too
        clipped += jnorm > 100.0
        np.testing.assert_allclose(norm.item(), jnorm, rtol=1e-6)
        for sub, leaves in values.items():
            for name in leaves:
                np.testing.assert_allclose(getattr(model, sub)[name].detach().numpy(),
                                           np.asarray(jparams[sub][name]), rtol=2e-5, atol=1e-7,
                                           err_msg=f"step {step} {sub}/{name}")
    assert clipped == 2 and opt.count == 10
    if frozen:
        np.testing.assert_array_equal(model.da3["w"].detach().numpy(), values["da3"]["w"])
    else:
        assert not np.array_equal(model.da3["w"].detach().numpy(), values["da3"]["w"])
    assert not np.array_equal(model.refinement["unused"].detach().numpy(), values["refinement"]["unused"])
    assert is_frozen("reconstruction_backbone.da3.backbone.pretrained.pos_embed", ("da3",))
    assert not is_frozen("reconstruction_backbone.refinement.middle_encoder.conv_input.weight", ("da3",))
    assert not is_frozen("reconstruction_backbone.da3_like.weight", ("da3",))  # whole components, not substrings


@pytest.fixture(scope="module")
def tiny():
    batch = make_batch(2)
    jmodel, tmodel = build_pair(freeze_da3=True)
    variables = random_model_variables(jmodel, batch, 1)
    return jmodel, load_model_variables(tmodel, variables), variables, batch


def test_three_trainer_steps_match_the_jax_trainer(tiny, tmp_path):
    """The default Trainer: DA3 frozen, AdamW on the refinement only."""
    jmodel, tmodel, variables, batch = tiny
    kw = dict(total_steps=1000, lr=1e-3)
    jtrainer = JTrainer(model=jmodel, mesh=make_mesh(devices=jax.devices()[:1], data=1, model=1), **kw)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    # the state that init_state would give, with the numpy-made variables (and without compiling the init)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                         opt_state=jtrainer.optimizer.init(params))
    jstate, jhistory = jtrainer.run(jstate, iter([batch] * 3))

    logged = []
    trainer = Trainer(model=tmodel, work_dir=str(tmp_path), checkpoint_interval=2, **kw)
    state = trainer.init_state()
    assert isinstance(state, TrainState) and state.step == 0
    da3_before = {n: p.detach().clone() for n, p in tmodel.named_parameters() if ".da3." in n}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    state, history = trainer.run(state, iter([tb] * 3), log_fn=lambda step, m: logged.append(step))
    assert state.step == int(jstate.step) == 3 and logged == [1, 2, 3] and tmodel.training
    for i, (h, jh) in enumerate(zip(history, jhistory)):
        assert set(h) == set(jh) == {"loss", "grad_norm", "reconstruction_loss_occupancy", "steps_per_sec"}
        np.testing.assert_allclose(h["loss"], jh["loss"], rtol=1e-5 if i == 0 else 5e-3, err_msg=f"step {i}")
        np.testing.assert_allclose(h["grad_norm"], jh["grad_norm"], rtol=2e-2 if i == 0 else 0.2, err_msg=f"step {i}")
    assert history[-1]["loss"] < history[0]["loss"]  # fitting a fixed batch
    # frozen subtree: bit-identical parameters and no moments
    assert all(torch.equal(p.detach(), da3_before[n]) for n, p in tmodel.named_parameters() if ".da3." in n)
    assert not any(".da3." in n for n in trainer.optimizer.names)
    assert len(trainer.optimizer.names) == sum(".refinement." in n for n, _ in tmodel.named_parameters())
    # checkpoint_interval=2 wrote step 2
    assert os.path.basename(latest_checkpoint(str(tmp_path))) == "step_00000002.pt"


def test_checkpoint_round_trip_restores_model_optimizer_and_caches(tiny, tmp_path):
    _, src, _, batch = tiny
    _, tmodel = build_pair(freeze_da3=False, port_only=True)
    tmodel.load_state_dict(src.state_dict())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    trainer = Trainer(model=tmodel, total_steps=100, lr=1e-3, frozen_patterns=(), work_dir=str(tmp_path))
    state, _ = trainer.run(trainer.init_state(), iter([tb] * 2))
    path = trainer.save_checkpoint(state)
    assert path == latest_checkpoint(str(tmp_path)) and path.endswith("step_00000002.pt")
    assert os.path.exists(path[:-3] + ".meta.json")
    saved = {k: v.clone() for k, v in tmodel.state_dict().items()}
    saved_mu = [m.clone() for m in trainer.optimizer.mu]

    def eval_depth():
        tmodel.eval()
        return tmodel.simple_test(tb["img"], tb["cam2lidar_rts"])["aux"]["da3"]["depth"].clone()

    d2 = eval_depth()
    state, _ = trainer.run(state, iter([tb] * 2))  # two more steps move everything
    assert state.step == 4 and not torch.equal(eval_depth(), d2)
    save_checkpoint(str(tmp_path), state, meta={"note": "later"})
    assert latest_checkpoint(str(tmp_path)).endswith("step_00000004.pt")

    raw = load_checkpoint(path)
    assert set(raw) == {"step", "model", "optimizer"} and raw["step"] == 2
    restored = load_checkpoint(path, target=state)
    assert restored is state and state.step == 2 and trainer.optimizer.count == 2
    for k, v in tmodel.state_dict().items():
        assert torch.equal(v, saved[k]), k
    assert all(torch.equal(a, b) for a, b in zip(trainer.optimizer.mu, saved_mu))
    # eval -> load_checkpoint -> eval: the restored position embedding is the one in use
    assert torch.equal(eval_depth(), d2)
    # training goes on from the restored state
    state, history = trainer.run(state, iter([tb]))
    assert state.step == 3 and np.isfinite(history[0]["loss"])
    with pytest.raises(ValueError):
        Trainer(model=tmodel, total_steps=100).optimizer.load_state_dict(raw["optimizer"])  # other trainable set


def test_hooks(tmp_path, caplog):
    class Aug:
        enabled = True

    aug = Aug()
    fading = FadingHook(aug, after_step=3)
    timing = TimingHook(interval=2)
    memory = DeviceMemoryLoggerHook(interval=1)
    aux = {"occupancy_logits": torch.zeros(1, 4, 4, 2), "gt_occupancy_map": torch.ones(1, 4, 4, 2),
           "pseudo_coors": torch.zeros(3, 4, dtype=torch.int32)}
    debug = OccupancyDebugHook(str(tmp_path / "dbg"), interval=2, aux_fn=lambda: aux, voxel_size=(0.1, 0.1, 0.1),
                               point_cloud_range=(-8.0, -8.0, -2.0, 8.0, 8.0, 2.0))
    with caplog.at_level(logging.INFO, logger="recondet3d_torch.hooks"):
        for step in range(1, 5):
            for hook in (fading, timing, memory, debug):
                hook(step, None, {})
            assert aug.enabled == (step < 3)
    assert timing.steps_per_sec is not None and timing.steps_per_sec > 0
    assert sum("steps/s" in r.message for r in caplog.records) == 2
    assert sum("fading" in r.message for r in caplog.records) == 1
    assert (memory.last is not None) == torch.cuda.is_available()
    assert sorted(os.listdir(tmp_path / "dbg")) == ["debug_iter_000002.pkl", "debug_iter_000004.pkl"]
    with open(tmp_path / "dbg" / "debug_iter_000002.pkl", "rb") as f:
        data = pickle.load(f)
    assert data["step"] == 2 and data["voxel_size"] == [0.1, 0.1, 0.1]
    np.testing.assert_allclose(data["pseudo_occupancy_map"], 0.5)
    np.testing.assert_array_equal(data["gt_occupancy_map"], np.ones((1, 4, 4, 2), np.float32))
    OccupancyDebugHook(str(tmp_path / "none"), interval=1)(1, None, {})  # without an aux_fn nothing is written
    assert os.listdir(tmp_path / "none") == []


def test_hooks_run_inside_the_trainer(tiny):
    _, src, _, batch = tiny
    _, tmodel = build_pair(freeze_da3=True, port_only=True)
    tmodel.load_state_dict(src.state_dict())
    seen = []
    trainer = Trainer(model=tmodel, total_steps=4, hooks=(lambda step, state, metrics: seen.append(
        (step, state.step, sorted(metrics))),), log_interval=2)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    state, history = trainer.run(trainer.init_state(), iter([tb] * 5), max_steps=2)
    assert state.step == 2 and len(history) == 1  # max_steps cuts the iterator, log_interval=2 logs once
    assert seen == [(1, 1, ["grad_norm", "loss", "reconstruction_loss_occupancy"]),
                    (2, 2, ["grad_norm", "loss", "reconstruction_loss_occupancy"])]
    assert trainer.save_checkpoint(state) is None  # no work_dir, no checkpoint
