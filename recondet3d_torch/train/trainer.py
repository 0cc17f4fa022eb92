"""Training loop, on one device or data-parallel over ``torch.distributed``
(port of ``recondet3d/train/trainer.py``).

The JAX package jits one pure ``train_step(state, batch)`` over a mesh. In
PyTorch the parameters, the batch statistics and the optimizer's moments
live in the model and the optimizer and are updated in place, so
``TrainState`` names them rather than carrying copies, and a step is:
forward in train mode -> sum of the losses -> backward -> global-norm clip
and AdamW -> metrics.

Data parallelism. With a mesh over a process group (``parallel/mesh.py``;
``Trainer`` makes one over the group this process is in) each rank runs
its shard of the global batch through the model wrapped in
``DistributedDataParallel``; the step runs under ``local_mesh_context``, so
the statistics that reduce over the batch are the global batch's, as GSPMD
computes them in the JAX trainer, and each loss is formed so that DDP's
average of the gradients is the global loss's gradient. Clipping reads the
norm of the averaged gradients, and the logged metrics are the global
batch's (the losses averaged over the ranks). Parameters that
``frozen_patterns`` freezes are taken out of autograd (``requires_grad``
False) before wrapping: DDP would otherwise wait for their gradients. The
state, the optimizer and the checkpoints keep the inner module's parameter
names; only rank 0 writes checkpoints and TensorBoard logs.

Tensor parallelism. On a mesh with a ``model`` extent > 1 the Trainer lays
the model out with ``parallel/tp.py`` ``shard_params`` when it is made
(the JAX trainer does so in ``init_state``; here the optimizer's moments
and DDP are built from the parameters at construction, so the layout comes
first): the DA3 blocks hold their shards and sum over the ``model`` group;
the optimizer averages the replicated gradients over it and its clip reads
the norm of the whole gradient; the floating buffers (batch statistics) are
averaged over it after each update, so that the replicas stay the same
bits; DDP, when ``data > 1``, averages over the ``data`` group only.
``TrainState``'s state dict holds full tensors, gathered over ``model``,
and loads onto any layout.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Dict, Iterable, Optional

import torch
import torch.nn as nn

from recondet3d_torch.parallel.distributed import is_main_process
from recondet3d_torch.parallel.mesh import Mesh, data_parallel_size, global_sum, local_mesh_context, make_mesh, \
    shard_batch
from recondet3d_torch.parallel.tp import gather_full, param_layouts, shard_full, shard_params
from recondet3d_torch.train.optim import Optimizer, average_over, build_optimizer, is_frozen
from recondet3d_torch.utils.stage_timer import stage

__all__ = ["TrainState", "Trainer", "make_train_step"]


@dataclasses.dataclass
class TrainState:
    """What a checkpoint holds: the step count, the model (parameters and
    batch statistics) and the optimizer (moments and its own count)."""

    step: int
    model: nn.Module
    optimizer: Optimizer

    def state_dict(self) -> Dict[str, Any]:
        """Full tensors: the shards of a tensor-parallel model gathered over its ``model`` group (a collective:
        every rank of the group calls this)."""
        layouts = param_layouts(self.model)
        group = self.optimizer.model_group

        def full(tree):
            return {k: gather_full(v, layouts[k], group) if k in layouts else v for k, v in tree.items()}

        opt = self.optimizer.state_dict()
        opt = dict(opt, mu=full(opt["mu"]), nu=full(opt["nu"]))
        return {"step": self.step, "model": full(self.model.state_dict()), "optimizer": opt}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """From full tensors, whatever layout wrote them: this rank's shards are cut out of them."""
        layouts = param_layouts(self.model)

        def local(tree):
            return {k: shard_full(v, layouts[k]) if k in layouts else v for k, v in tree.items()}

        self.step = int(state["step"])
        self.model.load_state_dict(local(state["model"]))
        opt = state["optimizer"]
        self.optimizer.load_state_dict(dict(opt, mu=local(opt["mu"]), nu=local(opt["nu"])))


def make_train_step(model: nn.Module, optimizer: Optimizer, after_step: Optional[Callable[[], None]] = None):
    """Returns train_step(state, batch) -> (state, metrics); ``after_step`` runs after each update.

    ``model(return_loss=True, **batch)`` must return (losses, aux). Metrics
    are 0-d tensors: ``loss`` (the sum of the losses), ``grad_norm`` (the
    global norm before clipping) and each loss by its name; under an active
    mesh the losses are averaged over its ranks (the global batch's)."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model.train()
        optimizer.zero_grad()
        with stage("forward"):
            losses, _ = model(return_loss=True, **batch)
            total = sum(losses.values())
        with stage("backward"):
            total.backward()
        with stage("optimizer"):
            grad_norm = optimizer.step()
            if after_step is not None:
                after_step()
        state.step += 1
        dp = data_parallel_size()
        with torch.no_grad():
            metrics = {"loss": global_sum(total.detach()) / dp, "grad_norm": grad_norm,
                       **{k: global_sum(v.detach()) / dp for k, v in losses.items()}}
        return state, metrics

    return train_step


@dataclasses.dataclass
class Trainer:
    """Minimal runner: drive steps over an iterator of batches, log, checkpoint.

    ``frozen_patterns``: parameter subtrees left out of the optimizer (the
    reference freezes the DA3 backbone); ``()`` trains everything, the
    fine-tuning mode, which with a model built with ``freeze_da3=False`` is
    what sends gradients through the flash-attention backward kernels.
    ``mesh``: the ``(data, model)`` mesh (default: data-parallel over this
    process's group, 1x1 without one); see the module docstring."""

    model: nn.Module
    total_steps: int
    lr: float = 1e-3
    weight_decay: float = 0.01
    grad_clip: float = 100.0
    work_dir: Optional[str] = None
    log_interval: int = 1
    checkpoint_interval: Optional[int] = None  # steps
    hooks: tuple = ()
    frozen_patterns: tuple = ("da3",)
    mesh: Optional[Mesh] = None

    def __post_init__(self):
        self.mesh = self.mesh or make_mesh()
        parallel = self.mesh.group is not None
        if parallel:
            for name, p in self.model.named_parameters():
                if is_frozen(name, self.frozen_patterns):
                    p.requires_grad_(False)
        shard_params(self.model, self.mesh)
        self.optimizer = build_optimizer(
            self.model.named_parameters(), lr=self.lr, weight_decay=self.weight_decay, total_steps=self.total_steps,
            grad_clip=self.grad_clip, frozen_patterns=self.frozen_patterns, sharded=tuple(param_layouts(self.model)),
            model_group=self.mesh.model_group if self.mesh.model > 1 else None)
        module = self.model
        if parallel and self.mesh.data > 1:
            from torch.nn.parallel import DistributedDataParallel

            device = next(self.model.parameters()).device
            # the batch statistics are the global batch's on every rank already: no buffers to broadcast; the
            # parameters no loss reaches (the unused DualDPT branch, the camera encoder without poses) get none
            module = DistributedDataParallel(
                self.model, device_ids=[device.index] if device.type == "cuda" else None, broadcast_buffers=False,
                find_unused_parameters=True, process_group=self.mesh.group)
        after = None
        if self.mesh.model > 1:
            # the batch statistics are computed on every model rank; atomics in a forward can part them by a bit
            buffers = [b for b in self.model.buffers() if b.is_floating_point()]
            after = functools.partial(average_over, self.mesh.model_group, buffers) if buffers else None
        self._step_fn = make_train_step(module, self.optimizer, after)
        self._writer = None

    def init_state(self) -> TrainState:
        """The state at step 0. The model arrives with its parameters (a
        build function draws them from its ``torch.Generator``); the
        optimizer's moments are zeros."""
        return TrainState(step=0, model=self.model, optimizer=self.optimizer)

    def run(self, state: TrainState, data_iter: Iterable[Dict[str, torch.Tensor]], max_steps: Optional[int] = None,
            log_fn: Callable[[int, Dict], None] = None, sharded: bool = False):
        """Take up to ``max_steps`` (default ``total_steps``) steps over
        ``data_iter`` (dicts of tensors, moved to the model's device): global
        batches, of which each rank takes its shard (``shard_batch``), or,
        with ``sharded``, this rank's shares already (a loader that reads
        only this rank's samples). Every ``checkpoint_interval`` steps of
        ``state.step`` a checkpoint is saved. Returns (state, history of
        logged metrics as floats)."""
        device = next(self.model.parameters()).device
        writer = self._get_writer()
        n = max_steps or self.total_steps
        t0 = time.time()
        history = []
        for i, batch in enumerate(data_iter):
            if i >= n:
                break
            with stage("train_step", unit=True):
                if not sharded:
                    batch = shard_batch(self.mesh, batch)
                batch = {k: v.to(device, non_blocking=True) if torch.is_tensor(v) else v for k, v in batch.items()}
                with local_mesh_context(self.mesh):
                    state, metrics = self._step_fn(state, batch)
                logged = (i + 1) % self.log_interval == 0
                if logged:
                    with stage("metrics_readback"):  # waits for the step's device work
                        m = {k: float(v) for k, v in metrics.items()}
            if logged:
                m["steps_per_sec"] = (i + 1) / (time.time() - t0)
                history.append(m)
                if writer is not None:
                    for k, v in m.items():
                        writer.add_scalar(f"train/{k}", v, state.step)
                if log_fn:
                    log_fn(state.step, m)
            for hook in self.hooks:
                hook(state.step, state, metrics)
            # by the state's step, so that a resumed run saves at the same steps as one that never stopped
            if self.checkpoint_interval and state.step % self.checkpoint_interval == 0:
                self.save_checkpoint(state)
        return state, history

    def save_checkpoint(self, state: TrainState):
        """The checkpoint's path (None without a work dir, and on every rank but 0, which alone writes)."""
        if self.work_dir is None:
            return None
        from recondet3d_torch.train.checkpoints import save_checkpoint

        return save_checkpoint(self.work_dir, state)

    def _get_writer(self):
        if self.work_dir is None or not is_main_process():
            return None
        if self._writer is None:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._writer = SummaryWriter(self.work_dir)
            except ImportError:
                self._writer = None
        return self._writer
