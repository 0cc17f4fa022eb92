"""Training loop on one device (port of ``recondet3d/train/trainer.py``).

The JAX package jits one pure ``train_step(state, batch)`` over a mesh. In
PyTorch the parameters, the batch statistics and the optimizer's moments
live in the model and the optimizer and are updated in place, so
``TrainState`` names them rather than carrying copies, and a step is:
forward in train mode -> sum of the losses -> backward -> global-norm clip
and AdamW -> metrics. The mesh, ``shard_batch`` and tensor-parallel layouts
of the JAX trainer are not ported (ROADMAP §1 item 11, the DDP part).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Optional

import torch
import torch.nn as nn

from recondet3d_torch.train.optim import Optimizer, build_optimizer
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
        return {"step": self.step, "model": self.model.state_dict(), "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.step = int(state["step"])
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])


def make_train_step(model: nn.Module, optimizer: Optimizer):
    """Returns train_step(state, batch) -> (state, metrics).

    ``model(return_loss=True, **batch)`` must return (losses, aux). Metrics
    are 0-d tensors: ``loss`` (the sum of the losses), ``grad_norm`` (the
    global norm before clipping) and each loss by its name."""

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
        state.step += 1
        metrics = {"loss": total.detach(), "grad_norm": grad_norm, **{k: v.detach() for k, v in losses.items()}}
        return state, metrics

    return train_step


@dataclasses.dataclass
class Trainer:
    """Minimal runner: drive steps over an iterator of batches, log, checkpoint.

    ``frozen_patterns``: parameter subtrees left out of the optimizer (the
    reference freezes the DA3 backbone); ``()`` trains everything, the
    fine-tuning mode, which with a model built with ``freeze_da3=False`` is
    what sends gradients through the flash-attention backward kernels."""

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

    def __post_init__(self):
        self.optimizer = build_optimizer(
            self.model.named_parameters(), lr=self.lr, weight_decay=self.weight_decay, total_steps=self.total_steps,
            grad_clip=self.grad_clip, frozen_patterns=self.frozen_patterns)
        self._step_fn = make_train_step(self.model, self.optimizer)
        self._writer = None

    def init_state(self) -> TrainState:
        """The state at step 0. The model arrives with its parameters (a
        build function draws them from its ``torch.Generator``); the
        optimizer's moments are zeros."""
        return TrainState(step=0, model=self.model, optimizer=self.optimizer)

    def run(self, state: TrainState, data_iter: Iterable[Dict[str, torch.Tensor]], max_steps: Optional[int] = None,
            log_fn: Callable[[int, Dict], None] = None):
        """Take up to ``max_steps`` (default ``total_steps``) steps over
        ``data_iter`` (dicts of tensors, moved to the model's device).
        Every ``checkpoint_interval`` steps of ``state.step`` a checkpoint
        is saved. Returns (state, history of logged metrics as floats)."""
        device = next(self.model.parameters()).device
        writer = self._get_writer()
        n = max_steps or self.total_steps
        t0 = time.time()
        history = []
        for i, batch in enumerate(data_iter):
            if i >= n:
                break
            batch = {k: v.to(device, non_blocking=True) if torch.is_tensor(v) else v for k, v in batch.items()}
            state, metrics = self._step_fn(state, batch)
            if (i + 1) % self.log_interval == 0:
                m = {k: float(v) for k, v in metrics.items()}
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
        if self.work_dir is None:
            return None
        from recondet3d_torch.train.checkpoints import save_checkpoint

        return save_checkpoint(self.work_dir, state)

    def _get_writer(self):
        if self.work_dir is None:
            return None
        if self._writer is None:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._writer = SummaryWriter(self.work_dir)
            except ImportError:
                self._writer = None
        return self._writer
