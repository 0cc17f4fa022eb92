"""Optimizer + cyclic schedules (port of ``recondet3d/train/optim.py``).

The JAX package chains ``optax.clip_by_global_norm`` with an AdamW whose
learning rate and beta1 are injected per step from two cyclic schedules
(mmcv's CyclicLrUpdater / CyclicMomentumUpdater), and masks frozen
subtrees out of the optimizer. ``Optimizer`` is that chain written out:

- the clip sees every gradient, frozen subtrees included, and scales by
  ``clip / norm`` only when ``norm >= clip``;
- moments: ``mu = b1 * mu + (1 - b1) * g``, ``nu = b2 * nu + (1 - b2) * g^2``
  with the step's b1 and optax's ``b2 = 0.999``; bias corrections
  ``1 - b1^t`` and ``1 - b2^t`` use the step's b1 too; ``eps = 1e-8`` is
  added outside the square root;
- decay is decoupled: ``p <- p * (1 - lr * wd) - lr * mu_hat / (sqrt(nu_hat) + eps)``;
- a parameter that received no gradient counts as a zero gradient (every
  leaf of the JAX tree gets an update, so its moments and weights decay);
- frozen parameters get no update and no moment buffers.

Updates are in place on the model's parameters (``torch._foreach`` over
the whole list: a handful of launches per step, not one per tensor).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

__all__ = ["cyclic_schedule", "build_optimizer", "Optimizer", "is_frozen"]

_B2, _EPS = 0.999, 1e-8  # optax.adamw's defaults, which the JAX package leaves as they are


def cyclic_schedule(base: float, total_steps: int, target_ratio=(10.0, 1e-4),
                    step_ratio_up: float = 0.4) -> Callable[[int], float]:
    """mmcv CyclicLrUpdater (by_epoch=False, cyclic_times=1): the value goes
    base -> base * ratio[0] over the first ``int(total_steps * step_ratio_up)``
    steps, then -> base * ratio[1], on cosine arcs (the JAX package's
    schedule always anneals by cosine); the step is clamped at
    ``total_steps - 1``."""
    up_steps = int(total_steps * step_ratio_up)
    hi, lo = base * target_ratio[0], base * target_ratio[1]

    def schedule(step: int) -> float:
        step = min(int(step), total_steps - 1)
        if step < up_steps:
            pct = min(max(step / max(up_steps, 1), 0.0), 1.0)
            return hi + (base - hi) * (1 + math.cos(math.pi * pct)) / 2
        pct = min(max((step - up_steps) / max(total_steps - up_steps, 1), 0.0), 1.0)
        return lo + (hi - lo) * (1 + math.cos(math.pi * pct)) / 2

    return schedule


def is_frozen(name: str, frozen_patterns: Iterable[str]) -> bool:
    """A parameter is frozen when a component of its dotted name equals a
    pattern (the JAX package's rule on the components of a flax path)."""
    parts = set(name.split("."))
    return any(p in parts for p in frozen_patterns)


class Optimizer:
    """Global-norm clip + AdamW with per-step learning rate and beta1 over
    ``named_parameters``; see the module docstring for the arithmetic."""

    def __init__(self, named_parameters: Iterable[Tuple[str, torch.nn.Parameter]],
                 lr: Callable[[int], float], b1: Callable[[int], float], weight_decay: float = 0.01,
                 grad_clip: Optional[float] = 100.0, frozen_patterns=()):
        named = [(n, p) for n, p in named_parameters if p.requires_grad]
        self.all_params: List[torch.nn.Parameter] = [p for _, p in named]
        self.names = [n for n, _ in named if not is_frozen(n, frozen_patterns)]
        self.params = [p for n, p in named if not is_frozen(n, frozen_patterns)]
        self.lr, self.b1 = lr, b1
        self.weight_decay, self.grad_clip = weight_decay, grad_clip
        self.count = 0
        with torch.no_grad():
            self.mu = [torch.zeros_like(p) for p in self.params]
            self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.all_params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the parameters' ``.grad``; returns the global
        gradient norm before clipping (0-d fp32 tensor)."""
        lr, b1, b2 = self.lr(self.count), self.b1(self.count), _B2
        self.count += 1
        have = [p.grad for p in self.all_params if p.grad is not None]
        if not have:
            raise RuntimeError("Optimizer.step: no parameter has a gradient")
        norms = torch.stack(torch._foreach_norm(have, 2, dtype=torch.float64))  # fp64 sums
        norm = torch.linalg.vector_norm(norms).float()
        if not self.params:
            return norm
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.grad_clip is not None:
            coef = torch.where(norm < self.grad_clip, torch.ones_like(norm), self.grad_clip / norm)
            grads = torch._foreach_mul(grads, coef)
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
        bc1, bc2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        denom = torch._foreach_sqrt(self.nu)
        torch._foreach_div_(denom, math.sqrt(bc2))
        torch._foreach_add_(denom, _EPS)
        torch._foreach_mul_(self.params, 1 - lr * self.weight_decay)
        torch._foreach_addcdiv_(self.params, self.mu, denom, value=-lr / bc1)
        return norm

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": dict(zip(self.names, self.mu)), "nu": dict(zip(self.names, self.nu))}

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        if set(state["mu"]) != set(self.names):
            raise ValueError("optimizer state holds other parameters than this optimizer trains")
        self.count = int(state["count"])
        for name, mu, nu in zip(self.names, self.mu, self.nu):
            mu.copy_(state["mu"][name])
            nu.copy_(state["nu"][name])


def build_optimizer(named_parameters, lr: float = 1e-3, weight_decay: float = 0.01, total_steps: int = 1000,
                    grad_clip: Optional[float] = 100.0, cyclic_lr: bool = True, cyclic_momentum: bool = True,
                    momentum_target_ratio=(0.8947368421052632, 1.0), base_momentum: float = 0.9,
                    frozen_patterns=("da3",)) -> Optimizer:
    """AdamW (lr 1e-3, wd 0.01), global-norm clip at 100, cyclic learning
    rate (x10 up over 40 % of the steps, then down to x1e-4) and cyclic
    beta1 (0.9 -> 0.805 -> 0.9), as the reference's training config.
    ``frozen_patterns``: parameters whose dotted name has a component equal
    to one of these are left out of the optimizer entirely (no update, no
    moment buffers; the reference freezes the DA3 backbone)."""
    lr_sched = cyclic_schedule(lr, total_steps) if cyclic_lr else (lambda step: lr)
    b1_sched = (cyclic_schedule(base_momentum, total_steps, target_ratio=momentum_target_ratio)
                if cyclic_momentum else (lambda step: base_momentum))
    return Optimizer(named_parameters, lr_sched, b1_sched, weight_decay=weight_decay, grad_clip=grad_clip,
                     frozen_patterns=tuple(frozen_patterns))
