"""Checkpoint save / load in torch's own format (port of
``recondet3d/train/checkpoints.py``, which uses orbax).

A checkpoint is ``<work_dir>/checkpoints/step_XXXXXXXX.pt``: the
``TrainState``'s step, model state dict (parameters and batch statistics)
and optimizer state (moments and count), written by ``torch.save``; beside
it ``step_XXXXXXXX.meta.json`` with the package version, the step and the
caller's meta dict. Under data parallelism only rank 0 writes (the ranks
hold the same state); every rank loads the same file. Under tensor
parallelism the state holds full tensors, gathered over the ``model``
group (every rank takes part in the gather, rank 0 writes), so a
checkpoint does not depend on the layout that wrote it: ``load_checkpoint``
cuts each rank's shards out of it on any ``(data, model)``, one process
included.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from recondet3d_torch.parallel.distributed import is_main_process

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint"]


def _ckpt_dir(work_dir: str) -> str:
    d = os.path.join(os.path.abspath(work_dir), "checkpoints")
    os.makedirs(d, exist_ok=True)
    return d


def save_checkpoint(work_dir: str, state, meta: Optional[dict] = None) -> Optional[str]:
    """Write ``state``; returns its path, or None on a rank other than 0, which writes nothing."""
    from recondet3d_torch import __version__

    full = state.state_dict()  # on every rank: gathering a tensor-parallel state is a collective
    if not is_main_process():
        return None
    step = int(state.step)
    path = os.path.join(_ckpt_dir(work_dir), f"step_{step:08d}.pt")
    tmp = path + ".tmp"
    torch.save(full, tmp)
    os.replace(tmp, path)  # a killed save leaves no half-written checkpoint to pick up
    meta = dict(meta or {})
    meta.update(version=__version__, step=step)
    with open(path[:-3] + ".meta.json", "w") as f:
        json.dump(meta, f)
    return path


def latest_checkpoint(work_dir: str) -> Optional[str]:
    d = _ckpt_dir(work_dir)
    steps = sorted(p for p in os.listdir(d) if p.startswith("step_") and p.endswith(".pt"))
    return os.path.join(d, steps[-1]) if steps else None


def load_checkpoint(path: str, target=None, map_location="cpu"):
    """The checkpoint's dict ({"step", "model", "optimizer"}). With
    ``target`` (a ``TrainState``) its model, optimizer and step are restored
    in place, onto ``target``'s layout, and ``target`` is returned."""
    state = torch.load(path, map_location=map_location, weights_only=True)
    if target is None:
        return state
    target.load_state_dict(state)
    return target
