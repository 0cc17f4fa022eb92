"""Process-group set-up (port of ``recondet3d/parallel/distributed.py``).

The JAX package runs one controller per host and joins the hosts with
``jax.distributed.initialize`` when ``JAX_COORDINATOR_ADDRESS`` is set.
PyTorch runs one process per device: ``init_distributed`` joins the group
that ``torchrun``'s environment describes (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``), or one whose
address, size and rank the caller gives (the train CLI's own workers).
Without either it does nothing, so one-process code is unchanged.

The backend follows the device the caller asked for, never what the host
happens to have: ``nccl`` for CUDA, ``gloo`` for the CPU. A process's
device is ``cuda:LOCAL_RANK``.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["init_distributed", "is_distributed", "is_main_process", "process_info", "local_rank", "process_device",
           "backend_for"]


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def process_device(device="cuda") -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` for CUDA, else ``device``."""
    dev = torch.device(device)
    return torch.device("cuda", local_rank()) if dev.type == "cuda" else dev


def init_distributed(device="cuda", init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, backend: Optional[str] = None) -> bool:
    """Join a process group; returns whether this process is in one.

    ``init_method`` (``tcp://host:port``), ``world_size`` and ``rank`` name
    the group; without them ``torchrun``'s environment does, and without
    that this is a no-op that returns False. ``backend`` defaults to
    ``backend_for(device)``. On CUDA the process's current device becomes
    ``cuda:LOCAL_RANK`` first (NCCL binds a communicator to it)."""
    if dist.is_initialized():
        return True
    if init_method is None and not ("RANK" in os.environ and "WORLD_SIZE" in os.environ):
        return False
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(process_device(device))
    kwargs = {} if init_method is None else dict(init_method=init_method, world_size=world_size, rank=rank)
    dist.init_process_group(backend or backend_for(device), **kwargs)
    return True


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def is_main_process() -> bool:
    """Rank 0, or a process outside any group: the one that writes checkpoints and logs."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def process_info() -> dict:
    joined = dist.is_available() and dist.is_initialized()
    return dict(process_index=dist.get_rank() if joined else 0,
                process_count=dist.get_world_size() if joined else 1,
                local_device_count=torch.cuda.device_count(),
                global_device_count=dist.get_world_size() if joined else 1)
