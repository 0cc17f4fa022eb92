"""Device resolution shared by every constructor that creates tensors."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if CUDA is asked for and absent.

    The port never falls back to the CPU on its own: a caller that wants
    the CPU says ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "recondet3d_torch: CUDA is not available; pass device='cpu' to run "
            "the plain PyTorch path on the CPU"
        )
    return dev
