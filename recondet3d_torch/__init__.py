"""recondet3d_torch — the PyTorch / CUDA (Hopper) port of ``recondet3d``.

The JAX package ``recondet3d`` is the reference; this package mirrors its
sub-package layout (``ops``, ``models.da3``, ``utils``, ``data``, ``api``)
and its public layouts (images ``(B, S, H, W, 3)`` channels-last,
attention tensors ``(B, H, N, D)``). It imports ``torch``, numpy and the
standard library only. Every TPU (Pallas) kernel on a ported path is a
hand-written CUDA kernel under ``csrc/``, built at first use
(``recondet3d_torch.ops.build``); each has a plain PyTorch version beside
it that the CPU tests run.

Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""

from recondet3d_torch.utils.device import resolve_device
from recondet3d_torch.version import __version__

__all__ = ["__version__", "resolve_device"]
