"""The control: the reference computed one precision below the one the
configuration states. Inside ``lower_precision()`` every matrix product and
convolution whose operands are bfloat16 takes them rounded to float8 e4m3
(each tensor scaled by its largest magnitude into e4m3's range, the scale
undone after the rounding), and float32 products and convolutions run in
TF32 on the card (TF32 is a property of the card's kernels; on the CPU they
stay float32)."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

__all__ = ["lower_precision", "round_fp8"]

_E4M3_MAX = 448.0
_PRODUCTS = {F.linear, F.conv2d, F.conv3d, F.conv_transpose2d, torch.matmul, torch.mm, torch.bmm, torch.einsum,
             torch.Tensor.matmul, torch.Tensor.__matmul__, torch.addmm, torch.baddbmm}


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` (bfloat16) rounded through float8 e4m3 at a per-tensor scale."""
    amax = t.detach().abs().amax().float().clamp(min=1e-12)
    scale = _E4M3_MAX / amax
    return ((t.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(t.dtype)


def _lower(x):
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return round_fp8(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_lower(v) for v in x)
    return x


class _Fp8Products(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            args, kwargs = _lower(args), {k: _lower(v) for k, v in kwargs.items()}
        return func(*args, **kwargs)


@contextlib.contextmanager
def lower_precision():
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with _Fp8Products():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn
