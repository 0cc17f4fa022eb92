"""Detectors and detection heads of the port, and ``build_resdet3d``."""

from __future__ import annotations

from typing import Optional

import torch

from recondet3d_torch.models.da3 import build_da3
from recondet3d_torch.models.detect.anchor3d_head import Anchor3DHead
from recondet3d_torch.models.detect.centerhead import CenterHead
from recondet3d_torch.models.detect.reconstruction_backbone import ReconstructionBackbone
from recondet3d_torch.models.detect.resdet3d import ResDet3D
from recondet3d_torch.models.refine.refinement import SparseRefinement, init_refinement_parameters_
from recondet3d_torch.utils.device import resolve_device

__all__ = ["ReconstructionBackbone", "ResDet3D", "CenterHead", "Anchor3DHead", "build_resdet3d"]


def build_resdet3d(preset: str = "da3nested-giant-large", dtype=torch.bfloat16, device="cuda",
                   generator: Optional[torch.Generator] = None, refinement: Optional[dict] = None,
                   freeze_da3: bool = True, remat_policy: str = "block", **backbone_kwargs) -> ResDet3D:
    """ResDet3D over the DA3 ``preset`` with random weights drawn from
    ``generator`` (default: seed 0 on ``device``), in eval mode.

    ``dtype`` is the compute dtype of the DA3 trunk and of the refinement's
    encoder and U-Net (parameters, batch-norm statistics and logits stay
    fp32). ``refinement`` holds ``SparseRefinement`` arguments; ``None``
    values it at its defaults, ``False`` builds none. ``freeze_da3=False``
    builds the model for fine-tuning: gradients flow through DA3, whose
    trunk then holds fp32 master parameters (computing in ``dtype``) and
    recomputes its activations in the backward pass by ``remat_policy``
    (``block``, ``global``, ``attn`` or ``dots``: ``models/da3/vit.py``); the
    default build and its request time are those of inference. Other keywords go to
    ``ReconstructionBackbone``. ``device`` defaults to CUDA and raises
    where CUDA is absent; pass ``device="cpu"`` to run the plain paths.
    """
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    tuned = dict(param_dtype=torch.float32, remat=True) if not freeze_da3 else {}
    tuned["remat_policy"] = remat_policy
    # the detector never calls the Gaussian-splat head, and the JAX package's ResDet3D has no parameters for it
    da3 = build_da3(preset, dtype=dtype, device=dev, generator=generator, with_gs=False, **tuned)
    ref = None
    if refinement is not False:
        ref = SparseRefinement(dtype=dtype, device=dev, **(refinement or {}))
        init_refinement_parameters_(ref, generator)
    return ResDet3D(ReconstructionBackbone(da3=da3, refinement=ref, freeze_da3=freeze_da3, **backbone_kwargs)).eval()
