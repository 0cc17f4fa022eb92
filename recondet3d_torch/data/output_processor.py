"""Model output dict -> Prediction (port of
``recondet3d/data/output_processor.py``): squeeze the B=1 batch dim, numpy
conversion, sky -> bool mask at 0.5. The forward's tensors reach the host
once, each as fp32 (``to_host``); the Gaussians come back as numpy too."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from recondet3d_torch.specs import Gaussians, Prediction

__all__ = ["OutputProcessor", "to_host"]


def to_host(x):
    """A forward output (tensors, dicts of them, ``Gaussians``) as numpy:
    floating tensors as fp32."""
    if torch.is_tensor(x):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).cpu().numpy()
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, Gaussians):
        return Gaussians(**{f.name: to_host(getattr(x, f.name)) for f in dataclasses.fields(x)})
    return x


def _np(x):
    return None if x is None else np.asarray(x)


class OutputProcessor:
    def __call__(self, model_output: Dict[str, Any]) -> Prediction:
        model_output = to_host(model_output)
        depth = _np(model_output["depth"])[0]  # (N, H, W)
        conf = model_output.get("depth_conf")
        conf = None if conf is None else _np(conf)[0]
        sky = model_output.get("sky")
        sky = None if sky is None else (_np(sky)[0] >= 0.5)
        extr = model_output.get("extrinsics")
        extr = None if extr is None else _np(extr)[0].astype(np.float32)
        intr = model_output.get("intrinsics")
        intr = None if intr is None else _np(intr)[0].astype(np.float32)
        aux = model_output.get("aux")
        if aux is not None:
            aux = {k: _np(v)[0] for k, v in aux.items()}
        gaussians = model_output.get("gaussians")
        sf = model_output.get("scale_factor")
        return Prediction(
            depth=depth.astype(np.float32),
            conf=None if conf is None else conf.astype(np.float32),
            sky=sky,
            extrinsics=extr,
            intrinsics=intr,
            gaussians=gaussians,
            aux=aux,
            scale_factor=None if sf is None else float(np.asarray(sf)),
            is_metric=bool(np.asarray(model_output.get("is_metric", 0))),
        )
