"""DA3 model presets and ``build_da3`` (port of
``recondet3d/models/da3/presets.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from recondet3d_torch.models.da3.cam import CameraDec, CameraEnc
from recondet3d_torch.models.da3.dpt import DPT, DualDPT, GSDPT
from recondet3d_torch.models.da3.gs_adapter import GaussianAdapter
from recondet3d_torch.models.da3.layers import init_parameters_
from recondet3d_torch.models.da3.net import DepthAnything3Net, NestedDepthAnything3Net
from recondet3d_torch.models.da3.vit import DinoViT, check_remat_policy
from recondet3d_torch.utils.device import resolve_device

__all__ = ["build_da3", "materialize_", "PRESETS", "MODEL_REGISTRY"]


def _anyview(vit_name, out_layers, alt_start, head_dim_in, features, out_channels, cam_dim, dtype,
             device, with_gs=False, **vit_kw):
    net = DinoViT(
        name_preset=vit_name, out_layers=tuple(out_layers), alt_start=alt_start,
        qknorm_start=alt_start, rope_start=alt_start, cat_token=True, dtype=dtype, device=device, **vit_kw,
    )
    head = DualDPT(dim_in=head_dim_in, output_dim=2, features=features,
                   out_channels=tuple(out_channels), device=device)
    gs = {}
    if with_gs:
        gs = dict(
            gs_head=GSDPT(dim_in=head_dim_in, output_dim=38, features=features, out_channels=tuple(out_channels),
                          device=device),
            gs_adapter=GaussianAdapter(sh_degree=2, pred_color=False, pred_offset_depth=True, pred_offset_xy=True,
                                       gaussian_scale_min=1e-5, gaussian_scale_max=30.0),
        )
    return DepthAnything3Net(
        net=net, head=head, cam_enc=CameraEnc(dim_out=cam_dim, device=device),
        cam_dec=CameraDec(dim_in=head_dim_in, device=device), **gs,
    )


def _monocular(dtype, device, **vit_kw):
    # da3metric-large / da3mono-large: plain ViT-L + DPT(1ch) + sky head
    net = DinoViT(
        name_preset="vitl", out_layers=(4, 11, 17, 23), alt_start=-1, qknorm_start=-1,
        rope_start=-1, cat_token=False, dtype=dtype, device=device, **vit_kw,
    )
    head = DPT(dim_in=1024, output_dim=1, features=256, out_channels=(256, 512, 1024, 1024), device=device)
    return DepthAnything3Net(net=net, head=head)


PRESETS = {
    "da3-small": dict(vit="vits", out_layers=(5, 7, 9, 11), alt_start=4,
                      head_dim_in=768, features=64, out_channels=(48, 96, 192, 384), cam_dim=384),
    "da3-base": dict(vit="vitb", out_layers=(5, 7, 9, 11), alt_start=4,
                     head_dim_in=1536, features=128, out_channels=(96, 192, 384, 768), cam_dim=768),
    "da3-large": dict(vit="vitl", out_layers=(11, 15, 19, 23), alt_start=8,
                      head_dim_in=2048, features=256, out_channels=(256, 512, 1024, 1024), cam_dim=1024),
    "da3-giant": dict(vit="vitg", out_layers=(19, 27, 33, 39), alt_start=13,
                      head_dim_in=3072, features=256, out_channels=(256, 512, 1024, 1024), cam_dim=1536,
                      with_gs=True),
}

MODEL_REGISTRY = [
    "da3-small", "da3-base", "da3-large", "da3-giant",
    "da3metric-large", "da3mono-large", "da3nested-giant-large",
]


def build_da3(name: str, dtype=torch.bfloat16, with_gs: Optional[bool] = None,
              device="cuda", generator: Optional[torch.Generator] = None, param_dtype=None,
              remat: bool = False, remat_policy: str = "block"):
    """Build a DA3 model for a preset name (HF-hub naming also accepted, e.g.
    'depth-anything/DA3NESTED-GIANT-LARGE') with random weights drawn from
    ``generator`` (default: seed 0 on ``device``).

    ``dtype`` is the ViT trunk's compute dtype and, unless ``param_dtype``
    says otherwise, its storage dtype; heads are fp32. A model that is
    trained takes ``param_dtype=torch.float32`` (fp32 master parameters,
    cast to ``dtype`` at use) and ``remat=True`` (activations recomputed in
    the backward pass by ``remat_policy``: ``block``, the default, every
    trunk block under activation checkpointing; ``global``, ``attn`` or
    ``dots``, see ``vit.py``; a name outside these raises ValueError).
    ``device`` defaults to CUDA and raises where CUDA is absent; ``"meta"``
    builds shapes only (``materialize_``).
    ``with_gs`` builds the Gaussian-splat head (``GSDPT`` + ``GaussianAdapter``);
    ``None`` takes the preset's default, as the JAX package does: da3-giant and
    the nested net build it, the other presets do not.
    """
    dev = resolve_device(device)
    vit_kw = dict(param_dtype=param_dtype, remat=remat, remat_policy=check_remat_policy(remat_policy))
    key = name.split("/")[-1].lower()
    if key in ("da3metric-large", "da3mono-large"):
        build = lambda d: _monocular(dtype, d, **vit_kw)
    elif key == "da3nested-giant-large":
        cfg = dict(PRESETS["da3-giant"])
        vit = cfg.pop("vit")
        cfg["with_gs"] = cfg["with_gs"] if with_gs is None else with_gs
        build = lambda d: NestedDepthAnything3Net(
            anyview=_anyview(vit, dtype=dtype, device=d, **cfg, **vit_kw),
            metric=_monocular(dtype, d, **vit_kw),
        )
    elif key in PRESETS:
        cfg = dict(PRESETS[key])
        vit = cfg.pop("vit")
        cfg["with_gs"] = cfg.get("with_gs", False) if with_gs is None else with_gs
        build = lambda d: _anyview(vit, dtype=dtype, device=d, **cfg, **vit_kw)
    else:
        raise KeyError(f"unknown DA3 preset {name!r}; known: {MODEL_REGISTRY}")
    return materialize_(build(torch.device("meta")), dev, generator)


def materialize_(model: torch.nn.Module, device: torch.device, generator: Optional[torch.Generator] = None):
    """A DA3 module built on the meta device -> its parameters on ``device``
    with random weights from ``generator`` (default: seed 0 on ``device``),
    in eval mode; on ``meta`` it stays shapes only. On CUDA this turns TF32
    off for matmuls and cuDNN convolutions, so fp32 heads run in full fp32
    as in the JAX package."""
    if device.type == "meta":
        return model.eval()
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    model = model.to_empty(device=device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    init_parameters_(model, generator)
    return model.eval()
