"""The reference model: ResDet3D assembled from the frozen plain modules of
this folder, with the parameter names of the program's model, so that one
state made by the benchmark loads into both.

``build(cfg, device)`` reads the configuration file's ``model`` dict as the
program's config function reads it, and leaves parameters and buffers
uninitialised (``weights.make_weights_`` fills both). Heads, norms and
logits are fp32; the ViT trunks and the refinement compute in
``compute_dtype``.
"""

from __future__ import annotations

import torch

from benchmark.reference.cam import CameraDec, CameraEnc
from benchmark.reference.centerhead import CenterHead
from benchmark.reference.dpt import DPT, DualDPT
from benchmark.reference.net import DepthAnything3Net, NestedDepthAnything3Net
from benchmark.reference.reconstruction_backbone import ReconstructionBackbone
from benchmark.reference.refinement import SparseRefinement
from benchmark.reference.resdet3d import ResDet3D
from benchmark.reference.vit import DinoViT

__all__ = ["build"]

ANYVIEW = {
    "da3-small": dict(vit="vits", out_layers=(5, 7, 9, 11), alt_start=4, head_dim_in=768, features=64,
                      out_channels=(48, 96, 192, 384), cam_dim=384),
    "da3-large": dict(vit="vitl", out_layers=(11, 15, 19, 23), alt_start=8, head_dim_in=2048, features=256,
                      out_channels=(256, 512, 1024, 1024), cam_dim=1024),
    "da3-giant": dict(vit="vitg", out_layers=(19, 27, 33, 39), alt_start=13, head_dim_in=3072, features=256,
                      out_channels=(256, 512, 1024, 1024), cam_dim=1536),
}
_REF_TUPLES = ("point_cloud_range", "voxel_size", "occ_feature_shape", "sparse_shape", "unet_channels",
               "stage_caps", "soft_vfe")
_BK_KEYS = ("process_res", "num_points", "gt_num_points", "bq_anchor_points", "bq_sample_num", "max_depth",
            "bq_max_radius", "voxel_pre_reduce", "pre_reduce_cap", "ref_view_strategy", "use_ray_pose")


def _anyview(preset, dtype, device):
    c = ANYVIEW[preset]
    net = DinoViT(name_preset=c["vit"], out_layers=c["out_layers"], alt_start=c["alt_start"],
                  qknorm_start=c["alt_start"], rope_start=c["alt_start"], cat_token=True, dtype=dtype, device=device)
    head = DualDPT(dim_in=c["head_dim_in"], output_dim=2, features=c["features"], out_channels=c["out_channels"],
                   device=device)
    return DepthAnything3Net(net=net, head=head, cam_enc=CameraEnc(dim_out=c["cam_dim"], device=device),
                             cam_dec=CameraDec(dim_in=c["head_dim_in"], device=device))


def _metric(dtype, device):
    net = DinoViT(name_preset="vitl", out_layers=(4, 11, 17, 23), alt_start=-1, qknorm_start=-1, rope_start=-1,
                  cat_token=False, dtype=dtype, device=device)
    head = DPT(dim_in=1024, output_dim=1, features=256, out_channels=(256, 512, 1024, 1024), device=device)
    return DepthAnything3Net(net=net, head=head)


def _da3(name, dtype, device):
    key = name.split("/")[-1].lower()
    if key == "da3nested-giant-large":
        return NestedDepthAnything3Net(anyview=_anyview("da3-giant", dtype, device), metric=_metric(dtype, device))
    return _anyview(key, dtype, device)


def build(cfg: dict, device) -> ResDet3D:
    """The reference ResDet3D of a configuration file's contents, on the meta
    device's shapes moved to ``device`` with no values set, in eval mode."""
    device = torch.device(device)
    meta = torch.device("meta")
    dtype = getattr(torch, cfg.get("compute_dtype", "bfloat16"))
    rb = cfg["model"]["reconstruction_backbone"]
    ref_kwargs = {k: (tuple(v) if k in _REF_TUPLES else v) for k, v in rb["refinement"].items() if k != "type"}
    refinement = SparseRefinement(dtype=dtype, device=meta, **ref_kwargs)
    head = None
    head_cfg = dict(cfg["model"].get("pts_bbox_head") or {})
    if head_cfg:
        head_cfg.pop("type")
        for key in ("point_cloud_range", "voxel_size", "code_weights"):
            if key in head_cfg:
                head_cfg[key] = tuple(head_cfg[key])
        head_cfg["tasks"] = tuple(tuple(t) for t in head_cfg["tasks"])
        head_cfg["in_channels"] = refinement.middle_encoder.bev_channels
        head = CenterHead(device=meta, **head_cfg)
    bk = {k: rb[k] for k in _BK_KEYS if k in rb}
    if "filter_range" in rb:
        bk["filter_range"] = tuple(rb["filter_range"])
    backbone = ReconstructionBackbone(da3=_da3(rb["pretrained"], dtype, meta), refinement=refinement,
                                      freeze_da3=bool(rb.get("freeze_da3", True)), **bk)
    model = ResDet3D(reconstruction_backbone=backbone, pts_bbox_head=head,
                     class_names=tuple(cfg.get("class_names") or ()))
    return model.to_empty(device=device).eval()
