"""Config-driven model building (port of ``build_model_from_cfg`` in
``recondet3d/cli/train.py``). The rest of the training CLI (argument
parsing, the data iterator, the run loop) is not ported yet.

    from recondet3d_torch.core.config import load_py_config
    from recondet3d_torch.cli.train import build_model_from_cfg
    model = build_model_from_cfg(load_py_config("configs/resdet3d_centerhead.py"), device="cuda")

Every shipped ``configs/*.py`` builds. Weights are random, drawn from
``generator``: no checkpoint is in the repository, and the JAX CLI too
starts from random weights when it finds none.
"""

from __future__ import annotations

from typing import Optional

import torch

from recondet3d_torch.utils.device import resolve_device

__all__ = ["build_model_from_cfg"]

_REF_TUPLES = ("point_cloud_range", "voxel_size", "occ_feature_shape", "sparse_shape", "unet_channels", "stage_caps",
               "soft_vfe")
_REF_INTS = ("max_num_points", "max_voxels", "occ_max_voxels", "occ_max_num_points", "encoder_out_channels")
# fields the JAX modules declare and never read (SparseRefinement.loss_weight,
# ReconstructionBackbone.gt_num_points): accepted and dropped
_REF_UNREAD = ("loss_weight",)
_BK_CASTS = (("process_res", int), ("num_points", int), ("bq_anchor_points", int), ("bq_sample_num", int),
             ("max_depth", float), ("bq_max_radius", float), ("voxel_pre_reduce", float), ("pre_reduce_cap", int),
             ("ref_view_strategy", str), ("use_ray_pose", bool), ("freeze_da3", bool))
_BK_KNOWN = {"type", "pretrained", "cache_dir", "refinement", "filter_range", "gt_num_points"}
_BK_KNOWN |= {k for k, _ in _BK_CASTS}


def build_model_from_cfg(cfg, device="cuda", generator: Optional[torch.Generator] = None):
    """A ``ResDet3D`` from a loaded config (``load_py_config``), in eval
    mode, with random weights from ``generator`` (default: seed 0 on
    ``device``; ``device="meta"`` builds shapes only).

    ``compute_dtype`` (default bfloat16) is the compute dtype of DA3's trunk
    and of the refinement; ``reconstruction_backbone.freeze_da3=False``
    builds DA3 for fine-tuning (fp32 master parameters, blocks under
    activation checkpointing). Unknown refinement, backbone or head keys
    raise ValueError, as in the JAX package."""
    from recondet3d_torch.models.da3 import build_da3
    from recondet3d_torch.models.detect import ReconstructionBackbone, ResDet3D
    from recondet3d_torch.models.detect.centerhead import CenterHead, init_head_parameters_
    from recondet3d_torch.models.refine.refinement import SparseRefinement, init_refinement_parameters_

    dev = resolve_device(device)
    draw = dev.type != "meta"
    if generator is None and draw:
        generator = torch.Generator(device=dev).manual_seed(0)
    m = cfg["model"]
    rb = m["reconstruction_backbone"]
    dtype = getattr(torch, str(cfg.get("compute_dtype", "bfloat16")))
    freeze = bool(rb.get("freeze_da3", True))

    ref_cfg = dict(rb.get("refinement", {}) or {})
    ref_cfg.pop("type", None)
    ref_kwargs = {}
    for keys, cast in ((_REF_TUPLES, tuple), (_REF_INTS, int), (("loss_type",), str),
                       (("occupancy_loss_weight",), float), (("use_color",), bool)):
        for key in keys:
            if key in ref_cfg:
                ref_kwargs[key] = cast(ref_cfg.pop(key))
    for key in _REF_UNREAD:
        ref_cfg.pop(key, None)
    if ref_cfg:  # typo'd or unsupported keys must not silently fall to defaults
        raise ValueError(f"unknown refinement config keys {sorted(ref_cfg)} — supported keys are the "
                         "SparseRefinement constructor arguments")
    ref_kwargs.setdefault("stage_caps", (40960, 32768, 24576, 16384))
    ref_kwargs.setdefault("max_voxels", 40960)

    bk_kwargs = {key: cast(rb[key]) for key, cast in _BK_CASTS if key in rb}
    if "filter_range" in rb:
        bk_kwargs["filter_range"] = tuple(rb["filter_range"])
    unknown_rb = set(rb) - _BK_KNOWN
    if unknown_rb:
        raise ValueError(f"unknown reconstruction_backbone config keys {sorted(unknown_rb)}")

    head_cfg = dict(m.get("pts_bbox_head") or {})
    if head_cfg:
        kind = head_cfg.pop("type", "CenterHead")
        if kind != "CenterHead":
            raise ValueError(f"unsupported pts_bbox_head type {kind!r}")
        for key in ("point_cloud_range", "voxel_size", "code_weights"):
            if key in head_cfg:
                head_cfg[key] = tuple(head_cfg[key])
        if "tasks" in head_cfg:
            head_cfg["tasks"] = tuple(tuple(t) for t in head_cfg["tasks"])

    tuned = {} if freeze else dict(param_dtype=torch.float32, remat=True)
    da3 = build_da3(rb.get("pretrained", "da3-large"), dtype=dtype, device=dev, generator=generator, **tuned)
    refinement = SparseRefinement(dtype=dtype, device=dev, **ref_kwargs)
    head = None
    if head_cfg:
        # the flax head infers its input width from the BEV features and never reads ``in_channels`` (the tiny
        # config's 32 meets 16-channel features there); a torch convolution needs it, so it is the refinement's
        head_cfg["in_channels"] = refinement.middle_encoder.bev_channels
        head = CenterHead(device=dev, **head_cfg)
    if draw:
        init_refinement_parameters_(refinement, generator)
        if head is not None:
            init_head_parameters_(head, generator)
    backbone = ReconstructionBackbone(da3=da3, refinement=refinement, **bk_kwargs)
    class_names = tuple(cfg.get("class_names") or ())
    return ResDet3D(reconstruction_backbone=backbone, pts_bbox_head=head, class_names=class_names).eval()
