"""Weight bridge between the JAX package's flax tree and the port.

The port's parameters carry the upstream DA3 torch state-dict names
(``da3.backbone.pretrained.blocks.3.attn.qkv.weight``,
``da3_metric.head.scratch.refinenet1.out_conv.weight``, ``ls1.gamma``,
``mlp.w12.weight``, ...), the names ``recondet3d/api/weights.py`` maps onto
the flax tree. This module holds the port's own copy of that mapping, run
backwards: ``state_dict_from_flax`` turns the flax parameters, flattened to
"/"-joined paths (``params/anyview/net/blocks_3/attn/qkv/kernel``), into a
state dict that the port's ``load_state_dict`` takes.

Layouts: Dense kernels (I, O) -> Linear weights (O, I); Conv kernels HWIO
-> OIHW; the strided deconvolutions keep the torch (I, O, k, k) layout the
JAX package already stores; fp32 LayerNorms lose their ``LayerNorm_0``
level and ``scale`` becomes ``weight``.

The refinement (``.../refinement/middle_encoder/...``,
``.../refinement/bev_height_occupancy/...``) keeps the flax module names.
Its leaves come from two flax collections, ``params`` and ``batch_stats``:
sparse kernels stay (K, Cin, Cout); ``nn.Conv`` kernels go HWIO -> OIHW;
a batch norm's ``scale`` / ``bias`` / ``mean`` / ``var`` become ``weight`` /
``bias`` / ``running_mean`` / ``running_var`` and lose their
``BatchNorm_0`` level. A whole ResDet3D tree
(``reconstruction_backbone/da3/...``, ``reconstruction_backbone/refinement/...``)
maps to the port's ``reconstruction_backbone.da3.`` and
``reconstruction_backbone.refinement.`` prefixes. The detection heads
(``pts_bbox_head/...``) keep the flax module names too, with the same
kernel layouts and batch-norm leaves; the CenterHead's ``task_<i>`` become
``branches.<i>``.

``flax_from_named`` runs the other way: named tensors of the port (its
parameters, their gradients, its batch statistics) come back under the
flax paths in the flax layouts, so that a test compares a gradient tree
with ``jax.grad``'s leaf by leaf.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Mapping, Tuple

import numpy as np
import torch

__all__ = ["state_dict_from_flax", "flax_from_named", "torch_name", "torch_layout_shape"]

# flax prefix -> torch prefix (the inverse of the JAX package's _PREFIX_MAP)
_PREFIXES = [
    ("anyview/net/", "da3.backbone.pretrained."),
    ("anyview/head/", "da3.head."),
    ("anyview/cam_enc/", "da3.cam_enc."),
    ("anyview/cam_dec/", "da3.cam_dec."),
    ("metric/net/", "da3_metric.backbone.pretrained."),
    ("metric/head/", "da3_metric.head."),
    ("net/", "backbone.pretrained."),
    ("head/", "head."),
    ("cam_enc/", "cam_enc."),
    ("cam_dec/", "cam_dec."),
]

# inside a module, applied in order to the rest of the path
_REWRITES = [
    (re.compile(r"/(LayerNorm|BatchNorm)_0/"), "/"),
    (re.compile(r"(^|/)blocks_(\d+)/"), r"\1blocks.\2/"),
    (re.compile(r"(^|/)trunk_(\d+)/"), r"\1trunk.\2/"),
    (re.compile(r"(^|/)projects_(\d+)/"), r"\1projects.\2/"),
    (re.compile(r"(^|/)resize_layers_(\d+)/"), r"\1resize_layers.\2/"),
    (re.compile(r"(^|/)output_conv1_aux_(\d+)_(\d+)/"), r"\1scratch.output_conv1_aux.\2.\3/"),
    (re.compile(r"(^|/)output_conv2_aux_(\d+)/conv_a/"), r"\1scratch.output_conv2_aux.\2.0/"),
    (re.compile(r"(^|/)output_conv2_aux_(\d+)/ln/"), r"\1scratch.output_conv2_aux.\2.2/"),
    (re.compile(r"(^|/)output_conv2_aux_(\d+)/conv_b/"), r"\1scratch.output_conv2_aux.\2.5/"),
    (re.compile(r"(^|/)(sky_output_conv2|output_conv2)/conv_a/"), r"\1scratch.\2.0/"),
    (re.compile(r"(^|/)(sky_output_conv2|output_conv2)/conv_b/"), r"\1scratch.\2.2/"),
    (re.compile(r"(^|/)(layer\d_rn|refinenet\d(?:_aux)?|output_conv1)/"), r"\1scratch.\2/"),
    (re.compile(r"(^|/)backbone_(\d+)/"), r"\1backbone.\2/"),
    (re.compile(r"(^|/)fc_fov_0/"), r"\1fc_fov.0/"),
    (re.compile(r"(^|/)task_(\d+)/"), r"\1branches.\2/"),  # CenterHead's per-task branches
]

_LEAVES = {"kernel": "weight", "scale": "weight", "mean": "running_mean", "var": "running_var"}
_COLLECTIONS = ("params/", "batch_stats/")
_BACKBONE_DA3 = "reconstruction_backbone/da3/"
_DECONV = re.compile(r"(^|\.)resize_layers\.[01]\.weight$")


def _strip_collection(path: str) -> str:
    for coll in _COLLECTIONS:
        if path.startswith(coll):
            return path[len(coll):]
    return path


def _split_prefix(path: str) -> Tuple[str, str]:
    path = _strip_collection(path)
    for flax_pref, torch_pref in _PREFIXES:
        if path.startswith(flax_pref):
            return torch_pref, path[len(flax_pref):]
    return "", path


def torch_name(path: str) -> str:
    """'params/anyview/net/blocks_3/attn/qkv/kernel' ->
    'da3.backbone.pretrained.blocks.3.attn.qkv.weight';
    'batch_stats/reconstruction_backbone/refinement/middle_encoder/conv_input_norm/mean' ->
    'reconstruction_backbone.refinement.middle_encoder.conv_input_norm.running_mean'."""
    path = _strip_collection(path)
    if path.startswith(_BACKBONE_DA3):
        return "reconstruction_backbone.da3." + torch_name(path[len(_BACKBONE_DA3):])
    prefix, rest = _split_prefix(path)
    rest = "/" + rest
    for pat, repl in _REWRITES:
        rest = pat.sub(repl, rest)
    *mods, leaf = rest.lstrip("/").split("/")
    return prefix + ".".join(mods + [_LEAVES.get(leaf, leaf)])


def _is_kernel(path: str) -> bool:
    return path.rsplit("/", 1)[-1] == "kernel"


def torch_layout_shape(path: str, shape) -> Tuple[int, ...]:
    """Shape of the torch parameter for the flax leaf ``path`` of ``shape``."""
    shape = tuple(shape)
    if _is_kernel(path) and len(shape) == 2:
        return shape[::-1]
    if _is_kernel(path) and len(shape) == 4 and not _DECONV.search(torch_name(path)):
        h, w, i, o = shape
        return (o, i, h, w)
    return shape


def _to_torch_layout(path: str, arr: np.ndarray) -> np.ndarray:
    if _is_kernel(path) and arr.ndim == 2:
        return arr.T
    if _is_kernel(path) and arr.ndim == 4 and not _DECONV.search(torch_name(path)):
        return np.transpose(arr, (3, 2, 0, 1))
    return arr


def state_dict_from_flax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flattened flax variables ("/"-joined paths, the ``params`` and, for
    the refinement's norms, the ``batch_stats`` collection) -> port state
    dict (fp32 CPU tensors; ``load_state_dict`` casts and moves them)."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in flat.items():
        name = torch_name(path)
        if name in out:
            raise ValueError(f"two flax leaves map to {name!r} (second: {path!r})")
        a = _to_torch_layout(path, np.asarray(arr, dtype=np.float32))
        out[name] = torch.from_numpy(np.array(a, order="C"))  # a writable copy
    return out


def flax_from_named(named: Mapping[str, torch.Tensor], flax_paths: Iterable[str]) -> Dict[str, np.ndarray]:
    """The inverse of ``state_dict_from_flax``: for every flax path
    ("/"-joined, with its collection) the port's tensor of that leaf from
    ``named`` (a state dict, or {name: parameter.grad}), as fp32 numpy in
    the flax layout. A path whose tensor is missing or None (a parameter
    that received no gradient) is left out."""
    out: Dict[str, np.ndarray] = {}
    for path in flax_paths:
        t = named.get(torch_name(path))
        if t is None:
            continue
        a = t.detach().float().cpu().numpy()
        if _is_kernel(path) and a.ndim == 2:
            a = a.T
        elif _is_kernel(path) and a.ndim == 4 and not _DECONV.search(torch_name(path)):
            a = np.transpose(a, (2, 3, 1, 0))  # OIHW -> HWIO
        out[path] = np.ascontiguousarray(a)
    return out
