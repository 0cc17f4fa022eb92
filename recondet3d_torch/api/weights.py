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
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["state_dict_from_flax", "torch_name", "torch_layout_shape"]

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
    (re.compile(r"/LayerNorm_0/"), "/"),
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
]

_LEAVES = {"kernel": "weight", "scale": "weight"}
_DECONV = re.compile(r"(^|\.)resize_layers\.[01]\.weight$")


def _split_prefix(path: str) -> Tuple[str, str]:
    if path.startswith("params/"):
        path = path[len("params/"):]
    for flax_pref, torch_pref in _PREFIXES:
        if path.startswith(flax_pref):
            return torch_pref, path[len(flax_pref):]
    return "", path


def torch_name(path: str) -> str:
    """'params/anyview/net/blocks_3/attn/qkv/kernel' ->
    'da3.backbone.pretrained.blocks.3.attn.qkv.weight'."""
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
    """Flattened flax parameters ("/"-joined paths) -> port state dict (fp32
    CPU tensors; ``load_state_dict`` casts and moves them)."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in flat.items():
        name = torch_name(path)
        if name in out:
            raise ValueError(f"two flax leaves map to {name!r} (second: {path!r})")
        a = _to_torch_layout(path, np.asarray(arr, dtype=np.float32))
        out[name] = torch.from_numpy(np.array(a, order="C"))  # a writable copy
    return out
