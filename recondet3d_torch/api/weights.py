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

Upstream DA3 checkpoints (the port's copy of ``recondet3d/api/weights.py``
``convert_torch_state_dict`` and of the checkpoint lookup in
``recondet3d/api/depth_anything3.py``): ``find_checkpoint`` looks in a
cache directory, ``download_checkpoint`` asks the Hugging Face hub and
returns None when it cannot, ``load_safetensors`` reads the file with numpy
(the ``safetensors`` package is not needed), and ``load_da3_state_dict``
fills a DA3 module from upstream names. Those names pass through the JAX
package's normalisation (``_PREFIX_MAP`` / ``_REWRITES``) to a flax path
and back through ``torch_name``, so the two packages accept the same keys;
upstream torch layouts are the port's, so values are copied as they are.
``cast_trunk_params_bf16_`` is the counterpart of the JAX package's
serving-time cast.
"""

from __future__ import annotations

import json
import logging
import os
import re
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = ["state_dict_from_flax", "flax_from_named", "torch_name", "torch_layout_shape", "find_checkpoint",
           "download_checkpoint", "load_safetensors", "load_da3_state_dict",
           "cast_trunk_params_bf16_"]

logger = logging.getLogger("recondet3d_torch.weights")

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


# ---------------------------------------------------------------------------------------------------------------------
# upstream checkpoints

# upstream prefix -> flax prefix, and the rewrites inside a module (copies of the JAX package's tables)
_UPSTREAM_PREFIX_MAP = [
    ("da3.backbone.pretrained.", "anyview/net/"),
    ("da3.head.", "anyview/head/"),
    ("da3.cam_enc.", "anyview/cam_enc/"),
    ("da3.cam_dec.", "anyview/cam_dec/"),
    ("da3.gs_head.", "anyview/gs_head/"),
    ("da3_metric.backbone.pretrained.", "metric/net/"),
    ("da3_metric.head.", "metric/head/"),
    ("backbone.pretrained.", "net/"),
    ("pretrained.", ""),  # bare DinoV2 wrapper
    ("head.", "head/"),
    ("cam_enc.", "cam_enc/"),
    ("cam_dec.", "cam_dec/"),
    ("gs_head.", "gs_head/"),
]

_UPSTREAM_REWRITES = [
    (re.compile(r"(^|/)scratch\."), r"\1"),
    (re.compile(r"blocks\.(\d+)\."), r"blocks_\1/"),
    (re.compile(r"trunk\.(\d+)\."), r"trunk_\1/"),
    (re.compile(r"projects\.(\d+)\."), r"projects_\1/"),
    (re.compile(r"resize_layers\.(\d+)\."), r"resize_layers_\1/"),
    (re.compile(r"output_conv1_aux\.(\d+)\.(\d+)\."), r"output_conv1_aux_\1_\2/"),
    (re.compile(r"output_conv2_aux\.(\d+)\.0\."), r"output_conv2_aux_\1/conv_a/"),
    (re.compile(r"output_conv2_aux\.(\d+)\.2\."), r"output_conv2_aux_\1/ln/"),
    (re.compile(r"output_conv2_aux\.(\d+)\.5\."), r"output_conv2_aux_\1/conv_b/"),
    (re.compile(r"(sky_output_conv2|output_conv2)\.0\."), r"\1/conv_a/"),
    (re.compile(r"(sky_output_conv2|output_conv2)\.2\.(?=weight|bias)"), r"\1/ln_or_convb/"),
    (re.compile(r"(sky_output_conv2|output_conv2)\.4\."), r"\1/conv_b/"),
    (re.compile(r"(sky_output_conv2|output_conv2)\.5\."), r"\1/conv_b/"),
    (re.compile(r"images_merger\.(\d+)\."), r"images_merger_\1/"),
    (re.compile(r"backbone\.(\d+)\."), r"backbone_\1/"),
    (re.compile(r"fc_fov\.0\."), "fc_fov_0/"),
    (re.compile(r"\."), "/"),
]


def _flax_candidates(key: str, ndim: int) -> List[str]:
    """The flax paths an upstream key may name, in the JAX package's order
    of trial (``convert_torch_state_dict``)."""
    for pref, repl in _UPSTREAM_PREFIX_MAP:
        if key.startswith(pref):
            key = repl + key[len(pref):]
            break
    for pat, repl in _UPSTREAM_REWRITES:
        key = pat.sub(repl, key)
    # the '.2' slot is a LayerNorm when the head uses them, the final conv otherwise: the shape decides
    variants = [key.replace("ln_or_convb", "conv_b"), key.replace("ln_or_convb", "ln")] \
        if "ln_or_convb" in key else [key]
    out = []
    for k in variants:
        base, leaf = k.rsplit("/", 1) if "/" in k else ("", k)
        base = base + "/" if base else ""
        if leaf == "weight":
            out += [f"{base}scale", f"{base}LayerNorm_0/scale"] if ndim == 1 else [f"{base}kernel"]
        elif leaf == "bias":
            out += [f"{base}bias", f"{base}LayerNorm_0/bias"]
        else:
            out.append(k)
    return out


def load_da3_state_dict(module: torch.nn.Module, state_dict: Mapping[str, np.ndarray]):
    """Fill ``module`` (a DA3 net of the port) from an upstream-named state
    dict (numpy arrays or tensors). Returns (unused upstream keys, port
    state-dict entries left unfilled), as ``convert_torch_state_dict``
    returns its unused keys and unfilled flax paths. Values are cast to each
    entry's dtype and copied in place."""
    own = module.state_dict()
    filled: Dict[str, torch.Tensor] = {}
    unused: List[str] = []
    for key, val in state_dict.items():
        t = val if torch.is_tensor(val) else torch.from_numpy(np.ascontiguousarray(val))
        name = next((n for n in (torch_name(c) for c in _flax_candidates(key, t.ndim))
                     if n in own and n not in filled and tuple(own[n].shape) == tuple(t.shape)), None)
        if name is None:
            unused.append(key)
        else:
            filled[name] = t
    with torch.no_grad():
        for name, t in filled.items():
            own[name].copy_(t.to(own[name].dtype))
    return unused, [n for n in own if n not in filled]


_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64, "I32": np.int32,
              "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A safetensors file as numpy arrays, read with numpy: an 8-byte
    little-endian header length, a JSON header of dtype / shape / byte
    offsets, then the raw little-endian buffers. bf16 tensors come back as
    fp32 (numpy has no bf16; the widening is exact)."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = f.read()
    out: Dict[str, np.ndarray] = {}
    for key, info in header.items():
        if key == "__metadata__":
            continue
        lo, hi = info["data_offsets"]
        buf = data[lo:hi]
        if info["dtype"] == "BF16":
            arr = (np.frombuffer(buf, "<u2").astype(np.uint32) << 16).view(np.float32)
        elif info["dtype"] in _ST_DTYPES:
            arr = np.frombuffer(buf, np.dtype(_ST_DTYPES[info["dtype"]]).newbyteorder("<"))
        else:
            raise ValueError(f"{path}: tensor {key!r} has dtype {info['dtype']}, which this reader does not take")
        out[key] = arr.reshape(info["shape"]).astype(arr.dtype.newbyteorder("="))
    return out


def find_checkpoint(name: str, cache_dir: str) -> Optional[str]:
    """``model.safetensors`` of preset ``name`` under ``cache_dir``: the
    layouts ``<short>/model.safetensors``, ``<short>.safetensors`` and
    ``model.safetensors``, then a Hugging Face cache tree whose path names
    the model (``short`` is the last component of ``name``, lower case)."""
    short = name.split("/")[-1].lower()
    for c in (os.path.join(cache_dir, short, "model.safetensors"), os.path.join(cache_dir, f"{short}.safetensors"),
              os.path.join(cache_dir, "model.safetensors")):
        if os.path.exists(c):
            return c
    if os.path.isdir(cache_dir):
        for root, _, files in os.walk(cache_dir):
            if "model.safetensors" in files and short in root.lower():
                return os.path.join(root, "model.safetensors")
    return None


def download_checkpoint(repo_id: str, cache_dir: str) -> Optional[str]:
    """``model.safetensors`` of ``repo_id`` from the Hugging Face hub into
    ``cache_dir``; None when ``HF_HUB_OFFLINE`` is set (nothing is asked),
    when ``huggingface_hub`` is not installed, or when the download fails
    (no network, no such repository), so that the caller starts from random
    weights with a warning, as the JAX package does."""
    if os.environ.get("HF_HUB_OFFLINE", "") not in ("", "0"):
        return None
    try:
        from huggingface_hub import hf_hub_download
    except ImportError:
        return None
    try:
        return hf_hub_download(repo_id=repo_id, filename="model.safetensors", cache_dir=cache_dir)
    except Exception as e:  # offline / auth / 404
        logger.warning("HF hub download failed for %r: %s", repo_id, e)
        return None


_TRUNK_BF16 = re.compile(r"(^|\.)blocks\.\d+\.(attn\.(qkv|proj)|mlp|ls1|ls2)\.|(^|\.)patch_embed\.|"
                         r"(^|\.)(cls_token|camera_token)$")


def cast_trunk_params_bf16_(module: torch.nn.Module) -> List[str]:
    """Store the ViT trunks' fp32 parameters that their modules consume in
    bf16 (attention qkv / proj, MLP, LayerScale, patch embedding, cls and
    camera tokens) as bf16, in place; returns their names. LayerNorms,
    positional embeddings and the heads stay fp32.

    Precondition, as for the JAX package's ``cast_trunk_params_bf16``: the
    net computes in bf16 (``dtype=torch.bfloat16``); then every cast
    parameter is cast to bf16 on each forward anyway and the outputs are
    unchanged. On an fp32 net it loses precision."""
    cast = []
    for name, p in module.named_parameters():
        if p.dtype == torch.float32 and _TRUNK_BF16.search(name):
            p.data = p.data.to(torch.bfloat16)
            cast.append(name)
    return cast
