"""YAML preset registry (port of ``recondet3d/api/registry.py``): the
presets in ``models/da3/presets/*.yaml`` by name, and ``build_from_yaml``,
which builds the port's DA3 net a preset describes (the YAML files are the
JAX package's with their ``__object__`` paths on the port's classes).
Reading YAML needs PyYAML; nothing on the API's path reads it."""

from __future__ import annotations

import glob
import inspect
import os
from typing import Dict, Optional

import torch

__all__ = ["MODEL_REGISTRY", "get_all_models", "get_config_path", "build_from_yaml"]

_PRESET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "models", "da3", "presets")


def _scan() -> Dict[str, str]:
    return {os.path.splitext(os.path.basename(p))[0]: p for p in sorted(glob.glob(os.path.join(_PRESET_DIR, "*.yaml")))}


MODEL_REGISTRY: Dict[str, str] = _scan()


def get_all_models():
    return sorted(MODEL_REGISTRY)


def get_config_path(name: str) -> str:
    key = name.split("/")[-1].lower()
    if key not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {get_all_models()}")
    return MODEL_REGISTRY[key]


def _with_build_args(node, dtype):
    """The config with ``device="meta"`` (and the trunk's ``dtype``) added to
    every object whose constructor takes them."""
    if isinstance(node, dict):
        node = {k: _with_build_args(v, dtype) for k, v in node.items()}
        spec = node.get("__object__")
        if spec is not None:
            import importlib

            params = inspect.signature(getattr(importlib.import_module(spec["path"]), spec["name"])).parameters
            if "device" in params:
                node["device"] = "meta"
            if "dtype" in params:
                node["dtype"] = dtype
        return node
    return node


def build_from_yaml(name: str, dtype=torch.bfloat16, device="cuda", generator: Optional[torch.Generator] = None):
    """The port's DA3 net of a YAML preset, built as ``build_da3`` builds:
    on the meta device, then random weights from ``generator`` on ``device``
    (``"meta"``: shapes only)."""
    from recondet3d_torch.core.config import create_object, load_config
    from recondet3d_torch.models.da3.presets import materialize_
    from recondet3d_torch.utils.device import resolve_device

    dev = resolve_device(device)
    model = create_object(_with_build_args(dict(load_config(get_config_path(name))), dtype))
    return materialize_(model, dev, generator)
