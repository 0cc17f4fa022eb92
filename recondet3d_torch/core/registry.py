"""Registries binding config dicts to classes.

Plays the role of the mmcv registry pattern the reference uses to wire
ResDet3D from python configs (reference: projects/mmdet3d_plugin/__init__.py
registers DETECTORS/BACKBONES/PIPELINES/LOSSES/VOXEL_ENCODERS/
MIDDLE_ENCODERS via import side effects). Here registries are plain
dictionaries populated by the ``@REGISTRY.register()`` decorator, and
``build()`` instantiates from a ``dict(type=..., **kwargs)`` config.

The port's own copy of ``recondet3d/core/registry.py``: its registries hold
the port's classes.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Type

__all__ = [
    "Registry",
    "DETECTORS",
    "BACKBONES",
    "MIDDLE_ENCODERS",
    "VOXEL_ENCODERS",
    "LOSSES",
    "PIPELINES",
    "DATASETS",
    "HOOKS",
    "ASSIGNERS",
    "BBOX_CODERS",
    "MATCH_COSTS",
]


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._modules: Dict[str, Type] = {}

    def register(self, name: Optional[str] = None) -> Callable[[Type], Type]:
        def deco(cls: Type) -> Type:
            key = name or cls.__name__
            if key in self._modules and self._modules[key] is not cls:
                raise KeyError(f"{key!r} already registered in {self.name}")
            self._modules[key] = cls
            return cls

        return deco

    def get(self, key: str) -> Type:
        if key not in self._modules:
            raise KeyError(
                f"{key!r} is not registered in {self.name}; "
                f"available: {sorted(self._modules)}"
            )
        return self._modules[key]

    def build(self, cfg: dict, **extra: Any) -> Any:
        if cfg is None:
            return None
        cfg = dict(cfg)
        cls = self.get(cfg.pop("type"))
        cfg.update(extra)
        return cls(**cfg)

    def __contains__(self, key: str) -> bool:
        return key in self._modules

    def keys(self):
        return self._modules.keys()


DETECTORS = Registry("detectors")
BACKBONES = Registry("backbones")
MIDDLE_ENCODERS = Registry("middle_encoders")
VOXEL_ENCODERS = Registry("voxel_encoders")
LOSSES = Registry("losses")
PIPELINES = Registry("pipelines")
DATASETS = Registry("datasets")
HOOKS = Registry("hooks")
ASSIGNERS = Registry("assigners")
BBOX_CODERS = Registry("bbox_coders")
MATCH_COSTS = Registry("match_costs")
