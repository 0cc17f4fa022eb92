"""Config system: YAML files with inheritance and reflective instantiation.

Provides the same capabilities as the reference's OmegaConf-based config
loader (reference: depth_anything_3/cfg.py:31-128 — ``load_config`` with
``__inherit__`` chains and ``__object__.{path,name,args}`` reflective
instantiation) plus the mmcv-style python/dict config with dotted overrides
used by the training configs (reference: tools/train_mmdet3d.py:143-169).

Implemented from scratch on top of PyYAML — no OmegaConf dependency.

The port's own copy of ``recondet3d/core/config.py`` (the port imports
nothing of the JAX package). PyYAML is imported where a YAML file is read,
so the python configs load where it is absent.
"""

from __future__ import annotations

import copy
import importlib
import os
import re
from typing import Any, Dict, Optional

__all__ = [
    "ConfigDict",
    "load_config",
    "resolve_inheritance",
    "create_object",
    "merge_dicts",
    "apply_overrides",
    "parse_cli_overrides",
    "load_py_config",
]


class ConfigDict(dict):
    """A dict with attribute access (replacement for addict.Dict / DictConfig)."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __delattr__(self, key: str) -> None:
        try:
            del self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    @classmethod
    def wrap(cls, obj: Any) -> Any:
        if isinstance(obj, dict):
            return cls({k: cls.wrap(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            return type(obj)(cls.wrap(v) for v in obj)
        return obj

    def to_dict(self) -> dict:
        def unwrap(o):
            if isinstance(o, dict):
                return {k: unwrap(v) for k, v in o.items()}
            if isinstance(o, (list, tuple)):
                return type(o)(unwrap(v) for v in o)
            return o

        return unwrap(self)


def merge_dicts(base: dict, override: dict) -> dict:
    """Deep-merge ``override`` into ``base`` (override wins), returning a new dict."""
    out = copy.deepcopy(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_dicts(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


_EVAL_RE = re.compile(r"^\$\{eval:(.*)\}$")


def _resolve_eval(node: Any) -> Any:
    """Resolve ``${eval:...}`` string values (arithmetic only, no builtins)."""
    if isinstance(node, dict):
        return {k: _resolve_eval(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_eval(v) for v in node]
    if isinstance(node, str):
        m = _EVAL_RE.match(node.strip())
        if m:
            return eval(m.group(1), {"__builtins__": {}}, {})  # noqa: S307
    return node


def resolve_inheritance(cfg: dict, base_dir: str) -> dict:
    """Resolve ``__inherit__`` chains: value is a path (or list of paths)
    relative to ``base_dir``; parents are merged in order, child wins.
    ``__inherit__`` may appear at any nested node (the reference uses this
    to compose da3nested-giant-large.yaml from the giant + metric-large
    presets — configs/da3nested-giant-large.yaml)."""
    inherit = cfg.pop("__inherit__", None)
    if inherit is not None:
        import yaml

        parents = inherit if isinstance(inherit, list) else [inherit]
        merged: dict = {}
        for parent in parents:
            ppath = parent if os.path.isabs(parent) else os.path.join(base_dir, parent)
            with open(ppath) as f:
                pcfg = yaml.safe_load(f) or {}
            pcfg = resolve_inheritance(pcfg, os.path.dirname(ppath))
            merged = merge_dicts(merged, pcfg)
        cfg = merge_dicts(merged, cfg)
    for k, v in list(cfg.items()):
        if isinstance(v, dict):
            cfg[k] = resolve_inheritance(v, base_dir)
    return cfg


def load_config(path: str) -> ConfigDict:
    """Load a YAML config file, resolving inheritance and eval expressions."""
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    cfg = resolve_inheritance(cfg, os.path.dirname(os.path.abspath(path)))
    cfg = _resolve_eval(cfg)
    return ConfigDict.wrap(cfg)


def create_object(cfg: dict, **extra_kwargs: Any) -> Any:
    """Reflectively instantiate the object described by ``cfg['__object__']``.

    ``__object__`` holds ``path`` (module), ``name`` (attribute) and ``args``:
    ``as_params`` passes the sibling keys as kwargs (recursively leaving
    nested ``__object__`` dicts as plain dicts for the constructor to build).
    """
    if "__object__" not in cfg:
        raise ValueError("create_object requires an '__object__' key")
    spec = cfg["__object__"]
    module = importlib.import_module(spec["path"])
    cls = getattr(module, spec["name"])
    args_mode = spec.get("args", "as_params")
    if args_mode == "as_params":
        kwargs = {}
        for k, v in cfg.items():
            if k == "__object__":
                continue
            # nested reflective configs instantiate depth-first (the
            # reference defers this into each constructor via _wrap_cfg;
            # doing it here keeps constructors config-free)
            if isinstance(v, dict) and "__object__" in v:
                v = create_object(v)
            elif isinstance(v, list):
                v = tuple(v)
            kwargs[k] = v
        kwargs.update(extra_kwargs)
        return cls(**kwargs)
    raise ValueError(f"Unsupported __object__.args mode: {args_mode!r}")


def _set_dotted(cfg: dict, dotted_key: str, value: Any) -> None:
    parts = dotted_key.split(".")
    node = cfg
    for p in parts[:-1]:
        if p not in node or not isinstance(node[p], dict):
            node[p] = {}
        node = node[p]
    node[parts[-1]] = value


def _parse_override_value(v: Any) -> Any:
    """Typed parse of a CLI override value: python literals (bools, ints,
    floats, tuples/lists, None) via literal_eval, anything else stays a
    string (paths etc.)."""
    if not isinstance(v, str):
        return v
    import ast

    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def parse_cli_overrides(pairs) -> Dict[str, Any]:
    """['a.b=1', 'c=x'] -> {'a.b': 1, 'c': 'x'} with typed values (the
    mmcv DictAction contract; shared by the train/test/inference CLIs)."""
    out: Dict[str, Any] = {}
    for kv in pairs or []:
        if "=" not in kv:
            raise ValueError(f"--cfg-options entry {kv!r} must be key=value")
        k, v = kv.split("=", 1)
        out[k] = _parse_override_value(v)
    return out


def apply_overrides(cfg: dict, overrides: Dict[str, Any]) -> dict:
    """Apply dotted-key overrides in place. Values are used as-is: string
    parsing (``ast.literal_eval``) happens only at the CLI boundary in
    :func:`parse_cli_overrides`, so programmatic callers keep exact types
    (a deliberate string ``'None'`` stays a string here)."""
    for k, v in overrides.items():
        _set_dotted(cfg, k, v)
    return cfg


def load_py_config(path: str, overrides: Optional[Dict[str, Any]] = None) -> ConfigDict:
    """Load a python config file (mmcv-style: module-level names become keys)."""
    namespace: Dict[str, Any] = {"__file__": os.path.abspath(path)}
    with open(path) as f:
        code = f.read()
    exec(compile(code, path, "exec"), namespace)  # noqa: S102
    namespace.pop("__file__", None)
    cfg = {
        k: v
        for k, v in namespace.items()
        if not k.startswith("__") and not callable(v) and not isinstance(v, type(os))
    }
    if overrides:
        apply_overrides(cfg, overrides)
    return ConfigDict.wrap(cfg)
