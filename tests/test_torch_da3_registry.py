"""The port's YAML presets (``recondet3d_torch/api/registry.py``) against
the code-built nets and the JAX package's YAML files, on the meta device
(shapes only, no weights): as tests/test_configs.py holds the JAX package's
``build_from_yaml`` to its ``build_da3``."""

import os

import pytest
import torch

from recondet3d_torch.api.registry import build_from_yaml, get_all_models, get_config_path
from recondet3d_torch.models.da3.dpt import DPT
from recondet3d_torch.models.da3.net import NestedDepthAnything3Net
from recondet3d_torch.models.da3.presets import MODEL_REGISTRY, build_da3

JAX_PRESETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "recondet3d", "models", "da3",
                           "presets")


def _layout(model):
    return {k: (tuple(v.shape), v.dtype) for k, v in model.state_dict().items()}


@pytest.mark.parametrize("name", MODEL_REGISTRY)
def test_yaml_preset_builds_the_code_built_net(name):
    """Same module tree, parameter names, shapes and dtypes as ``build_da3``."""
    assert name in get_all_models()
    y, c = build_from_yaml(name, device="meta"), build_da3(name, device="meta")
    assert type(y) is type(c) and repr(y) == repr(c)
    assert _layout(y) == _layout(c)


def test_yaml_files_are_the_jax_packages():
    """Each YAML is the JAX package's with its ``__object__`` paths on the
    port's modules."""
    names = sorted(f for f in os.listdir(JAX_PRESETS) if f.endswith(".yaml"))
    assert sorted(n[:-5] for n in names) == get_all_models()
    for f in names:
        with open(os.path.join(JAX_PRESETS, f)) as fj, open(get_config_path(f[:-5])) as ft:
            assert ft.read() == fj.read().replace("recondet3d.", "recondet3d_torch."), f


def test_yaml_inheritance():
    """da3nested-giant-large composes giant + metric-large through nested
    ``__inherit__``; da3-small-mono is da3-small with the metric DPT head."""
    m = build_from_yaml("depth-anything/DA3NESTED-GIANT-LARGE", device="meta")
    assert isinstance(m, NestedDepthAnything3Net)
    assert m.da3.gs_head is not None and m.da3.gs_adapter is not None
    assert len(m.da3.backbone.pretrained.blocks) == 40 and m.da3.backbone.pretrained.embed_dim == 1536
    assert len(m.da3_metric.backbone.pretrained.blocks) == 24 and m.da3_metric.backbone.pretrained.alt_start == -1
    mono, small = build_from_yaml("da3-small-mono", device="meta"), build_da3("da3-small", device="meta")
    assert isinstance(mono.head, DPT) and mono.head.output_dim == 1
    assert _layout(mono.backbone) == _layout(small.backbone) and _layout(mono.cam_enc) == _layout(small.cam_enc)


def test_yaml_build_draws_build_da3s_weights():
    """Materialised on the CPU from the same generator, both builds hold the
    same weights."""
    y = build_from_yaml("da3-small", dtype=torch.float32, device="cpu", generator=torch.Generator().manual_seed(3))
    c = build_da3("da3-small", dtype=torch.float32, device="cpu", generator=torch.Generator().manual_seed(3))
    for k, v in c.state_dict().items():
        assert torch.equal(y.state_dict()[k], v), k
