"""The weight bridge (``recondet3d_torch/api/weights.py``) and the port's
isolation from JAX.

- round trip: JAX init -> ``state_dict_from_flax`` -> port
  ``load_state_dict(strict=True)`` -> the JAX package's
  ``convert_torch_state_dict`` gives back bit-equal leaves, nothing unfilled;
- full-scale layout: the port built on the meta device against the JAX tree
  from ``jax.eval_shape``, with zero unused and zero unfilled keys;
- isolation: importing every port module and ``chip_smoke.py`` loads no
  ``jax*`` and no ``recondet3d.*`` module, and ``build_da3()`` without
  ``device=`` raises where CUDA is absent.

The other port parity tests take their shared helpers from here:
``random_flax_params`` (numpy-made weights for a flax tree) and
``load_into_port`` (those weights into the port through the bridge).
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recondet3d.api.weights import _flatten, convert_torch_state_dict
from recondet3d.models.da3 import DPT as JDPT, DepthAnything3Net as JNet, DinoViT as JDinoViT
from recondet3d.models.da3 import NestedDepthAnything3Net as JNested, build_da3 as j_build
from recondet3d.models.da3.presets import _anyview as j_anyview
from recondet3d_torch.api.weights import state_dict_from_flax, torch_layout_shape, torch_name
from recondet3d_torch.models.da3 import DPT, DepthAnything3Net, DinoViT, NestedDepthAnything3Net, build_da3
from recondet3d_torch.models.da3.presets import _anyview


def random_flax_params(abstract, seed):
    """Fill a flax parameter tree of ``jax.ShapeDtypeStruct`` leaves (from
    ``jax.eval_shape(model.init, ...)``) with float32 numpy values: kernels
    N(0, 1/fan_in), LayerNorm scales and LayerScale gammas near 1, small
    random biases and tokens."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(path[-1].key)
        joined = "/".join(str(p.key) for p in path)
        shape = tuple(x.shape)
        z = rng.standard_normal(shape).astype(np.float32)
        if name == "kernel":
            fan_in = shape[0] if "resize_layers_0" in joined or "resize_layers_1" in joined else int(np.prod(shape[:-1]))
            return z / np.sqrt(fan_in)
        if name in ("scale", "gamma"):
            return 1.0 + 0.1 * z
        if name == "camera_token":
            return z
        return 0.05 * z

    return jax.tree_util.tree_map_with_path(leaf, abstract)


def load_into_port(model, params):
    """Flax params -> the port model via ``state_dict_from_flax`` (strict)."""
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    model.load_state_dict(state_dict_from_flax(flat), strict=True)
    return model.eval()


def to_np(t):
    return t.detach().cpu().numpy()


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(out_layers=(5, 7, 9, 11), alt_start=4, head_dim_in=768, features=64,
             out_channels=(48, 96, 192, 384), cam_dim=384)
METRIC_VIT = dict(name_preset="vits", out_layers=(2, 5, 8, 11), alt_start=-1, qknorm_start=-1, rope_start=-1,
                  cat_token=False)
METRIC_HEAD = dict(dim_in=384, output_dim=1, features=64, out_channels=(48, 96, 192, 384))


def _poses():
    ext = jnp.broadcast_to(jnp.eye(4)[None, None], (1, 2, 4, 4))
    ixt = jnp.broadcast_to(jnp.eye(3)[None, None] * 20.0, (1, 2, 3, 3))
    return ext, ixt


def test_bridge_round_trip_is_bit_exact():
    """A nested net of small trunks covers every prefix (da3., da3_metric.)
    and every module kind of the heads and camera modules."""
    jnet = JNested(anyview=j_anyview("vits", dtype=jnp.float32, attn_impl="xla", **SMALL),
                   metric=JNet(net=JDinoViT(dtype=jnp.float32, attn_impl="xla", **METRIC_VIT),
                               head=JDPT(**METRIC_HEAD)))
    params = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, 2, 28, 28, 3)), *_poses())
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}

    tnet = NestedDepthAnything3Net(
        anyview=_anyview("vits", dtype=torch.float32, device="cpu", **SMALL),
        metric=DepthAnything3Net(net=DinoViT(device="cpu", **METRIC_VIT), head=DPT(device="cpu", **METRIC_HEAD)))
    tnet.load_state_dict(state_dict_from_flax(flat), strict=True)

    back_sd = {k: v.numpy() for k, v in tnet.state_dict().items()}
    back, unused, unfilled = convert_torch_state_dict(back_sd, params)
    assert not unused and not unfilled, (unused[:5], unfilled[:5])
    back_flat = _flatten(back)
    assert set(back_flat) == set(flat)
    for k, v in flat.items():
        assert np.array_equal(np.asarray(back_flat[k]), v), k


@pytest.mark.parametrize("name", ["da3nested-giant-large", "da3-small", "da3metric-large"])
def test_full_scale_layout_matches_jax(name):
    jnet = j_build(name, dtype=jnp.bfloat16, attn_impl="xla", with_gs=False)
    args = (jnp.zeros((1, 2, 28, 28, 3)),)
    if name != "da3metric-large":
        args += _poses()
    abstract = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), *args)
    jax_side = {}
    for path, leaf in _flatten(abstract).items():
        jax_side[torch_name(path)] = torch_layout_shape(path, leaf.shape)

    port = build_da3(name, device="meta", with_gs=False)  # as the JAX side: the GS layout is in test_torch_gs.py
    port_side = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    unfilled = sorted(set(port_side) - set(jax_side))
    unused = sorted(set(jax_side) - set(port_side))
    assert not unfilled and not unused, (unfilled[:5], unused[:5])
    bad = [k for k in port_side if port_side[k] != jax_side[k]]
    assert not bad, [(k, port_side[k], jax_side[k]) for k in bad[:5]]


def test_port_imports_no_jax_and_needs_cuda_by_default():
    code = textwrap.dedent(
        """
        import importlib, importlib.util, pkgutil, sys
        import torch
        import recondet3d_torch
        for m in pkgutil.walk_packages(recondet3d_torch.__path__, "recondet3d_torch."):
            importlib.import_module(m.name)
        spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = [n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "flax", "recondet3d")]
        assert not bad, bad
        if not torch.cuda.is_available():
            from recondet3d_torch.models.da3 import build_da3
            try:
                build_da3("da3-small")
            except RuntimeError as e:
                assert "CUDA is not available" in str(e)
            else:
                raise AssertionError("build_da3 ran without CUDA")
        print("isolated")
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and "isolated" in res.stdout, res.stderr[-3000:]
