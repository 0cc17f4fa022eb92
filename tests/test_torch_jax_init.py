"""The JAX package's initial weights made again without JAX
(``tests/jax_init.py``), against JAX on the CPU.

- Threefry bits, ``fold_in`` and ``uniform`` are bit-exact; ``normal`` and
  ``truncated_normal`` go through XLA's float32 ``erf_inv`` polynomial, whose
  ``log1p`` numpy computes differently in the last bit for some inputs: they
  agree within 4.8e-7 relative (4 ulp).
- The committed manifest of ``configs/resdet3d_tiny_centerhead_test.py`` is
  what a flax ``init`` of that config records: every parameter's path, scope
  key path and counter, shape and initializer. With
  ``RECONDET3D_WRITE_MANIFESTS=1`` the test writes it instead.
- From the manifest, the initial weights of seeds 0 and 1 equal the JAX
  training CLI's (``Trainer.init_state(PRNGKey(seed), batch)``) within the
  same 4 ulp, and load into the port's model of the config.
"""

import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recondet3d.api.weights import _flatten
from recondet3d.cli.train import build_model_from_cfg as j_build_model_from_cfg
from recondet3d.core.config import load_py_config as j_load_py_config
from recondet3d_torch.cli.train import build_model_from_cfg
from recondet3d_torch.core.config import load_py_config

import jax_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "resdet3d_tiny_centerhead_test.py")
ULP_RTOL, ULP_ATOL = 4.8e-7, 1e-12  # 4 ulp of float32


def tiny_batch(jmodel):
    """Inputs of the training CLI's shapes (the structured fixture's 2 views; values do not enter the weights)."""
    return dict(img=jnp.zeros((1, 2, 900, 1600, 3)), cam2lidar_rts=jnp.zeros((1, 2, 4, 4)),
                gt_points=jnp.zeros((1, 512, 3)), gt_bboxes_3d=jnp.zeros((1, jmodel.pts_bbox_head.max_objs, 9)),
                gt_labels_3d=jnp.zeros((1, jmodel.pts_bbox_head.max_objs), jnp.int32),
                gt_bboxes_valid=jnp.zeros((1, jmodel.pts_bbox_head.max_objs), bool))


def init_spec(fn):
    """The manifest's description of a flax initializer."""
    name = getattr(fn, "__qualname__", repr(fn)).split(".")[0]
    free = {k: v for k, v in inspect.getclosurevars(fn).nonlocals.items() if not callable(v)} \
        if inspect.isfunction(fn) else {}
    if name in ("zeros", "ones"):
        return {"kind": name}
    if name == "constant":
        return {"kind": "constant", "value": float(free["value"])}
    if name == "normal":
        return {"kind": "normal", "stddev": float(free["stddev"])}
    if name == "variance_scaling":
        assert free["batch_axis"] == () or free["batch_axis"] == [], free
        return {"kind": "variance_scaling", "scale": float(free["scale"]), "mode": free["mode"],
                "distribution": free["distribution"], "in_axis": int(free["in_axis"]),
                "out_axis": int(free["out_axis"])}
    raise AssertionError(f"an initializer the manifest does not describe: {name} {free}")


def record_manifest(jmodel):
    """Trace the JAX CLI's init and record every ``Scope.param``: its path,
    the key path folded into its key, its shape and initializer."""
    import flax.core.scope as fs

    params, last = [], {}
    fold, param = fs._fold_in_static, fs.Scope.param

    def spy_fold(rng, data):
        last["rng"] = list(data)
        return fold(rng, data)

    def spy_param(self, name, init_fn, *args, **kwargs):
        def wrapped(rng, *a, **k):
            out = init_fn(rng, *a, **k)
            params.append({"path": "/".join(("params",) + tuple(self.path) + (name,)), "rng": last["rng"],
                           "shape": list(np.shape(out)), "init": init_spec(init_fn)})
            return out
        return param(self, name, wrapped, *args, **kwargs)

    fs._fold_in_static, fs.Scope.param = spy_fold, spy_param
    try:
        jax.eval_shape(lambda r: jmodel.init(r, return_loss=True, train=False, **tiny_batch(jmodel)),
                       jax.random.PRNGKey(0))
    finally:
        fs._fold_in_static, fs.Scope.param = fold, param
    return {"config": "configs/" + os.path.basename(CONFIG), "params": params}


@pytest.fixture(scope="module")
def jmodel():
    return j_build_model_from_cfg(j_load_py_config(CONFIG))


def test_random_streams_match_jax():
    key = jax.random.PRNGKey(7)
    k = jax_init.prng_key(7)
    assert tuple(np.asarray(jax.random.key_data(key)) if hasattr(jax.random, "key_data") else key) == k
    for data in (0, 1, 123456789, 2 ** 32 - 1):
        assert tuple(np.asarray(jax.random.fold_in(key, data))) == jax_init.fold_in(k, data)
    f, kf = jax.random.fold_in(key, 5), jax_init.fold_in(k, 5)
    np.testing.assert_array_equal(np.asarray(jax.random.bits(f, (33, 7))), jax_init.random_bits(kf, (33, 7)))
    np.testing.assert_array_equal(np.asarray(jax.random.uniform(f, (1000,), minval=-0.5, maxval=3.0)),
                                  jax_init.uniform(kf, (1000,), -0.5, 3.0))
    for got, ref in ((jax_init.normal(kf, (20000,)), jax.random.normal(f, (20000,))),
                     (jax_init.truncated_normal(kf, (20000,)), jax.random.truncated_normal(f, -2, 2, (20000,)))):
        ref = np.asarray(ref)
        assert got.dtype == np.float32 and np.mean(got == ref) > 0.95
        np.testing.assert_allclose(got, ref, rtol=ULP_RTOL, atol=ULP_ATOL)


def test_manifest_is_what_flax_records(jmodel):
    got = record_manifest(jmodel)
    path = jax_init.manifest_path(CONFIG)
    if os.environ.get("RECONDET3D_WRITE_MANIFESTS") == "1":
        with open(path, "w") as f:
            json.dump(got, f, indent=0)
    with open(path) as f:
        assert json.load(f) == got
    assert len(got["params"]) > 500


@pytest.mark.parametrize("seed", [0, 1])
def test_initial_weights_match_the_jax_cli(jmodel, seed):
    variables = jax.jit(lambda r: jmodel.init(r, return_loss=True, train=False, **tiny_batch(jmodel)))(
        jax.random.PRNGKey(seed))
    ref = {k: np.asarray(v) for k, v in _flatten(variables).items() if k.startswith("params/")}
    with open(jax_init.manifest_path(CONFIG)) as f:
        got = jax_init.init_arrays(json.load(f), seed)
    assert set(got) == set(ref)
    exact = 0
    for k, v in ref.items():
        assert got[k].shape == v.shape, k
        np.testing.assert_allclose(got[k], v, rtol=ULP_RTOL, atol=ULP_ATOL, err_msg=k)
        exact += int(np.array_equal(got[k], v))
    assert exact > 0.5 * len(ref)  # every zeros / ones / constant leaf, and some drawn ones, bit for bit


def test_initial_checkpoint_loads_into_the_port(tmp_path):
    from recondet3d_torch.train.checkpoints import latest_checkpoint, load_checkpoint

    model = build_model_from_cfg(load_py_config(CONFIG), device="cpu")
    path = jax_init.write_initial_checkpoint(model, CONFIG, str(tmp_path), total_steps=10)
    assert path == latest_checkpoint(str(tmp_path)) and path.endswith("step_00000000.pt")
    state = load_checkpoint(path)
    sd = jax_init.initial_state_dict(CONFIG, 0)
    for k, v in sd.items():
        assert torch.equal(state["model"][k].float(), v.to(state["model"][k].dtype).float()), k
    assert state["step"] == 0 and state["optimizer"]["count"] == 0
