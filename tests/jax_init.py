"""The JAX package's random initial weights, made again with numpy.

The JAX training CLI draws a model's first weights from ``PRNGKey(seed)``:
flax gives each parameter its own key, ``fold_in(root, h)`` with ``h`` the
first four bytes of the SHA-1 of the parameter's scope path and its scope's
draw counter, and the parameter's initializer draws from that key through
JAX's counter-based Threefry-2x32 generator. All of it is fixed arithmetic,
so it runs here without JAX: Threefry, ``fold_in``, ``uniform`` (bit-exact),
``normal`` and ``truncated_normal`` through XLA's float32 ``erf_inv``
polynomial (numpy's ``log1p`` inside it may differ from XLA's by an ulp: about
1 % of the values differ by ~1 ulp), and the initializers the models use
(zeros, ones, constants, normal, lecun-normal ``variance_scaling``).

What is not arithmetic is the model's list of parameters: flax path, scope
key path and counter, shape and initializer of each. A manifest per config
holds it (``tests/manifests/<config>.json``, written from a flax ``init`` by
tests/test_torch_jax_init.py, which also holds these weights against the
JAX package's). ``initial_state_dict`` turns a manifest and a seed into the
port's state dict through ``api/weights.py`` (batch statistics keep the
port's fresh values, which are flax's: mean 0, variance 1).

Use: a run that must start where the JAX package's run of the same seed
starts, e.g. tests/test_full_loop.py's experiment through the port's CLIs
(``write_initial_checkpoint`` puts a step-0 checkpoint in the work dir; the
train CLI resumes from it).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Iterable

import numpy as np

__all__ = ["prng_key", "fold_in", "random_bits", "uniform", "normal", "truncated_normal", "manifest_path",
           "init_arrays", "initial_state_dict", "write_initial_checkpoint"]

_U = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_MANIFESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "manifests")


def _threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 with 20 rounds (JAX's ``threefry2x32_p``) on uint32 arrays."""
    k1, k2 = _U(k1), _U(k2)
    ks = (k1, k2, _U(k1 ^ k2 ^ _U(0x1BD11BDA)))
    x = [np.asarray(x1, _U).copy(), np.asarray(x2, _U).copy()]
    with np.errstate(over="ignore"):
        x[0] += ks[0]
        x[1] += ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] += x[1]
                x[1] = (x[1] << _U(r)) | (x[1] >> _U(32 - r))
                x[1] ^= x[0]
            x[0] += ks[(i + 1) % 3]
            x[1] += ks[(i + 2) % 3] + _U(i + 1)
    return x


def prng_key(seed: int):
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32 bits."""
    return _U((seed >> 32) & 0xFFFFFFFF), _U(seed & 0xFFFFFFFF)


def fold_in(key, data: int):
    out = _threefry2x32(key[0], key[1], np.array([0], _U), np.array([data], _U))
    return out[0][0], out[1][0]


def random_bits(key, shape) -> np.ndarray:
    """32 random bits an element (JAX's partitionable Threefry: the element's
    64-bit index as the counter, the two output words xor-ed)."""
    idx = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64)
    b1, b2 = _threefry2x32(key[0], key[1], (idx >> np.uint64(32)).astype(_U), (idx & np.uint64(0xFFFFFFFF)).astype(_U))
    return (b1 ^ b2).reshape(shape)


def _fma(a, b, c) -> np.ndarray:
    """a * b + c rounded once to float32 (XLA fuses these into an fma)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(np.float32)


def uniform(key, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """float32 in [minval, maxval): 23 random mantissa bits under exponent 0."""
    f = ((random_bits(key, shape) >> _U(9)) | _U(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, _fma(f, hi - lo, lo))


# XLA's float32 erf_inv (Giles' approximation), w < 5 and w >= 5
_ERFINV_LT = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682)


def _erf_inv(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    w = -np.log1p(-(x * x))
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(lt, np.float32(_ERFINV_LT[0]), np.float32(_ERFINV_GE[0])).astype(np.float32)
    for a, b in zip(_ERFINV_LT[1:], _ERFINV_GE[1:]):
        p = _fma(p, w, np.where(lt, np.float32(a), np.float32(b)))
    return np.where(np.abs(x) == 1, np.copysign(np.float32(np.inf), x), p * x).astype(np.float32)


_SQRT2 = np.float32(np.sqrt(2))
_ERF_2 = np.float32(0.9544997)  # float32 erf(2 / sqrt 2) as XLA computes it: the truncation bounds of (-2, 2)


def normal(key, shape) -> np.ndarray:
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return _SQRT2 * _erf_inv(uniform(key, shape, lo, 1.0))


def truncated_normal(key, shape) -> np.ndarray:
    """Standard normal truncated to (-2, 2), as ``jax.random.truncated_normal(key, -2, 2)``."""
    out = _SQRT2 * _erf_inv(uniform(key, shape, -_ERF_2, _ERF_2))
    return np.clip(out, np.nextafter(np.float32(-2), np.float32(np.inf)),
                   np.nextafter(np.float32(2), np.float32(-np.inf))).astype(np.float32)


def _rng_hash(suffix: Iterable) -> int:
    """flax's ``_fold_in_static`` (no separators): SHA-1 over the scope names
    (UTF-8) and counters (big-endian, shortest), first 4 bytes big-endian."""
    m = hashlib.sha1()
    for x in suffix:
        m.update(x.encode("utf-8") if isinstance(x, str) else int(x).to_bytes((int(x).bit_length() + 7) // 8, "big"))
    return int.from_bytes(m.digest()[:4], "big")


def _draw(init: dict, key, shape) -> np.ndarray:
    kind = init["kind"]
    if kind in ("zeros", "ones", "constant"):
        return np.full(shape, {"zeros": 0.0, "ones": 1.0}.get(kind, init.get("value")), np.float32)
    if kind == "normal":
        return normal(key, shape) * np.float32(init["stddev"])
    if kind == "variance_scaling" and init["distribution"] == "truncated_normal" and init["mode"] == "fan_in":
        in_size = shape[init["in_axis"]]
        receptive = np.prod(shape) / in_size / shape[init["out_axis"]]
        variance = np.float32(init["scale"] / (in_size * receptive))
        stddev = np.sqrt(variance) / np.float32(0.87962566103423978)
        return truncated_normal(key, shape) * stddev
    raise NotImplementedError(f"initializer {init} is not reproduced")


def manifest_path(config: str) -> str:
    """The manifest of ``configs/<name>.py``."""
    return os.path.join(_MANIFESTS, os.path.splitext(os.path.basename(config))[0] + ".json")


def init_arrays(manifest: dict, seed: int = 0) -> Dict[str, np.ndarray]:
    """{flax path: float32 array} of every parameter the manifest lists, as
    the JAX package's ``model.init(PRNGKey(seed), ...)`` makes it."""
    root = prng_key(seed)
    return {p["path"]: _draw(p["init"], fold_in(root, _rng_hash(p["rng"])), tuple(p["shape"]))
            for p in manifest["params"]}


def initial_state_dict(config: str, seed: int = 0):
    """The port's state dict (parameters only) of the JAX package's initial
    weights for ``config`` and ``seed``."""
    from recondet3d_torch.api.weights import state_dict_from_flax

    with open(manifest_path(config)) as f:
        manifest = json.load(f)
    return state_dict_from_flax(init_arrays(manifest, seed))


def write_initial_checkpoint(model, config: str, work_dir: str, total_steps: int, seed: int = 0) -> str:
    """Load the JAX package's initial weights of ``config`` / ``seed`` into
    ``model`` (a ``build_model_from_cfg`` model of that config) and save them
    with fresh optimizer state as the step-0 checkpoint of ``work_dir``, from
    which the train CLI resumes. Parameters the flax tree does not have (the
    camera encoder of a tree initialised without poses) keep the model's."""
    from recondet3d_torch.train import Trainer

    res = model.load_state_dict(initial_state_dict(config, seed), strict=False)
    if res.unexpected_keys or any(".cam_enc." not in k and not k.endswith(("running_mean", "running_var",
                                                                            "num_batches_tracked"))
                                  for k in res.missing_keys):
        raise ValueError(f"manifest of {config} does not fit the model: {res}")
    trainer = Trainer(model=model, total_steps=total_steps, work_dir=work_dir)
    return trainer.save_checkpoint(trainer.init_state())
