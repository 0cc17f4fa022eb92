"""The benchmark's weights: one state made from the seed, loaded alike into
the program's model and into the reference.

The law follows the JAX package's flax initialisers, by the kind of module a
tensor belongs to (class names, which the program and the reference share):
lecun-normal kernels (std fan_in ** -0.5), zero biases, unit norms,
LayerScale at its init value, zero class and position tokens, a unit-normal
camera token, the CenterHead heatmap bias at the focal prior, fresh batch
statistics. The normal draws come from one ``torch.Generator`` on the
device, one ``randn`` call a dtype over all tensors of that dtype in name
order; each tensor's slice of that buffer is scaled and copied into the
tensor's own storage, and the buffer is freed. The
configuration file's ``weights.adjust`` entries then scale or set single
tensors by name (the changes a random net needs to give a cloud, stated in
the configuration file).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

__all__ = ["make_weights_", "HM_PRIOR"]

HM_PRIOR = -2.19  # CenterPoint's heatmap bias: sigmoid(-2.19) = 0.1
_NORMS = ("LayerNorm", "LayerNormFp32", "_ChannelLayerNorm", "FlaxBatchNorm2d", "MaskedBatchNorm")
_TOKENS_ZERO = ("cls_token", "pos_embed")


def _fan_in(kind: str, shape) -> int:
    if kind == "ConvTranspose2d":  # (in, out, k, k)
        return shape[0] * shape[2] * shape[3]
    if len(shape) == 3:  # sparse kernels (taps, in, out)
        return shape[0] * shape[1]
    n = 1
    for s in shape[1:]:
        n *= s
    return n


def _law(model: torch.nn.Module) -> List[Tuple[str, torch.nn.Parameter, object]]:
    """(name, tensor, rule) for every parameter, in name order; a rule is a
    float std (normal draw) or ('fill', value)."""
    rules = []
    for mname, mod in model.named_modules():
        kind = type(mod).__name__
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            if pname in _TOKENS_ZERO:
                rule = ("fill", 0.0)
            elif pname == "camera_token":
                rule = 1.0
            elif pname == "gamma":
                rule = ("fill", float(mod.init_values))
            elif pname == "bias":
                rule = ("fill", HM_PRIOR if name.endswith("hm_out.bias") else 0.0)
            elif kind in _NORMS:
                rule = ("fill", 1.0)
            elif p.dim() >= 2:
                rule = _fan_in(kind, p.shape) ** -0.5
            else:
                raise ValueError(f"no weight law for {name} ({kind}, {tuple(p.shape)})")
            rules.append((name, p, rule))
    return sorted(rules, key=lambda r: r[0])


@torch.no_grad()
def make_weights_(model: torch.nn.Module, seed: int, adjust: List[Dict] = ()) -> None:
    """Give every parameter and buffer of ``model`` the benchmark's value
    for ``seed`` (the same on any model with these names, shapes, dtypes and
    kinds of module), on the device the model lies on."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    rules = _law(model)
    by_dtype: Dict[torch.dtype, List] = {}
    for name, p, rule in rules:
        if not isinstance(rule, tuple):
            by_dtype.setdefault(p.dtype, []).append((p, rule))
    for dtype in sorted(by_dtype, key=str):
        group = by_dtype[dtype]
        flat = torch.randn(sum(p.numel() for p, _ in group), generator=gen, device=device, dtype=dtype)
        offset = 0
        for p, std in group:
            p.copy_(flat[offset:offset + p.numel()].view(p.shape)).mul_(std)
            offset += p.numel()
        del flat
    for name, p, rule in rules:
        if isinstance(rule, tuple):
            p.fill_(rule[1])
    for name, b in model.named_buffers():
        if name.endswith("running_mean"):
            b.zero_()
        elif name.endswith("running_var"):
            b.fill_(1.0)
        else:
            raise ValueError(f"no value law for buffer {name}")
    params = dict(model.named_parameters())
    for entry in adjust:
        p = params[entry["param"]]
        if "scale" in entry:
            p.mul_(float(entry["scale"]))
        else:
            p.copy_(torch.tensor(entry["values"], dtype=p.dtype, device=device).reshape(p.shape))
