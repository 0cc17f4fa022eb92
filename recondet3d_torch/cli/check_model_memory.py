"""Model memory breakdown after build (port of
``recondet3d/cli/check_model_memory.py``; reference:
tools/check_model_memory.py:17 — per-component memory after constructing
the detector).

    python -m recondet3d_torch.cli.check_model_memory configs/resdet3d_centerhead.py [--device cpu]

Builds the config's model (random weights from seed 0), runs one forward
on a (1, 6, 900, 1600) batch, and prints parameters and bytes per component
(the first two levels of the parameter names; a list of modules one level
more, one row a member), the TOTAL, then ``device_memory_snapshot()``.

The table counts what the JAX package's table counts: the parameters of
the modules that a forward without input poses runs, which are the ones
its ``init`` creates. The camera encoder (``cam_enc``) runs only with
input poses; its parameters are printed on a line of their own, outside
the TOTAL.
"""

from __future__ import annotations

import argparse
from collections import defaultdict

import torch

__all__ = ["main", "component_table"]

POSED_ONLY = "cam_enc"  # a module that only a forward with input poses runs


def component_table(model: torch.nn.Module):
    """({component: [params, bytes]} in name order, [params, bytes] of the
    posed-only modules)."""
    containers = {name for name, mod in model.named_modules() if isinstance(mod, (torch.nn.ModuleList,
                                                                                  torch.nn.ModuleDict))}
    table, posed = defaultdict(lambda: [0, 0]), [0, 0]
    for name, p in model.named_parameters():
        parts = name.split(".")
        row = posed if POSED_ONLY in parts[:-1] else table[
            "/".join(parts[:2]) + ("." + parts[2] if ".".join(parts[:2]) in containers else "")]
        row[0] += p.numel()
        row[1] += p.numel() * p.element_size()
    return dict(sorted(table.items())), posed


def main(argv=None):
    from recondet3d_torch.cli.train import build_model_from_cfg
    from recondet3d_torch.core.config import load_py_config
    from recondet3d_torch.utils.device import resolve_device
    from recondet3d_torch.utils.profiling import device_memory_snapshot

    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    model = build_model_from_cfg(load_py_config(args.config), device=device)

    img = torch.zeros((1, 6, 900, 1600, 3), device=device)
    c2l = torch.eye(4, device=device).expand(1, 6, 4, 4)
    with torch.inference_mode():
        model(img, c2l)
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    table, posed = component_table(model)
    print(f"{'component':<40}{'params':>14}{'bytes':>14}")
    for name, (n, b) in table.items():
        print(f"{name:<40}{n:>14,}{b / 2**20:>12.1f}Mi")
    n = sum(v[0] for v in table.values())
    b = sum(v[1] for v in table.values())
    print(f"{'TOTAL':<40}{n:>14,}{b / 2**20:>12.1f}Mi")
    if posed[0]:
        print(f"not in TOTAL, run only with input poses: {POSED_ONLY} {posed[0]:,} params, "
              f"{posed[1] / 2**20:.1f}Mi")
    for dev, stats in device_memory_snapshot().items():
        print(dev, stats)
    return 0


if __name__ == "__main__":
    main()
