"""The device trace of the traced stretch: kernel time by name and class,
the device's busy time (the union of kernel intervals), and the idle gaps
labelled by what the host was doing in them.

``kernel_class`` and the classes' arithmetic are copies of
``chip_smoke.py``'s ``kernel_class`` and ``profile_summary``.
"""

from __future__ import annotations

import heapq
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

__all__ = ["kernel_class", "profile_stretch"]


def kernel_class(name: str) -> str:
    n = name.lower()
    if "nccl" in n:
        return "NCCL collectives"
    if "flash_fwd_kernel" in n:
        return "flash_attn_fwd (hand kernel)"
    if "flash_bwd_dq_kernel" in n:
        return "flash_attn_bwd dq (hand kernel)"
    if "flash_bwd_dkv_kernel" in n:
        return "flash_attn_bwd dk/dv (hand kernel)"
    if "fps_kernel" in n:
        return "fps (hand kernel)"
    if any(t in n for t in ("conv", "fprop", "dgrad", "wgrad", "implicit_gemm", "winograd", "cudnn")):
        return "convolution (cuDNN)"
    if any(t in n for t in ("gemm", "nvjet", "cutlass", "xmma", "sm90_", "cublas")):
        return "GEMM (cuBLAS)"
    if "layer_norm" in n or "layernorm" in n:
        return "layer norm"
    if any(t in n for t in ("sort", "radix", "scan", "topk", "gathertopk", "bitonic")):
        return "sort / scan / top-k"
    if any(t in n for t in ("upsample", "interpolat", "adaptive")):
        return "interpolation"
    if any(t in n for t in ("elementwise", "vectorized", "unrolled", "reduce", "cat", "copy", "gather",
                            "index", "softmax", "fill")):
        return "elementwise / copy / reduce"
    return "other"


def _union_us(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(covered microseconds, the gaps between covered stretches)."""
    total, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            total += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


def busy_intervals(kernels: List[Tuple[str, float, float]]) -> List[Tuple[float, float]]:
    """The intervals of ``kernels`` (name, start, end) that count as work:
    every kernel but NCCL's collectives, which spin while they wait for the
    other ranks (their time is in the class ``NCCL collectives``)."""
    return [(s, e) for name, s, e in kernels if kernel_class(name) != "NCCL collectives"]


def profile_stretch(fn: Callable[[int], None], units: int, top_n: int = 10) -> Dict:
    """Run ``fn(i)`` for ``units`` requests or steps under ``torch.profiler``
    and reduce the trace: ``busy_s`` (``busy_intervals`` merged),
    ``window_s`` (host wall time of the stretch, ending in a synchronise),
    device seconds by kernel name and by class, and the idle gaps by the
    innermost host operation running at each gap's middle. Device-side
    ranges of user annotations (the program's spans) are not kernels and
    are left out."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(units):
            fn(i)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    kernels, host, annotations = [], [], 0
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):  # a span's range mirrored on the device: no kernel
                annotations += 1
            else:
                kernels.append((e.name, tr.start, tr.end))
        elif tr.end > tr.start:
            host.append((e.name, tr.start, tr.end))
    by_name = defaultdict(float)
    for name, s, e in kernels:
        by_name[name] += (e - s) / 1e6
    by_class = defaultdict(float)
    for name, sec in by_name.items():
        by_class[kernel_class(name)] += sec
    busy_us, gaps = _union_us(busy_intervals(kernels))
    gap_by_host = defaultdict(float)
    host.sort(key=lambda h: h[1])
    running, j = [], 0  # heap of (duration, end, name) of the host operations begun by the gap's middle
    for gs, ge in gaps:  # in time order
        mid = 0.5 * (gs + ge)
        while j < len(host) and host[j][1] <= mid:
            name, s, e = host[j]
            heapq.heappush(running, (e - s, e, name))
            j += 1
        while running and running[0][1] < mid:
            heapq.heappop(running)
        gap_by_host[running[0][2] if running else "(no host operation)"] += (ge - gs) / 1e6
    order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])  # noqa: E731
    return {"busy_s": busy_us / 1e6, "window_s": window_s, "units": units, "kernels_by_name": dict(by_name),
            "annotations_left_out": annotations,
            "device_ops": [[k, v] for k, v in order(by_class)[:top_n]],
            "idle_gaps": [[k, v] for k, v in order(gap_by_host)[:top_n]]}
