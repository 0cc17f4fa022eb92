"""Time the FPS and dq kernels of whichever ``recondet3d_torch`` is first on
``sys.path``, so that two trees can be compared in turns on one card.

    PYTHONPATH=<tree> python3 <path of this file> FPS_INPUTS [--iters-fps 3] [--iters-dq 20]

``FPS_INPUTS`` is a ``torch.save`` file of a list of dicts with ``name``,
``points`` (N, 3) fp32, ``valid`` (N,) bool, ``start`` (1,) int32 and ``k``:
the arguments ``furthest_point_sample_cuda`` takes, as ``chip_smoke.py``
writes them for its FPS cases. The dq kernel is timed at the fine-tuning
step's shapes (ViT-L local and global at B=1) on inputs made from a seed.
Prints one JSON line: ms per call of each. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from recondet3d_torch.ops.attention import flash_attention_bwd_dq, flash_attention_fwd
from recondet3d_torch.ops.fps import furthest_point_sample_cuda

DQ_SHAPES = {"vitl_local_b1": (6, 16, 721, 721), "vitl_global_b1": (1, 16, 4326, 4326)}


def time_ms(fn, iters, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("fps_inputs")
    ap.add_argument("--iters-fps", type=int, default=3)
    ap.add_argument("--iters-dq", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_times: CUDA is not available", file=sys.stderr)
        return 1
    res = {"fps_ms": {}, "fps_indices_sum": {}, "dq_ms": {}}
    for case in torch.load(args.fps_inputs):
        p, m, s, k = (case[key].cuda() if torch.is_tensor(case[key]) else case[key]
                      for key in ("points", "valid", "start", "k"))
        res["fps_indices_sum"][case["name"]] = int(furthest_point_sample_cuda(p, m, s, k).long().sum())
        res["fps_ms"][case["name"]] = time_ms(lambda: furthest_point_sample_cuda(p, m, s, k), args.iters_fps)
    for name, (B, H, N, M) in DQ_SHAPES.items():
        rng = np.random.default_rng(20)
        q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, n, 64), dtype=np.float32)).cuda()
                       .to(torch.bfloat16) for n in (N, M, M, N))
        out, lse = flash_attention_fwd(q, k, v)
        delta = (do.float() * out.float()).sum(dim=-1)
        res["dq_ms"][name] = time_ms(lambda: flash_attention_bwd_dq(q, k, v, do, lse, delta), args.iters_dq)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
