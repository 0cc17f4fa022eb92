"""Time the FPS, attention and fp32 attention kernels of whichever
``recondet3d_torch`` is first on ``sys.path``, so that two trees can be
compared in turns on one card, and, with ``--requests N``, N requests of
the main path (bench.py's workload: ``build_resdet3d("da3nested-giant-large")``
with random weights from seed 0, B=2 scenes of six 900x1600 noise images,
voxel pre-reduce 0.1, the point path on the anchored depth of
``data/anchor_scene.py``; host clock around work ending in
``torch.cuda.synchronize()``, after one warm-up).

    PYTHONPATH=<tree> python3 <path of this file> FPS_INPUTS [--iters-fps 3] [--iters-dq 20] [--requests 0]

``FPS_INPUTS`` is a ``torch.save`` file of a list of dicts with ``name``,
``points`` (N, 3) fp32, ``valid`` (N,) bool, ``start`` (1,) int32 and ``k``:
the arguments ``furthest_point_sample_cuda`` takes, as ``chip_smoke.py``
writes them for its FPS cases. On inputs made from a seed: the dq and dk/dv
kernels at the fine-tuning step's shapes (ViT-L local and global at B=1)
and their mixes in one step (16 local and 8 global launches each); the
flash forward at the request's shapes (ViT-g local and global, ViT-L local
at B=2) and its mix in one request (26, 14 and 24 launches); bf16 attention
at the head dims no DA3 trunk has ((1, 4, N, D), D in {32, 96, 128, 20}, N
in {721, 4326}, and D in {160, 256} at 4,326): the forward, dq and dk/dv
through the kernels the tree routes them to (its ``attention_fwd``, and the
wgmma or CUDA-core dq and dk/dv wrapper its ``kernel_variant(dtype, D,
kernel)`` names: trees since the per-kernel routing); the fp32 attention forward and backward at the
camera encoders' shapes, each on the tree's own route (its ``attention_fwd``
and ``flash_attention_bwd``: the tiled CUDA-core kernels and delta's
expression, or one launch each of the short kernels), device time from
``torch.profiler`` (a call is launch-bound there) and host time a call in a
loop of calls. Prints one
JSON line: ms per call of each, and the compiler's report of the two flash
libraries (``ptxas``). Needs CUDA. It calls only ``build_resdet3d``, the
anchored scene, the kernel build and the FPS and attention wrappers, which
earlier trees of the port have too, so an earlier tree can be timed with it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from recondet3d_torch.ops import attention
from recondet3d_torch.ops.attention import flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd
from recondet3d_torch.ops.build import BUILD_LOG, load_kernels
from recondet3d_torch.ops.fps import furthest_point_sample_cuda

# (B, H, N, M) at D = 64 and the launches of one fine-tuning step (backward) or one request (forward) at each
DQ_SHAPES = {"vitl_local_b1": (6, 16, 721, 721), "vitl_global_b1": (1, 16, 4326, 4326)}
BWD_PER_STEP = {"vitl_local_b1": 16, "vitl_global_b1": 8}  # dq launches and dk/dv launches alike
FWD_SHAPES = {"vitg_local": (12, 24, 721, 721), "vitg_global": (2, 24, 4326, 4326), "vitl_local": (12, 16, 721, 721)}
FWD_PER_REQUEST = {"vitg_local": 26, "vitg_global": 14, "vitl_local": 24}
ANY_D_SHAPES = {f"bf16_d{d}_n{n}": (1, 4, n, d) for d in (32, 96, 128, 20) for n in (721, 4326)}
ANY_D_SHAPES.update({f"bf16_d{d}_n4326": (1, 4, 4326, d) for d in (160, 256)})
F32_SHAPES = {"cam_enc_giant": (2, 16, 6, 96), "cam_enc_large_b1": (1, 16, 6, 64)}
F32_CALLS = 100  # profiled calls of the fp32 forward at each shape


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


def bf16_inputs(shape_q, M, seed):
    """q, k, v (M rows) and dO of (B, H, N, D) from a seed, bf16 on the card."""
    B, H, N, D = shape_q
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, H, n, D), dtype=np.float32)).cuda().to(torch.bfloat16)
            for n in (N, M, M, N)]


def bwd_wrapper(kind, head_dim):
    """The ``kind`` ('dq' or 'dkv') wrapper the tree routes bf16 at
    ``head_dim`` to: the wgmma or the CUDA-core one, as its
    ``kernel_variant`` names it."""
    wgmma = attention.kernel_variant(torch.bfloat16, head_dim, kind) == "wgmma"
    return {("dq", True): flash_attention_bwd_dq, ("dkv", True): flash_attention_bwd_dkv,
            ("dq", False): attention.attention_bwd_dq_cuda_core,
            ("dkv", False): attention.attention_bwd_dkv_cuda_core}[kind, wgmma]


def device_ms_per_call(fn, calls):
    """Device time of one call of ``fn``: the summed durations of what it
    runs on the card over ``calls`` calls under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / calls


def request_ms(n):
    """Wall ms of each of ``n`` main-path requests after one warm-up, and the
    device ms of each request's stages (``utils/stage_timer.py``: the point
    path's cell sort, FPS and ball query, the refinement's parts)."""
    import time
    from pathlib import Path

    from recondet3d_torch.utils import stage_timer

    from recondet3d_torch.data.anchor_scene import anchor_depth, rig_cam2lidar
    from recondet3d_torch.models.detect import build_resdet3d

    model = build_resdet3d("da3nested-giant-large", dtype=torch.bfloat16, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(0),
                           refinement=dict(max_voxels=40960, occ_max_voxels=65536,
                                           stage_caps=(40960, 32768, 24576, 16384)), voxel_pre_reduce=0.1)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(0.0, 255.0, (2, 6, 900, 1600, 3)).astype(np.float32)).cuda()
    c2l = rig_cam2lidar(2)
    points = np.load(Path(__file__).resolve().parents[2] / "assets" / "bench_sample" / "reference_points.npz")
    depth = torch.from_numpy(anchor_depth(points["points"], c2l, 280, 504, batch=2)).cuda()
    c2l = torch.from_numpy(c2l).cuda()
    times, stages = [], []
    for i in range(n + 1):
        torch.cuda.synchronize()
        with stage_timer.collect() as stage_ms:
            t0 = time.perf_counter()
            model.simple_test(img, c2l, depth_override=depth)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        stages.append({k: v for k, v in stage_ms.items() if "/" not in k})
    return times[1:], stages[1:]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("fps_inputs")
    ap.add_argument("--iters-fps", type=int, default=3)
    ap.add_argument("--iters-dq", type=int, default=20)
    ap.add_argument("--requests", type=int, default=0, help="timed requests of the main path (0: none)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_times: CUDA is not available", file=sys.stderr)
        return 1
    res = {"fps_ms": {}, "fps_indices_sum": {}, "dq_ms": {}, "dkv_ms": {}, "fwd_ms": {}, "any_d_fwd_ms": {},
           "any_d_dq_ms": {}, "any_d_dkv_ms": {}, "f32_fwd_device_ms": {}, "f32_bwd_device_ms": {},
           "f32_fwd_host_ms": {}, "f32_bwd_host_ms": {}}
    for case in torch.load(args.fps_inputs):
        p, m, s, k = (case[key].cuda() if torch.is_tensor(case[key]) else case[key]
                      for key in ("points", "valid", "start", "k"))
        res["fps_indices_sum"][case["name"]] = int(furthest_point_sample_cuda(p, m, s, k).long().sum())
        res["fps_ms"][case["name"]] = time_ms(lambda: furthest_point_sample_cuda(p, m, s, k), args.iters_fps)
    for name, (B, H, N, M) in DQ_SHAPES.items():
        q, k, v, do = bf16_inputs((B, H, N, 64), M, seed=20)
        out, lse = flash_attention_fwd(q, k, v)
        delta = (do.float() * out.float()).sum(dim=-1)
        res["dq_ms"][name] = time_ms(lambda: flash_attention_bwd_dq(q, k, v, do, lse, delta), args.iters_dq)
        res["dkv_ms"][name] = time_ms(lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta), args.iters_dq)
    for kind in ("dq", "dkv"):
        res[f"{kind}_step_mix_ms"] = sum(res[f"{kind}_ms"][name] * n for name, n in BWD_PER_STEP.items())
    for name, (B, H, N, M) in FWD_SHAPES.items():
        q, k, v, _ = bf16_inputs((B, H, N, 64), M, seed=10)
        res["fwd_ms"][name] = time_ms(lambda: flash_attention_fwd(q, k, v), args.iters_dq)
    res["fwd_request_mix_ms"] = sum(res["fwd_ms"][name] * n for name, n in FWD_PER_REQUEST.items())
    for name, (B, H, N, D) in ANY_D_SHAPES.items():
        q, k, v, do = bf16_inputs((B, H, N, D), N, seed=70)
        out, lse = attention.attention_fwd(q, k, v)
        delta = (do.float() * out.float()).sum(dim=-1)
        res["any_d_fwd_ms"][name] = time_ms(lambda: attention.attention_fwd(q, k, v), args.iters_dq)
        for kind in ("dq", "dkv"):
            fn = bwd_wrapper(kind, D)
            res[f"any_d_{kind}_ms"][name] = time_ms(lambda: fn(q, k, v, do, lse, delta), args.iters_dq)
    for name, shape in F32_SHAPES.items():
        rng = np.random.default_rng(40)
        q, k, v, do = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda() for _ in range(4))
        out, lse = attention.attention_fwd(q, k, v)
        calls = dict(fwd=lambda: attention.attention_fwd(q, k, v),
                     bwd=lambda: attention.flash_attention_bwd(q, k, v, out, lse, do))
        for kind, fn in calls.items():
            res[f"f32_{kind}_device_ms"][name] = device_ms_per_call(fn, F32_CALLS)
            res[f"f32_{kind}_host_ms"][name] = time_ms(fn, F32_CALLS)
    if args.requests:
        res["request_ms"], res["request_stage_ms"] = request_ms(args.requests)
    load_kernels()
    res["ptxas"] = {stem: BUILD_LOG[stem]["ptxas"] for stem in ("flash_attn_fwd", "flash_attn_bwd")}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
