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
and their mix in one step (16 local and 8 global launches); the flash
forward at the request's shapes (ViT-g local and global, ViT-L local at
B=2) and its mix in one request (26, 14 and 24 launches); bf16 attention at
the head dims no DA3 trunk has ((1, 4, N, D), D in {32, 96, 128, 20}, N in
{721, 4326}) through the kernels the tree routes them to (its
``attention_fwd``, and its wgmma dk/dv where it takes the head dim, else
``attention_bwd_dkv_cuda_core``); the fp32 attention forward at the camera
encoders' shapes (device time from ``torch.profiler``: a call is
launch-bound there) through the tree's wrapper (``attention_fwd_cuda_core``,
or ``attention_fwd_f32`` in trees before the CUDA-core family). Prints one
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
DKV_PER_STEP = {"vitl_local_b1": 16, "vitl_global_b1": 8}
FWD_SHAPES = {"vitg_local": (12, 24, 721, 721), "vitg_global": (2, 24, 4326, 4326), "vitl_local": (12, 16, 721, 721)}
FWD_PER_REQUEST = {"vitg_local": 26, "vitg_global": 14, "vitl_local": 24}
ANY_D_SHAPES = {f"bf16_d{d}_n{n}": (1, 4, n, d) for d in (32, 96, 128, 20) for n in (721, 4326)}
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


def dkv_wrapper(head_dim):
    """The dk/dv wrapper the tree routes bf16 at ``head_dim`` to: its wgmma
    kernel where it takes the head dim (any D up to
    ``WGMMA_DKV_MAX_HEAD_DIM`` since that constant exists, D = 64 before),
    else the CUDA-core kernel."""
    wgmma_max = getattr(attention, "WGMMA_DKV_MAX_HEAD_DIM", None)
    takes = head_dim <= wgmma_max if wgmma_max is not None else head_dim == 64
    return flash_attention_bwd_dkv if takes else attention.attention_bwd_dkv_cuda_core


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
    """Wall ms of each of ``n`` main-path requests after one warm-up."""
    import time
    from pathlib import Path

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
    times = []
    for i in range(n + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.simple_test(img, c2l, depth_override=depth)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return times[1:]


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
           "any_d_dkv_ms": {}, "f32_fwd_device_ms": {}}
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
    res["dkv_step_mix_ms"] = sum(res["dkv_ms"][name] * n for name, n in DKV_PER_STEP.items())
    for name, (B, H, N, M) in FWD_SHAPES.items():
        q, k, v, _ = bf16_inputs((B, H, N, 64), M, seed=10)
        res["fwd_ms"][name] = time_ms(lambda: flash_attention_fwd(q, k, v), args.iters_dq)
    res["fwd_request_mix_ms"] = sum(res["fwd_ms"][name] * n for name, n in FWD_PER_REQUEST.items())
    for name, (B, H, N, D) in ANY_D_SHAPES.items():
        q, k, v, do = bf16_inputs((B, H, N, D), N, seed=70)
        out, lse = attention.attention_fwd(q, k, v)
        delta = (do.float() * out.float()).sum(dim=-1)
        dkv = dkv_wrapper(D)
        res["any_d_fwd_ms"][name] = time_ms(lambda: attention.attention_fwd(q, k, v), args.iters_dq)
        res["any_d_dkv_ms"][name] = time_ms(lambda: dkv(q, k, v, do, lse, delta), args.iters_dq)
    f32_fwd = getattr(attention, "attention_fwd_cuda_core", None) or attention.attention_fwd_f32
    for name, shape in F32_SHAPES.items():
        rng = np.random.default_rng(40)
        q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda() for _ in range(3))
        res["f32_fwd_device_ms"][name] = device_ms_per_call(lambda: f32_fwd(q, k, v), F32_CALLS)
    if args.requests:
        res["request_ms"] = request_ms(args.requests)
    load_kernels()
    res["ptxas"] = {stem: BUILD_LOG[stem]["ptxas"] for stem in ("flash_attn_fwd", "flash_attn_bwd")}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
