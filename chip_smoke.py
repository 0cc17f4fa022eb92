#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. env      torch / CUDA versions and the card (nvidia-smi name, power limit).
2. build    compiles every CUDA kernel of the port from ``recondet3d_torch/csrc``
            (one nvcc per source, started together).
3. kernel   the flash-attention kernel vs its plain PyTorch version (fp32
            math on the same bf16 values) at the DA3 nested-giant-large
            shapes, with times of the kernel, the plain version, one
            ``scaled_dot_product_attention`` call (a yardstick only, never
            used by the port) and the card's lower bound.
4. model    ``build_resdet3d("da3nested-giant-large")`` at the benchmark
            configuration of the JAX package, random weights from seed 0.
5. slice    the DA3 slice of the main path: requests of B=2 scenes x 6
            views x 900x1600 images through ``process_tensor_batch`` and the
            nested forward; output shapes and finiteness checked, flash
            launches counted per shape.
6. in-situ  one B=1 forward with the flash kernel and one with the plain
            attention; the last ViT-g feature map must agree.
7. fps      the furthest-point-sampling kernel vs its plain PyTorch
            version at the sizes the point path gives it, on the buffers
            that path produces for a rendered street scene; the index
            sequences must be identical. Times of the kernel, the plain
            version, the grid-wide exchange alone, and the bound.
8. resdet3d the whole main path: ``ResDet3D.simple_test`` on B=2 scenes x 6
            views x 900x1600 images, the point path driven by depth maps
            rendered from ``assets/bench_sample/reference_points.npz``
            (random-weight depth says nothing about a street scene); one
            warm-up and three timed requests; shapes, finiteness, valid
            counts per stage, FPS and flash launches counted.
9. in-situ  one scene's ``points_from_depth`` with the FPS kernel and with
            its plain version: identical points and mask.
10. profile where one request's time goes: CUDA events around each stage
            (input processing, both trunks, both heads, camera decoder,
            every stage of the point path and the refinement) and a
            ``torch.profiler`` trace summed by kernel class, with the
            device's idle share of the request.
11. the kernel table as one JSON line; then the card line, then the result.

Needs CUDA; exits non-zero without it (or without the rest of the repo).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch
import torch.nn.functional as F

from recondet3d_torch.data.anchor_scene import anchor_depth, rig_cam2lidar
from recondet3d_torch.data.input_processor import compute_process_shape, process_tensor_batch
from recondet3d_torch.data.pipelines.point_pipeline import ball_query_downsample, voxel_pre_reduce
from recondet3d_torch.models.da3.layers import set_attn_impl
from recondet3d_torch.models.detect import build_resdet3d
from recondet3d_torch.ops import fps as fps_ops
from recondet3d_torch.ops.attention import attention_plain, flash_attention_fwd, reset_launch_counts
from recondet3d_torch.ops.build import BUILD_LOG, load_kernels
from recondet3d_torch.ops.cell_sort import cell_sort
from recondet3d_torch.ops.sampling import furthest_point_sample
from recondet3d_torch.utils import stage_timer
from recondet3d_torch.utils.geometry import depth_to_points_cam

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# kernel vs the plain version in fp32 on the same bf16 values. Out values are
# ~0.02-0.3 at these shapes: the absolute gate sits a few bf16 ulps above the
# readings (7.5e-4 to 2.0e-3 on an H100), the relative L2 gate catches faults
# spread thin over the output (a dropped ragged K/V tile moves it ~0.1).
OUT_TOL, OUT_REL_TOL, LSE_TOL = 5e-3, 1e-2, 1e-3
FEAT_REL_TOL = 5e-2  # relative L2 of the last ViT-g feature map, kernel vs plain attention

PRESET = "da3nested-giant-large"
B, S, IMG_H, IMG_W = 2, 6, 900, 1600
REQUESTS = 3
# the (B, H, N, M) shapes a nested forward gives the kernel at 6 views of 280x504 (721 tokens a view)
SHAPES = {
    "vitg_local": (B * S, 24, 721, 721),
    "vitg_global": (B, 24, S * 721, S * 721),
    "vitl_local": (B * S, 16, 721, 721),
}
# launches a forward must make at each: ViT-g 40 blocks, global from block 13 on
# every odd block -> 26 local + 14 global; ViT-L 24 local
EXPECTED_PER_FORWARD = {"vitg_local": 26, "vitg_global": 14, "vitl_local": 24}

# the JAX package's benchmark configuration (bench.py build_pipeline)
REFINEMENT = dict(max_voxels=40960, occ_max_voxels=65536, stage_caps=(40960, 32768, 24576, 16384))
PRE_REDUCE_VOXEL, PRE_REDUCE_CAP = 0.1, 393216
ANCHORS, NUM_POINTS = 25000, 40000
UNION_CAP_NO_PRE_REDUCE = 425088  # min(846720, 25000 * 17) rounded up to 128: the union buffer without pre-reduce
# (N, K) -> launches per scene on the main path
FPS_EXPECTED_PER_SCENE = {(PRE_REDUCE_CAP, ANCHORS): 1, (PRE_REDUCE_CAP, NUM_POINTS): 1}
REFERENCE_POINTS = "assets/bench_sample/reference_points.npz"


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound_ms(BH, N, kv_rows, D=64):
    """Least time for one call: the larger of the bf16 tensor-core time of
    4*N*D operations per needed (query, key) pair and the time to move q, k,
    v (needed rows), out and lse once. kv_rows: keys needed per (b*h)."""
    flops = 4.0 * N * D * float(kv_rows.sum())
    nbytes = 2 * BH * N * D * 2 + 2 * float(kv_rows.sum()) * D * 2 + BH * N * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def kernel_case(name, shape, kv_len, seed, iters=20):
    Bq, H, N, M = shape
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((Bq, H, n, 64), dtype=np.float32)).cuda().to(torch.bfloat16)
               for n in (N, M, M))
    kvl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    out, lse = flash_attention_fwd(q, k, v, kvl)
    torch.cuda.synchronize()
    ref_out, ref_lse = attention_plain(q.float(), k.float(), v.float(), kvl)
    err_out = (out.float() - ref_out).abs().max().item()
    rel_out = rel_l2(out, ref_out)
    err_lse = (lse - ref_lse).abs().max().item()
    del ref_out, ref_lse
    ok = (err_out <= OUT_TOL and rel_out <= OUT_REL_TOL and err_lse <= LSE_TOL
          and bool(torch.isfinite(out).all()))

    if kvl is None:
        mask = None
        rows = np.full(Bq * H, M, np.float64)
    else:
        mask = (torch.arange(M, device="cuda")[None, :] < kvl[:, None])[:, None, None, :]
        rows = np.repeat(np.minimum(np.asarray(kv_len, np.float64), M), H)
    k_ms = time_ms(lambda: flash_attention_fwd(q, k, v, kvl), iters)
    p_ms = time_ms(lambda: attention_plain(q, k, v, kvl), 3, warmup=1)
    l_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask), iters)
    b_ms, b_by = bound_ms(Bq * H, N, rows)
    res = dict(name=name, shape=list(shape), kv_len=kv_len, max_abs_err=err_out, rel_l2_err=rel_out,
               max_abs_err_lse=err_lse, tol=dict(out=OUT_TOL, out_rel_l2=OUT_REL_TOL, lse=LSE_TOL),
               ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
               tflops=4.0 * N * 64 * rows.sum() / (k_ms * 1e-3) / 1e12, ok=ok)
    emit("kernel", **res)
    if not ok:
        fail(f"flash kernel disagrees with the plain version at {name}: "
             f"out {err_out} (rel L2 {rel_out}), lse {err_lse}")
    return res


def fps_bound_ms(n_rows, n_valid, k, exchange_us):
    """Least time for one FPS call on these inputs, the largest of: the bytes
    (points and mask read once, indices written once) over the memory rate;
    k * n_valid distance updates (3 subtractions, 3 products, 2 sums, 1
    minimum = 9 fp32 operations on a valid point; an invalid one needs none)
    over the fp32 rate; and k - 1 dependent selections, each at least one
    grid-wide exchange, whose latency was measured in this run."""
    t_bytes = 1e3 * (n_rows * 13 + k * 4) / PEAK_BYTES
    t_ops = 1e3 * 9.0 * k * n_valid / PEAK_FP32_FLOPS
    t_seq = 1e-3 * exchange_us * (k - 1)
    return max(t_bytes, t_ops, t_seq), dict(bytes_ms=t_bytes, operations_ms=t_ops, exchanges_ms=t_seq)


def fps_case(name, pts, valid, k, presorted, exchange_us, on_main_path, iters=3):
    """Kernel vs plain version on one buffer: the index sequences must be
    identical (FPS is chaotic: one different pick changes all later ones)."""
    n = pts.shape[0]
    n_valid = int(valid.sum())
    got = furthest_point_sample(pts, k, valid, presorted=presorted)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = furthest_point_sample(pts, k, valid, impl="plain", presorted=presorted)
    torch.cuda.synchronize()
    p_ms = 1e3 * (time.perf_counter() - t0)
    mismatches = int((got != ref).sum())
    first_bad = int((got != ref).nonzero()[0]) if mismatches else None
    in_range = bool(((got >= 0) & (got < n)).all())
    picks_valid = bool(valid[got[:min(k, n_valid)]].all()) if n_valid else True
    ok = mismatches == 0 and in_range and picks_valid
    k_ms = time_ms(lambda: furthest_point_sample(pts, k, valid, presorted=presorted), iters, warmup=1)
    b_ms, parts = fps_bound_ms(n, n_valid, k, exchange_us)
    res = dict(name=name, N=n, n_valid=n_valid, K=k, presorted=presorted is not None, on_main_path=on_main_path,
               mismatches=mismatches, first_mismatch=first_bad, max_abs_err=float(mismatches), tol=0,
               ms=k_ms, us_per_selection=1e3 * k_ms / k, plain_ms=p_ms, library_ms=None,
               bound_ms=b_ms, bound_by="operations", bound_parts=parts, ok=ok)
    emit("fps_kernel", **res)
    if not ok:
        fail(f"fps kernel disagrees with the plain version at {name}: {mismatches} of {k} indices differ "
             f"(first at {first_bad}); in range {in_range}; picks valid {picks_valid}")
    return res


def scene_inputs(batch):
    """The rig and the rendered depth maps of the street scene, on the card."""
    _, _, ph, pw = compute_process_shape(IMG_H, IMG_W, 504)
    c2l = rig_cam2lidar(batch)
    depth = anchor_depth(np.load(REFERENCE_POINTS)["points"], c2l, ph, pw, batch=batch)
    return torch.from_numpy(c2l).cuda(), torch.from_numpy(depth).cuda()


def fps_phase(backbone, c2l, depth, exchange_us):
    """The kernel at the sizes and on the buffers the point path gives it:
    scene 0 of the rendered street scene, taken through the path's own
    stages up to each FPS call."""
    intr = torch.tensor([[1266.0 * depth.shape[-1] / IMG_W, 0, depth.shape[-1] / 2],
                         [0, 1266.0 * depth.shape[-2] / IMG_H, depth.shape[-2] / 2], [0, 0, 1]], device="cuda")
    d = depth[:1]
    pts_cam = depth_to_points_cam(d, intr.expand(1, S, 3, 3))
    pts = torch.einsum("bnhwc,bndc->bnhwd", pts_cam, c2l[:1, :, :3, :3]) + c2l[:1, :, 3, :3][:, :, None, None]
    pts, msk = pts.reshape(-1, 3), (d > 0).reshape(-1)
    p1, m1 = voxel_pre_reduce(pts, msk, voxel_size=PRE_REDUCE_VOXEL, point_cloud_range=backbone.filter_range,
                              max_out=PRE_REDUCE_CAP)
    cs = cell_sort(p1, m1, grid_dim=backbone.bq_grid_dim, min_cell=backbone.bq_max_radius)
    cases = [fps_case("anchors_production_density", p1, m1, ANCHORS, cs, exchange_us, True)]
    bq = dict(anchor_points=ANCHORS, max_radius=backbone.bq_max_radius, sample_num=backbone.bq_sample_num,
              compact=True, grid_dim=backbone.bq_grid_dim, share_sort=True)
    p2, m2 = ball_query_downsample(p1, m1, **bq)
    cases.append(fps_case("final_union_production_density", p2, m2, NUM_POINTS,
                          (p2, m2, torch.arange(p2.shape[0], device="cuda")), exchange_us, True))
    all_valid = torch.ones_like(m1)
    cs_all = cell_sort(p1, all_valid, grid_dim=backbone.bq_grid_dim, min_cell=backbone.bq_max_radius)
    cases.append(fps_case("anchors_fully_valid", p1, all_valid, ANCHORS, cs_all, exchange_us, False))
    # a denser final FPS than this scene gives: the cell-sorted buffer with its first 150,000 rows valid,
    # then the same rows in the larger buffer the union has when pre-reduce is off
    rows = torch.arange(p1.shape[0], device="cuda")
    p3, m3 = cs_all.spts, rows < 150000
    cases.append(fps_case("final_150k_valid", p3, m3, NUM_POINTS, (p3, m3, rows), exchange_us, False))
    pad = UNION_CAP_NO_PRE_REDUCE - p3.shape[0]
    p4, m4 = torch.cat([p3, p3.new_zeros(pad, 3)]), torch.cat([m3, m3.new_zeros(pad)])
    cases.append(fps_case("final_150k_valid_no_pre_reduce_cap", p4, m4, NUM_POINTS,
                          (p4, m4, torch.arange(p4.shape[0], device="cuda")), exchange_us, False, iters=2))
    rng = np.random.default_rng(5)
    small = torch.from_numpy(rng.uniform(-20, 20, (1000, 3)).astype(np.float32)).cuda()
    small_valid = torch.from_numpy(rng.random(1000) < 0.3).cuda()
    cases.append(fps_case("ragged_fewer_valid_than_k", small, small_valid, 500, None, exchange_us, False))
    return cases


def images(seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0.0, 255.0, size=(B, S, IMG_H, IMG_W, 3)).astype(np.float32)).cuda()


def rel_l2(a, b):
    a, b = a.float(), b.float()
    return (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()


def kernel_class(name: str) -> str:
    n = name.lower()
    if "flash_fwd_kernel" in n:
        return "flash_attn_fwd (hand kernel)"
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


def profile(resdet, request, img, runs=2):
    """Stage times from CUDA events (module hooks on the DA3 parts, the
    port's stage timer on the point path and the refinement; mean of
    ``runs`` requests, summed over the scenes of a request), then one
    request under ``torch.profiler``: device time by kernel class, the
    device's idle share of the wall time, top kernels."""
    da3 = resdet.reconstruction_backbone.da3
    stages = {
        "anyview ViT-g": da3.da3.backbone.pretrained,
        "anyview DualDPT head": da3.da3.head,
        "camera decoder": da3.da3.cam_dec,
        "metric ViT-L": da3.da3_metric.backbone.pretrained,
        "metric DPT head": da3.da3_metric.head,
    }
    events = defaultdict(list)
    handles = []
    for name, mod in stages.items():
        def pre(_m, _a, name=name):
            events[name].append([torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)])
            events[name][-1][0].record()

        def post(_m, _a, _o, name=name):
            events[name][-1][1].record()

        handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]

    with stage_timer.collect() as times:
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(runs):
            request(img)
        t1.record()
    for h in handles:
        h.remove()
    stage_ms = {"request": t0.elapsed_time(t1) / runs}
    for name, pairs in events.items():
        stage_ms[name] = float(np.sum([a.elapsed_time(b) for a, b in pairs])) / runs
    stage_ms.update({k: v / runs for k, v in times.items() if not k.endswith("/calls")})

    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        request(img)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)

    by_kernel = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name][0] += e.device_time_total / 1e3
            by_kernel[e.name][1] += 1
    by_class = defaultdict(float)
    for name, (ms, _) in by_kernel.items():
        by_class[kernel_class(name)] += ms
    busy = sum(by_class.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    emit("profile", stage_ms=stage_ms, wall_ms_profiled=wall_ms, device_busy_ms=busy,
         device_idle_share=max(0.0, 1 - busy / wall_ms) if busy else None,
         ms_by_class=dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
         top_kernels=[{"name": n[:120], "ms": v[0], "calls": v[1]} for n, v in top])


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1

    # 1. env
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    emit("env", torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0],
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(), nvidia_smi=smi)

    # 2. build
    t0 = time.perf_counter()
    load_kernels()
    emit("build", seconds=time.perf_counter() - t0,
         kernels={k: {"nvcc_s": v["seconds"], "ptxas": [l for l in v["ptxas"].splitlines() if "Used" in l]}
                  for k, v in BUILD_LOG.items()})

    # 3. flash kernel vs plain at the production shapes (+ a kv_len case)
    cases = {name: kernel_case(name, shape, None, seed=i) for i, (name, shape) in enumerate(SHAPES.items())}
    kvl_case = kernel_case("vitg_global_kv_len", SHAPES["vitg_global"], [2911, S * 721], seed=9)

    # 4. the model of the main path
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    resdet = build_resdet3d(PRESET, dtype=torch.bfloat16, device="cuda", generator=gen, refinement=REFINEMENT,
                            voxel_pre_reduce=PRE_REDUCE_VOXEL, pre_reduce_cap=PRE_REDUCE_CAP,
                            bq_anchor_points=ANCHORS, num_points=NUM_POINTS)
    backbone = resdet.reconstruction_backbone
    model = backbone.da3
    torch.cuda.synchronize()
    emit("model", preset=PRESET, params=sum(p.numel() for p in model.parameters()),
         refinement_params=sum(p.numel() for p in backbone.refinement.parameters()),
         build_s=time.perf_counter() - t0)

    # 5. the DA3 slice of the main path
    def request(img):
        x, _ = process_tensor_batch(img, process_res=504)
        return model(x, use_ray_pose=False, ref_view_strategy="saddle_balanced")

    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        request(images(100))  # warm-up
        torch.cuda.synchronize()
        times, launches = [], []
        reset_launch_counts()
        for r in range(REQUESTS):
            img = images(101 + r)
            torch.cuda.synchronize()
            before = flash_attention_fwd.launches
            t0 = time.perf_counter()
            out = request(img)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            launches.append(flash_attention_fwd.launches - before)
        by_shape = dict(flash_attention_fwd.launches_by_shape)
    for key in ("depth", "depth_conf", "sky"):
        if tuple(out[key].shape) != (B, S, 280, 504) or not bool(torch.isfinite(out[key]).all()):
            fail(f"{key}: shape {tuple(out[key].shape)} or non-finite values")
    for key, shp in (("extrinsics", (B, S, 3, 4)), ("intrinsics", (B, S, 3, 3))):
        if tuple(out[key].shape) != shp or not bool(torch.isfinite(out[key]).all()):
            fail(f"{key}: shape {tuple(out[key].shape)} or non-finite values")
    case_of = {tuple(c["shape"]): c for c in cases.values()}
    unchecked = [shape for shape in by_shape if shape not in case_of]
    if unchecked:
        fail(f"the DA3 slice launched the flash kernel at shapes no kernel case checked: {unchecked}")
    per_forward = {name: by_shape.get(shape, 0) / REQUESTS for name, shape in SHAPES.items()}
    expected = sum(EXPECTED_PER_FORWARD.values())
    if launches != [expected] * REQUESTS or per_forward != EXPECTED_PER_FORWARD:
        fail(f"flash launches per forward {launches} split {per_forward}, expected {EXPECTED_PER_FORWARD}")
    ms_mean = float(np.mean(times))
    emit("slice", requests=REQUESTS, scenes_per_request=B, views=S, image=[IMG_H, IMG_W],
         ms_per_request=times, ms_mean=ms_mean, camera_frames_per_s=B * S / (ms_mean / 1e3),
         flash_launches_per_forward=launches, flash_launches_by_shape={str(k): n for k, n in by_shape.items()},
         depth_mean=out["depth"].mean().item(), scale_factor=out["scale_factor"].item(),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del out

    # 6. in-situ: the flash kernel vs the plain attention inside the full DA3 forward
    with torch.inference_mode():
        x, _ = process_tensor_batch(images(200)[:1], process_res=504)
        kw = dict(export_feat_layers=(39,), ref_view_strategy="first")
        got = model(x, **kw)
        set_attn_impl(model, "plain")
        ref = model(x, **kw)
        set_attn_impl(model, "auto")
    feat_err = rel_l2(got["aux"]["feat_layer_39"], ref["aux"]["feat_layer_39"])
    depth_err = rel_l2(got["depth"], ref["depth"])
    emit("in_situ", feat_layer_39_rel_l2=feat_err, depth_rel_l2=depth_err, tol=FEAT_REL_TOL)
    if not feat_err <= FEAT_REL_TOL:
        fail(f"in-situ feature rel L2 {feat_err} > {FEAT_REL_TOL}")
    del got, ref

    # 7. fps kernel vs plain on the buffers of the point path
    c2l, depth = scene_inputs(B)
    exchange_us = 1e3 * time_ms(lambda: fps_ops.exchange_probe(ANCHORS), 3, warmup=1) / (ANCHORS - 1)
    emit("fps_exchange", rounds=ANCHORS - 1, us_per_round=exchange_us)
    fps_cases = fps_phase(backbone, c2l, depth, exchange_us)
    fps_case_of = {(c["N"], c["K"]): c for c in fps_cases if c["on_main_path"]}

    # 8. the whole main path: ResDet3D.simple_test
    torch.cuda.reset_peak_memory_stats()
    resdet.simple_test(images(400), c2l, depth_override=depth)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    fps_ops.reset_launch_counts()
    times, counts = [], []
    for r in range(REQUESTS):
        img = images(401 + r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = resdet.simple_test(img, c2l, depth_override=depth)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        counts.append({k: [int(c) for c in v] for k, v in backbone.last_stage_counts.items()})
    flash_total, flash_by_shape = flash_attention_fwd.launches, dict(flash_attention_fwd.launches_by_shape)
    fps_total = fps_ops.furthest_point_sample_cuda.launches
    fps_by_shape = dict(fps_ops.furthest_point_sample_cuda.launches_by_shape)
    pts, msk, logits = out["pseudo_points"], out["pseudo_valid"], out["aux"]["occupancy_logits"]
    if tuple(pts.shape) != (B, NUM_POINTS, 3) or not bool(torch.isfinite(pts).all()):
        fail(f"pseudo_points: shape {tuple(pts.shape)} or non-finite values")
    if tuple(logits.shape) != (B, 180, 180, 32) or logits.dtype != torch.float32 \
            or not bool(torch.isfinite(logits).all()):
        fail(f"occupancy_logits: shape {tuple(logits.shape)} dtype {logits.dtype} or non-finite values")
    if tuple(msk.shape) != (B, NUM_POINTS) or int(msk.sum()) == 0:
        fail(f"pseudo_valid: shape {tuple(msk.shape)} with {int(msk.sum())} valid points")
    lo = torch.tensor(backbone.filter_range[:3], device="cuda")
    hi = torch.tensor(backbone.filter_range[3:], device="cuda")
    if not bool(((pts[msk] >= lo) & (pts[msk] <= hi)).all()):
        fail("a valid pseudo point lies outside the filter range")
    unchecked = [shape for shape in fps_by_shape if shape not in fps_case_of]
    if unchecked:
        fail(f"the main path launched the fps kernel at sizes no fps case checked: {unchecked}")
    fps_expected = {shape: n * B * REQUESTS for shape, n in FPS_EXPECTED_PER_SCENE.items()}
    if fps_by_shape != fps_expected or fps_total != sum(fps_expected.values()):
        fail(f"fps launches {fps_by_shape}, expected {fps_expected}")
    flash_expected = {SHAPES[name]: n * REQUESTS for name, n in EXPECTED_PER_FORWARD.items()}
    if flash_by_shape != flash_expected:
        fail(f"flash launches on the main path {flash_by_shape}, expected {flash_expected}")
    ms_full = float(np.mean(times))
    emit("resdet3d", requests=REQUESTS, scenes_per_request=B, views=S, image=[IMG_H, IMG_W],
         ms_per_request=times, ms_mean=ms_full, camera_frames_per_s=B * S / (ms_full / 1e3),
         valid_counts_per_scene=counts[-1], pseudo_valid=int(msk.sum()),
         depth_override_valid_share=float((depth > 0).float().mean()),
         logits_mean=logits.mean().item(), logits_std=logits.std().item(),
         fps_launches_per_request=fps_total / REQUESTS,
         fps_launches_by_size={str(k): n for k, n in fps_by_shape.items()},
         flash_launches_per_request=flash_total / REQUESTS,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)

    # 9. in-situ: the fps kernel vs its plain version inside one scene's point path
    da3_depth, intr, _ = backbone.predict_depth(img[:1])
    got_pts, got_msk = backbone.points_from_depth(depth[:1], intr, img[:1], c2l[:1])
    backbone.fps_impl = "plain"
    ref_pts, ref_msk = backbone.points_from_depth(depth[:1], intr, img[:1], c2l[:1])
    backbone.fps_impl = "auto"
    same = bool(torch.equal(got_pts, ref_pts) and torch.equal(got_msk, ref_msk))
    emit("in_situ_fps", identical=same, points=list(got_pts.shape), valid=int(got_msk.sum()))
    if not same:
        fail("in-situ: points_from_depth with the fps kernel differs from the run with its plain version")

    # 10. where one request's time goes
    profile(resdet, lambda im: resdet.simple_test(im, c2l, depth_override=depth), images(300))

    # 11. kernel table: per kernel, its numbers summed over one request's launch
    # mix as counted on the main path in phase 8 (per-shape numbers under
    # "shapes"), and the kernels still to port
    mix = {key: sum(case_of[shape][key] * n for shape, n in flash_by_shape.items()) / REQUESTS
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    by = "operations" if all(case_of[shape]["bound_by"] == "operations" for shape in flash_by_shape) else "bytes"
    fps_mix = {key: sum(fps_case_of[shape][key] * n for shape, n in fps_by_shape.items()) / REQUESTS
               for key in ("ms", "plain_ms", "bound_ms")}
    table = {
        "kernels": [
            dict(name="flash_attn_fwd", route="cuda", source="recondet3d_torch/csrc/flash_attn_fwd.cu",
                 replaces="recondet3d/ops/attention.py:54", status="ported+checked", launches=flash_total,
                 launches_da3_slice=sum(by_shape.values()),
                 max_abs_err=max(c["max_abs_err"] for c in list(cases.values()) + [kvl_case]),
                 ms=mix["ms"], plain_ms=mix["plain_ms"], bound_ms=mix["bound_ms"], bound_by=by,
                 library_ms=mix["library_ms"], per="one request's launch mix (B=2)",
                 shapes=[dict(c, launches_per_forward=per_forward[n]) for n, c in cases.items()] + [kvl_case]),
            dict(name="fps", route="cuda", source="recondet3d_torch/csrc/fps.cu",
                 replaces="recondet3d/ops/fps_pallas.py:54", status="ported+checked", launches=fps_total,
                 max_abs_err=max(c["max_abs_err"] for c in fps_cases),
                 ms=fps_mix["ms"], plain_ms=fps_mix["plain_ms"], bound_ms=fps_mix["bound_ms"],
                 bound_by="operations", library_ms=None, per="one request's launch mix (B=2: 4 launches)",
                 note="max_abs_err counts differing indices (gate: 0); bound = max(bytes, K*n_valid fp32 distance "
                      "updates, K-1 dependent grid-wide exchanges as timed in this run); no single PyTorch call "
                      "computes FPS, so library_ms is null",
                 exchange_us_per_round=exchange_us, shapes=fps_cases),
        ],
        "not_yet_ported": [
            dict(name="flash_bwd_dq", replaces="recondet3d/ops/attention.py:185", status="not yet ported"),
            dict(name="flash_bwd_dkv", replaces="recondet3d/ops/attention.py:231", status="not yet ported"),
        ],
    }
    print(json.dumps(table), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
