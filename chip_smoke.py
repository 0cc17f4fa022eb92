#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. env      torch / CUDA versions and the card (nvidia-smi name, power limit).
2. build    compiles every CUDA kernel of the port from ``recondet3d_torch/csrc``
            (one nvcc per source, started together); per kernel the ptxas
            registers, spills and shared memory, and the Hopper kernels'
            wgmma / TMA instructions counted in the SASS (``cuobjdump``). Fails on a spill or an ignored
            ``setmaxnreg`` in the forward, dq or dk/dv kernel, or if one has
            no HGMMA or no TMA load; launches the FPS kernel once on a small
            cloud and fails unless it ran with its cluster dimension (16).
3. kernel   the flash-attention kernel vs its plain PyTorch version (fp32
            math on the same bf16 values) at the DA3 nested-giant-large
            shapes, plus one case at a scale that is no power of two, with
            times of the kernel, the plain version, one
            ``scaled_dot_product_attention`` call (a yardstick only, never
            used by the port), the card's lower bound and the floor of the
            exponentials alone (one ex2 per needed score on the MUFU).
4. model    ``build_resdet3d("da3nested-giant-large")`` at the benchmark
            configuration of the JAX package, random weights from seed 0.
5. slice    the DA3 slice of the main path: requests of B=2 scenes x 6
            views x 900x1600 images through ``process_tensor_batch`` and the
            nested forward; output shapes and finiteness checked, flash
            launches counted per shape.
6. in-situ  one B=1 forward with the flash kernel and one with the plain
            attention; the last ViT-g feature map must agree.
6b. gt-pose the nested-giant-large net of phase 4 with GT poses (random w2c
            extrinsics and pinhole intrinsics from a seed), B=2 scenes x 6
            views x 900x1600: ``CameraEnc`` runs its four fp32 trunk blocks
            (16 heads of 96) through the fp32 attention kernel, launches
            counted per shape; once more with the camera encoder's attention
            switched to the plain version: camera tokens and depth must
            agree. Before it, the fp32 kernel against its plain version at
            the camera encoders' shapes of da3-giant (D = 96) and da3-large
            (D = 64), timed on the device (``torch.profiler``) and on the
            host beside the plain version and SDPA on the same fp32 inputs,
            and one da3-large ``CameraEnc`` (kernel vs plain).
7. fps      the furthest-point-sampling kernel vs its plain PyTorch
            version at the sizes the point path gives it, on the buffers
            that path produces for a rendered street scene; the index
            sequences must be identical. Times of the kernel, the plain
            version, the bound (bytes or fp32 operations), and the exchange
            floor: this design's exchange alone (one cluster, or two levels
            for the clusters a case uses) times K - 1.
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
11. bwd      the two flash-attention backward kernels (dq; dk and dv) vs
            their plain PyTorch version on the same bf16 values at the
            shapes a fine-tuning step gives them (ViT-L local and global),
            one case with ``kv_len``, one at a scale that is no power of two
            and the ViT-g global shape; same bits run to run; times of each
            kernel, the plain version, the backward of
            ``scaled_dot_product_attention`` (a yardstick only), the bound
            and the exponentials' floor.
12. finetune ``Trainer`` with ``frozen_patterns=()`` on
            ``build_resdet3d("da3-large", freeze_da3=False)``: fp32 master
            parameters, bf16 compute, every ViT block under checkpointing
            (the depth head's last convolution scaled by 0.1 so that the
            random net's exp() depths stay finite under AdamW),
            B=1 scene x 6 views x 900x1600 images and 40,000 GT points;
            one warm-up and three steps. Losses and gradients finite, DA3
            gradient norm > 0, a ViT and a refinement parameter moved, flash
            forward / dq / dk-dv launches counted per shape and held to
            the count the model's blocks give.
13. in-situ  at the fine-tuning model's weights as built (before the steps of
            phase 12 move them): one backward through the whole DA3 net with
            the kernels and one with the plain attention under autograd; the
            patch-embedding and last-block qkv gradients must agree.
14. train    the production train step: the nested-giant model of phase 4,
            ``Trainer`` with DA3 frozen; one warm-up and three steps; finite
            loss, no backward-kernel launch, no optimizer state for DA3, DA3
            parameters bit-identical afterwards.
15. the kernel table as one JSON line; then the card line, then the result.

``--parent DIR`` (a ``git archive`` of an earlier tree, e.g. in the git-ignored
``scratch_tree/``) adds one phase after phase 7: the FPS kernel on this run's
FPS cases and the dq kernel at the fine-tuning shapes, timed by
``recondet3d_torch/tools/kernel_times.py`` in four processes, the earlier
tree's and this tree's in turns (parent, change, change, parent).

Needs CUDA; exits non-zero without it (or without the rest of the repo).
"""

from __future__ import annotations

import functools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch
import torch.nn.functional as F

from recondet3d_torch.data.anchor_scene import anchor_depth, rig_cam2lidar
from recondet3d_torch.data.input_processor import compute_process_shape, process_tensor_batch
from recondet3d_torch.data.pipelines.point_pipeline import ball_query_downsample, voxel_pre_reduce
from recondet3d_torch.models.da3 import CameraEnc
from recondet3d_torch.models.da3.layers import init_parameters_, set_attn_impl
from recondet3d_torch.models.detect import build_resdet3d
from recondet3d_torch.ops import fps as fps_ops
from recondet3d_torch.models.detect import ReconstructionBackbone, ResDet3D
from recondet3d_torch.ops.attention import (
    attention_bwd_plain,
    attention_fwd_f32,
    attention_plain,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_fwd,
    reset_launch_counts,
)
from recondet3d_torch.ops.build import BUILD_LOG, load_kernels
from recondet3d_torch.ops.cell_sort import cell_sort
from recondet3d_torch.ops.sampling import furthest_point_sample
from recondet3d_torch.utils import stage_timer
from recondet3d_torch.train import Trainer
from recondet3d_torch.utils.geometry import depth_to_points_cam

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
SMS, EX2_PER_CLOCK_PER_SM = 132, 16  # H100 SXM: SMs, MUFU ex2 results per clock per SM
# kernel vs the plain version in fp32 on the same bf16 values. Out values are
# ~0.02-0.3 at these shapes: the absolute gate sits a few bf16 ulps above the
# readings (7.5e-4 to 2.0e-3 on an H100), the relative L2 gate catches faults
# spread thin over the output (a dropped ragged K/V tile moves it ~0.1).
OUT_TOL, OUT_REL_TOL, LSE_TOL = 5e-3, 1e-2, 1e-3
FEAT_REL_TOL = 5e-2  # relative L2 of the last ViT-g feature map, kernel vs plain attention
# fp32 attention kernel vs fp32 attention_plain: relative L2 of out (readings ~7e-8 on an H100) and max |lse error|
F32_REL_TOL, F32_LSE_TOL = 1e-5, 1e-5
# GT-pose path, camera encoder's attention on the kernel vs on the plain version, everything else the same:
# the camera tokens (fp32 end to end) to F32_REL_TOL; the depth, after 40 bf16 ViT-g blocks that take the tokens,
# to the in-situ feature gate (one bf16 rounding flipped by a 1e-7 difference is ~4e-3 of a value)
POSE_DEPTH_REL_TOL = FEAT_REL_TOL
CAM_BLOCKS = 4  # CameraEnc trunk depth: fp32 launches per GT-pose forward

PRESET = "da3nested-giant-large"
B, S, IMG_H, IMG_W = 2, 6, 900, 1600
REQUESTS = 3
# the (B, H, N, M) shapes a nested forward gives the kernel at 6 views of 280x504 (721 tokens a view)
SHAPES = {
    "vitg_local": (B * S, 24, 721, 721),
    "vitg_global": (B, 24, S * 721, S * 721),
    "vitl_local": (B * S, 16, 721, 721),
}
# (B, H, S, D) of the camera encoder's trunk attention: 16 heads of dim_out / 16, one token a view
CAM_SHAPES = {"cam_enc_giant": (B, 16, S, 96), "cam_enc_large": (B, 16, S, 64)}
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

# backward kernels vs the plain version (the same roundings of qs, P and dS, fp32 sums in another order) on the
# same bf16 values: relative L2 and max |error| of each of dq, dk, dv. Gradients are ~0.04-0.2 at these shapes;
# both gates were fixed before the first run on the card.
BWD_REL_TOL, BWD_ABS_TOL = 1e-2, 5e-3
# in-situ: relative L2 of a parameter's gradient through the whole DA3 net, kernels vs plain attention under
# autograd. The two attentions round differently (the kernels round qs, P and dS to bf16, the plain version
# keeps them in fp32), and 24 random-weight blocks amplify that: the forward's in-situ depth maps already differ
# by 0.14 (phase 6), these gradients by 0.09-0.10 at the weights as built; a wrong kernel moves them by ~1.
GRAD_REL_TOL = 0.2
FT_PRESET, TRAIN_B, TRAIN_STEPS, GT_POINTS = "da3-large", 1, 3, 40000
# (B, H, N, M) a fine-tuning step of da3-large (ViT-L: 16 heads of 64) gives the three flash kernels
FT_SHAPES = {"vitl_local_b1": (TRAIN_B * S, 16, 721, 721), "vitl_global_b1": (TRAIN_B, 16, S * 721, S * 721)}
# the forward kernel's shapes in the two train steps: da3-large (a) and nested-giant-large (b) at B=1
TRAIN_FWD_SHAPES = dict(FT_SHAPES, vitg_local_b1=(TRAIN_B * S, 24, 721, 721),
                        vitg_global_b1=(TRAIN_B, 24, S * 721, S * 721))
# The flax initializers give the depth head's last convolution logits of about +-9, and depth = exp(logit):
# under AdamW every weight moves by ~lr per step whatever its gradient, the logits of this random net grow by
# several units a step, and within a few steps a depth overflows to inf, whose masked-out pixel still turns
# the gradients into NaN (0 * inf in the backward of exp). The fine-tuning phase therefore scales that one
# convolution's random weights once, before the first step: depths start within about [0.9, 2.5] m and stay
# finite over the steps taken here (``recondet3d_torch/tools/finetune_divergence.py`` follows both cases for
# eight steps). Widths, depth of the net and every other weight are as built.
FT_DEPTH_HEAD_SCALE = 0.1
MIN_POINTS = 1000  # a train step's scene must keep at least this many points, or max_depth is set from the depth


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


@functools.lru_cache(maxsize=None)
def max_sm_clock_hz():
    """The card's maximum SM clock as ``nvidia-smi`` reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.split()[0]) * 1e6


def exp_floor_ms(N, kv_rows):
    """The time of the exponentials alone: one ex2 per needed (query, key)
    score at the MUFU's rate, at the card's maximum SM clock."""
    return 1e3 * N * float(kv_rows.sum()) / (EX2_PER_CLOCK_PER_SM * SMS * max_sm_clock_hz())


def kernel_case(name, shape, kv_len, seed, iters=20, scale=None):
    """The forward kernel against ``attention_plain`` on the scores of the
    TPU kernel: bf16(q * scale) k^T, formed here in fp32 and rounded."""
    Bq, H, N, M = shape
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((Bq, H, n, 64), dtype=np.float32)).cuda().to(torch.bfloat16)
               for n in (N, M, M))
    kvl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    out, lse = flash_attention_fwd(q, k, v, kvl, scale)
    torch.cuda.synchronize()
    qs = (q.float() * (64 ** -0.5 if scale is None else scale)).to(q.dtype)
    ref_out, ref_lse = attention_plain(qs.float(), k.float(), v.float(), kvl, 1.0)
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
    k_ms = time_ms(lambda: flash_attention_fwd(q, k, v, kvl, scale), iters)
    p_ms = time_ms(lambda: attention_plain(q, k, v, kvl, scale), 3, warmup=1)
    l_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale), iters)
    b_ms, b_by = bound_ms(Bq * H, N, rows)
    res = dict(name=name, shape=list(shape), kv_len=kv_len, scale=scale, max_abs_err=err_out, rel_l2_err=rel_out,
               max_abs_err_lse=err_lse, tol=dict(out=OUT_TOL, out_rel_l2=OUT_REL_TOL, lse=LSE_TOL),
               ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
               exp_floor_ms=exp_floor_ms(N, rows), tflops=4.0 * N * 64 * rows.sum() / (k_ms * 1e-3) / 1e12, ok=ok)
    emit("kernel", **res)
    if not ok:
        fail(f"flash kernel disagrees with the plain version at {name}: "
             f"out {err_out} (rel L2 {rel_out}), lse {err_lse}")
    return res


def bwd_bound_ms(BH, N, M, kv_rows, ops_per_pair, n_out_rows, D=64):
    """Least time for one backward kernel: the larger of the bf16 tensor-core
    time of ``ops_per_pair``*D operations per needed (query, key) pair (6 for
    dq: S, dP, dS K; 8 for dk and dv: S, dP, P^T dO, dS^T Q) and the time to
    read q, dO (N rows), k, v (needed rows), lse and delta once and write
    ``n_out_rows`` output rows per (b*h) once."""
    flops = float(ops_per_pair) * N * D * float(kv_rows.sum())
    nbytes = 2 * BH * N * D * 2 + 2 * float(kv_rows.sum()) * D * 2 + 2 * BH * N * 4 + BH * n_out_rows * D * 2
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bwd_case(name, shape, kv_len, seed, on_path, iters=10, scale=None):
    """Both backward kernels against ``attention_bwd_plain`` on one set of
    bf16 values, with out and lse from the forward kernel."""
    Bq, H, N, M = shape
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((Bq, H, n, 64), dtype=np.float32)).cuda().to(torch.bfloat16)
                   for n in (N, M, M, N))
    kvl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    out, lse = flash_attention_fwd(q, k, v, kvl, scale)
    got = flash_attention_bwd(q, k, v, out, lse, do, kvl, scale)
    torch.cuda.synchronize()
    ref = attention_bwd_plain(q, k, v, out, lse, do, kvl, scale)
    errs = {}
    for key, a, r in zip(("dq", "dk", "dv"), got, ref):
        errs[key] = dict(rel_l2=rel_l2(a, r), max_abs=(a.float() - r.float()).abs().max().item(),
                         finite=bool(torch.isfinite(a).all()))
    del ref
    ok = all(e["rel_l2"] <= BWD_REL_TOL and e["max_abs"] <= BWD_ABS_TOL and e["finite"] for e in errs.values())
    again = flash_attention_bwd(q, k, v, out, lse, do, kvl, scale)
    same_bits = all(torch.equal(a, b) for a, b in zip(got, again))

    delta = (do.float() * out.float()).sum(dim=-1)
    if kvl is None:
        mask, rows = None, np.full(Bq * H, M, np.float64)
    else:
        mask = (torch.arange(M, device="cuda")[None, :] < kvl[:, None])[:, None, None, :]
        rows = np.repeat(np.minimum(np.asarray(kv_len, np.float64), M), H)
    dq_ms = time_ms(lambda: flash_attention_bwd_dq(q, k, v, do, lse, delta, kvl, scale), iters)
    dkv_ms = time_ms(lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta, kvl, scale), iters)
    delta_ms = time_ms(lambda: (do.float() * out.float()).sum(dim=-1), iters)
    p_ms = time_ms(lambda: attention_bwd_plain(q, k, v, out, lse, do, kvl, scale), 1, warmup=1)
    # the library's backward, timed alone: one autograd call over a forward made once
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask, scale=scale)
    # (the least of three timings: at the small shapes this call is bound by autograd's host work, which varies)
    l_ms = min(time_ms(lambda: torch.autograd.grad(o_lib, (ql, kl, vl), do, retain_graph=True), iters)
               for _ in range(3))
    del o_lib
    dq_b, dq_by = bwd_bound_ms(Bq * H, N, M, rows, 6, N)
    dkv_b, dkv_by = bwd_bound_ms(Bq * H, N, M, rows, 8, 2 * M)
    pairs = N * 64 * rows.sum()
    floor = exp_floor_ms(N, rows)  # dq and dk/dv each recompute P: one ex2 per needed score
    res = dict(name=name, shape=list(shape), kv_len=kv_len, scale=scale, on_path=on_path, errors=errs,
               max_abs_err=max(e["max_abs"] for e in errs.values()),
               rel_l2_err=max(e["rel_l2"] for e in errs.values()),
               tol=dict(rel_l2=BWD_REL_TOL, max_abs=BWD_ABS_TOL), same_bits_run_to_run=same_bits,
               dq=dict(ms=dq_ms, bound_ms=dq_b, bound_by=dq_by, exp_floor_ms=floor,
                       tflops=6.0 * pairs / (dq_ms * 1e-3) / 1e12),
               dkv=dict(ms=dkv_ms, bound_ms=dkv_b, bound_by=dkv_by, exp_floor_ms=floor,
                        tflops=8.0 * pairs / (dkv_ms * 1e-3) / 1e12),
               delta_ms=delta_ms, plain_ms=p_ms, library_ms=l_ms, ok=ok and same_bits)
    emit("bwd_kernel", **res)
    if not res["ok"]:
        fail(f"flash backward kernels disagree with the plain version at {name}: {errs}; "
             f"same bits run to run: {same_bits}")
    return res


def fps_bound_ms(n_rows, n_valid, k):
    """Least time for one FPS call on these inputs: the larger of the bytes
    (points and mask read once, indices written once) over the memory rate
    and the k * n_valid distance updates (3 subtractions, 3 products, 2
    sums, 1 minimum = 9 fp32 operations on a valid point; an invalid one
    needs none) over the fp32 rate. Returns (ms, "bytes" or "operations")."""
    t_bytes = 1e3 * (n_rows * 13 + k * 4) / PEAK_BYTES
    t_ops = 1e3 * 9.0 * k * n_valid / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes else "bytes")


def fps_case(name, pts, valid, k, presorted, exchange_us, on_main_path, iters=3):
    """Kernel vs plain version on one buffer: the index sequences must be
    identical (FPS is chaotic: one different pick changes all later ones).
    ``exchange_us``: {clusters: µs of one step of this design's exchange}."""
    n = pts.shape[0]
    n_valid = int(valid.sum())
    got = furthest_point_sample(pts, k, valid, presorted=presorted)
    kernel_args = fps_ops.furthest_point_sample_cuda.last_args
    ctrl = fps_ops.furthest_point_sample_cuda.last_ctrl.tolist()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = furthest_point_sample(pts, k, valid, impl="plain", presorted=presorted)
    torch.cuda.synchronize()
    p_ms = 1e3 * (time.perf_counter() - t0)
    mismatches = int((got != ref).sum())
    first_bad = int((got != ref).nonzero()[0]) if mismatches else None
    in_range = bool(((got >= 0) & (got < n)).all())
    picks_valid = bool(valid[got[:min(k, n_valid)]].all()) if n_valid else True
    ok = mismatches == 0 and in_range and picks_valid and ctrl[2] == fps_ops.CLUSTER
    k_ms = time_ms(lambda: furthest_point_sample(pts, k, valid, presorted=presorted), iters, warmup=1)
    b_ms, b_by = fps_bound_ms(n, n_valid, k)
    clusters = ctrl[3]
    res = dict(name=name, N=n, n_valid=n_valid, K=k, presorted=presorted is not None, on_main_path=on_main_path,
               plan=fps_ops.furthest_point_sample_cuda.last_plan._asdict(), cluster_size=ctrl[2],
               clusters_used=clusters, mismatches=mismatches, first_mismatch=first_bad, max_abs_err=float(mismatches),
               tol=0, ms=k_ms, us_per_selection=1e3 * k_ms / k, plain_ms=p_ms, library_ms=None,
               bound_ms=b_ms, bound_by=b_by, exchange_us=exchange_us[clusters],
               exchange_floor_ms=1e-3 * exchange_us[clusters] * (k - 1), ok=ok)
    emit("fps_kernel", **res)
    if not ok:
        fail(f"fps kernel disagrees with the plain version at {name}: {mismatches} of {k} indices differ "
             f"(first at {first_bad}); in range {in_range}; picks valid {picks_valid}; cluster size {ctrl[2]}")
    res["kernel_args"] = kernel_args
    return res


def f32_bound_ms(shape):
    """Least time for one fp32 attention call over (B, H, S, D): the larger
    of 4*S*S*D fp32 operations a head over the fp32 rate and q, k, v and out
    (fp32) and lse read or written once over the memory rate."""
    Bq, H, N, D = shape
    t_ops = 4.0 * Bq * H * N * N * D / PEAK_FP32_FLOPS
    t_bytes = (4 * Bq * H * N * D * 4 + Bq * H * N * 4) / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def device_ms_per_call(fn, calls):
    """Device time of one call of ``fn``: the summed durations of what it
    runs on the card, read from ``torch.profiler`` over ``calls`` calls, so
    the host's time between launches does not count."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    if not us > 0:
        fail("torch.profiler recorded no device time")
    return us / 1e3 / calls


def f32_case(name, shape, seed, iters=100):
    """The fp32 attention kernel against ``attention_plain`` (fp32) on one set
    of fp32 inputs. At these shapes a call is launch-bound: ``ms``,
    ``plain_ms`` and ``library_ms`` (SDPA on the same fp32 inputs) are device
    time from the profiler, the ``host_*`` keys the time a call takes in a
    loop of ``iters`` calls."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda() for _ in range(3))
    out, lse = attention_fwd_f32(q, k, v)
    ref_out, ref_lse = attention_plain(q, k, v)
    rel, err = rel_l2(out, ref_out), (out - ref_out).abs().max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    ok = rel <= F32_REL_TOL and err_lse <= F32_LSE_TOL and bool(torch.isfinite(out).all())
    b_ms, b_by = f32_bound_ms(shape)
    calls = {"": lambda: attention_fwd_f32(q, k, v), "plain_": lambda: attention_plain(q, k, v),
             "library_": lambda: F.scaled_dot_product_attention(q, k, v)}
    times = {}
    for key, fn in calls.items():
        times[f"{key}ms"] = device_ms_per_call(fn, iters)
        times[f"{key}host_ms"] = time_ms(fn, iters)
    res = dict(name=name, shape=list(shape), max_abs_err=err, rel_l2_err=rel, max_abs_err_lse=err_lse,
               library_rel_l2=rel_l2(F.scaled_dot_product_attention(q, k, v), ref_out),
               tol=dict(out_rel_l2=F32_REL_TOL, lse=F32_LSE_TOL), **times, bound_ms=b_ms, bound_by=b_by, ok=ok)
    emit("f32_kernel", **res)
    if not ok:
        fail(f"fp32 attention kernel disagrees with the plain version at {name}: rel L2 {rel}, lse {err_lse}")
    return res


def gt_poses(batch, views, seed, h, w):
    """Random w2c extrinsics (B, S, 4, 4) (rotations from the QR of normal
    matrices, translations of a few metres) and pinhole intrinsics (B, S, 3,
    3) at the processed image size h x w (the rig's focal length, scaled,
    +-10 %), from a seed."""
    rng = np.random.default_rng(seed)
    rot, _ = np.linalg.qr(rng.normal(size=(batch, views, 3, 3)))
    rot = rot * np.sign(np.linalg.det(rot))[..., None, None]
    ext = np.zeros((batch, views, 4, 4), np.float32)
    ext[..., :3, :3] = rot
    ext[..., :3, 3] = rng.normal(scale=2.0, size=(batch, views, 3))
    ext[..., 3, 3] = 1.0
    ixt = np.zeros((batch, views, 3, 3), np.float32)
    ixt[..., 0, 0] = ixt[..., 1, 1] = 1266.0 * w / IMG_W * rng.uniform(0.9, 1.1, size=(batch, views))
    ixt[..., 0, 2], ixt[..., 1, 2], ixt[..., 2, 2] = w / 2, h / 2, 1.0
    return torch.from_numpy(ext).cuda(), torch.from_numpy(ixt).cuda()


def gt_pose_phase(model):
    """GT-pose conditioning through the nested net (B=2 x 6 views): the
    camera encoder's fp32 trunk attention on the kernel, counted per shape,
    then on the plain version with everything else the same. Returns the
    phase's result and the fp32 launches by shape."""
    x, _ = process_tensor_batch(images(700), process_res=504)
    ext, ixt = gt_poses(B, S, 701, x.shape[2], x.shape[3])
    enc = model.da3.cam_enc
    kw = dict(extrinsics=ext, intrinsics=ixt, use_ray_pose=False, ref_view_strategy="saddle_balanced")
    with torch.inference_mode():
        model(x, **kw)  # warm-up
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        got = model(x, **kw)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        launches = dict(attention_fwd_f32.launches_by_shape)
        tok = enc(ext, ixt, (x.shape[2], x.shape[3]))
        set_attn_impl(enc, "plain")
        ref = model(x, **kw)
        tok_ref = enc(ext, ixt, (x.shape[2], x.shape[3]))
        set_attn_impl(enc, "auto")
        no_poses = model(x, use_ray_pose=False, ref_view_strategy="saddle_balanced")
    res = dict(scenes=B, views=S, image=[IMG_H, IMG_W], ms=ms, f32_launches_by_shape={str(k): n for k, n in
                                                                                        launches.items()},
               cam_token_rel_l2=rel_l2(tok, tok_ref), depth_rel_l2=rel_l2(got["depth"], ref["depth"]),
               extrinsics_rel_l2=rel_l2(got["extrinsics"], ref["extrinsics"]),
               depth_rel_l2_vs_no_poses=rel_l2(got["depth"], no_poses["depth"]),
               tol=dict(cam_token=F32_REL_TOL, depth=POSE_DEPTH_REL_TOL),
               depth_finite=bool(torch.isfinite(got["depth"]).all()), depth_mean=got["depth"].mean().item())
    emit("gt_pose", **res)
    expected = {(B, 16, S, S, 96): CAM_BLOCKS}
    if launches != expected:
        fail(f"gt-pose: fp32 launches {launches}, expected {expected}")
    if tuple(got["depth"].shape) != (B, S, 280, 504) or not res["depth_finite"]:
        fail(f"gt-pose: depth of shape {tuple(got['depth'].shape)} or non-finite")
    if not res["depth_rel_l2_vs_no_poses"] > 0:
        fail("gt-pose: the depth with GT poses equals the depth without them: the camera tokens did not reach it")
    if not (res["cam_token_rel_l2"] <= F32_REL_TOL and res["depth_rel_l2"] <= POSE_DEPTH_REL_TOL):
        fail(f"gt-pose: kernel vs plain camera tokens {res['cam_token_rel_l2']}, depth {res['depth_rel_l2']}")
    return res, launches


def large_cam_enc_case():
    """One da3-large camera encoder (dim_out 1024: 16 heads of 64), random
    weights from a seed, on B=2 x 6 GT poses: kernel vs plain tokens."""
    enc = CameraEnc(dim_out=1024, device="cuda")
    init_parameters_(enc, torch.Generator(device="cuda").manual_seed(11))
    ext, ixt = gt_poses(B, S, 702, 280, 504)
    with torch.inference_mode():
        tok = enc(ext, ixt, (280, 504))
        set_attn_impl(enc, "plain")
        ref = enc(ext, ixt, (280, 504))
    err = rel_l2(tok, ref)
    emit("cam_enc_large", tokens=list(tok.shape), rel_l2=err, tol=F32_REL_TOL)
    if not err <= F32_REL_TOL:
        fail(f"da3-large CameraEnc: kernel vs plain tokens rel L2 {err}")
    return err


def parent_comparison(parent, fps_cases):
    """The FPS kernel on this run's FPS cases and the dq kernel at the
    fine-tuning shapes, of the tree at ``parent`` and of this one, timed by
    ``recondet3d_torch/tools/kernel_times.py`` in four processes in turns:
    parent, change, change, parent. Both trees must give the same FPS
    indices."""
    here = os.path.dirname(os.path.abspath(__file__))
    tool = os.path.join(here, "recondet3d_torch", "tools", "kernel_times.py")
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "fps_inputs.pt")
        torch.save([dict(name=c["name"], points=a[0].cpu(), valid=a[1].cpu(), start=a[2].cpu(), k=a[3])
                    for c in fps_cases for a in [c["kernel_args"]]], inputs)
        for tree, label in ((parent, "parent"), (here, "change"), (here, "change"), (parent, "parent")):
            tree = os.path.abspath(tree)
            out = subprocess.run([sys.executable, tool, inputs], cwd=tree, capture_output=True, text=True, timeout=900,
                                 env=dict(os.environ, PYTHONPATH=tree))
            if out.returncode != 0:
                fail(f"kernel_times.py in {tree} failed ({out.returncode}): {out.stderr[-2000:]}")
            runs.append(dict(tree=label, **json.loads(out.stdout.strip().splitlines()[-1])))
    emit("parent_comparison", parent=os.path.abspath(parent), runs=runs)
    if any(r["fps_indices_sum"] != runs[0]["fps_indices_sum"] for r in runs):
        fail("parent comparison: the two trees' FPS kernels chose different indices")
    return runs


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

    emit("profile", stage_ms=stage_ms, **device_profile(lambda: request(img)))


def device_profile(fn, top_n=15):
    """One call of ``fn`` under ``torch.profiler``: device time by kernel
    class, the device's idle share of the wall time, top kernels."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:top_n]
    return dict(wall_ms_profiled=wall_ms, device_busy_ms=busy,
                device_idle_share=max(0.0, 1 - busy / wall_ms) if busy else None,
                ms_by_class=dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
                top_kernels=[{"name": n[:120], "ms": v[0], "calls": v[1]} for n, v in top])


def sparse_conv_backward_cost(refinement, pts, msk):
    """The sparse convolution's gather-form backward (what the port runs)
    beside autograd's own derivative of the row gather (a scatter-add with
    atomics) on the first encoder stage's neighbour map of a real request:
    forward + backward ms of each, and their largest difference."""
    from recondet3d_torch.models.refine.refinement import batch_voxelize
    from recondet3d_torch.ops import sparse_conv as sc

    with torch.no_grad():
        _, coors, _ = batch_voxelize(pts[:1], msk[:1], point_cloud_range=refinement.point_cloud_range,
                                     voxel_size=refinement.voxel_size, max_points=refinement.max_num_points,
                                     max_voxels=refinement.max_voxels)
        st = sc.sort_by_column(sc.sparse_tensor_from_voxels(
            torch.zeros(coors.shape[0], 1, device="cuda"), coors, refinement.middle_encoder.sparse_shape, 1))
        nbr = sc.build_neighbor_map(st, 3)
    gen = torch.Generator(device="cuda").manual_seed(3)
    n, c = nbr.shape[0], 16
    f = torch.randn(n, c, device="cuda", generator=gen).to(torch.bfloat16).requires_grad_()
    f.data[~st.valid] = 0
    w = (torch.randn(27, c, c, device="cuda", generator=gen) / (27 * c) ** 0.5).requires_grad_()
    g = torch.randn(n, c, device="cuda", generator=gen).to(torch.bfloat16)
    gather_form = lambda: torch.autograd.grad(sc.subm_conv_apply(f, nbr, w), (f, w), g)
    scatter_form = lambda: torch.autograd.grad(sc._gather_matmul(f, nbr, w), (f, w), g)
    a, b = gather_form(), scatter_form()
    emit("sparse_conv_bwd", rows=n, active=int(st.valid.sum()), taps=27, channels=c,
         neighbours_per_row=float((nbr < n).sum() / max(int(st.valid.sum()), 1)),
         gather_form_fwd_bwd_ms=time_ms(gather_form, 20), scatter_add_fwd_bwd_ms=time_ms(scatter_form, 20),
         max_abs_diff_dfeatures=(a[0].float() - b[0].float()).abs().max().item(),
         max_abs_dfeatures=a[0].float().abs().max().item(),
         max_abs_diff_dweight=(a[1] - b[1]).abs().max().item(), max_abs_dweight=a[1].abs().max().item())


def train_batch(seed):
    """One sample per device, as the training CLI batches: B=1 scene x 6
    views of 900x1600 float images, the rig, 40,000 GT points in the range."""
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-50, 50, (TRAIN_B, GT_POINTS, 3)).astype(np.float32)
    gt[..., 2] = rng.uniform(-4, 2, (TRAIN_B, GT_POINTS))
    return dict(img=images(seed)[:TRAIN_B], cam2lidar_rts=torch.from_numpy(rig_cam2lidar(TRAIN_B)).cuda(),
                gt_points=torch.from_numpy(gt).cuda())


def fit_max_depth(model, batch, what):
    """``forward_train`` takes no depth override, so a train step's cloud
    comes from DA3's own depth, which under random weights need not look
    like a street scene. Counts the points a scene keeps; when that is
    fewer than MIN_POINTS and the predicted depth lies beyond ``max_depth``,
    tries ``max_depth`` at the 0.5 and 0.9 quantiles of the predicted depth
    and, if one keeps more points, returns the model rebuilt around the same
    DA3 and refinement modules with it. The model's weights and widths are
    untouched. Where no ``max_depth`` helps (rays or depths that leave the
    range whatever the cut), the phase runs on the cloud it gets and says so:
    buffers are static, so the work per step is the same."""
    bk = model.reconstruction_backbone
    with torch.no_grad():
        depth, intr, _ = bk.predict_depth(batch["img"])
        qs = [0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99]
        sample = depth.flatten()[:: max(1, depth.numel() // 1_000_000)]
        quantiles = dict(zip(qs, torch.quantile(sample.float(), torch.tensor(qs, device="cuda")).tolist()))

        def kept(max_depth):
            bk.max_depth = max_depth
            _, msk = bk.points_from_depth(depth, intr, batch["img"], batch["cam2lidar_rts"])
            return int(msk.sum())

        built = bk.max_depth
        tried = [dict(max_depth=built, quantile=None, kept=kept(built))]
        if tried[0]["kept"] < MIN_POINTS:
            tried += [dict(max_depth=quantiles[q], quantile=q, kept=kept(quantiles[q]))
                      for q in (0.5, 0.9) if quantiles[q] > built]
        bk.max_depth = built
    chosen = max(tried, key=lambda t: t["kept"])  # the first (as built) on ties
    emit("depth_filter", phase_of=what, depth_quantiles=quantiles, tried=tried, chosen_max_depth=chosen["max_depth"],
         chosen_quantile=chosen["quantile"], intrinsics_view0=intr[0, 0].tolist(),
         enough_points=chosen["kept"] >= MIN_POINTS)
    if chosen["quantile"] is None:
        return model, chosen
    rebuilt = ReconstructionBackbone(
        da3=bk.da3, refinement=bk.refinement, process_res=bk.process_res, ref_view_strategy=bk.ref_view_strategy,
        use_ray_pose=bk.use_ray_pose, max_depth=chosen["max_depth"], freeze_da3=bk.freeze_da3,
        filter_range=bk.filter_range, bq_anchor_points=bk.bq_anchor_points, bq_max_radius=bk.bq_max_radius,
        bq_sample_num=bk.bq_sample_num, bq_grid_dim=bk.bq_grid_dim, bq_share_sort=bk.bq_share_sort,
        num_points=bk.num_points, voxel_pre_reduce=bk.voxel_pre_reduce, pre_reduce_cap=bk.pre_reduce_cap,
        fps_impl=bk.fps_impl)
    return ResDet3D(rebuilt), chosen


def attention_blocks(model):
    """(local, global) attention blocks of every ViT trunk in ``model``."""
    n_local = n_global = 0
    for m in model.modules():
        if hasattr(m, "alt_start") and hasattr(m, "blocks"):
            for i in range(len(m.blocks)):
                if m.alt_start != -1 and i >= m.alt_start and i % 2 == 1:
                    n_global += 1
                else:
                    n_local += 1
    return n_local, n_global


def run_train_steps(phase, model, trainer, batch, fps_case_of, fwd_case_of):
    """One warm-up step and TRAIN_STEPS timed steps through ``Trainer.run``;
    the launch counts of every kernel are set to zero just before the timed
    steps and read just after."""
    state = trainer.init_state()
    state, _ = trainer.run(state, iter([batch]), max_steps=1)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    fps_ops.reset_launch_counts()
    times, history, counts = [], [], []
    with stage_timer.collect() as stages:
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, h = trainer.run(state, iter([batch]), max_steps=1)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            history += h
            counts.append({k: [int(c) for c in v] for k, v in model.reconstruction_backbone.last_stage_counts.items()})
    launches = dict(
        fwd=dict(flash_attention_fwd.launches_by_shape), dq=dict(flash_attention_bwd_dq.launches_by_shape),
        dkv=dict(flash_attention_bwd_dkv.launches_by_shape),
        fps=dict(fps_ops.furthest_point_sample_cuda.launches_by_shape))
    unchecked = [shape for shape in launches["fps"] if shape not in fps_case_of]
    unchecked += [shape for shape in launches["fwd"] if shape not in fwd_case_of]
    if unchecked:
        fail(f"{phase}: a kernel ran at sizes no kernel case checked: {unchecked}")
    if sum(launches["fps"].values()) != 2 * TRAIN_B * TRAIN_STEPS:
        fail(f"{phase}: fps launches {launches['fps']}, expected {2 * TRAIN_B * TRAIN_STEPS}")
    for h in history:
        if not all(np.isfinite(v) for v in h.values()):
            fail(f"{phase}: non-finite metrics {h}")
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    if not all(bool(torch.isfinite(g).all()) for g in grads.values()):
        fail(f"{phase}: a gradient of the last step is not finite")
    norm = lambda gs: float(torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g.float()) for g in gs]))) \
        if gs else 0.0
    res = dict(
        steps=TRAIN_STEPS, scenes_per_step=TRAIN_B, views=S, image=[IMG_H, IMG_W], gt_points=GT_POINTS,
        ms_per_step=times, ms_mean=float(np.mean(times)),
        stage_ms_per_step={k: v / TRAIN_STEPS for k, v in stages.items() if not k.endswith("/calls")},
        loss=[h["loss"] for h in history], grad_norm=[h["grad_norm"] for h in history],
        grad_norm_last_step=norm(list(grads.values())),
        da3_grad_norm_last_step=norm([g for n, g in grads.items() if ".da3." in n]),
        valid_counts_per_step=counts,
        launches_by_shape={k: {str(s): n for s, n in v.items()} for k, v in launches.items()},
        trained_params=sum(p.numel() for p in trainer.optimizer.params),
        optimizer_state_tensors=len(trainer.optimizer.mu) + len(trainer.optimizer.nu),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return state, res, launches


HOPPER_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")  # on wgmma / TMA / mbarriers
SASS_OPS = ("HGMMA", "UTMALDG", "HMMA", "LDSM", "MUFU.EX2", "SYNCS")


def ptxas_report(log):
    """Per kernel (mangled name) from ``nvcc -Xptxas -v``: registers at entry,
    spill stores / loads, stack and static shared-memory bytes."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            cur = m.group(1)
            out.setdefault(cur, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            out[cur].update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            smem = re.search(r"(\d+) bytes smem", line)
            out[cur].update(registers=int(m.group(1)), static_smem_bytes=int(smem.group(1)) if smem else 0)
    return {k: v for k, v in out.items() if "registers" in v}


def instruction_counts(lib):
    """{kernel: {opcode: count}} of a few opcodes in ``cuobjdump -sass`` of a
    library; kernels named by their unmangled base name."""
    exe = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([exe, "-sass", lib], capture_output=True, text=True, check=True, timeout=120).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : .*?([a-z][a-z_]*_kernel)", line)
        if m:
            cur = m.group(1)
            counts[cur] = dict.fromkeys(SASS_OPS, 0)
        elif cur:
            for op in SASS_OPS:
                if op in line:
                    counts[cur][op] += 1
    return counts


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Run the PyTorch port on one NVIDIA GPU and check it end to end.")
    ap.add_argument("--parent", default=None, help="an earlier tree to time the FPS and dq kernels against")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1

    # 1. env
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    emit("env", torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0],
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(), nvidia_smi=smi,
         max_sm_clock_mhz=max_sm_clock_hz() / 1e6)

    # 2. build
    t0 = time.perf_counter()
    libs = load_kernels()
    build_s = time.perf_counter() - t0
    kernels = {}
    for stem, entry in BUILD_LOG.items():
        sass = instruction_counts(libs[stem]._name)
        for fn, info in ptxas_report(entry["ptxas"]).items():
            short = next((k for k in sass if k in fn), fn)
            kernels[short] = dict(info, source=f"{stem}.cu", sass=sass.get(short, {}))
    warnings = {k: [l.strip() for l in v["ptxas"].splitlines() if "warning" in l.lower()] for k, v in BUILD_LOG.items()}
    emit("build", seconds=build_s, nvcc_s={k: v["seconds"] for k, v in BUILD_LOG.items()}, kernels=kernels,
         warnings=warnings)
    for name in HOPPER_KERNELS:
        info = kernels.get(name)
        if info is None or info.get("spill_stores", 1) or info.get("spill_loads", 1):
            fail(f"{name}: ptxas reports spills or no entry: {info}")
        if not info["sass"].get("HGMMA") or not info["sass"].get("UTMALDG"):
            fail(f"{name}: no wgmma or no TMA load in its SASS: {info['sass']}")
    if any("setmaxnreg ignored" in l for stem in ("flash_attn_fwd", "flash_attn_bwd") for l in warnings[stem]):
        fail(f"ptxas ignored setmaxnreg: {warnings}")
    # the FPS kernel's cluster launch: the cluster size it ran with, as the kernel itself reads it
    small = torch.zeros((1000, 3), device="cuda")
    fps_ops.furthest_point_sample_cuda(small, torch.ones(1000, dtype=torch.bool, device="cuda"),
                                       torch.zeros(1, dtype=torch.int32, device="cuda"), 4)
    fps_ctrl = fps_ops.furthest_point_sample_cuda.last_ctrl.tolist()
    emit("build_fps_launch", cluster_size=fps_ctrl[2], clusters_used=fps_ctrl[3],
         plan=fps_ops.furthest_point_sample_cuda.last_plan._asdict())
    if fps_ctrl[2] != fps_ops.CLUSTER:
        fail(f"the FPS kernel ran with cluster size {fps_ctrl[2]}, not {fps_ops.CLUSTER}")

    # 3. flash kernel vs plain at the production shapes (+ a kv_len case)
    cases = {name: kernel_case(name, shape, None, seed=i) for i, (name, shape) in enumerate(SHAPES.items())}
    kvl_case = kernel_case("vitg_global_kv_len", SHAPES["vitg_global"], [2911, S * 721], seed=9)
    # a scale that is no power of two: the wrapper passes bf16(q * scale) and a multiplier of 1
    scale_case = kernel_case("vitl_local_scale_0.1", SHAPES["vitl_local"], None, seed=8, scale=0.1)
    # the shapes the two train steps (B=1) give the forward kernel
    train_fwd_cases = {name: kernel_case(name, shape, None, seed=10 + i, iters=10)
                       for i, (name, shape) in enumerate(TRAIN_FWD_SHAPES.items())}
    fwd_case_of = {tuple(c["shape"]): c for c in list(cases.values()) + list(train_fwd_cases.values())}

    # 11. the backward kernels vs plain (here, while the card's memory is free of models: the plain version keeps
    # several fp32 (N, M) tensors)
    bwd_cases = {name: bwd_case(name, shape, None, seed=20 + i, on_path=True)
                 for i, (name, shape) in enumerate(FT_SHAPES.items())}
    bwd_extra = [bwd_case("vitl_global_b2_kv_len", (2, 16, S * 721, S * 721), [2911, S * 721], seed=29, on_path=False),
                 bwd_case("vitg_global", SHAPES["vitg_global"], None, seed=30, on_path=False, iters=5),
                 bwd_case("vitl_local_b1_scale_0.1", FT_SHAPES["vitl_local_b1"], None, seed=31, on_path=False,
                          scale=0.1)]
    bwd_case_of = {tuple(c["shape"]): c for c in bwd_cases.values()}

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

    # 6b. GT-pose conditioning: the fp32 attention kernel at the camera encoders' shapes, then the path
    f32_cases = {name: f32_case(name, shape, seed=40 + i) for i, (name, shape) in enumerate(CAM_SHAPES.items())}
    cam_large_err = large_cam_enc_case()
    pose_res, f32_launches = gt_pose_phase(model)

    # 7. fps kernel vs plain on the buffers of the point path
    c2l, depth = scene_inputs(B)
    # this design's exchange alone: one cluster, and the two levels of 2 and 3 clusters
    exchange_us = {c: 1e3 * time_ms(lambda: fps_ops.exchange_probe(ANCHORS, c), 3, warmup=1) / (ANCHORS - 1)
                   for c in (1, 2, 3)}
    emit("fps_exchange", rounds=ANCHORS - 1, us_per_round_by_clusters=exchange_us)
    fps_cases = fps_phase(backbone, c2l, depth, exchange_us)
    if args.parent:
        parent_comparison(args.parent, fps_cases)
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

    # 10b. one sparse convolution's forward + backward on that request's map: gather form vs autograd's scatter-add
    sparse_conv_backward_cost(backbone.refinement, pts, msk)

    # 12. fine-tuning: Trainer.run -> ResDet3D.forward_train with gradients through DA3
    t0 = time.perf_counter()
    ft = build_resdet3d(FT_PRESET, dtype=torch.bfloat16, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(1), refinement=REFINEMENT,
                        voxel_pre_reduce=PRE_REDUCE_VOXEL, pre_reduce_cap=PRE_REDUCE_CAP,
                        bq_anchor_points=ANCHORS, num_points=NUM_POINTS, freeze_da3=False)
    with torch.no_grad():
        ft.reconstruction_backbone.da3.head.scratch.output_conv2._modules["2"].weight.mul_(FT_DEPTH_HEAD_SCALE)
    batch = train_batch(500)
    ft, ft_depth = fit_max_depth(ft, batch, "finetune")
    vit = ft.reconstruction_backbone.da3.backbone.pretrained
    n_local, n_global = attention_blocks(ft)
    emit("finetune_model", preset=FT_PRESET, params=sum(p.numel() for p in ft.parameters()),
         da3_params=sum(p.numel() for p in ft.reconstruction_backbone.da3.parameters()),
         depth_head_last_conv_scale=FT_DEPTH_HEAD_SCALE, trunk_param_dtype=str(vit.blocks[0].attn.qkv.weight.dtype),
         compute_dtype=str(vit.dtype), remat=vit.remat,
         local_blocks=n_local, global_blocks=n_global, build_s=time.perf_counter() - t0)
    # 13. in-situ, at the weights as built (the steps of phase 12 come after it, so that this check reads the same
    # model in every run): the whole DA3 net's backward with the kernels and with the plain attention under autograd
    da3 = ft.reconstruction_backbone.da3
    x, _ = process_tensor_batch(batch["img"], process_res=504)
    weights = torch.from_numpy(
        np.random.default_rng(7).standard_normal((TRAIN_B, S, 280, 504)).astype(np.float32)).cuda()
    probes = {"patch_embed": vit.patch_embed.proj.weight, "last_block_qkv": vit.blocks[-1].attn.qkv.weight}

    def da3_backward():
        # a smooth scalar of the depth map: the train loss passes through the point path's discrete
        # selections, which amplify any rounding difference into another point set
        out = da3(x, use_ray_pose=False, ref_view_strategy="first")
        loss = (torch.log(out["depth"].float()) * weights).mean()
        return loss.item(), torch.autograd.grad(loss, list(probes.values()))

    def train_loss_backward():
        ft.zero_grad(set_to_none=True)
        losses, _ = ft(return_loss=True, **batch)
        total = sum(losses.values())
        return total.item(), torch.autograd.grad(total, list(probes.values()))

    ft.train()
    strategy = ft.reconstruction_backbone.ref_view_strategy
    ft.reconstruction_backbone.ref_view_strategy = "first"  # no argmin over bf16 scores between the two runs
    tl_k, tg_k = train_loss_backward()
    reset_launch_counts()
    loss_k, grads_k = da3_backward()
    insitu_launches = (flash_attention_fwd.launches, flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    set_attn_impl(da3, "plain")
    loss_p, grads_p = da3_backward()
    tl_p, tg_p = train_loss_backward()
    set_attn_impl(da3, "auto")
    ft.reconstruction_backbone.ref_view_strategy = strategy
    ft.zero_grad(set_to_none=True)
    insitu = {name: rel_l2(a, b) for name, a, b in zip(probes, grads_k, grads_p)}
    emit("in_situ_bwd", loss_kernels=loss_k, loss_plain=loss_p, grad_rel_l2=insitu, tol=GRAD_REL_TOL,
         launches_fwd_dq_dkv=insitu_launches,
         # not gated: the train loss passes through the point path's selections, made on depths that differ by
         # bf16 rounding between the two runs, so the two losses are taken on different point sets
         train_loss_kernels=tl_k, train_loss_plain=tl_p,
         train_loss_grad_rel_l2={name: rel_l2(a, b) for name, a, b in zip(probes, tg_k, tg_p)})
    if insitu_launches != (2 * (n_local + n_global), n_local + n_global, n_local + n_global):
        fail(f"in-situ backward: launches {insitu_launches}")
    if not all(e <= GRAD_REL_TOL for e in insitu.values()):
        fail(f"in-situ backward: gradient rel L2 {insitu} > {GRAD_REL_TOL}")
    del grads_k, grads_p, tg_k, tg_p, probes, weights, x

    # 12 (continued). the steps
    trainer = Trainer(model=ft, total_steps=1000, lr=1e-4, frozen_patterns=())
    watched = {"vit": vit.blocks[-1].attn.qkv.weight,
               "refinement": ft.reconstruction_backbone.refinement.middle_encoder.conv_input.weight}
    before = {k: p.detach().clone() for k, p in watched.items()}
    _, ft_res, ft_launches = run_train_steps("finetune", ft, trainer, batch, fps_case_of, fwd_case_of)
    # with block checkpointing a step runs every block's forward twice and its backward once
    local_shape, global_shape = FT_SHAPES["vitl_local_b1"], FT_SHAPES["vitl_global_b1"]
    expected = dict(fwd={local_shape: 2 * n_local * TRAIN_STEPS, global_shape: 2 * n_global * TRAIN_STEPS},
                    dq={local_shape: n_local * TRAIN_STEPS, global_shape: n_global * TRAIN_STEPS},
                    dkv={local_shape: n_local * TRAIN_STEPS, global_shape: n_global * TRAIN_STEPS})
    emit("finetune", **ft_res, max_depth=ft_depth["max_depth"], max_depth_quantile=ft_depth["quantile"],
         expected_launches={k: {str(s): n for s, n in v.items()} for k, v in expected.items()},
         moved={k: float((p.detach() - before[k]).abs().max()) for k, p in watched.items()})
    for kind in ("fwd", "dq", "dkv"):
        if ft_launches[kind] != expected[kind]:
            fail(f"finetune: {kind} launches {ft_launches[kind]}, expected {expected[kind]}")
    unchecked = [shape for kind in ("dq", "dkv") for shape in ft_launches[kind] if shape not in bwd_case_of]
    if unchecked:
        fail(f"finetune: a backward kernel ran at shapes no kernel case checked: {unchecked}")
    if not ft_res["da3_grad_norm_last_step"] > 0:
        fail("finetune: no gradient reached DA3")
    for k, p in watched.items():
        if torch.equal(p.detach(), before[k]):
            fail(f"finetune: the {k} parameter did not change in {TRAIN_STEPS} steps")
    ft_profile = device_profile(lambda: trainer.run(trainer.init_state(), iter([batch]), max_steps=1))
    # the profiler slows the host; against the unprofiled step the device is busy this share of the time
    emit("finetune_profile", **ft_profile,
         device_busy_share_of_unprofiled_step=ft_profile["device_busy_ms"] / ft_res["ms_mean"])

    del ft, trainer, da3, vit, watched, before
    torch.cuda.empty_cache()

    # 14. the production train step: nested-giant frozen, AdamW on the refinement only
    batch = train_batch(600)
    prod, prod_depth = fit_max_depth(resdet, batch, "train")
    trainer = Trainer(model=prod, total_steps=1000, lr=1e-3)
    da3_before = [p.detach().clone() for p in prod.reconstruction_backbone.da3.parameters()]
    _, tr_res, tr_launches = run_train_steps("train", prod, trainer, batch, fps_case_of, fwd_case_of)
    n_local_g, n_global_g = attention_blocks(prod)
    emit("train", **tr_res, preset=PRESET, max_depth=prod_depth["max_depth"], max_depth_quantile=prod_depth["quantile"])
    if tr_launches["dq"] or tr_launches["dkv"]:
        fail(f"train: backward kernels launched with DA3 frozen: {tr_launches}")
    if sum(tr_launches["fwd"].values()) != (n_local_g + n_global_g) * TRAIN_STEPS:
        fail(f"train: flash forward launches {tr_launches['fwd']}, expected {(n_local_g + n_global_g) * TRAIN_STEPS}")
    if any(".da3." in n for n in trainer.optimizer.names):
        fail("train: the optimizer holds state for DA3")
    if tr_res["trained_params"] != sum(p.numel() for p in prod.reconstruction_backbone.refinement.parameters()):
        fail(f"train: {tr_res['trained_params']} trained parameters are not the refinement's")
    if not all(torch.equal(p.detach(), b) for p, b in zip(prod.reconstruction_backbone.da3.parameters(), da3_before)):
        fail("train: a DA3 parameter changed")
    del da3_before
    tr_profile = device_profile(lambda: trainer.run(trainer.init_state(), iter([batch]), max_steps=1))
    emit("train_profile", **tr_profile,
         device_busy_share_of_unprofiled_step=tr_profile["device_busy_ms"] / tr_res["ms_mean"])
    prod.eval()

    # 15. kernel table: per kernel, its numbers summed over one request's launch
    # mix as counted on the main path in phase 8 (per-shape numbers under
    # "shapes"), and the kernels still to port
    mix = {key: sum(case_of[shape][key] * n for shape, n in flash_by_shape.items()) / REQUESTS
           for key in ("ms", "plain_ms", "library_ms", "bound_ms", "exp_floor_ms")}
    by = "operations" if all(case_of[shape]["bound_by"] == "operations" for shape in flash_by_shape) else "bytes"
    fps_mix = {key: sum(fps_case_of[shape][key] * n for shape, n in fps_by_shape.items()) / REQUESTS
               for key in ("ms", "plain_ms", "bound_ms", "exchange_floor_ms")}
    fps_by = "operations" if all(fps_case_of[shape]["bound_by"] == "operations" for shape in fps_by_shape) \
        else "bytes"
    table = {
        "kernels": [
            dict(name="flash_attn_fwd", route="cuda", source="recondet3d_torch/csrc/flash_attn_fwd.cu",
                 replaces="recondet3d/ops/attention.py:54", status="ported+checked", launches=flash_total,
                 launches_da3_slice=sum(by_shape.values()),
                 max_abs_err=max(c["max_abs_err"] for c in list(cases.values()) + [kvl_case, scale_case]),
                 ms=mix["ms"], plain_ms=mix["plain_ms"], bound_ms=mix["bound_ms"], bound_by=by,
                 exp_floor_ms=mix["exp_floor_ms"], library_ms=mix["library_ms"], per="one request's launch mix (B=2)",
                 design="wgmma + TMA + mbarriers, warp-specialised",
                 shapes=[dict(c, launches_per_forward=per_forward[n]) for n, c in cases.items()]
                 + [kvl_case, scale_case], train_shapes=list(train_fwd_cases.values())),
            dict(name="fps", route="cuda", source="recondet3d_torch/csrc/fps.cu",
                 replaces="recondet3d/ops/fps_pallas.py:54", status="ported+checked", launches=fps_total,
                 max_abs_err=max(c["max_abs_err"] for c in fps_cases),
                 ms=fps_mix["ms"], plain_ms=fps_mix["plain_ms"], bound_ms=fps_mix["bound_ms"],
                 bound_by=fps_by, exchange_floor_ms=fps_mix["exchange_floor_ms"], library_ms=None,
                 per="one request's launch mix (B=2: 4 launches)",
                 design="clusters of 16 CTAs, records through distributed shared memory (st.async + mbarrier), "
                        "points in registers; a second level through device memory for clouds beyond one cluster",
                 note="max_abs_err counts differing indices (gate: 0); bound = max(bytes, K*n_valid fp32 distance "
                      "updates); exchange_floor_ms = (K-1) steps of this design's exchange alone as timed in this "
                      "run; no single PyTorch call computes FPS, so library_ms is null",
                 exchange_us_per_round=exchange_us,
                 shapes=[{k: v for k, v in c.items() if k != "kernel_args"} for c in fps_cases]),
        ],
        "not_yet_ported": [],
    }
    per_step = {kind: {shape: n / TRAIN_STEPS for shape, n in ft_launches[kind].items()} for kind in ("dq", "dkv")}
    for kind, fn_name, line, what in (("dq", "flash_bwd_dq", 185, "dq"), ("dkv", "flash_bwd_dkv", 231, "dk and dv")):
        step_mix = {key: sum(bwd_case_of[shape][kind][key] * n for shape, n in per_step[kind].items())
                    for key in ("ms", "bound_ms", "exp_floor_ms")}
        shared = {key: sum(bwd_case_of[shape][key] * n for shape, n in per_step[kind].items())
                  for key in ("plain_ms", "library_ms")}
        table["kernels"].append(dict(
            name=fn_name, route="cuda", source="recondet3d_torch/csrc/flash_attn_bwd.cu",
            replaces=f"recondet3d/ops/attention.py:{line}", status="ported+checked",
            launches=sum(ft_launches[kind].values()),
            max_abs_err=max(c["max_abs_err"] for c in list(bwd_cases.values()) + bwd_extra),
            ms=step_mix["ms"], plain_ms=shared["plain_ms"], bound_ms=step_mix["bound_ms"], bound_by="operations",
            exp_floor_ms=step_mix["exp_floor_ms"], library_ms=shared["library_ms"],
            per="one fine-tuning step's launch mix (B=1)",
            design="wgmma + TMA + mbarriers, warp-specialised",
            note=f"computes {what}; plain_ms is attention_bwd_plain (dq, dk and dv together) and library_ms the "
                 "backward of scaled_dot_product_attention (dq, dk and dv in one call): the same numbers stand in "
                 "both backward rows; max_abs_err is the largest over dq, dk, dv and all cases",
            shapes=[dict(name=c["name"], shape=c["shape"], kv_len=c["kv_len"], scale=c["scale"], on_path=c["on_path"],
                         launches_per_step=per_step[kind].get(tuple(c["shape"]), 0), **c[kind],
                         plain_ms=c["plain_ms"], library_ms=c["library_ms"], errors=c["errors"])
                    for c in list(bwd_cases.values()) + bwd_extra]))
    table["kernels"].append(dict(
        name="attn_fwd_f32", route="cuda", source="recondet3d_torch/csrc/attn_f32.cu",
        replaces="recondet3d/ops/attention.py:54", status="ported+checked", launches=sum(f32_launches.values()),
        max_abs_err=max(c["max_abs_err"] for c in f32_cases.values()),
        **{key: sum(f32_cases["cam_enc_giant"][key] * n for n in f32_launches.values())
           for key in ("ms", "host_ms", "plain_ms", "plain_host_ms", "library_ms", "library_host_ms", "bound_ms")},
        bound_by=f32_cases["cam_enc_giant"]["bound_by"],
        per="one GT-pose forward of nested-giant-large (B=2: 4 launches at (2, 16, 6, 6) D=96)",
        design="fp32 on the CUDA cores: one CTA per (b*h, 8 query rows), K/V tiles through shared memory, "
               "one warp per query row, online softmax with expf",
        note="the fp32 instance of _flash_kernel (CameraEnc's trunk); ms, plain_ms and library_ms (SDPA on the same "
             "fp32 inputs) are device time from torch.profiler, the host_* keys the time a call takes in a loop of "
             "launches",
        cam_enc_large_token_rel_l2=cam_large_err, gt_pose=pose_res, shapes=list(f32_cases.values())))
    table["kernels"][0]["launches_finetune_steps"] = sum(ft_launches["fwd"].values())
    table["kernels"][0]["launches_train_steps"] = sum(tr_launches["fwd"].values())
    table["kernels"][1]["launches_finetune_steps"] = sum(ft_launches["fps"].values())
    table["kernels"][1]["launches_train_steps"] = sum(tr_launches["fps"].values())
    print(json.dumps(table), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
