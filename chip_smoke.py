#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. env      torch / CUDA versions and the card (nvidia-smi name, power limit).
2. build    compiles every CUDA kernel of the port from ``recondet3d_torch/csrc``
            (one nvcc per source, started together); per kernel the ptxas
            registers, spills and shared memory, and the Hopper kernels'
            wgmma / TMA instructions counted in the SASS (``cuobjdump``). Fails on a spill or an ignored
            ``setmaxnreg`` in any instance of the forward, the dq or the
            dk/dv kernel (<DC, EDGE>: DC = 1-4 64-column chunks, EDGE a last
            chunk partly past D), or if one has no HGMMA or no TMA load;
            launches the FPS kernel once on a small
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
            (16 heads of 96) through the short forward kernel (four launches,
            none of the tiled kernels), and a profiled forward of the camera
            encoder shows no copy kernel inside its attention modules; once
            more with the camera encoder's attention switched to the plain
            version: camera tokens and depth must agree. Before it, the fp32
            kernels (tiled and short) against their plain version at the
            camera encoders' shapes of da3-giant (D = 96) and da3-large (D =
            64), timed on the device (calls queued behind a spin kernel, CUDA
            events) and on the host beside the plain version, SDPA on the same fp32 inputs and an
            empty kernel launched the same way (the launch floor), and one
            da3-large ``CameraEnc`` (kernel vs plain).
6c. gt-pose-bwd ``build_da3("da3-large")`` unfrozen with GT poses, B=1 x 6
            views x 900x1600, one forward and a backward into every
            parameter: CameraEnc's four blocks on the short forward and fused
            backward kernels (4 launches each, none of the tiled dq or dk/dv),
            the 24 bf16 trunk blocks on the wgmma ones (launches counted: 48
            forward, 24 dq, 24 dk/dv); CameraEnc's
            parameter gradients against a run with its attention on the
            plain version.
7. fps      the furthest-point-sampling kernel vs its plain PyTorch
            version at the sizes the point path gives it, on the buffers
            that path produces for a rendered street scene; the index
            sequences must be identical. Times of the kernel, the plain
            version, the bound (bytes or fp32 operations), and the exchange
            floor: this design's exchange alone (one cluster, or two levels
            for the clusters a case uses) times K - 1.
7b. fps-large the same at the sizes past the main path: the street scene's
            846,720 rows without pre-reduce (5 clusters), 6 x 364 x 644 =
            1,406,496 rows all valid (past what 7 clusters hold on chip: the
            overflow path) and ``MAX_POINTS`` random rows (K cut to 4,096).
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
11b. cc      the CUDA-core attention family (``csrc/attn_cuda_core.cu``):
            the tiled forward, dq and dk/dv against the plain versions in fp32
            at the camera encoders' shapes; same bits run to run; times beside
            the bound, the plain versions and SDPA. The short fp32 forward and
            fused backward through ``flash_attention`` and autograd on the qkv
            split's views at the camera encoders' shapes, N = M in {1, 6, 32}
            x D in {24, 48, 64, 96, 256}, with ``kv_len`` and at scale 0.1:
            the fp32 gates, one launch of each, the same bits run to run, the
            (B, N, H, D) output; every case timed on the device (calls queued
            behind a spin kernel) and in loops of calls beside the tiled
            kernels, SDPA, the bound and the launch floor. Then bf16 at the
            head dims no
            DA3 trunk has, (1, 4, N, D) at D in {32, 96, 128, 20} and N in
            {721, 4326}, D in {16, 48, 160, 192, 256} at 4,326, one case with
            ``kv_len`` and two at scale 0.1 (D = 128, 256), through
            ``flash_attention``: the wgmma forward, dq and dk/dv, launches
            counted (none on the CUDA cores), under the bf16 gates, same bits
            run to run; the bf16 CUDA-core forward, dq and dk/dv, which no call
            is routed to, held to the same references; times beside the bound,
            the exp floor, the plain versions, SDPA forward and backward and
            the CUDA-core kernels the wgmma kernels replace. Then B*H = 65,552
            > 65,535 for the wgmma kernels (bf16 D=64), the wgmma kernels at
            D = 128, the tiled CUDA-core family and the short kernels (fp32).
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
16. detection ``build_model_from_cfg(configs/resdet3d_centerhead.py)`` at full
            width (nested-giant-large, no pre-reduce, the CenterHead's six
            tasks): one warm-up and three B=2 requests through
            ``simple_test`` + ``decode`` on the anchored depth, FPS and
            flash launches counted; then one warm-up and three production
            train steps (DA3 frozen) with the CenterHead and occupancy
            losses on GT boxes from a seed; the head's parameters must move.
17. bench    ``recondet3d_torch/tools/bench.py`` (bench.py's workload) on
            the model of phase 4 (the one it builds), its JSON line as it
            prints it; after phase 10b, before any step trains that model.
18. full loop the training loop through the port's entry points on
            ``tests/nuscenes_fixture.py``'s structured fixture (its images
            written as binary PPM): ``cli.create_data``, ``cli.train`` on
            ``configs/resdet3d_tiny_centerhead_test.py`` for 150 steps on the
            card from the JAX test's initial weights (``tests/jax_init.py``,
            a step-0 checkpoint the CLI resumes from), ``cli.test`` on its
            checkpoint; tests/test_full_loop.py's
            gates (normalised loss, per-class AP, mAP, NDS); the fixture's
            images as the port's loader resizes them against cv2.resize, as
            the JAX loader does, byte for byte (printed; fails where they
            differ; skipped without cv2); ms per step
            (median, p90), the share of a step spent waiting on the data
            iterator, eval ms per sample; flash-forward and FPS launches
            counted and held to the shapes checked against the plain versions
            just before.
19. full loop, full width: ``configs/resdet3d_centerhead.py`` (nested-giant-large,
            no pre-reduce, six tasks) through the same CLIs on a six-view
            fixture: 3 steps with only the final checkpoint, then the test CLI
            on it; ms per step, one step under ``torch.profiler`` (the
            device's idle share), checkpoint bytes and save / load seconds,
            eval ms per sample, valid points per stage; gates on running
            (exit codes, finite losses, a checkpoint that loads, every metric
            line) and on the launches.
20. da3-api the DA3 public API and the ``da3`` CLI at full width, random
            weights from seed 0, no checkpoint (``HF_HUB_OFFLINE``, an empty
            cache): (a) ``DepthAnything3.from_pretrained(
            "depth-anything/DA3NESTED-GIANT-LARGE")`` with the GS head its
            preset builds, ``inference`` on 6 uint8 views of 900x1600 with
            ``infer_gs`` and every exporter but the video, plus feature
            layers; one warm-up and three timed calls; shapes, finiteness,
            846,720 Gaussians, every file read back, flash launches per
            shape; (b) the same call on the plain attention: the last ViT-g
            features and the raw Gaussians to the in-situ gate, depth reported; (c) with GT poses: extrinsics
            aligned, 4 launches of the short fp32 forward and none of the tiled one, and with
            ``align_to_input_ext_scale=False`` the poses one
            similarity of the input whose scale (c)'s depth was divided by; (d) ``use_ray_pose``;
            (e) ``python -m recondet3d_torch.cli.da3 images`` and ``colmap``
            in subprocesses; (f) 32 views (the CLI's ``--max-frames``) at
            280x504 with ``infer_gs``, timed with its peak memory, and the
            flash forward at (1, 24, 23072, 64) against its plain version,
            SDPA and the bound; (g) ``render_3dgs`` along the 30-frame path of
            the gs_video exporter on its default device, the exporter's own
            render call and the exporter as the API calls it (or its cv2 error
            where cv2 is absent), and a frame that 846,720 planted Gaussians
            cover, held to the same renderer on the CPU and timed with the JAX
            package's 4,096-Gaussian blocks too.
15. the kernel table as one JSON line; then the card line, then the result.

``--parent DIR`` (a ``git archive`` of an earlier tree, e.g. in the git-ignored
``scratch_tree/``) adds one phase after phase 7: the FPS kernel on this run's
FPS cases, the dq and dk/dv kernels at the fine-tuning shapes, the flash
forward at the request's shapes, bf16 attention at D in {32, 96, 128, 20}
and {160, 256} (forward, dq and dk/dv on the kernels each tree routes them
to), the fp32
attention forward and backward at the camera encoders' shapes on each tree's
own route (device and host time) and five
main-path requests, timed by ``recondet3d_torch/tools/kernel_times.py`` in
four processes, the earlier tree's and this tree's in turns (parent, change,
change, parent), with the change's median request against the parent's
quartiles; it fails unless ptxas gives the D = 64 instances the parent's
registers.

Needs CUDA; exits non-zero without it (or without the rest of the repo).
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import importlib.util
import io
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

from recondet3d_torch.api import DepthAnything3
from recondet3d_torch.data.anchor_scene import anchor_depth, rig_cam2lidar
from recondet3d_torch.data.export import export as da3_export
from recondet3d_torch.data.export.colmap_io import read_cameras_bin, read_images_bin
from recondet3d_torch.data.export.pointcloud_io import read_ply
from recondet3d_torch.data.input_processor import compute_process_shape, process_tensor_batch
from recondet3d_torch.cli import create_data as cli_create_data
from recondet3d_torch.cli import test as cli_test
from recondet3d_torch.cli import train as cli_train
from recondet3d_torch.cli.train import build_model_from_cfg
from recondet3d_torch.core.config import load_py_config
from recondet3d_torch.data.image_io import imread_rgb, resize_bilinear, write_png, write_ppm
from recondet3d_torch.data.pipelines.point_pipeline import (ball_query_downsample, filter_point_by_range,
                                                            voxel_pre_reduce)
from recondet3d_torch.models.da3 import CameraEnc, build_da3
from recondet3d_torch.models.da3 import gs_renderer
from recondet3d_torch.models.da3.gs_renderer import render_3dgs, render_trajectory_frames
from recondet3d_torch.models.da3.layers import init_parameters_, set_attn_impl
from recondet3d_torch.models.detect import build_resdet3d
from recondet3d_torch.ops import fps as fps_ops
from recondet3d_torch.models.detect import ReconstructionBackbone, ResDet3D
from recondet3d_torch.ops import attention as port_attention
from recondet3d_torch.ops.attention import (
    attention_bwd_dkv_cuda_core,
    attention_bwd_dq_cuda_core,
    attention_bwd_plain,
    attention_bwd_short,
    attention_fwd_cuda_core,
    attention_fwd_short,
    attention_plain,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_fwd,
    KERNELS,
    kernel_variant,
    reset_launch_counts,
)
from recondet3d_torch.ops.build import BUILD_LOG, load_kernels
from recondet3d_torch.ops.cell_sort import cell_sort
from recondet3d_torch.ops.sampling import furthest_point_sample
from recondet3d_torch.tools import bench as port_bench
from recondet3d_torch.tools.ptxas_spills import kernel_label
from recondet3d_torch.utils import stage_timer
from recondet3d_torch.train import Trainer
from recondet3d_torch.train import checkpoints as ckpt_io
from recondet3d_torch.specs import Gaussians
from recondet3d_torch.utils.camera_traj import interpolate_camera_path
from recondet3d_torch.utils.pose_align import align_poses_umeyama
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
# (nested-giant's in the GT-pose forward; da3-large's at B=1 in the GT-pose backward)
CAM_SHAPES = {"cam_enc_giant": (B, 16, S, 96), "cam_enc_large_b1": (1, 16, S, 64)}
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

# the CUDA-core attention family (csrc/attn_cuda_core.cu) in fp32 at CAM_SHAPES, forward and backward. bf16 at head
# dims no DA3 trunk has, at the trunks' token counts: the wgmma forward, dq and dk/dv, beside the CUDA-core kernels
# they replace; (B, H, N, D), kv_len, scale
ANY_D_CASES = {f"bf16_d{d}_n{n}": ((1, 4, n, d), None, None) for d in (32, 96, 128, 20) for n in (721, S * 721)}
ANY_D_CASES.update({f"bf16_d{d}_n{S * 721}": ((1, 4, S * 721, d), None, None) for d in (16, 48, 160, 192, 256)})
ANY_D_CASES.update({"bf16_d96_n4326_kv_len": ((2, 4, S * 721, 96), [2911, S * 721], None),
                    "bf16_d128_n4326_scale_0.1": ((1, 4, S * 721, 128), None, 0.1),
                    "bf16_d256_n4326_scale_0.1": ((1, 4, S * 721, 256), None, 0.1)})
# the kernel table's rows: (1, 4, 4326, 128), and (1, 4, 4326, 256) for dk/dv past D = 128
ANY_D_HEADLINE, ANY_D_HEADLINE_WIDE = "bf16_d128_n4326", "bf16_d256_n4326"
# B*H = 65,552 > 65,535 (the most grid.y takes): (shape, dtype, route) of the wgmma kernels at D = 64, the wgmma
# forward and dk/dv at D = 128, the tiled CUDA-core family and the short fp32 kernels
MANY_HEADS = {"bf16_d64": ((4097, 16, 64, 64), torch.bfloat16, "wgmma"),
              "bf16_d128": ((4097, 16, 64, 128), torch.bfloat16, "wgmma"),
              "f32_d24": ((4097, 16, S, 24), torch.float32, "cuda_core"),
              "f32_d24_short": ((4097, 16, S, 24), torch.float32, "short")}
# the kernel wrappers of each kind on each route (the short route's dq and dk/dv are one launch)
WRAPPER = {("fwd", "wgmma"): flash_attention_fwd, ("dq", "wgmma"): flash_attention_bwd_dq,
           ("dkv", "wgmma"): flash_attention_bwd_dkv, ("fwd", "cuda_core"): attention_fwd_cuda_core,
           ("dq", "cuda_core"): attention_bwd_dq_cuda_core, ("dkv", "cuda_core"): attention_bwd_dkv_cuda_core,
           ("fwd", "short"): attention_fwd_short, ("dq", "short"): attention_bwd_short,
           ("dkv", "short"): attention_bwd_short}
# phase 11b, the short fp32 kernels (N, M <= 32): (B, H, N, D), kv_len, scale. The camera encoders' shapes (B=2 GT-pose
# forward, the B=1 backward, the B=1 API call), N = M in {1, 6, 32} x D in {24, 48, 64, 96, 256}, kv_len, scale 0.1
SHORT_CASES = {"cam_enc_giant": ((B, 16, S, 96), None, None), "cam_enc_large_b1": ((1, 16, S, 64), None, None),
               "cam_enc_giant_b1": ((1, 16, S, 96), None, None)}
SHORT_CASES.update({f"short_n{n}_d{d}": ((B, 16, n, d), None, None) for n in (1, S, 32) for d in (24, 48, 64, 96, 256)})
SHORT_CASES.update({"cam_enc_giant_kv_len": ((B, 16, S, 96), [3, S], None),
                    "cam_enc_giant_scale_0.1": ((B, 16, S, 96), None, 0.1)})
SHORT_CALLS = 20  # calls of a function in phase 11b's profiled sessions and in each loop that times host time
SPIN_TRIES = 3  # device_ms: runs of a function, each with a 4x longer spin, before it fails
# The GT-pose backward: CameraEnc's parameter gradients with its attention on the kernels vs on the plain version,
# everything else the same. The two differ by fp32 rounding (~1e-7) in the camera tokens, which then pass 24 bf16
# ViT-L blocks forward and back, where one flipped bf16 rounding moves a value by ~4e-3: the in-situ feature
# gate. A wrong dq or dk/dv kernel moves these gradients by ~1. Fixed before the first run on the card.
POSE_GRAD_REL_TOL = FEAT_REL_TOL
# FPS past the main path's sizes: the production anchors without pre-reduce (6 views of 280 x 504), process_res
# 644 without pre-reduce (6 x 364 x 644: 14 rows a CTA past the on-chip capacity of 7 clusters), and the most rows
# the kernel takes; K of the last cut to what the plain version finishes in seconds
NO_PRE_REDUCE_ROWS, RES644_HW = S * 280 * 504, (364, 644)
LARGEST_FPS_K = 4096
DET_CONFIG = "configs/resdet3d_centerhead.py"
PARENT_REQUESTS = 5  # main-path requests each process of the parent comparison times
DET_TASKS = 6
DET_GT_BOXES = 64  # GT boxes a training scene, from a seed, inside the head's range
BENCH_ITERS = 3  # timed requests of the bench line
# the full loop (create_data -> train CLI -> checkpoint -> test CLI) on tests/nuscenes_fixture.py's structured
# fixture, its images written as binary PPM (no cv2 on the card's machine): the tiny CenterHead config for the
# steps and gates of tests/test_full_loop.py, and the production detection config at full width for a few steps
TINY_CONFIG = "configs/resdet3d_tiny_centerhead_test.py"
LOOP_STEPS, LOOP_CKPT_INTERVAL = 150, 50  # the JAX test's steps; a save every 50 (the default, one an epoch, is 37)
LOOP_SAMPLES = 4  # the fixture's: 2 scenes x 2 samples
# (B, H, N, M) da3-small (6 heads of 64) gives the forward kernel in the tiny loop: the fixture's 2 views at
# process_res 56 (2 x 4 patches + the camera token a view), 8 local and 4 global blocks a forward
TINY_FWD_SHAPES = {"tiny_local": (2, 6, 9, 9), "tiny_global": (1, 6, 18, 18)}
TINY_FWD_PER_FORWARD = {"tiny_local": 8, "tiny_global": 4}
# (N, K) of its two FPS calls a scene: 2 views of 28 x 56 depth rows -> 128 anchors; the union buffer -> 256 points
TINY_FPS = {"tiny_anchors": (3136, 128), "tiny_final": (1152, 256)}
FULL_LOOP_STEPS = 3
# the loop's gates, as tests/test_full_loop.py holds the JAX package's (correctness gates, not speed limits)
LOOP_GATES = dict(normalized_loss_below=0.25, car_ap_above=0.35, present_mean_ap_above=0.2, map_above=0.06,
                  nds_above=0.1)
PRESENT = ("car_AP", "pedestrian_AP", "traffic_cone_AP")
CLASS_NAMES = ("car", "truck", "construction_vehicle", "bus", "trailer", "barrier", "motorcycle", "bicycle",
               "pedestrian", "traffic_cone")


# phase 20, the DA3 API: the CLI's default model, 6 views of 900x1600 (and 32 of 280x504, the CLI's --max-frames),
# every exporter but gs_video (its mp4 needs cv2: phase 20g runs it, or checks its error where cv2 is absent),
# feature layers for feat_vis; phase 6's in-situ gate for the features and the raw Gaussians on the plain attention
API_MODEL = "depth-anything/DA3NESTED-GIANT-LARGE"
API_FORMATS = "glb-npz-mini_npz-depth_vis-gs_ply-colmap-feat_vis"
API_FEAT_LAYERS = (39,)
API_CALLS = 3
API_LONG_S = 32
API_SHAPES = {"vitg_local": (S, 24, 721, 721), "vitg_global": (1, 24, S * 721, S * 721),
              "vitl_local": (S, 16, 721, 721)}
API_LONG_SHAPES = {"vitg_local": (API_LONG_S, 24, 721, 721), "vitg_global": (1, 24, API_LONG_S * 721, API_LONG_S * 721),
                   "vitl_local": (API_LONG_S, 16, 721, 721)}
API_GAUSSIANS = S * 280 * 504
TRAJ_FRAMES = 30  # export_to_gs_video's path
# phase 20g's planted frame: API_GAUSSIANS Gaussians inside the identity camera's frustum at 280x504
PLANTED_K = np.array([[500.0, 0, 252], [0, 500.0, 140], [0, 0, 1]], np.float32)
PLANTED_MIN_COVERED = 0.99  # the share of pixels the frame must cover (alpha > 0)
RENDER_TOL = 1e-4  # card vs CPU: rgb and alpha absolute, depth relative to max(1, |depth|)


START = time.perf_counter()


def emit(phase, **kw):
    """One JSON line: the phase, the seconds since the script started (``t_s``) and ``kw``."""
    print(json.dumps({"phase": phase, "t_s": time.perf_counter() - START, **kw}), flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def d64_launches(wrapper, where):
    """A wgmma wrapper's launches keyed (B, H, N, M), as the main path's
    shapes are named here; fails on a launch at a head dim other than 64,
    which no trunk of the main path has."""
    other = [key for key in wrapper.launches_by_shape if key[4] != 64]
    if other:
        fail(f"{where}: {wrapper.__name__} launched at head dims other than 64: {other}")
    return {key[:4]: n for key, n in wrapper.launches_by_shape.items()}


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


def short_bounds(shape, kv_len):
    """Least times of the short forward and backward over (B, H, N, D)
    queries and N keys, of which kv_len[b] count: the larger of the fp32
    operations over the fp32 rate (forward 4 N M D a head, backward 10 N M D:
    S, dP, dq, dk and dv, with M the keys that count) and the bytes each
    moves once over the memory rate (forward: q, the keys and values that
    count, out, lse; backward: q, O, dO, lse and those keys and values read,
    dq, dk and dv written). Returns {"fwd": (ms, by), "bwd": (ms, by)}."""
    Bq, H, N, D = shape
    rows = Bq * N if kv_len is None else sum(min(int(x), N) for x in kv_len)  # keys that count, over the batch
    work = dict(fwd=(4.0 * H * N * D * rows, 4.0 * H * (2 * Bq * N * D + 2 * rows * D + Bq * N)),
                bwd=(10.0 * H * N * D * rows, 4.0 * H * (3 * Bq * N * D + Bq * N + 2 * rows * D + 3 * Bq * N * D)))
    out = {}
    for kind, (ops, nbytes) in work.items():
        t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
        out[kind] = (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
    return out


@functools.lru_cache(maxsize=None)
def launch_floor():
    """A call that launches ``csrc/attn_cuda_core.cu``'s empty kernel as the
    attention wrappers launch theirs (ctypes, PyTorch's current raw stream):
    the yardstick a launch-bound kernel is read against."""
    import ctypes

    fn = load_kernels()["attn_cuda_core"].attn_cc_empty
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    current, raw_stream = port_attention._cuda_hooks()

    def call():
        err = fn(raw_stream(current()))
        if err:
            fail(f"the empty kernel's launch failed: cudaError {err}")
    return call


def qkv_split(q, k, v):
    """q, k and v as ``layers.Attention`` hands them to the attention: views
    of one (B, N, 3, H, D) projection output, holding these values."""
    qkv = torch.stack([q, k, v], 0).permute(1, 3, 0, 2, 4).contiguous()
    return qkv.permute(2, 0, 3, 1, 4).unbind(0)


def device_ms(fns, calls):
    """Device time of one call of each function in ``fns`` ({label:
    function}): ``calls`` calls queued behind a spin kernel
    (``torch.cuda._sleep``) long enough that the host has queued them all
    before the device reaches them, timed by CUDA events around them. That
    is each call's device work and the device's own gap between one launch
    and the next, and none of the host's time between launches (these calls
    are launch-bound: a loop of them without the spin times the host). A
    run whose queueing took more than half the spin is run again with a
    longer spin. The launches of ``calls`` calls must fit the queue of
    pending launches, or the host waits on it (100 calls of the plain
    version did not). (``torch.profiler`` on the card lost device events
    once a process had run many sessions, and placed events a range away
    from their own when they were split between ranges by the host's
    clock.)"""
    out = {}
    for label, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        spin_s = 2 * calls * (time.perf_counter() - t0) + 1e-3
        for _ in range(SPIN_TRIES):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(spin_s * max_sm_clock_hz()))
            t0 = time.perf_counter()
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            queued_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            if queued_s < 0.5 * spin_s:
                out[label] = start.elapsed_time(end) / calls
                break
            spin_s *= 4
        else:
            fail(f"device time of {label}: the host queued {calls} calls in {queued_s} s, past half the spin "
                 f"({spin_s / 4} s) in {SPIN_TRIES} tries")
    return out


def f32_case(name, shape, seed, iters=100):
    """The fp32 attention forwards (the tiled CUDA-core kernel and the short
    one on the qkv split's views) against ``attention_plain`` (fp32) on one
    set of fp32 inputs. At these shapes a call is launch-bound: ``ms``,
    ``dq_ms`` and ``dkv_ms`` (the tiled kernels), ``tiled_bwd_ms`` (the
    tiled backward's call: delta's expression and both kernels),
    ``short_ms`` and ``short_bwd_ms`` (the short forward and fused
    backward), ``floor_ms`` (an empty kernel launched the same way: the
    launch floor), ``plain_ms`` and ``library_ms`` (the forward of SDPA on
    the same fp32 inputs), ``plain_bwd_ms`` (``attention_bwd_plain``) and
    ``library_bwd_ms`` (SDPA's backward alone: dq, dk and dv) are device
    time (``device_ms``); the ``*host_ms`` keys are the time a call takes in
    a loop of ``iters`` calls."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda() for _ in range(4))
    out, lse = attention_fwd_cuda_core(q, k, v)
    ref_out, ref_lse = attention_plain(q, k, v)
    rel, err = rel_l2(out, ref_out), (out - ref_out).abs().max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    ok = rel <= F32_REL_TOL and err_lse <= F32_LSE_TOL and bool(torch.isfinite(out).all())
    b_ms, b_by = f32_bound_ms(shape)
    delta = (do * out).sum(dim=-1)
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(ql, kl, vl)
    # the short kernels on the views the qkv split hands over, the gradient as the output projection returns it
    qs, ks, vs = qkv_split(q, k, v)
    so, slse = attention_fwd_short(qs, ks, vs)
    sdo = do.transpose(1, 2).contiguous().transpose(1, 2)

    def tiled_bwd():  # the tiled route's backward call: delta's expression, then its two kernels
        d = (do * out).sum(dim=-1)
        return attention_bwd_dq_cuda_core(q, k, v, do, lse, d), attention_bwd_dkv_cuda_core(q, k, v, do, lse, d)

    calls = {"ms": lambda: attention_fwd_cuda_core(q, k, v),
             "dq_ms": lambda: attention_bwd_dq_cuda_core(q, k, v, do, lse, delta),
             "dkv_ms": lambda: attention_bwd_dkv_cuda_core(q, k, v, do, lse, delta),
             "tiled_bwd_ms": tiled_bwd,
             "short_ms": lambda: attention_fwd_short(qs, ks, vs),
             "short_bwd_ms": lambda: attention_bwd_short(qs, ks, vs, so, slse, sdo),
             "floor_ms": launch_floor(),
             "plain_ms": lambda: attention_plain(q, k, v),
             "library_ms": lambda: F.scaled_dot_product_attention(q, k, v),
             "plain_bwd_ms": lambda: attention_bwd_plain(q, k, v, out, lse, do),
             "library_bwd_ms": lambda: torch.autograd.grad(o_lib, (ql, kl, vl), do, retain_graph=True)}
    times = device_ms(calls, SHORT_CALLS)  # a queue of 100 calls of the plain version fills the launch queue
    for key, fn in calls.items():
        times[key.replace("ms", "host_ms")] = time_ms(fn, iters)
    del o_lib
    short_rel, short_lse = rel_l2(so, ref_out), (slse - ref_lse).abs().max().item()
    ok = ok and short_rel <= F32_REL_TOL and short_lse <= F32_LSE_TOL
    sb = short_bounds(shape, None)
    res = dict(name=name, shape=list(shape), max_abs_err=err, rel_l2_err=rel, max_abs_err_lse=err_lse,
               short_max_abs_err=(so - ref_out).abs().max().item(), short_rel_l2_err=short_rel,
               short_max_abs_err_lse=short_lse, short_bound_ms={k: b[0] for k, b in sb.items()},
               short_bound_by={k: b[1] for k, b in sb.items()},
               library_rel_l2=rel_l2(F.scaled_dot_product_attention(q, k, v), ref_out),
               tol=dict(out_rel_l2=F32_REL_TOL, lse=F32_LSE_TOL), **times,
               bound_ms=b_ms, bound_by=b_by, ok=ok)
    emit("f32_kernel", **res)
    if not ok:
        fail(f"fp32 attention kernels disagree with the plain version at {name}: tiled rel L2 {rel}, lse {err_lse}; "
             f"short rel L2 {short_rel}, lse {short_lse}")
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


def cam_attention_kernels(enc, forward):
    """{device kernel: launches} inside the attention modules of the camera
    encoder's trunk during one profiled ``forward()``: each module's forward
    runs in a ``record_function`` range, and a kernel counts to a range when
    the host call that launched it (an operator or a runtime launch) runs
    inside it. The qkv split, the attention and the output projection's
    reshape launch no copy when the short kernels read and write their
    layouts."""
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    mods = [blk.attn for blk in enc.trunk]

    def ranged(mod):
        inner = mod.forward

        def fwd(*a, **kw):
            with record_function("cam_attention"):
                return inner(*a, **kw)
        return fwd

    forward()
    torch.cuda.synchronize()
    try:
        for m in mods:
            m.forward = ranged(m)
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            forward()
            torch.cuda.synchronize()
    finally:
        for m in mods:
            del m.forward
    counts = defaultdict(int)

    def walk(e):
        for kern in e.kernels:
            counts[kern.name] += 1
        for child in e.cpu_children:
            walk(child)

    for e in prof.events():
        if e.name == "cam_attention" and e.device_type != torch.autograd.DeviceType.CUDA:
            walk(e)
    return dict(counts)


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
        launches = dict(attention_fwd_short.launches_by_shape)
        others = {w.__name__: w.launches for w in (attention_fwd_cuda_core, attention_bwd_short,
                                                   attention_bwd_dq_cuda_core, attention_bwd_dkv_cuda_core)}
        around = cam_attention_kernels(enc, lambda: enc(ext, ixt, (x.shape[2], x.shape[3])))
        tok = enc(ext, ixt, (x.shape[2], x.shape[3]))
        set_attn_impl(enc, "plain")
        ref = model(x, **kw)
        tok_ref = enc(ext, ixt, (x.shape[2], x.shape[3]))
        set_attn_impl(enc, "auto")
        no_poses = model(x, use_ray_pose=False, ref_view_strategy="saddle_balanced")
    res = dict(scenes=B, views=S, image=[IMG_H, IMG_W], ms=ms, f32_launches_by_shape={str(k): n for k, n in
                                                                                        launches.items()},
               other_fp32_launches=others, cam_attention_kernels=around,
               cam_token_rel_l2=rel_l2(tok, tok_ref), depth_rel_l2=rel_l2(got["depth"], ref["depth"]),
               extrinsics_rel_l2=rel_l2(got["extrinsics"], ref["extrinsics"]),
               depth_rel_l2_vs_no_poses=rel_l2(got["depth"], no_poses["depth"]),
               tol=dict(cam_token=F32_REL_TOL, depth=POSE_DEPTH_REL_TOL),
               depth_finite=bool(torch.isfinite(got["depth"]).all()), depth_mean=got["depth"].mean().item())
    emit("gt_pose", **res)
    expected = {(B, 16, S, S, 96): CAM_BLOCKS}
    if launches != expected or any(others.values()):
        fail(f"gt-pose: short fp32 forward launches {launches}, expected {expected}; others {others} (expected 0)")
    copies = {n: c for n, c in around.items() if "copy" in n.lower()}
    if copies or not any("cc_short_fwd_kernel" in n for n in around):
        fail(f"gt-pose: kernels inside CameraEnc's attention modules {around}: a copy ({copies}) or no short kernel")
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


def elem_bytes(dtype):
    return torch.tensor([], dtype=dtype).element_size()


def cc_bounds(shape, M, dtype):
    """Least times of the forward, dq and dk/dv on (B, H, N, D) queries over M
    keys: the larger of 4, 6 and 8 * N * M * D operations a head at the
    card's peak for the inputs' type (fp32 on the CUDA cores, bf16 on the
    tensor cores) and the bytes each moves once (forward: q, k, v, out, lse;
    dq: q, k, v, dO, lse, delta, dq; dk/dv: the same inputs, dk and dv)."""
    Bq, H, N, D = shape
    e, bh = elem_bytes(dtype), Bq * H
    peak = PEAK_FP32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    out = {}
    for kind, ops, nbytes in (("fwd", 4, bh * ((2 * N + 2 * M) * D * e + 4 * N)),
                              ("dq", 6, bh * ((3 * N + 2 * M) * D * e + 8 * N)),
                              ("dkv", 8, bh * ((2 * N + 4 * M) * D * e + 8 * N))):
        t_ops, t_bytes = ops * bh * N * M * D / peak, nbytes / PEAK_BYTES
        out[kind] = (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
    return out


def cc_gate(got, ref, dtype, scale=None):
    """fp32: relative L2 against ``scale`` (default the reference's norm) <=
    F32_REL_TOL; bf16: relative L2 <= the bf16 gate and |error| <= the
    absolute gate times max(1, |value|) elementwise (a bf16 value carries a
    rounding of up to 2^-9 of itself). Returns (ok, rel, max_abs)."""
    got, ref = got.float(), ref.float()
    err = got - ref
    rel = (torch.linalg.norm(err) / (scale if scale is not None else torch.linalg.norm(ref))).item()
    mx = err.abs().max().item()
    if dtype == torch.float32:
        return rel <= F32_REL_TOL, rel, mx
    scaled = (err.abs() / ref.abs().clamp(min=1.0)).max().item()
    return rel <= BWD_REL_TOL and scaled <= BWD_ABS_TOL, rel, mx


def cc_case(name, shape, seed, iters=10):
    """The tiled CUDA-core forward, dq and dk/dv kernels in fp32 against
    ``attention_plain`` and ``attention_bwd_plain`` on one set of inputs
    (called by name: fp32 at these lengths is routed to the short kernels);
    same bits run to run; times of each kernel in a loop of launches, the
    plain versions and SDPA (forward, and its backward alone); device times
    at the launch-bound camera-encoder shapes are ``f32_case``'s."""
    Bq, H, N, D = shape
    dtype = torch.float32
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda() for _ in range(4))
    if any(kernel_variant(dtype, D, kind, N, N) != "short" or kernel_variant(dtype, D, kind, 33, N) != "cuda_core"
           for kind in KERNELS):
        fail(f"{name}: fp32 D={D} is not routed to the short kernels at {N} rows and the tiled ones past 32")
    def tiled_bwd(out, lse):  # fp32 at these lengths is routed to the short kernels: the tiled ones by name
        delta = (do * out).sum(dim=-1)
        dk, dv = attention_bwd_dkv_cuda_core(q, k, v, do, lse, delta)
        return attention_bwd_dq_cuda_core(q, k, v, do, lse, delta), dk, dv

    reset_launch_counts()
    out, lse = attention_fwd_cuda_core(q, k, v)
    got = tiled_bwd(out, lse)
    launched = (attention_fwd_cuda_core.launches, attention_bwd_dq_cuda_core.launches,
                attention_bwd_dkv_cuda_core.launches, flash_attention_bwd_dq.launches)
    out2, lse2 = attention_fwd_cuda_core(q, k, v)
    again = tiled_bwd(out, lse)
    torch.cuda.synchronize()
    same_bits = torch.equal(out, out2) and torch.equal(lse, lse2) and all(torch.equal(a, b) for a, b in zip(got, again))
    ref_out, ref_lse = attention_plain(q, k, v)
    ok_out, rel_out, err_out = cc_gate(out, ref_out, dtype)
    err_lse = (lse - ref_lse).abs().max().item()
    ok_out = ok_out and err_lse <= F32_LSE_TOL
    ref = attention_bwd_plain(q, k, v, out, lse, do)
    # the call's gradient scale: with few keys dq and dk can be rounding noise of dP - delta, which cancels
    gscale = max(torch.linalg.norm(r.float()) for r in ref)
    errs = {}
    for key, a, r in zip(("dq", "dk", "dv"), got, ref):
        ok, rl, mx = cc_gate(a, r, dtype, scale=gscale)
        errs[key] = dict(rel_l2=rl, max_abs=mx, ok=ok and bool(torch.isfinite(a).all()))
    del ref, ref_out, ref_lse
    ok = ok_out and all(e["ok"] for e in errs.values()) and same_bits and launched == (1, 1, 1, 0)
    delta = (do.float() * out.float()).sum(dim=-1)
    calls = {"fwd": lambda: attention_fwd_cuda_core(q, k, v),
             "dq": lambda: attention_bwd_dq_cuda_core(q, k, v, do, lse, delta),
             "dkv": lambda: attention_bwd_dkv_cuda_core(q, k, v, do, lse, delta)}
    times = {kind: time_ms(fn, iters) for kind, fn in calls.items()}
    plain_ms = time_ms(lambda: attention_bwd_plain(q, k, v, *attention_plain(q, k, v), do), 1, warmup=1)
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters)
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(ql, kl, vl)
    lib_bwd = min(time_ms(lambda: torch.autograd.grad(o_lib, (ql, kl, vl), do, retain_graph=True), iters)
                  for _ in range(3))
    del o_lib
    bounds = cc_bounds(shape, N, dtype)
    res = dict(name=name, shape=list(shape), dtype=str(dtype).split(".")[-1],
        max_abs_err=max([err_out] + [e["max_abs"] for e in errs.values()]),
        rel_l2_err=max([rel_out] + [e["rel_l2"] for e in errs.values()]),
        max_abs_err_lse=err_lse, errors=errs, same_bits_run_to_run=same_bits, launches_fwd_dq_dkv_wgmma_dq=launched,
        ms={k: times[k] for k in calls}, bound_ms={k: b[0] for k, b in bounds.items()},
        bound_by={k: b[1] for k, b in bounds.items()}, plain_ms=plain_ms, library_ms=dict(fwd=lib_fwd, bwd=lib_bwd),
        ok=ok)
    emit("cc_kernel", **res)
    if not ok:
        fail(f"CUDA-core attention kernels disagree with the plain versions at {name}: out rel {rel_out} "
             f"(abs {err_out}, lse {err_lse}), {errs}; same bits {same_bits}; launches {launched}")
    return res


def short_case(name, shape, kv_len, scale, seed):
    """The short fp32 forward and fused backward through ``flash_attention``
    and autograd on the qkv split's views, as ``CameraEnc`` calls them: one
    launch of each and none of another kernel, against ``attention_plain``
    and ``attention_bwd_plain`` (fp32 gates; the backward against the
    call's largest gradient norm), the same bits run to run, the output in
    the (B, N, H, D) layout. Returns the result and the functions phase
    11b times on these inputs: the short forward and backward, the tiled
    forward, dq and dk/dv, SDPA's forward and its backward alone."""
    Bq, H, N, D = shape
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda() for _ in range(4))
    kvl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    views = qkv_split(q, k, v)
    sdo = do.transpose(1, 2).contiguous().transpose(1, 2)  # as the output projection's gradient arrives
    routes = {kind: kernel_variant(torch.float32, D, kind, N, N) for kind in KERNELS}
    reset_launch_counts()
    leaves = [t.detach().clone().requires_grad_() for t in views]
    out = flash_attention(*leaves, kv_len=kvl, scale=scale)
    got = torch.autograd.grad(out, leaves, sdo)
    launched = {w.__name__: w.launches for w in port_attention._KERNEL_WRAPPERS}
    out2 = flash_attention(*leaves, kv_len=kvl, scale=scale)
    again = torch.autograd.grad(out2, leaves, sdo)
    torch.cuda.synchronize()
    same_bits = torch.equal(out, out2) and all(torch.equal(a, b) for a, b in zip(got, again))
    want = {w.__name__: int(w in (attention_fwd_short, attention_bwd_short)) for w in port_attention._KERNEL_WRAPPERS}
    out = out.detach()
    _, lse = attention_fwd_short(*views, kvl, scale)
    ref_out, ref_lse = attention_plain(q, k, v, kvl, scale)
    ok_out, rel_out, err_out = cc_gate(out, ref_out, torch.float32)
    err_lse = (lse - ref_lse).abs().max().item()
    ref = attention_bwd_plain(q, k, v, out, lse, do, kvl, scale)
    gscale = max(torch.linalg.norm(r) for r in ref)
    errs = {}
    for key, a, r in zip(("dq", "dk", "dv"), got, ref):
        ok, rl, mx = cc_gate(a, r, torch.float32, scale=gscale)
        errs[key] = dict(rel_l2=rl, max_abs=mx, ok=ok and bool(torch.isfinite(a).all()))
    layout = out.transpose(1, 2).is_contiguous()
    ok = (ok_out and err_lse <= F32_LSE_TOL and all(e["ok"] for e in errs.values()) and same_bits and layout
          and launched == want and all(r == "short" for r in routes.values()))
    res = dict(name=name, shape=list(shape), kv_len=kv_len, scale=scale, routes=routes,
               max_abs_err=max([err_out] + [e["max_abs"] for e in errs.values()]), rel_l2_err_out=rel_out,
               max_abs_err_lse=err_lse, errors=errs, same_bits_run_to_run=same_bits, out_layout_bnhd=layout,
               launches=launched, tol=dict(rel_l2=F32_REL_TOL, lse=F32_LSE_TOL), ok=ok)
    if not ok:
        emit("short_kernel", **res)
        fail(f"short fp32 attention kernels disagree with the plain versions at {name}: out rel {rel_out}, lse "
             f"{err_lse}, {errs}; same bits {same_bits}; (B, N, H, D) output {layout}; launches {launched}, expected "
             f"{want}; routes {routes}")
    so = attention_fwd_short(*views, kvl, scale)[0]
    delta = (do * out).sum(dim=-1)
    mask = None if kvl is None else (torch.arange(N, device="cuda")[None, :] < kvl[:, None])[:, None, None, :]
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask, scale=scale)
    calls = {"fwd": lambda: attention_fwd_short(*views, kvl, scale),
             "bwd": lambda: attention_bwd_short(*views, so, lse, sdo, kvl, scale),
             "tiled_fwd": lambda: attention_fwd_cuda_core(q, k, v, kvl, scale),
             "tiled_dq": lambda: attention_bwd_dq_cuda_core(q, k, v, do, lse, delta, kvl, scale),
             "tiled_dkv": lambda: attention_bwd_dkv_cuda_core(q, k, v, do, lse, delta, kvl, scale),
             "sdpa_fwd": lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale),
             "sdpa_bwd": lambda: torch.autograd.grad(o_lib, (ql, kl, vl), do, retain_graph=True)}
    return res, calls


def short_phase():
    """Phase 11b, the short fp32 kernels: ``short_case`` at SHORT_CASES, each
    case's functions and the launch floor (an empty kernel launched the same
    way) timed on the device (``device_ms``) and in loops of calls (host
    time), beside the bound."""
    results, floors = {}, []
    floor = launch_floor()
    for i, (name, (shape, kv_len, scale)) in enumerate(SHORT_CASES.items()):
        res, calls = short_case(name, shape, kv_len, scale, seed=110 + i)
        times = device_ms(dict(calls, floor=floor), SHORT_CALLS)
        floors.append(times["floor"])
        res.update(ms={key: times[key] for key in calls}, floor_ms=times["floor"],
                   host_ms={key: time_ms(fn, SHORT_CALLS) for key, fn in calls.items()},
                   floor_host_ms=time_ms(floor, SHORT_CALLS))
        bounds = short_bounds(shape, kv_len)
        res.update(bound_ms={k: b[0] for k, b in bounds.items()}, bound_by={k: b[1] for k, b in bounds.items()},
                   library_ms=dict(fwd=res["ms"]["sdpa_fwd"], bwd=res["ms"]["sdpa_bwd"]))
        emit("short_kernel", **res)
        results[name] = res
    floor_res = dict(ms=float(np.median(floors)), ms_each_case=floors, host_ms=time_ms(floor, SHORT_CALLS))
    emit("launch_floor", **floor_res)
    return results, floor_res


def any_d_case(name, shape, kv_len, scale, seed, iters=5):
    """bf16 attention at a head dim no DA3 trunk has, through
    ``flash_attention`` under autograd as a user calls it: the wgmma forward,
    dq and dk/dv, launches counted, against ``attention_plain`` on the kernels' scores
    (bf16(q * scale) k^T, in fp32) and ``attention_bwd_plain``'s fp32 sums
    before their last rounding (a kernel's bf16 output is one rounding from
    them; two roundings of sums taken in other orders can land one bf16 ulp
    apart, 2^-7 at values in [1, 2), past the absolute gate), under the bf16
    gates; same bits run to run. The bf16 CUDA-core forward, dq and dk/dv,
    which no call is routed to, on the same inputs (the backward on the wgmma
    forward's out and lse) under the same gates. Times of each kernel in a
    loop of launches (the wrapper's pad of a D that is no multiple of 8
    included) beside the bound, the exp floor, the plain versions, SDPA's
    forward and its backward alone on the same values, and the CUDA-core
    kernels that the wgmma kernels replace, in this call."""
    Bq, H, N, D = shape
    M = N
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda().to(torch.bfloat16)
                   for _ in range(4))
    kvl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    routes = {kind: kernel_variant(torch.bfloat16, D, kind) for kind in KERNELS}
    reset_launch_counts()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves, kv_len=kvl, scale=scale)
    got = torch.autograd.grad(out, leaves, do)
    launched = {f"{kind}_{route}": WRAPPER[kind, route].launches for kind, route in WRAPPER}
    out2 = flash_attention(*leaves, kv_len=kvl, scale=scale)
    again = torch.autograd.grad(out2, leaves, do)
    torch.cuda.synchronize()
    same_bits = torch.equal(out, out2) and all(torch.equal(a, b) for a, b in zip(got, again))
    want = {f"{kind}_{route}": int(routes[kind] == route) for kind, route in WRAPPER}
    out = out.detach()
    _, lse = flash_attention_fwd(q, k, v, kvl, scale)
    qs = (q.float() * (D ** -0.5 if scale is None else scale)).to(torch.bfloat16)
    ref_out, ref_lse = attention_plain(qs.float(), k.float(), v.float(), kvl, 1.0)
    ok_out, rel_out, err_out = cc_gate(out, ref_out, torch.bfloat16)
    err_lse = (lse - ref_lse).abs().max().item()
    ok_out = ok_out and err_lse <= LSE_TOL and bool(torch.isfinite(out).all())
    delta = (do.float() * out.float()).sum(dim=-1)
    args = (q, k, v, do, lse, delta, kvl, scale)
    # the bf16 CUDA-core kernels, routed no more, on the same inputs
    cc_got = dict(out=attention_fwd_cuda_core(q, k, v, kvl, scale)[0], dq=attention_bwd_dq_cuda_core(*args))
    cc_got["dk"], cc_got["dv"] = attention_bwd_dkv_cuda_core(*args)
    cc_errs = {"out": cc_gate(cc_got["out"], ref_out, torch.bfloat16)}
    del ref_out, ref_lse
    ref = attention_bwd_plain(q, k, v, out, lse, do, kvl, scale, out_dtype=torch.float32)
    errs = {}
    for key, a, r in zip(("dq", "dk", "dv"), got, ref):
        ok, rl, mx = cc_gate(a, r, torch.bfloat16)
        errs[key] = dict(rel_l2=rl, max_abs=mx, ok=ok and bool(torch.isfinite(a).all()))
        cc_errs[key] = cc_gate(cc_got[key], r, torch.bfloat16)
    del ref, cc_got
    cc_errs = {key: dict(rel_l2=rl, max_abs=mx, ok=ok) for key, (ok, rl, mx) in cc_errs.items()}
    ok = (ok_out and all(e["ok"] for e in list(errs.values()) + list(cc_errs.values())) and same_bits
          and launched == want)

    ms = {kind: time_ms(lambda: WRAPPER[kind, routes[kind]](*args), iters) for kind in ("dq", "dkv")}
    ms["fwd"] = time_ms(lambda: flash_attention_fwd(q, k, v, kvl, scale), iters)
    cuda_core_ms = dict(fwd=time_ms(lambda: attention_fwd_cuda_core(q, k, v, kvl, scale), iters),
                        dq=time_ms(lambda: attention_bwd_dq_cuda_core(*args), iters),
                        dkv=time_ms(lambda: attention_bwd_dkv_cuda_core(*args), iters))
    plain_ms = dict(fwd=time_ms(lambda: attention_plain(q, k, v, kvl, scale), 1, warmup=1),
                    bwd=time_ms(lambda: attention_bwd_plain(q, k, v, out, lse, do, kvl, scale), 1, warmup=1))
    if kvl is None:
        mask, rows = None, np.full(Bq * H, M, np.float64)
    else:
        mask = (torch.arange(M, device="cuda")[None, :] < kvl[:, None])[:, None, None, :]
        rows = np.repeat(np.minimum(np.asarray(kv_len, np.float64), M), H)
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale), iters)
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask, scale=scale)
    lib_bwd = min(time_ms(lambda: torch.autograd.grad(o_lib, (ql, kl, vl), do, retain_graph=True), iters)
                  for _ in range(3))
    del o_lib, ql, kl, vl
    bounds = dict(fwd=bound_ms(Bq * H, N, rows, D), dq=bwd_bound_ms(Bq * H, N, M, rows, 6, N, D),
                  dkv=bwd_bound_ms(Bq * H, N, M, rows, 8, 2 * M, D))
    res = dict(name=name, shape=list(shape), kv_len=kv_len, scale=scale, routes=routes,
               max_abs_err=max([err_out] + [e["max_abs"] for e in errs.values()]), max_abs_err_out=err_out,
               rel_l2_err_out=rel_out, max_abs_err_lse=err_lse, errors=errs, cuda_core_errors=cc_errs,
               tol=dict(out_rel_l2=BWD_REL_TOL, max_abs_over_max1_value=BWD_ABS_TOL, lse=LSE_TOL),
               same_bits_run_to_run=same_bits, launches=launched, ms=ms, cuda_core_ms=cuda_core_ms,
               bound_ms={k: b[0] for k, b in bounds.items()}, bound_by={k: b[1] for k, b in bounds.items()},
               exp_floor_ms=exp_floor_ms(N, rows), plain_ms=plain_ms, library_ms=dict(fwd=lib_fwd, bwd=lib_bwd),
               ok=ok)
    emit("any_d_kernel", **res)
    if not ok:
        fail(f"bf16 attention at D={D} disagrees with the plain versions at {name}: out rel {rel_out} (abs {err_out}, "
             f"lse {err_lse}), {errs}; CUDA-core {cc_errs}; same bits {same_bits}; launches {launched}, "
             f"expected {want}")
    return res


def head_rel_l2(got, ref, scale=None):
    """The largest relative L2 error of one head over (B, H, rows, D)
    tensors, each head against its own ``scale`` (B, H) (default: the
    reference head's norm). Over 65,552 heads a wrong head cannot hide in a
    global norm, and an elementwise gate would trip on single bf16 roundings
    of the rare values above 1 (one bf16 ulp there is 2^-7)."""
    err = torch.linalg.vector_norm((got.float() - ref.float()).flatten(2), dim=-1)
    den = torch.linalg.vector_norm(ref.float().flatten(2), dim=-1) if scale is None else scale
    return (err / den).max().item()


def many_heads_case(name, shape, dtype, route, seed):
    """B*H = 65,552: the forward and backward kernels of ``route`` against
    the plain versions: the worst head's relative L2 to the dtype's relative
    gate (the backward against the head's largest gradient norm)."""
    Bq, H, N, D = shape
    # 268 M values a tensor at D = 64: drawn on the card (numpy takes ~20 s for the four)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(4))
    routes = {kind: route for kind in KERNELS}
    if any(kernel_variant(dtype, D, kind, *((N, N) if route != "cuda_core" else ())) != route for kind in KERNELS):
        fail(f"{name}: {dtype} at D={D}, {N} rows is not routed to {route}")
    kernels = [WRAPPER[kind, route] for kind in KERNELS]
    fwd = kernels[0]

    def bwd(out, lse):  # the tiled CUDA-core kernels by name (fp32 at 6 rows is routed to the short ones)
        if route != "cuda_core":
            return flash_attention_bwd(q, k, v, out, lse, do)
        delta = (do.float() * out.float()).sum(dim=-1)
        return (kernels[1](q, k, v, do, lse, delta), *kernels[2](q, k, v, do, lse, delta))

    reset_launch_counts()
    out, lse = fwd(q, k, v)
    got = bwd(out, lse)
    torch.cuda.synchronize()
    launched = [w.launches for w in kernels]
    if dtype == torch.float32:
        ref_out = attention_plain(q, k, v)[0]
    else:
        ref_out = attention_plain((q.float() * D ** -0.5).to(dtype).float(), k.float(), v.float(), None, 1.0)[0]
    tol = F32_REL_TOL if dtype == torch.float32 else BWD_REL_TOL
    rel_out, err_out = head_rel_l2(out, ref_out), (out.float() - ref_out).abs().max().item()
    ref = attention_bwd_plain(q, k, v, out, lse, do)
    # each head's gradients against its largest gradient norm: with few keys dq and dk can be rounding noise of
    # dP - delta, which cancels
    hscale = torch.stack([torch.linalg.vector_norm(r.float().flatten(2), dim=-1) for r in ref]).amax(0)
    errs = {key: dict(rel_l2=head_rel_l2(a, r, hscale), max_abs=(a.float() - r.float()).abs().max().item())
            for key, a, r in zip(("dq", "dk", "dv"), got, ref)}
    del ref, ref_out
    ms = {"fwd": time_ms(lambda: fwd(q, k, v), 5), "bwd": time_ms(lambda: bwd(out, lse), 5)}
    if route != "short":  # the dk/dv kernel alone (the short route's backward is one launch)
        delta = (do.float() * out.float()).sum(dim=-1)
        ms["dkv"] = time_ms(lambda: kernels[2](q, k, v, do, lse, delta), 5)
    # the table's bound (cc_bounds: 4 / 6 / 8 N M D a head at the inputs' peak, or the bytes; short_bounds for the
    # fused backward) and SDPA on the same inputs, its forward and its backward alone (CUDA events around 5 calls:
    # these calls are long enough that the events read device time)
    bounds = cc_bounds(shape, N, dtype)
    if route == "short":
        bounds = dict(short_bounds(shape, None), dq=bounds["dq"], dkv=bounds["dkv"])
    ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(ql, kl, vl)
    library_ms = dict(fwd=time_ms(lambda: F.scaled_dot_product_attention(q, k, v), 5),
                      bwd=time_ms(lambda: torch.autograd.grad(o_lib, (ql, kl, vl), do, retain_graph=True), 5))
    del ql, kl, vl, o_lib
    # one launch of each kernel (the short backward's one launch is read under dq and dk/dv alike)
    ok = rel_out <= tol and all(e["rel_l2"] <= tol for e in errs.values()) and launched == [1, 1, 1]
    res = dict(name=name, shape=list(shape), heads=Bq * H, routes=routes, worst_head_rel_l2_out=rel_out,
               max_abs_err_out=err_out, errors=errs, tol=dict(worst_head_rel_l2=tol), launches=launched, ms=ms,
               bound_ms={k: v[0] for k, v in bounds.items()}, bound_by={k: v[1] for k, v in bounds.items()},
               library_ms=library_ms, ok=ok)
    emit("many_heads", **res)
    if not ok:
        fail(f"B*H > 65535 case {name}: out rel {rel_out}, {errs}, launches {launched}")
    return res


def gt_pose_backward_phase():
    """GT-pose conditioning trained: ``build_da3("da3-large")`` unfrozen (fp32
    master parameters, blocks under checkpointing), B=1 scene x 6 views x
    900x1600 with GT poses from a seed, one forward and a backward into every
    parameter of a smooth scalar of the depth (``loss.backward()``, as a
    fine-tuning step takes it). CameraEnc's four fp32 trunk blocks run the
    short forward and fused backward kernels (none of the tiled CUDA-core
    ones), the 24 bf16 ViT-L blocks the wgmma ones (each block's forward twice under checkpointing); then the
    camera encoder's attention on the plain version, all else the same:
    CameraEnc's parameter gradients must agree."""
    model = build_da3("da3-large", dtype=torch.bfloat16, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(12), param_dtype=torch.float32, remat=True)
    x, _ = process_tensor_batch(images(800)[:1], process_res=504)
    ext, ixt = gt_poses(1, S, 801, x.shape[2], x.shape[3])
    weights = torch.from_numpy(np.random.default_rng(802).standard_normal((1, S, 280, 504)).astype(np.float32)).cuda()
    enc = model.cam_enc
    names, params = zip(*enc.named_parameters())

    def run():
        model.zero_grad(set_to_none=True)
        out = model(x, extrinsics=ext, intrinsics=ixt, use_ray_pose=False, ref_view_strategy="first")
        loss = (torch.log(out["depth"].float()) * weights).mean()
        loss.backward()
        return loss.item(), [p.grad.detach().clone() for p in params]

    run()  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    loss_k, grads_k = run()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    launches = {w.__name__: dict(w.launches_by_shape) for w in (
        attention_fwd_short, attention_bwd_short, attention_fwd_cuda_core, attention_bwd_dq_cuda_core,
        attention_bwd_dkv_cuda_core, flash_attention_fwd, flash_attention_bwd_dq, flash_attention_bwd_dkv)}
    with_grad = sum(p.grad is not None for p in model.parameters())
    set_attn_impl(enc, "plain")
    loss_p, grads_p = run()
    set_attn_impl(enc, "auto")
    errs = {n: rel_l2(a, b) for n, a, b in zip(names, grads_k, grads_p)}
    finite = all(bool(torch.isfinite(g).all()) for g in grads_k)
    blocks = len(model.backbone.pretrained.blocks)
    cam = (1, 16, S, S, 64)
    expected = dict(attention_fwd_short={cam: CAM_BLOCKS}, attention_bwd_short={cam: CAM_BLOCKS},
                    attention_fwd_cuda_core={}, attention_bwd_dq_cuda_core={}, attention_bwd_dkv_cuda_core={})
    counts = {k: sum(v.values()) for k, v in launches.items()}
    res = dict(preset="da3-large", scenes=1, views=S, image=[IMG_H, IMG_W], ms=ms, loss_kernels=loss_k,
               loss_plain=loss_p, cam_enc_grad_rel_l2_max=max(errs.values()), cam_enc_grad_rel_l2=errs,
               tol=POSE_GRAD_REL_TOL, grads_finite=finite, trunk_blocks=blocks,
               params_with_grad=with_grad, params=sum(1 for _ in model.parameters()),
               launches_by_shape={k: {str(s): n for s, n in v.items()} for k, v in launches.items()})
    emit("gt_pose_backward", **res)
    for key, want in expected.items():
        if launches[key] != want:
            fail(f"gt-pose backward: {key} launches {launches[key]}, expected {want}")
    if (counts["flash_attention_fwd"], counts["flash_attention_bwd_dq"], counts["flash_attention_bwd_dkv"]) != \
            (2 * blocks, blocks, blocks):
        fail(f"gt-pose backward: trunk launches {counts}, expected {(2 * blocks, blocks, blocks)}")
    if not finite or not max(errs.values()) <= POSE_GRAD_REL_TOL:
        fail(f"gt-pose backward: CameraEnc gradients kernel vs plain {errs} (finite {finite})")
    del model
    torch.cuda.empty_cache()
    return res, launches


def parent_comparison(parent, fps_cases):
    """The FPS kernel on this run's FPS cases, the dq and dk/dv kernels at
    the fine-tuning shapes, the flash forward at the request's shapes, bf16
    attention at head dims other than 64 (forward and dk/dv, on whatever
    kernels each tree routes them to), the fp32 attention forward at the
    camera encoders' shapes and PARENT_REQUESTS main-path requests, of the
    tree at ``parent`` and of this one, timed by
    ``recondet3d_torch/tools/kernel_times.py`` in four processes in turns:
    parent, change, change, parent. Both trees must give the same FPS
    indices, and ptxas must give the D = 64 instances of this tree's
    forward, dq and dk/dv (``<1,0>``) the registers of the parent's kernels
    (or of a parent's kernel that is no template). Emits the change's
    D = 64 request and step mixes over the parent's."""
    here = os.path.dirname(os.path.abspath(__file__))
    tool = os.path.join(here, "recondet3d_torch", "tools", "kernel_times.py")
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "fps_inputs.pt")
        torch.save([dict(name=c["name"], points=a[0].cpu(), valid=a[1].cpu(), start=a[2].cpu(), k=a[3])
                    for c in fps_cases for a in [c["kernel_args"]]], inputs)
        for tree, label in ((parent, "parent"), (here, "change"), (here, "change"), (parent, "parent")):
            tree = os.path.abspath(tree)
            out = subprocess.run([sys.executable, tool, inputs, "--requests", str(PARENT_REQUESTS)], cwd=tree,
                                 capture_output=True, text=True, timeout=900, env=dict(os.environ, PYTHONPATH=tree))
            if out.returncode != 0:
                fail(f"kernel_times.py in {tree} failed ({out.returncode}): {out.stderr[-2000:]}")
            runs.append(dict(tree=label, **json.loads(out.stdout.strip().splitlines()[-1])))
    registers = {}
    for r in runs:
        regs = {kernel_label(fn): info["registers"] for log in r.pop("ptxas").values()
                for fn, info in ptxas_report(log).items()}
        registers[r["tree"]] = regs
    def d64(regs, kernel):  # the D = 64 instance: <1,0> of a template, the kernel itself in a tree without one
        return regs.get(f"{kernel}<1,0>", regs.get(kernel))

    same_registers = {kernel: d64(registers["parent"], kernel) == d64(registers["change"], kernel)
                      for kernel in ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")}

    def ratio(key, sub=None):
        mean = {tree: np.mean([r[key] if sub is None else r[key][sub] for r in runs if r["tree"] == tree])
                for tree in ("parent", "change")}
        return float(mean["change"] / mean["parent"])

    # the main path's requests: the change's median against the parent's quartiles (both trees' processes pooled)
    requests = {tree: [ms for r in runs if r["tree"] == tree for ms in r.get("request_ms", [])]
                for tree in ("parent", "change")}
    request_stats = {tree: dict(median=float(np.median(v)), quartiles=[float(np.percentile(v, 25)),
                                                                       float(np.percentile(v, 75))])
                     for tree, v in requests.items() if v}
    emit("parent_comparison", parent=os.path.abspath(parent), runs=runs, registers=registers,
         d64_same_registers=same_registers, fwd_request_mix_change_over_parent=ratio("fwd_request_mix_ms"),
         dq_step_mix_change_over_parent=ratio("dq_step_mix_ms"),
         dkv_step_mix_change_over_parent=ratio("dkv_step_mix_ms"), requests=request_stats,
         f32_change_over_parent={f"{kind}_{key}_{name}": ratio(f"f32_{kind}_{key}_ms", name)
                                 for kind in ("fwd", "bwd") for key in ("device", "host") for name in CAM_SHAPES})
    if any(r["fps_indices_sum"] != runs[0]["fps_indices_sum"] for r in runs):
        fail("parent comparison: the two trees' FPS kernels chose different indices")
    if not all(same_registers.values()):
        fail(f"parent comparison: the D = 64 instances' registers differ from the parent's: {registers}")
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


def cloud_from_depth(depth, c2l):
    """(N, 3) LiDAR-frame points of one scene's depth maps (1, S, h, w), the
    rig's nominal pinhole at that size."""
    h, w = depth.shape[-2:]
    intr = torch.tensor([[1266.0 * w / IMG_W, 0, w / 2], [0, 1266.0 * h / IMG_H, h / 2], [0, 0, 1]], device="cuda")
    pts_cam = depth_to_points_cam(depth, intr.expand(1, S, 3, 3))
    pts = torch.einsum("bnhwc,bndc->bnhwd", pts_cam, c2l[:1, :, :3, :3]) + c2l[:1, :, 3, :3][:, :, None, None]
    return pts.reshape(-1, 3).contiguous()


def fps_large_phase(backbone, c2l, depth, exchange_us):
    """FPS past the main path's sizes, each against the plain version: the
    production anchors without pre-reduce (the street scene's valid rows of
    6 x 280 x 504, range-filtered and cell-sorted as the point path does: 5
    clusters launched, as many used as the valid rows need), 6 x 364 x 644 rows all valid (process_res 644: past what 7
    clusters hold on chip, so the overflow path), and ``MAX_POINTS`` random
    rows all valid with K cut to ``LARGEST_FPS_K``."""
    d = depth[:1]
    pts = cloud_from_depth(d, c2l)
    msk = ((d > 0) & (d <= backbone.max_depth)).reshape(-1)
    p, m = filter_point_by_range(pts, msk, backbone.filter_range)
    cs = cell_sort(p, m, grid_dim=backbone.bq_grid_dim, min_cell=backbone.bq_max_radius)
    cases = [fps_case("anchors_no_pre_reduce", p, m, ANCHORS, cs, exchange_us, False)]
    _, _, ph, pw = compute_process_shape(IMG_H, IMG_W, RES644_HW[1])
    d644 = torch.from_numpy(anchor_depth(np.load(REFERENCE_POINTS)["points"], c2l[:1].cpu().numpy(), ph, pw)).cuda()
    rng = np.random.default_rng(13)
    fill = torch.from_numpy(rng.uniform(2.0, 60.0, tuple(d644.shape)).astype(np.float32)).cuda()
    p644 = cloud_from_depth(torch.where(d644 > 0, d644, fill), c2l)
    cases.append(fps_case("all_valid_process_res_644", p644, torch.ones(p644.shape[0], dtype=torch.bool, device="cuda"),
                          ANCHORS, None, exchange_us, False, iters=2))
    n = fps_ops.MAX_POINTS
    big = torch.from_numpy(np.concatenate([rng.uniform(-54, 54, (n, 2)), rng.uniform(-5, 3, (n, 1))], 1)
                           .astype(np.float32)).cuda()
    cases.append(fps_case("largest_n_all_valid", big, torch.ones(n, dtype=torch.bool, device="cuda"), LARGEST_FPS_K,
                          None, exchange_us, False, iters=2))
    if (tuple(RES644_HW) != (ph, pw) or cases[1]["N"] != S * ph * pw or cases[0]["N"] != NO_PRE_REDUCE_ROWS
            or cases[0]["plan"]["clusters"] != 5
            or not (cases[1]["plan"]["overflow"] and cases[2]["plan"]["overflow"])):
        fail(f"fps large cases: sizes {[(c['N'], c['clusters_used'], c['plan']) for c in cases]}")
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
    return profile_summary(prof, wall_ms, top_n)


def profile_summary(prof, wall_ms, top_n=15):
    """A finished ``torch.profiler`` session over ``wall_ms`` of wall time:
    device time by kernel class, the device's idle share, top kernels."""
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
        num_points=bk.num_points, gt_num_points=bk.gt_num_points, voxel_pre_reduce=bk.voxel_pre_reduce,
        pre_reduce_cap=bk.pre_reduce_cap,
        fps_impl=bk.fps_impl)
    return ResDet3D(rebuilt, model.pts_bbox_head, model.class_names), chosen


def det_train_batch(seed, head):
    """``train_batch`` with GT boxes: DET_GT_BOXES boxes a scene from a seed,
    centres inside the head's range, nuScenes-sized, labels over the ten
    classes (a fifth of them padding, -1)."""
    batch = train_batch(seed)
    rng = np.random.default_rng(seed + 1)
    pcr = head.point_cloud_range
    n = (TRAIN_B, DET_GT_BOXES)
    boxes = np.concatenate([rng.uniform(pcr[0] + 2, pcr[3] - 2, n + (1,)),
                            rng.uniform(pcr[1] + 2, pcr[4] - 2, n + (1,)), rng.uniform(-2.0, 0.0, n + (1,)),
                            rng.uniform(0.5, 5.0, n + (3,)), rng.uniform(-np.pi, np.pi, n + (1,)),
                            rng.normal(size=n + (2,))], -1).astype(np.float32)
    labels = rng.integers(0, 10, n)
    labels[:, -DET_GT_BOXES // 5:] = -1
    return dict(batch, gt_bboxes_3d=torch.from_numpy(boxes).cuda(), gt_labels_3d=torch.from_numpy(labels).cuda())


def detection_phase(c2l, depth, fps_case_of, case_of, fwd_case_of):
    """``configs/resdet3d_centerhead.py`` built by ``build_model_from_cfg`` at
    full width (nested-giant-large, process_res 504, no pre-reduce, the
    CenterHead's six tasks over the 256-channel BEV features), random weights
    from a seed: one warm-up and REQUESTS B=2 requests through
    ``simple_test`` and ``decode`` with the point path driven by the anchored
    depth, FPS and flash launches counted; then one warm-up and TRAIN_STEPS
    production train steps (DA3 frozen) with the CenterHead and occupancy
    losses on GT boxes from a seed, the point path again on the anchored
    depth."""
    t0 = time.perf_counter()
    cfg = load_py_config(DET_CONFIG)
    det = build_model_from_cfg(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(3))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    head, bk = det.pts_bbox_head, det.reconstruction_backbone
    if len(head.branches) != DET_TASKS or bk.voxel_pre_reduce != 0.0 or head.shared_conv.in_channels != 256:
        fail(f"detection: the config built {len(head.branches)} tasks, pre-reduce {bk.voxel_pre_reduce}, "
             f"head input {head.shared_conv.in_channels}")
    det.simple_test(images(900), c2l, depth_override=depth)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    fps_ops.reset_launch_counts()
    times, decode_ms = [], []
    for r in range(REQUESTS):
        img = images(901 + r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = det.simple_test(img, c2l, depth_override=depth)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dets = head.decode(out["det_preds"], class_names=det.class_names)
        times.append(1e3 * (t1 - t0))
        decode_ms.append(1e3 * (time.perf_counter() - t1))
    flash_by_shape = d64_launches(flash_attention_fwd, "detection")
    fps_by_shape = dict(fps_ops.furthest_point_sample_cuda.launches_by_shape)
    preds = out["det_preds"]
    grid = (B, 180, 180)
    shapes_ok = len(preds) == DET_TASKS and all(
        tuple(p["heatmap"].shape) == grid + (len(t),) and all(bool(torch.isfinite(v).all()) for v in p.values())
        for p, t in zip(preds, head.tasks))
    boxes_ok = len(dets) == B and all(np.isfinite(d["boxes_3d"]).all() and d["boxes_3d"].shape[1] == 9 for d in dets)
    unchecked = [sh for sh in fps_by_shape if sh not in fps_case_of]
    unchecked += [sh for sh in flash_by_shape if sh not in case_of]
    fps_expected = {(NO_PRE_REDUCE_ROWS, ANCHORS): B * REQUESTS, (UNION_CAP_NO_PRE_REDUCE, NUM_POINTS): B * REQUESTS}
    flash_expected = {SHAPES[name]: n * REQUESTS for name, n in EXPECTED_PER_FORWARD.items()}
    ms_mean = float(np.mean(times))
    res = dict(config=DET_CONFIG, tasks=[list(t) for t in head.tasks], build_s=build_s, requests=REQUESTS,
               scenes_per_request=B, views=S, image=[IMG_H, IMG_W], ms_per_request=times, ms_mean=ms_mean,
               camera_frames_per_s=B * S / (ms_mean / 1e3), decode_ms=decode_ms,
               boxes_per_scene=[len(d["boxes_3d"]) for d in dets], valid_counts_per_scene=
               {k: [int(c) for c in v] for k, v in bk.last_stage_counts.items()},
               fps_launches_by_size={str(k): n for k, n in fps_by_shape.items()},
               flash_launches_per_request=sum(flash_by_shape.values()) / REQUESTS,
               heatmap_max=max(float(torch.sigmoid(p["heatmap"]).max()) for p in preds))
    emit("detection", **res)
    if not shapes_ok or not boxes_ok:
        fail(f"detection: predictions of the wrong shape or non-finite ({shapes_ok}, {boxes_ok})")
    if unchecked:
        fail(f"detection: a kernel ran at sizes no case checked: {unchecked}")
    if fps_by_shape != fps_expected or flash_by_shape != flash_expected:
        fail(f"detection: fps launches {fps_by_shape} (expected {fps_expected}), flash {flash_by_shape}")

    # forward_train takes no depth override, and the random nested net calls every pixel sky (an empty cloud,
    # on which the head's input is zero and most of its gradients vanish): its depth is replaced by the anchored
    # scene's after DA3 has run, as depth_override does in the requests
    predict_depth = bk.predict_depth

    def anchored_depth(img):
        _, intr, da3_out = predict_depth(img)
        return depth[:img.shape[0]], intr, da3_out

    bk.predict_depth = anchored_depth
    batch = det_train_batch(950, head)
    trainer = Trainer(model=det, total_steps=1000, lr=1e-3)
    watched = {n: p.detach().clone() for n, p in det.pts_bbox_head.named_parameters()}
    _, tr, launches = run_train_steps("detection_train", det, trainer, batch, fps_case_of, fwd_case_of)
    # a convolution's bias in front of a batch norm in train mode gets no gradient (the norm subtracts it again):
    # every other parameter of the head must have moved
    params = dict(det.pts_bbox_head.named_parameters())
    still = {n: None if p.grad is None else float(p.grad.abs().max()) for n, p in params.items()
             if torch.equal(p.detach(), watched[n])}
    det_losses = sorted({k for h in tr.pop("history") for k in h if k.startswith("task")})
    emit("detection_train", **tr, depth="anchored scene", head_params=len(watched),
         head_params_moved=len(watched) - len(still), unmoved_with_largest_grad=still, detection_losses=det_losses)
    if len(det_losses) != 2 * DET_TASKS or any(g for g in still.values()):
        fail(f"detection train: losses {det_losses}, head parameters with a gradient that did not move {still}")
    if launches["dq"] or launches["dkv"]:
        fail(f"detection train: backward kernels launched with DA3 frozen: {launches}")
    res["train"] = tr
    del det, trainer, watched
    torch.cuda.empty_cache()
    return res, fps_by_shape


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
        fwd=d64_launches(flash_attention_fwd, phase), dq=d64_launches(flash_attention_bwd_dq, phase),
        dkv=d64_launches(flash_attention_bwd_dkv, phase),
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
        history=[{k: v for k, v in h.items() if k.startswith("task")} for h in history],
        trained_params=sum(p.numel() for p in trainer.optimizer.params),
        optimizer_state_tensors=len(trainer.optimizer.mu) + len(trainer.optimizer.nu),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return state, res, launches


@contextlib.contextmanager
def patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


@contextlib.contextmanager
def hub_offline():
    """``HF_HUB_OFFLINE=1`` for the CLIs' calls, the old value back afterwards:
    the production config names a hub checkpoint, and ``download_checkpoint``
    then returns None without asking the network."""
    saved = os.environ.get("HF_HUB_OFFLINE")
    os.environ["HF_HUB_OFFLINE"] = "1"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("HF_HUB_OFFLINE", None)
        else:
            os.environ["HF_HUB_OFFLINE"] = saved


class LoopClock:
    """Wraps the CLIs' data iterator (``recondet3d_torch.cli.train.data_iterator``,
    which both CLIs call): per batch the wall time between its hand-over and
    the next one's (a step: the caller's work on the batch plus the wait for
    the next) and the time spent waiting on the iterator; with
    ``profile_batch`` the caller's work on that batch (0-based) runs under
    ``torch.profiler``, from the hand-over to the request for the next."""

    def __init__(self, profile_batch=None):
        self.profile_batch = profile_batch
        self.intervals, self.waits, self.profile, self.profiled_interval = [], [], None, None

    def wrap(self, fn):
        def iterator(*args, **kwargs):
            from torch.profiler import ProfilerActivity, profile as torch_profile

            gen = fn(*args, **kwargs)
            prof, handed, n = None, None, 0
            try:
                while True:
                    if prof is not None:  # the profiled step: timed alone, the profiler's teardown left out
                        torch.cuda.synchronize()
                        wall = time.perf_counter() - prof_t0
                        prof.__exit__(None, None, None)
                        self.profile, self.profiled_interval, prof, handed = profile_summary(prof, 1e3 * wall), \
                            wall, None, None
                    t0 = time.perf_counter()
                    try:
                        batch = next(gen)
                    except StopIteration:
                        return
                    t1 = time.perf_counter()
                    if handed is not None:
                        self.waits.append(t1 - t0)
                        self.intervals.append(t1 - handed)
                    handed = t1
                    if n == self.profile_batch:
                        prof = torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                        prof.__enter__()
                        prof_t0 = time.perf_counter()
                    n += 1
                    yield batch
            finally:
                if prof is not None:
                    prof.__exit__(None, None, None)
                gen.close()

        return iterator

    def stats(self, skip=1):
        """ms per step (median, p90, each) after ``skip`` warm-up steps, and
        the share of their wall time spent waiting on the iterator (the
        profiled step is not among them)."""
        ms = 1e3 * np.asarray(self.intervals[skip:] or self.intervals)
        waits = self.waits[skip:] if self.intervals[skip:] else self.waits
        return dict(ms_median=float(np.median(ms)) if ms.size else None,
                    ms_p90=float(np.percentile(ms, 90)) if ms.size else None,
                    ms_each=[float(v) for v in 1e3 * np.asarray(self.intervals)],
                    host_wait_share=float(sum(waits) / max(1e-3 * ms.sum(), 1e-9)),
                    profiled_step_ms=None if self.profiled_interval is None else 1e3 * self.profiled_interval)


def tests_module(name):
    """A helper module of the repository's ``tests/`` (``nuscenes_fixture``, ``jax_init``)."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    return importlib.import_module(name)


def write_loop_fixture(root, n_cams):
    """``tests/nuscenes_fixture.make_fixture(structured=True)`` with its
    images written as binary PPM (file names as they are), then
    ``create_data`` through the port's CLI. The fixture names cameras past
    the second ``CAM_2``, ``CAM_3``, ...; the converter takes the six nuScenes
    channels only, so with six cameras their channels in ``sensor.json`` and
    ``sample.json`` are renamed to the other four (the rig's other poses)."""
    nuscenes_fixture = tests_module("nuscenes_fixture")

    with patched(nuscenes_fixture, "_write_jpeg", write_ppm):
        nuscenes_fixture.make_fixture(root, n_cams=n_cams, structured=True)
    others = iter(c for c in ("CAM_FRONT_RIGHT", "CAM_FRONT_LEFT", "CAM_BACK_LEFT", "CAM_BACK_RIGHT"))
    channel = {f"CAM_{i}": next(others) for i in range(2, n_cams)}
    for table in ("sensor", "sample"):
        path = os.path.join(root, "v1.0-mini", f"{table}.json")
        with open(path) as f:
            rows = json.load(f)
        for row in rows:
            if table == "sensor":
                row["channel"] = channel.get(row["channel"], row["channel"])
            else:
                row["data"] = {channel.get(k, k): v for k, v in row["data"].items()}
        with open(path, "w") as f:
            json.dump(rows, f)
    with contextlib.redirect_stdout(io.StringIO()):
        if cli_create_data.main(["nuscenes", "--root-path", root, "--extra-tag", "loop", "--version", "v1.0-mini"]):
            fail("create_data failed")
    return os.path.join(root, "loop_infos_train.pkl")


def loader_images_identical(root, hw=(IMG_H, IMG_W)):
    """The fixture's images as the two training loaders read them: the
    port's ``resize_bilinear(imread_rgb(path))`` against the JAX package's
    ``cv2.resize(cv2.imread(path)[..., ::-1], (W, H))``
    (``recondet3d/cli/train.py``); None where cv2 does not import."""
    try:
        import cv2
    except ImportError:
        return None
    samples = os.path.join(root, "samples")
    paths = sorted(os.path.join(samples, cam, f) for cam in os.listdir(samples) if cam.startswith("CAM")
                   for f in os.listdir(os.path.join(samples, cam)))
    same = [np.array_equal(resize_bilinear(imread_rgb(p), hw), cv2.resize(cv2.imread(p)[..., ::-1], hw[::-1]))
            for p in paths]
    return dict(images=len(paths), source_hw=list(imread_rgb(paths[0]).shape[:2]), loader_hw=list(hw),
                byte_identical=int(sum(same)), all_byte_identical=bool(paths) and all(same), cv2=cv2.__version__)


def stage_counts(model):
    return {k: [int(c) for c in v] for k, v in model.reconstruction_backbone.last_stage_counts.items()}


def loop_launches():
    return dict(fwd=d64_launches(flash_attention_fwd, "full loop"),
                fps=dict(fps_ops.furthest_point_sample_cuda.launches_by_shape))


def run_full_loop(phase, config, n_cams, steps, train_args, train_inner, profile_batch=None, jax_seed=None):
    """The loop through the port's entry points, in this process (so that the
    kernels' launch counts are read): the fixture, ``create_data``,
    ``cli.train.main`` for ``steps`` steps on the card, ``cli.test.main`` on
    its last checkpoint; the CLIs' output is kept and parsed. Counts are set
    to 0 just before each CLI and read just after. The work dir and fixture
    live in a temporary directory that is removed afterwards. With
    ``jax_seed`` the run starts from the JAX package's initial weights of
    that seed (``tests/jax_init.py``: a step-0 checkpoint the CLI resumes
    from)."""
    tmp = tempfile.mkdtemp(prefix="recondet3d_loop_")
    built, timing = [], defaultdict(list)

    def build(cfg, device="cuda", generator=None):
        built.append(build_model_from_cfg(cfg, device=device, generator=generator))
        return built[-1]

    def timed(fn, key):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            timing[key].append(time.perf_counter() - t0)
            return out
        return call

    try:
        t0 = time.perf_counter()
        ann = write_loop_fixture(os.path.join(tmp, "nusc"), n_cams)
        root = os.path.dirname(ann)
        fixture_s = time.perf_counter() - t0
        loader_images = loader_images_identical(root)
        ov = ["--cfg-options", f"{train_inner}.ann_file={ann}", f"{train_inner}.data_root={root}",
              f"data.test.ann_file={ann}", f"data.test.data_root={root}"]
        wd = os.path.join(tmp, "work_dir")
        if jax_seed is not None:
            tests_module("jax_init").write_initial_checkpoint(
                build_model_from_cfg(load_py_config(config), device="cuda"), config, wd, steps, seed=jax_seed)
            torch.cuda.empty_cache()
        train_clock, test_clock = LoopClock(profile_batch), LoopClock()
        with hub_offline(), patched(cli_train, "build_model_from_cfg", build), \
                patched(ckpt_io, "save_checkpoint", timed(ckpt_io.save_checkpoint, "save_s")), \
                patched(ckpt_io, "load_checkpoint", timed(ckpt_io.load_checkpoint, "load_s")):
            out = io.StringIO()
            with patched(cli_train, "data_iterator", train_clock.wrap(cli_train.data_iterator)), \
                    contextlib.redirect_stdout(out):
                torch.cuda.synchronize()
                reset_launch_counts()
                fps_ops.reset_launch_counts()
                t0 = time.perf_counter()
                rc = cli_train.main([config, "--work-dir", wd, "--max-steps", str(steps)] + train_args + ov)
                torch.cuda.synchronize()
                train_s = time.perf_counter() - t0
                train_launches = loop_launches()
            train_out = out.getvalue()
            train_counts = stage_counts(built[-1])
            built.clear()
            torch.cuda.empty_cache()
            ckpt = ckpt_io.latest_checkpoint(wd)
            ckpt_bytes = os.path.getsize(ckpt) if ckpt else None
            out = io.StringIO()
            with patched(cli_train, "data_iterator", test_clock.wrap(cli_train.data_iterator)), \
                    contextlib.redirect_stdout(out):
                torch.cuda.synchronize()
                reset_launch_counts()
                fps_ops.reset_launch_counts()
                t0 = time.perf_counter()
                rc_test = cli_test.main([config, "--checkpoint", ckpt] + ov) if ckpt else None
                torch.cuda.synchronize()
                test_s = time.perf_counter() - t0
                test_launches = loop_launches()
            test_out = out.getvalue()
            test_counts = stage_counts(built[-1]) if built else None
    finally:
        built.clear()
        torch.cuda.empty_cache()
        shutil.rmtree(tmp, ignore_errors=True)
    steps_logged = [{k: float(v) for k, v in re.findall(r"(\S+)=(\S+)", line)}
                    for line in re.findall(r"^step \d+: (.*)$", train_out, re.M)]
    metrics = {m.group(1): float(m.group(2)) for m in re.finditer(r"pts_bbox_NuScenes/(\S+): ([0-9.naif-]+)", test_out)}
    boxes = [int(n) for n in re.findall(r"^sample \d+: (\d+) boxes", test_out, re.M)]
    return dict(config=config, views=n_cams, steps=steps, initial_weights=(
                    f"the JAX package's at seed {jax_seed} (tests/jax_init.py)" if jax_seed is not None
                    else "the port's from --seed 0"), resumed_at_step_0="at step 0" in train_out,
                rc_train=rc, rc_test=rc_test, fixture_s=fixture_s, loader_images=loader_images,
                train_s=train_s, test_s=test_s, train_step=train_clock.stats(), eval_sample=test_clock.stats(skip=1),
                profiled_step=train_clock.profile, checkpoint=os.path.basename(ckpt) if ckpt else None,
                checkpoint_bytes=ckpt_bytes, save_s=timing["save_s"], load_s=timing["load_s"],
                loss_first=steps_logged[0].get("loss") if steps_logged else None,
                loss_last=steps_logged[-1].get("loss") if steps_logged else None,
                losses=[h.get("loss") for h in steps_logged], logged=steps_logged, metrics=metrics,
                boxes_per_sample=boxes, valid_counts_last_step=train_counts, valid_counts_last_sample=test_counts,
                launches=dict(train={k: {str(s): n for s, n in v.items()} for k, v in train_launches.items()},
                              test={k: {str(s): n for s, n in v.items()} for k, v in test_launches.items()}),
                train_tail=train_out[-1500:], test_tail=test_out[-1500:]), train_launches, test_launches


def check_loop_launches(phase, launches, fwd_expected, fps_expected, fwd_case_of, fps_case_of):
    unchecked = [sh for sh in launches["fwd"] if sh not in fwd_case_of]
    unchecked += [sh for sh in launches["fps"] if sh not in fps_case_of]
    if unchecked:
        fail(f"{phase}: a kernel ran at sizes no kernel case checked: {unchecked}")
    if launches["fwd"] != fwd_expected or launches["fps"] != fps_expected:
        fail(f"{phase}: launches {launches} (expected flash {fwd_expected}, fps {fps_expected})")


def tiny_loop_cases(exchange_us):
    """The flash forward and FPS kernels against their plain versions at the
    tiny loop's sizes (random bf16 q, k, v; a random cloud in the tiny
    config's range with as many valid rows as the loop's first step has)."""
    fwd = {tuple(c["shape"]): c for c in (kernel_case(name, shape, None, seed=90 + i)
                                           for i, (name, shape) in enumerate(TINY_FWD_SHAPES.items()))}
    rng = np.random.default_rng(96)
    fps = {}
    for (name, (n, k)), share in zip(TINY_FPS.items(), (0.34, 0.5)):
        pts = torch.from_numpy(np.concatenate([rng.uniform(-8, 8, (n, 2)), rng.uniform(-2, 2, (n, 1))], 1)
                               .astype(np.float32)).cuda()
        valid = torch.from_numpy(rng.random(n) < share).cuda()
        fps[(n, k)] = fps_case(name, pts, valid, k, None, exchange_us, False)
    return fwd, fps


def loop_gates(res):
    """tests/test_full_loop.py's gates on a loop's result: (passed, values)."""
    m, losses = res["metrics"], res["losses"]
    normalized = losses[-1] / losses[0] if len(losses) >= 2 and losses[0] else None
    present_mean = float(np.mean([m.get(k, 0.0) for k in PRESENT]))
    values = dict(normalized_loss=normalized, car_ap=m.get("car_AP"), present_mean_ap=present_mean,
                  present_aps={k: m.get(k) for k in PRESENT}, map=m.get("mAP"), nds=m.get("NDS"))
    ok = (normalized is not None and normalized < LOOP_GATES["normalized_loss_below"]
          and m.get("car_AP", 0.0) > LOOP_GATES["car_ap_above"]
          and present_mean > LOOP_GATES["present_mean_ap_above"] and all(m.get(k, 0.0) > 0.0 for k in PRESENT)
          and m.get("mAP", 0.0) > LOOP_GATES["map_above"] and m.get("NDS", 0.0) > LOOP_GATES["nds_above"])
    return ok, values


def metrics_complete(res):
    m = res["metrics"]
    keys = [f"{c}_AP" for c in CLASS_NAMES] + ["mAP", "NDS"]
    return all(k in m and np.isfinite(m[k]) for k in keys)


def full_loop_tiny_phase(exchange_us):
    """Phase 18: the full loop on the tiny CenterHead config, LOOP_STEPS steps on the card from the JAX full-loop
    test's own initial weights (the JAX CLI's at seed 0), with that test's gates; the flash forward and FPS
    launches counted and held to the shapes checked just before. The gates depend on the initial weights: from
    its own draws either package meets them at a minority of seeds (PERF.md, PR 7), so the phase runs the
    JAX test's experiment, not a draw of the port's generator."""
    fwd_case_of, fps_case_of = tiny_loop_cases(exchange_us)
    res, tr, te = run_full_loop("full_loop_tiny", TINY_CONFIG, 2, LOOP_STEPS,
                                ["--checkpoint-interval", str(LOOP_CKPT_INTERVAL)], "data.train", jax_seed=0)
    ok, gates = loop_gates(res)
    res["gates"], res["gate_values"], res["gates_passed"] = LOOP_GATES, gates, ok
    emit("full_loop_tiny", **{k: v for k, v in res.items() if k != "logged"})
    # the two packages' loaders hand the models the same bytes (cv2's INTER_LINEAR in the port's fixed point)
    print(f"chip_smoke: full loop (tiny): the loaders' images, port vs cv2: {res['loader_images']}", flush=True)
    if res["loader_images"] is not None and not res["loader_images"]["all_byte_identical"]:
        fail(f"full loop (tiny): the port's loader resizes the fixture's images otherwise than cv2: "
             f"{res['loader_images']}")
    if res["rc_train"] != 0 or res["rc_test"] != 0 or not res["resumed_at_step_0"]:
        fail(f"full loop (tiny): exit codes train {res['rc_train']} test {res['rc_test']}, resumed from the "
             f"initial checkpoint {res['resumed_at_step_0']}")
    fwd_step = {TINY_FWD_SHAPES[n]: c for n, c in TINY_FWD_PER_FORWARD.items()}
    check_loop_launches("full loop (tiny) train", tr, {s: c * LOOP_STEPS for s, c in fwd_step.items()},
                        {s: LOOP_STEPS for s in TINY_FPS.values()}, fwd_case_of, fps_case_of)
    check_loop_launches("full loop (tiny) test", te, {s: c * LOOP_SAMPLES for s, c in fwd_step.items()},
                        {s: LOOP_SAMPLES for s in TINY_FPS.values()}, fwd_case_of, fps_case_of)
    if not metrics_complete(res):
        fail(f"full loop (tiny): metric lines missing or not finite: {res['metrics']}")
    if not ok:
        fail(f"full loop (tiny): the JAX full-loop test's gates fail on the card: {gates}")
    return res, fwd_case_of, fps_case_of, tr, te


def full_loop_full_width_phase(fwd_case_of, fps_case_of):
    """Phase 19: the production detection config (nested-giant-large, no pre-reduce, six tasks) through the same
    CLIs on a six-view fixture: FULL_LOOP_STEPS steps with only the final checkpoint, then the test CLI on it.
    Random DA3 weights (the repository holds no checkpoint): gates on running, not on quality."""
    res, tr, te = run_full_loop("full_loop_full_width", DET_CONFIG, S, FULL_LOOP_STEPS,
                                ["--checkpoint-interval", "0"], "data.train.dataset", profile_batch=1)
    emit("full_loop_full_width", **res)
    if res["rc_train"] != 0 or res["rc_test"] != 0:
        fail(f"full loop (full width): exit codes train {res['rc_train']} test {res['rc_test']}")
    if len(res["logged"]) != FULL_LOOP_STEPS or not all(np.isfinite(v) for h in res["logged"] for v in h.values()):
        fail(f"full loop (full width): steps logged {len(res['logged'])}, finite {res['logged']}")
    if not res["load_s"] or not metrics_complete(res):
        fail(f"full loop (full width): checkpoint not loaded ({res['load_s']}) or metrics {res['metrics']}")
    fwd_step = {TRAIN_FWD_SHAPES["vitg_local_b1"]: 26, TRAIN_FWD_SHAPES["vitg_global_b1"]: 14,
                TRAIN_FWD_SHAPES["vitl_local_b1"]: 24}
    fps_sizes = ((NO_PRE_REDUCE_ROWS, ANCHORS), (UNION_CAP_NO_PRE_REDUCE, NUM_POINTS))
    check_loop_launches("full loop (full width) train", tr, {s: c * FULL_LOOP_STEPS for s, c in fwd_step.items()},
                        {s: FULL_LOOP_STEPS for s in fps_sizes}, fwd_case_of, fps_case_of)
    check_loop_launches("full loop (full width) test", te, {s: c * LOOP_SAMPLES for s, c in fwd_step.items()},
                        {s: LOOP_SAMPLES for s in fps_sizes}, fwd_case_of, fps_case_of)
    return res, tr, te


def f32_check(name, shape, seed, iters=50):
    """The fp32 attention forward at one more shape: the short kernel (on the
    qkv split's views, as the API's CameraEnc calls it) and the tiled one
    against ``attention_plain``, rel L2 and lse gates; host time per call in
    a loop of calls (launch-bound here) of both, the plain version, SDPA and
    the launch floor, no profiler session (phase 11b times this shape on
    the device)."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda() for _ in range(3))
    views = qkv_split(q, k, v)
    ref_out, ref_lse = attention_plain(q, k, v)
    errs = {}
    for key, (out, lse) in (("short", attention_fwd_short(*views)), ("tiled", attention_fwd_cuda_core(q, k, v))):
        errs[key] = dict(max_abs_err=(out - ref_out).abs().max().item(), rel_l2_err=rel_l2(out, ref_out),
                         max_abs_err_lse=(lse - ref_lse).abs().max().item())
    b_ms, b_by = f32_bound_ms(shape)
    res = dict(name=name, shape=list(shape), max_abs_err=max(e["max_abs_err"] for e in errs.values()), errors=errs,
               tol=dict(out_rel_l2=F32_REL_TOL, lse=F32_LSE_TOL),
               host_ms=time_ms(lambda: attention_fwd_short(*views), iters),
               tiled_host_ms=time_ms(lambda: attention_fwd_cuda_core(q, k, v), iters),
               plain_host_ms=time_ms(lambda: attention_plain(q, k, v), iters),
               library_host_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters),
               floor_host_ms=time_ms(launch_floor(), iters), bound_ms=b_ms, bound_by=b_by)
    emit("f32_kernel", **res)
    if not all(e["rel_l2_err"] <= F32_REL_TOL and e["max_abs_err_lse"] <= F32_LSE_TOL for e in errs.values()):
        fail(f"fp32 attention kernels disagree with the plain version at {name}: {errs}")
    return res


def long_flash_case(name, shape, seed, smi, iters=5):
    """The flash forward at a global shape too large for the plain version's
    (N, M) scores at once: the plain version runs one head at a time (its
    time is the loop over the heads), the kernel and SDPA on all heads."""
    Bq, H, N, M = shape
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((Bq, H, n, 64), dtype=np.float32)).cuda().to(torch.bfloat16)
               for n in (N, M, M))
    out, lse = flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    qs = (q.float() * 64 ** -0.5).to(q.dtype)
    err_out = err_lse = 0.0
    num = den = 0.0
    for h in range(H):
        ref_out, ref_lse = attention_plain(qs[:, h:h + 1].float(), k[:, h:h + 1].float(), v[:, h:h + 1].float(), None,
                                           1.0)
        d = out[:, h:h + 1].float() - ref_out
        err_out = max(err_out, d.abs().max().item())
        err_lse = max(err_lse, (lse[:, h:h + 1] - ref_lse).abs().max().item())
        num, den = num + float((d * d).sum()), den + float((ref_out * ref_out).sum())
        del ref_out, ref_lse, d
    rel_out = (num / den) ** 0.5
    ok = err_out <= OUT_TOL and rel_out <= OUT_REL_TOL and err_lse <= LSE_TOL and bool(torch.isfinite(out).all())

    def plain_heads():
        for h in range(H):
            attention_plain(q[:, h:h + 1], k[:, h:h + 1], v[:, h:h + 1])

    rows = np.full(Bq * H, M, np.float64)
    k_ms = time_ms(lambda: flash_attention_fwd(q, k, v), iters)
    b_ms, b_by = bound_ms(Bq * H, N, rows)
    res = dict(name=name, shape=list(shape), kv_len=None, scale=None, max_abs_err=err_out, rel_l2_err=rel_out,
               max_abs_err_lse=err_lse, tol=dict(out=OUT_TOL, out_rel_l2=OUT_REL_TOL, lse=LSE_TOL), ms=k_ms,
               plain_ms=time_ms(plain_heads, 1, warmup=1), plain_note="one head at a time",
               library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters), bound_ms=b_ms,
               bound_by=b_by, exp_floor_ms=exp_floor_ms(N, rows),
               tflops=4.0 * N * 64 * rows.sum() / (k_ms * 1e-3) / 1e12, nvidia_smi=smi, ok=ok)
    emit("kernel", **res)
    if not ok:
        fail(f"flash kernel disagrees with the plain version at {name}: out {err_out} (rel L2 {rel_out}), "
             f"lse {err_lse}")
    return res


def api_images(seed, views, h, w):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(views)]


def read_glb(path):
    """(JSON chunk, BIN length) of a GLB file, its header and chunk lengths checked."""
    import struct

    with open(path, "rb") as f:
        data = f.read()
    magic, version, total = struct.unpack("<III", data[:12])
    n_json, t_json = struct.unpack("<II", data[12:20])
    n_bin, t_bin = struct.unpack("<II", data[20 + n_json:28 + n_json])
    if (magic, version, total, t_json, t_bin) != (0x46546C67, 2, len(data), 0x4E4F534A, 0x004E4942) \
            or 28 + n_json + n_bin != len(data):
        fail(f"{path}: not a well-formed GLB (magic {magic:#x}, version {version}, length {total} of {len(data)})")
    return json.loads(data[20:20 + n_json]), n_bin


def check_api_exports(d, views):
    """Read every file of the API's exports back with the port's readers."""
    gltf, n_bin = read_glb(os.path.join(d, "scene.glb"))
    n_points = gltf["accessors"][0]["count"]
    ply = read_ply(os.path.join(d, "gaussians.ply"))
    cams = read_cameras_bin(os.path.join(d, "colmap", "cameras.bin"))
    imgs = read_images_bin(os.path.join(d, "colmap", "images.bin"))
    npz, mini = np.load(os.path.join(d, "prediction.npz")), np.load(os.path.join(d, "prediction_mini.npz"))
    depth_vis = [imread_rgb(os.path.join(d, f"depth_{i:03d}.png")) for i in range(views)]
    feat = [imread_rgb(os.path.join(d, f"feat_layer_{API_FEAT_LAYERS[0]}_view{i:02d}.png")) for i in range(views)]
    res = dict(glb_points=n_points, glb_bin_bytes=n_bin, glb_meshes=len(gltf["meshes"]), ply_vertices=len(ply["x"]),
               ply_fields=len(ply), colmap_cameras=len(cams), colmap_images=len(imgs),
               npz_keys=sorted(npz.files), mini_npz_keys=sorted(mini.files),
               depth_vis=[list(im.shape) for im in depth_vis[:1]], feat_vis=[list(im.shape) for im in feat[:1]])
    ok = (0 < n_points <= 1_000_000 and len(gltf["meshes"]) == 1 + views and res["ply_vertices"] == API_GAUSSIANS
          and res["ply_fields"] == 6 + 3 + 24 + 1 + 3 + 4 and len(cams) == len(imgs) == views
          and all((c["width"], c["height"]) == (504, 280) for c in cams.values())
          and {"depth", "conf", "extrinsics", "intrinsics", "processed_images"} <= set(npz.files)
          and {"depth", "conf", "extrinsics", "intrinsics"} <= set(mini.files)
          and npz["depth"].shape == (views, 280, 504)
          and all(im.shape == (280, 504, 3) for im in depth_vis)
          and all(im.shape == (20 * 8, 36 * 8, 3) for im in feat))
    if not ok:
        fail(f"da3-api: the exported files read back wrong: {res}")
    return res


def planted_gaussians(n, hw, K, seed):
    """``n`` Gaussians in the identity camera's frustum: centres uniform over
    the image at 256 depths in [2, 6) (many equal), footprints of 0.7-2.5 px,
    opacities 0.1-0.9, degree-2 colours; a frame they cover, where every tile
    composites its full 192 splats."""
    rng = np.random.default_rng(seed)
    H, W = hw
    u, v = rng.uniform(0, W, n), rng.uniform(0, H, n)
    z = 2.0 + rng.integers(0, 256, n) / 64.0
    means = np.stack([(u - K[0, 2]) * z / K[0, 0], (v - K[1, 2]) * z / K[1, 1], z], 1)
    scales = (rng.uniform(0.7, 2.5, n) * z / K[0, 0])[:, None] * rng.uniform(0.5, 1.5, (n, 3))
    rot = rng.normal(size=(n, 4))
    f32 = lambda a: np.ascontiguousarray(a, np.float32)
    return Gaussians(means=f32(means), scales=f32(scales), rotations=f32(rot / np.linalg.norm(rot, axis=1, keepdims=True)),
                     harmonics=f32(0.3 * rng.normal(size=(n, 3, 9))), opacities=f32(rng.uniform(0.1, 0.9, n)))


def timed_ms(fn, reps=3):
    """One warm-up call, then ``reps`` timed calls: (the last result, ms a call)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return out, times


def check_prediction(pred, views, what, gaussians=True):
    shapes = dict(depth=(views, 280, 504), conf=(views, 280, 504), extrinsics=(views, 3, 4), intrinsics=(views, 3, 3))
    for key, shp in shapes.items():
        a = getattr(pred, key)
        if a is None or a.shape != shp or not np.isfinite(a).all():
            fail(f"da3-api {what}: {key} of shape {None if a is None else a.shape} or non-finite")
    if not (pred.depth > 0).all():
        fail(f"da3-api {what}: a depth is not positive")
    if not gaussians:
        return {}
    g = pred.gaussians
    n = views * 280 * 504
    want = dict(means=(1, n, 3), scales=(1, n, 3), rotations=(1, n, 4), harmonics=(1, n, 3, 9), opacities=(1, n))
    for key, shp in want.items():
        a = getattr(g, key)
        if a.shape != shp or not np.isfinite(a).all():
            fail(f"da3-api {what}: gaussians.{key} of shape {a.shape} or non-finite")
    quat_err = float(np.abs(np.linalg.norm(g.rotations, axis=-1) - 1.0).max())
    res = dict(gaussians=n, quat_norm_max_err=quat_err, opacity_range=[float(g.opacities.min()),
                                                                         float(g.opacities.max())])
    if quat_err > 1e-4 or g.opacities.min() < 0 or g.opacities.max() > 1:
        fail(f"da3-api {what}: quaternions or opacities out of range: {res}")
    return res


def raw_gs_hook(model):
    """A forward hook on the GS head that keeps its last outputs."""
    kept = {}
    head = model.da3.gs_head
    handle = head.register_forward_hook(lambda m, args, out: kept.update(raw=out["raw_gs"].float().clone()))
    return kept, handle


def da3_api_phase(smi, fwd_case_of):
    """Phase 20: the DA3 API and the da3 CLI at full width (see the module docstring)."""
    work = tempfile.mkdtemp(prefix="da3_api_")
    res = {}
    try:
        with hub_offline():
            t0 = time.perf_counter()
            api = DepthAnything3.from_pretrained(API_MODEL, cache_dir=os.path.join(work, "empty_cache"))
            torch.cuda.synchronize()
            model = api.model
            res["build"] = dict(model=API_MODEL, random_init=api.random_init, build_s=time.perf_counter() - t0,
                                cv2=importlib.util.find_spec("cv2") is not None,
                                pil=importlib.util.find_spec("PIL") is not None,
                                params=sum(p.numel() for p in model.parameters()),
                                gs_head_params=sum(p.numel() for p in model.da3.gs_head.parameters()))
            if not api.random_init or model.da3.gs_head is None:
                fail(f"da3-api: expected the preset's GS head on random weights: {res['build']}")
            emit("da3_api_build", **res["build"])

            # (a) the CLI's default model on 6 views of 900x1600, every exporter but the video
            imgs = api_images(900, S, IMG_H, IMG_W)
            # the random metric branch calls every pixel sky, and a GLB of no point fails in both packages
            # (export_to_glb takes min/max of the points): the GLB keeps the sky pixels
            kw = dict(infer_gs=True, export_format=API_FORMATS, export_feat_layers=API_FEAT_LAYERS,
                      export_kwargs=dict(filter_sky=False, max_depth=None))
            api.inference(imgs, export_dir=os.path.join(work, "warm"), **kw)
            torch.cuda.synchronize()
            reset_launch_counts()
            times = []
            for r in range(API_CALLS):
                t0 = time.perf_counter()
                pred = api.inference(imgs, export_dir=os.path.join(work, f"call{r}"), **kw)
                times.append(1e3 * (time.perf_counter() - t0))
            launches = d64_launches(flash_attention_fwd, "da3-api")
            per_call = {name: launches.get(shape, 0) / API_CALLS for name, shape in API_SHAPES.items()}
            unchecked = [shape for shape in launches if shape not in fwd_case_of]
            # the parts of one call: the host preprocessing, the call without exports, the exports alone
            t0 = time.perf_counter()
            api.input_processor(imgs)
            pre_ms = 1e3 * (time.perf_counter() - t0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            api.inference(imgs, infer_gs=True, export_feat_layers=API_FEAT_LAYERS)
            no_export_ms = 1e3 * (time.perf_counter() - t0)
            with torch.inference_mode():  # the device forward alone, then its outputs to the host
                x = torch.from_numpy(api.input_processor(imgs)[0]).to(api.device)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = model(x, infer_gs=True, export_feat_layers=API_FEAT_LAYERS)
                torch.cuda.synchronize()
                forward_ms = 1e3 * (time.perf_counter() - t0)
                t0 = time.perf_counter()
                api.output_processor(out)
                to_host_ms = 1e3 * (time.perf_counter() - t0)
                del x, out
            t0 = time.perf_counter()
            da3_export(pred, API_FORMATS, os.path.join(work, "export_alone"), conf_thresh_percentile=40.0,
                       max_points=1_000_000, show_cameras=True, **kw["export_kwargs"])
            export_ms = 1e3 * (time.perf_counter() - t0)
            checks = check_prediction(pred, S, "(a)")
            files = check_api_exports(os.path.join(work, f"call{API_CALLS - 1}"), S)
            res["a"] = dict(views=S, image=[IMG_H, IMG_W], formats=API_FORMATS, ms_per_call=times,
                            ms_mean=float(np.mean(times)), preprocess_ms=pre_ms, call_without_export_ms=no_export_ms,
                            forward_ms=forward_ms, to_host_ms=to_host_ms, export_ms=export_ms,
                            forward_share_of_call=forward_ms / float(np.mean(times)), flash_launches_by_shape={str(k): n for k, n in launches.items()},
                            flash_launches_per_call=per_call, **checks, files=files, nvidia_smi=smi)
            emit("da3_api", **res["a"])
            if unchecked:
                fail(f"da3-api: a flash launch at shapes no kernel case checked: {unchecked}")
            if per_call != EXPECTED_PER_FORWARD:
                fail(f"da3-api: flash launches per call {per_call}, expected {EXPECTED_PER_FORWARD}")

            # (b) in situ: the same call with the trunks' attention on the plain version
            kept, handle = raw_gs_hook(model)
            kw_b = dict(infer_gs=True, ref_view_strategy="first", export_feat_layers=API_FEAT_LAYERS)
            got = api.inference(imgs, **kw_b)
            raw_k = kept["raw"]
            set_attn_impl(model, "plain")
            ref = api.inference(imgs, **kw_b)
            set_attn_impl(model, "auto")
            handle.remove()
            feat = f"feat_layer_{API_FEAT_LAYERS[0]}"
            res["b"] = dict(feat_rel_l2=rel_l2(torch.from_numpy(got.aux[feat]), torch.from_numpy(ref.aux[feat])),
                            raw_gs_rel_l2=rel_l2(raw_k, kept["raw"]),
                            depth_rel_l2=rel_l2(torch.from_numpy(got.depth), torch.from_numpy(ref.depth)),
                            tol=dict(feat=FEAT_REL_TOL, raw_gs=FEAT_REL_TOL), depth_gate=None)
            emit("da3_api_in_situ", **res["b"])
            # as in phase 6, the gate holds the features and what the heads compute from them linearly (the raw
            # Gaussians); depth = exp(logit) of a random head amplifies a rounding difference (phase 6 reads 0.17 on
            # the depth of the same net, ungated), so it is reported beside them
            if not (res["b"]["feat_rel_l2"] <= FEAT_REL_TOL and res["b"]["raw_gs_rel_l2"] <= FEAT_REL_TOL):
                fail(f"da3-api in situ: kernel vs plain {res['b']}")
            del got, ref, raw_k, kept

            # (c) GT poses: the camera encoder's fp32 attention, extrinsics aligned back to the input
            f32_b1 = f32_check("cam_enc_giant_b1", (1, 16, S, 96), seed=903)
            ext, ixt = gt_poses(1, S, 904, IMG_H, IMG_W)
            ext, ixt = ext[0].cpu().numpy(), ixt[0].cpu().numpy()
            reset_launch_counts()
            t0 = time.perf_counter()
            posed = api.inference(imgs, extrinsics=ext, intrinsics=ixt, infer_gs=True)
            pose_ms = 1e3 * (time.perf_counter() - t0)
            f32_launches = dict(attention_fwd_short.launches_by_shape)
            tiled = attention_fwd_cuda_core.launches
            pose_checks = check_prediction(posed, S, "(c)")
            align_err = float(np.abs(posed.extrinsics - ext[:, :3]).max())
            res["c"] = dict(ms=pose_ms, extrinsics_max_abs_err=align_err, tol=1e-5,
                            f32_launches_by_shape={str(k): n for k, n in f32_launches.items()}, **pose_checks,
                            nvidia_smi=smi)
            emit("da3_api_poses", **res["c"])
            if align_err > 1e-5:
                fail(f"da3-api (c): extrinsics {align_err} from the input")
            if f32_launches != {(1, 16, S, S, 96): CAM_BLOCKS} or tiled:
                fail(f"da3-api (c): short fp32 launches {f32_launches}, expected {CAM_BLOCKS} at (1, 16, {S}, {S}, "
                     f"96); tiled {tiled}, expected 0")
            # without align_to_input_ext_scale the API returns the input's poses moved by the Umeyama similarity into
            # the prediction's frame, and leaves the depth undivided: one similarity must map the input onto them
            # exactly, and its scale is what the depth above was divided by
            unscaled = api.inference(imgs, extrinsics=ext, intrinsics=ixt, align_to_input_ext_scale=False)
            check_prediction(unscaled, S, "(c) unscaled", gaussians=False)
            _, _, sim_scale, refit = align_poses_umeyama(unscaled.extrinsics, ext, return_aligned=True)
            pose_scale = max(1.0, float(np.abs(unscaled.extrinsics).max()))
            res["c"]["unscaled"] = dict(
                similarity_max_abs_err=float(np.abs(refit[:, :3] - unscaled.extrinsics).max()) / pose_scale,
                similarity_scale=float(sim_scale),
                depth_ratio=float(np.median(unscaled.depth / posed.depth)), moved_from_input=float(
                    np.abs(unscaled.extrinsics - ext[:, :3]).max()), tol=1e-4)
            emit("da3_api_poses_unscaled", **res["c"]["unscaled"])
            u = res["c"]["unscaled"]
            if not (u["similarity_max_abs_err"] <= 1e-4 and abs(u["depth_ratio"] / u["similarity_scale"] - 1) <= 1e-4):
                fail(f"da3-api (c): the unscaled poses are no similarity of the input at the depth's scale: {u}")
            del posed, unscaled

            # (d) pose from the ray head
            t0 = time.perf_counter()
            rayed = api.inference(imgs, use_ray_pose=True)
            ray_ms = 1e3 * (time.perf_counter() - t0)
            check_prediction(rayed, S, "(d)", gaussians=False)
            fx, fy = rayed.intrinsics[:, 0, 0], rayed.intrinsics[:, 1, 1]
            res["d"] = dict(ms=ray_ms, fx=fx.tolist(), fy=fy.tolist(), nvidia_smi=smi)
            emit("da3_api_ray_pose", **res["d"])
            if not ((fx > 0).all() and (fy > 0).all()):
                fail(f"da3-api (d): focal lengths not positive: {res['d']}")
            del rayed

            # (e) the CLI as a user runs it, on PNGs written by the port and on the COLMAP model (a) exported
            png_dir = os.path.join(work, "pngs")
            os.makedirs(png_dir)
            for i, im in enumerate(imgs):
                write_png(os.path.join(png_dir, f"view_{i:03d}.png"), im)
            colmap_dir = os.path.join(work, "colmap_model")
            os.makedirs(os.path.join(colmap_dir, "sparse"))
            shutil.copytree(os.path.join(work, f"call{API_CALLS - 1}", "colmap"), os.path.join(colmap_dir, "sparse", "0"))
            os.makedirs(os.path.join(colmap_dir, "images"))
            for i, im in enumerate(pred.processed_images):
                write_png(os.path.join(colmap_dir, "images", f"view_{i:03d}.png"), im)
            res["e"] = {}
            # no GLB here: the CLI keeps the sky filter, and the random net's cloud is all sky (see (a))
            for kind, src, fmt, want in (("images", png_dir, "mini_npz-depth_vis",
                                          sorted(["prediction_mini.npz"] + [f"depth_{i:03d}.png" for i in range(S)])),
                                         ("colmap", colmap_dir, "npz-colmap", ["colmap", "prediction.npz"])):
                out = os.path.join(work, f"cli_{kind}")
                t0 = time.perf_counter()
                proc = subprocess.run([sys.executable, "-m", "recondet3d_torch.cli.da3", kind, src, "--export-dir", out,
                                       "--export-format", fmt, "--cache-dir", os.path.join(work, "empty_cache")],
                                      cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
                                      timeout=900)
                written = sorted(os.listdir(out)) if os.path.isdir(out) else []
                res["e"][kind] = dict(rc=proc.returncode, s=time.perf_counter() - t0, files=written,
                                      stdout_tail=proc.stdout[-300:])
                if proc.returncode != 0 or written != want:
                    fail(f"da3-api (e): da3 {kind} exited {proc.returncode} with {written}: {proc.stderr[-3000:]}")
            emit("da3_api_cli", **res["e"])
            if not np.allclose(np.load(os.path.join(work, "cli_colmap", "prediction.npz"))["extrinsics"],
                               pred.extrinsics, atol=1e-5):
                fail("da3-api (e): da3 colmap did not return the model's poses")

            # (g) the renderer along export_to_gs_video's path, at 280x504, on its default device (numpy in: the card)
            r_ext, r_ixt = interpolate_camera_path(pred.extrinsics, pred.intrinsics, n_frames=TRAJ_FRAMES)
            (rgb, dep, alpha), traj_ms = timed_ms(lambda: render_3dgs(pred.gaussians, r_ext, r_ixt, (280, 504)), reps=1)
            res["g"] = dict(frames=TRAJ_FRAMES, hw=[280, 504], gaussians=API_GAUSSIANS, device=str(rgb.device),
                            ms_per_frame=traj_ms[0] / TRAJ_FRAMES,
                            rgb_finite=bool(torch.isfinite(rgb).all()), depth_finite=bool(torch.isfinite(dep).all()),
                            alpha_range=[alpha.min().item(), alpha.max().item()],
                            alpha_mean=alpha.mean().item(), nvidia_smi=smi)
            if not (rgb.is_cuda and res["g"]["rgb_finite"] and res["g"]["depth_finite"]
                    and 0 <= res["g"]["alpha_range"][0] and res["g"]["alpha_range"][1] <= 1):
                fail(f"da3-api (g): rendered frames {res['g']}")
            del rgb, dep, alpha
            # the exporter's own render call (export_to_gs_video -> render_trajectory_video), on the API's device
            frames, frames_ms = timed_ms(lambda: render_trajectory_frames(pred.gaussians, r_ext, r_ixt, (280, 504),
                                                                          device=api.device), reps=1)
            res["g"]["exporter_render_ms_per_frame"] = frames_ms[0] / TRAJ_FRAMES
            if frames.shape != (TRAJ_FRAMES, 280, 504, 3):
                fail(f"da3-api (g): the exporter's frames are {frames.shape}")
            video_dir = os.path.join(work, "gs_video")
            if importlib.util.find_spec("cv2") is None:
                try:
                    da3_export(pred, "gs_video", video_dir, device=api.device)
                except ImportError as e:
                    res["g"]["gs_video"] = f"ImportError: {e}"
                    if "cv2" not in str(e):
                        fail(f"da3-api (g): gs_video raised an ImportError that does not name cv2: {e}")
                else:
                    fail("da3-api (g): gs_video ran without cv2")
            else:  # the exporter as the API calls it, with the device each render ran on
                seen, render = [], gs_renderer.render_3dgs
                gs_renderer.render_3dgs = lambda *a, **kw: (lambda out: seen.append(str(out[0].device)) or out)(
                    render(*a, **kw))
                try:
                    t0 = time.perf_counter()
                    da3_export(pred, "gs_video", video_dir, device=api.device)
                    res["g"]["gs_video_export_ms"] = 1e3 * (time.perf_counter() - t0)
                finally:
                    gs_renderer.render_3dgs = render
                res["g"]["gs_video"] = sorted(os.listdir(video_dir))
                res["g"]["gs_video_render_devices"] = seen
                if seen != [str(torch.device("cuda", torch.cuda.current_device()))] or res["g"]["gs_video"] != [
                        "gs_video.mp4"]:
                    fail(f"da3-api (g): the gs_video export rendered on {seen} and wrote {res['g']['gs_video']}")
            # a frame the cloud fills: the same number of Gaussians planted in the frustum, every tile at its 192
            # splats, held to the same renderer on the CPU; timed again with the JAX package's 4,096-Gaussian blocks
            planted = planted_gaussians(API_GAUSSIANS, (280, 504), PLANTED_K, seed=930)
            eye = np.eye(4, dtype=np.float32)[None]
            (rgb_p, dep_p, alpha_p), planted_ms = timed_ms(lambda: render_3dgs(planted, eye, PLANTED_K[None],
                                                                               (280, 504)))
            block = gs_renderer.BLOCK
            gs_renderer.BLOCK = 4096
            try:
                _, planted_ms_4096 = timed_ms(lambda: render_3dgs(planted, eye, PLANTED_K[None], (280, 504)))
            finally:
                gs_renderer.BLOCK = block
            t0 = time.perf_counter()
            rgb_c, dep_c, alpha_c = render_3dgs(planted, eye, PLANTED_K[None], (280, 504), device="cpu")
            cpu_s = time.perf_counter() - t0
            rgb_p, dep_p, alpha_p = rgb_p.cpu(), dep_p.cpu(), alpha_p.cpu()
            res["g"]["planted_frame"] = dict(
                gaussians=API_GAUSSIANS, ms=planted_ms, ms_blocks_4096=planted_ms_4096, cpu_s=cpu_s,
                covered_share=(alpha_p > 0).float().mean().item(), alpha_mean=alpha_p.mean().item(),
                rgb_max_abs_err=(rgb_p - rgb_c).abs().max().item(),
                alpha_max_abs_err=(alpha_p - alpha_c).abs().max().item(),
                depth_max_rel_err=(dep_p - dep_c).abs().max().item() / max(1.0, dep_c.abs().max().item()),
                tol=RENDER_TOL, min_covered_share=PLANTED_MIN_COVERED)
            pf = res["g"]["planted_frame"]
            if not (pf["covered_share"] >= PLANTED_MIN_COVERED and max(pf["rgb_max_abs_err"], pf["alpha_max_abs_err"],
                                                                        pf["depth_max_rel_err"]) <= RENDER_TOL):
                fail(f"da3-api (g): the planted frame {pf}")
            del rgb_p, dep_p, alpha_p, rgb_c, dep_c, alpha_c, planted, frames
            emit("da3_api_render", **res["g"])
            del pred

            # (f) 32 views (the CLI's --max-frames default) at 280x504, no export: the flash kernel at the new shapes
            long_cases = {name: kernel_case(f"{name}_s{API_LONG_S}", shape, None, seed=910 + i, iters=5)
                          for i, (name, shape) in enumerate(API_LONG_SHAPES.items()) if name != "vitg_global"}
            long_cases["vitg_global"] = long_flash_case(f"vitg_global_s{API_LONG_S}", API_LONG_SHAPES["vitg_global"],
                                                        seed=913, smi=smi)
            res["f"] = dict(long_cases=long_cases)
            for views in (API_LONG_S, 16):
                imgs_f = api_images(920, views, 280, 504)
                try:
                    api.inference(imgs_f, infer_gs=True)  # warm-up
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    reset_launch_counts()
                    t0 = time.perf_counter()
                    long_pred = api.inference(imgs_f, infer_gs=True)
                    torch.cuda.synchronize()
                except torch.cuda.OutOfMemoryError as e:  # the phase reports the error at 32 and the peak at 16
                    res["f"][f"s{views}_error"] = str(e)[:500]
                    torch.cuda.empty_cache()
                    continue
                ms = 1e3 * (time.perf_counter() - t0)
                long_launches = d64_launches(flash_attention_fwd, "da3-api (f)")
                check_prediction(long_pred, views, f"(f) at {views} views")
                res["f"][f"s{views}"] = dict(views=views, ms=ms, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                                             flash_launches_by_shape={str(k): n for k, n in long_launches.items()},
                                             nvidia_smi=smi)
                if views == API_LONG_S:
                    expected = {API_LONG_SHAPES[name]: n for name, n in EXPECTED_PER_FORWARD.items()}
                    if long_launches != expected:
                        fail(f"da3-api (f): flash launches {long_launches}, expected {expected}")
                    break
                del long_pred
            if f"s{API_LONG_S}" not in res["f"] and "s16" not in res["f"]:
                fail(f"da3-api (f): neither 32 nor 16 views ran: {res['f']}")
            emit("da3_api_long", **{k: v for k, v in res["f"].items() if k != "long_cases"})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res["launches"] = sum(launches.values())
    res["f32_launches"] = sum(f32_launches.values())
    res["f32_case"] = f32_b1
    return res


# the kernels on wgmma / TMA / mbarriers, one name a template instance: the forward and dk/dv as <DC, EDGE> (64-column
# chunks of the head dim; a last chunk partly past D)
HOPPER_KERNELS = tuple(f"{kernel}<{dc},{edge}>" for kernel in ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                                                                 "flash_bwd_dkv_kernel")
                       for dc in (1, 2, 3, 4) for edge in (0, 1))
HOPPER_LIBS = ("flash_attn_fwd", "flash_attn_bwd")  # the sources of HOPPER_KERNELS
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
    library; kernels named by ``kernel_label``."""
    exe = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([exe, "-sass", lib], capture_output=True, text=True, check=True, timeout=120).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = kernel_label(m.group(1))
            counts[cur] = dict.fromkeys(SASS_OPS, 0)
        elif cur:
            for op in SASS_OPS:
                if op in line:
                    counts[cur][op] += 1
    return counts


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Run the PyTorch port on one NVIDIA GPU and check it end to end.")
    ap.add_argument("--parent", default=None, help="an earlier tree to time the FPS and attention kernels against")
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
    t0 = time.perf_counter()
    for stem, entry in BUILD_LOG.items():
        # the SASS gates hold only the wgmma kernels: the other libraries' SASS is not read
        sass = instruction_counts(libs[stem]._name) if stem in HOPPER_LIBS else {}
        for fn, info in ptxas_report(entry["ptxas"]).items():
            label = kernel_label(fn) if stem in HOPPER_LIBS else fn
            kernels[label] = dict(info, source=f"{stem}.cu", sass=sass.get(label, {}))
    warnings = {k: [l.strip() for l in v["ptxas"].splitlines() if "warning" in l.lower()] for k, v in BUILD_LOG.items()}
    emit("build", seconds=build_s, nvcc_s={k: v["seconds"] for k, v in BUILD_LOG.items()},
         report_s=time.perf_counter() - t0, kernels=kernels, warnings=warnings)
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

    # 11b. the CUDA-core attention family in fp32 at the camera encoders' shapes (forward and backward; launch-bound,
    # so device times too); bf16 at head dims no DA3 trunk has on the wgmma forward and dk/dv; then B*H > 65535
    cc_cam = {name: cc_case(name, shape, seed=60 + i, iters=50) for i, (name, shape) in enumerate(CAM_SHAPES.items())}
    short_res, floor = short_phase()
    any_d = {name: any_d_case(name, shape, kv_len, scale, seed=70 + i)
             for i, (name, (shape, kv_len, scale)) in enumerate(ANY_D_CASES.items())}
    many = {name: many_heads_case("many_heads_" + name, shape, dtype, route, seed=80 + i)
            for i, (name, (shape, dtype, route)) in enumerate(MANY_HEADS.items())}

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
        by_shape = d64_launches(flash_attention_fwd, "slice")
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
    # 6c. GT-pose conditioning trained: the fp32 backward kernels at full width
    pose_bwd, pose_bwd_launches = gt_pose_backward_phase()

    # 7. fps kernel vs plain on the buffers of the point path
    c2l, depth = scene_inputs(B)
    # this design's exchange alone: one cluster, and the two levels of 2 and 3 clusters
    exchange_us = {c: 1e3 * time_ms(lambda: fps_ops.exchange_probe(ANCHORS, c), 3, warmup=1) / (ANCHORS - 1)
                   for c in (1, 2, 3, 5, 7)}
    emit("fps_exchange", rounds=ANCHORS - 1, us_per_round_by_clusters=exchange_us)
    fps_cases = fps_phase(backbone, c2l, depth, exchange_us)
    if args.parent:
        parent_comparison(args.parent, fps_cases)
    fps_case_of = {(c["N"], c["K"]): c for c in fps_cases if c["on_main_path"]}
    # 7b. FPS past the main path's sizes: no pre-reduce, the overflow past 7 clusters, the most rows it takes
    fps_large = fps_large_phase(backbone, c2l, depth, exchange_us)
    # the detection config sets no pre-reduce: its anchors and final FPS run at these two sizes
    det_fps_case_of = {(c["N"], c["K"]): c for c in fps_cases + fps_large
                       if (c["N"], c["K"]) in ((NO_PRE_REDUCE_ROWS, ANCHORS), (UNION_CAP_NO_PRE_REDUCE, NUM_POINTS))}

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
    flash_total, flash_by_shape = flash_attention_fwd.launches, d64_launches(flash_attention_fwd, "resdet3d")
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

    # 17. the port's bench entry point (bench.py's workload), its JSON line as it prints it. Its model is phase
    # 4's, which is the one bench.py builds (the same preset, sizes and seed 0), before any step trains it
    bench_rec = port_bench.measure(resdet, port_bench.FULL, BENCH_ITERS, 0, torch.device("cuda"))
    print(json.dumps(bench_rec), flush=True)
    emit("bench", **bench_rec)
    if not (np.isfinite(bench_rec["value"]) and bench_rec["value"] > 0 and bench_rec["mfu_pct"] is not None
            and np.isfinite(bench_rec["mfu_pct"]) and bench_rec["mfu_pct"] > 0):
        fail(f"bench: {bench_rec}")

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
    del trainer, prod
    torch.cuda.empty_cache()

    # 16. detection: configs/resdet3d_centerhead.py at full width, requests and production train steps
    det_res, det_fps_by_shape = detection_phase(c2l, depth, det_fps_case_of, case_of,
                                                dict(fwd_case_of))
    del resdet, backbone, model
    torch.cuda.empty_cache()
    # 18. the full loop through the port's CLIs on the tiny config, with the JAX full-loop test's gates
    loop_tiny, tiny_fwd_case_of, tiny_fps_case_of, loop_tr, loop_te = full_loop_tiny_phase(exchange_us)
    # 19. the same CLIs on the production detection config at full width
    loop_full, full_tr, full_te = full_loop_full_width_phase(dict(fwd_case_of), det_fps_case_of)
    torch.cuda.empty_cache()
    # 20. the DA3 public API and the da3 CLI at full width
    api_res = da3_api_phase(smi, dict(fwd_case_of))
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
                 max_abs_err=max(c["max_abs_err"] for c in list(cases.values()) + [kvl_case, scale_case]
                                 + list(tiny_fwd_case_of.values())),
                 ms=mix["ms"], plain_ms=mix["plain_ms"], bound_ms=mix["bound_ms"], bound_by=by,
                 exp_floor_ms=mix["exp_floor_ms"], library_ms=mix["library_ms"], per="one request's launch mix (B=2)",
                 design="wgmma + TMA + mbarriers, warp-specialised",
                 shapes=[dict(c, launches_per_forward=per_forward[n]) for n, c in cases.items()]
                 + [kvl_case, scale_case], train_shapes=list(train_fwd_cases.values()),
                 full_loop_shapes=list(tiny_fwd_case_of.values()),
                 many_heads=[many["bf16_d64"]]),
            dict(name="fps", route="cuda", source="recondet3d_torch/csrc/fps.cu",
                 replaces="recondet3d/ops/fps_pallas.py:54", status="ported+checked", launches=fps_total,
                 max_abs_err=max(c["max_abs_err"] for c in fps_cases + list(tiny_fps_case_of.values())),
                 ms=fps_mix["ms"], plain_ms=fps_mix["plain_ms"], bound_ms=fps_mix["bound_ms"],
                 bound_by=fps_by, exchange_floor_ms=fps_mix["exchange_floor_ms"], library_ms=None,
                 per="one request's launch mix (B=2: 4 launches)",
                 launches_detection_requests=sum(det_fps_by_shape.values()),
                 design="clusters of 16 CTAs, records through distributed shared memory (st.async + mbarrier), "
                        "points in registers; a second level through device memory for clouds beyond one cluster; "
                        "past the 1,404,928 points 7 clusters hold on chip, each CTA streams the rest of its share "
                        "from device memory every selection (the overflow path)",
                 note="max_abs_err counts differing indices (gate: 0); bound = max(bytes, K*n_valid fp32 distance "
                      "updates); exchange_floor_ms = (K-1) steps of this design's exchange alone as timed in this "
                      "run; no single PyTorch call computes FPS, so library_ms is null",
                 exchange_us_per_round=exchange_us,
                 shapes=[{k: v for k, v in c.items() if k != "kernel_args"}
                         for c in fps_cases + fps_large + list(tiny_fps_case_of.values())]),
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
    # the fp32 kernels, on the camera encoder's calls: the forward's on the GT-pose forward's launches (nested-giant,
    # B=2: CameraEnc at D=96), the backward's on the GT-pose backward's (da3-large, B=1: D=64); ms, plain_ms and
    # library_ms are device time (device_ms: calls queued behind a spin kernel) at these launch-bound shapes, the host_*
    # keys the time a call takes in a loop of launches, floor_* an empty kernel launched the same way. The short
    # kernels take these calls; the tiled ones, routed no more at these lengths, are timed on the same inputs over the
    # same CAM_BLOCKS calls
    giant, large = f32_cases["cam_enc_giant"], f32_cases["cam_enc_large_b1"]
    short_err = max([c["max_abs_err"] for c in short_res.values()]
                    + [c["short_max_abs_err"] for c in f32_cases.values()]
                    + [many["f32_d24_short"]["max_abs_err_out"]] + [e["max_abs"] for e in
                                                                     many["f32_d24_short"]["errors"].values()])
    short_fwd_n, short_bwd_n = sum(f32_launches.values()), sum(pose_bwd_launches["attention_bwd_short"].values())
    table["kernels"].append(dict(
        name="attn_cc_short_fwd", route="cuda", source="recondet3d_torch/csrc/attn_cuda_core.cu",
        replaces="recondet3d/ops/attention.py:54", status="ported+checked", launches=short_fwd_n,
        launches_gt_pose_backward=sum(pose_bwd_launches["attention_fwd_short"].values()),
        max_abs_err=short_err,
        **{key: giant[f"short_{key}"] * short_fwd_n for key in ("ms", "host_ms")},
        **{key: giant[key] * short_fwd_n for key in ("plain_ms", "plain_host_ms", "library_ms", "library_host_ms",
                                                     "floor_ms", "floor_host_ms")},
        tiled_ms=giant["ms"] * short_fwd_n, tiled_host_ms=giant["host_ms"] * short_fwd_n,
        bound_ms=giant["short_bound_ms"]["fwd"] * short_fwd_n, bound_by=giant["short_bound_by"]["fwd"],
        per=f"one GT-pose forward of nested-giant-large (B=2: {short_fwd_n} launches at (2, 16, 6, 6) D=96)",
        design="fp32 on the CUDA cores, N, M <= 32: one CTA a head (8 / N heads below 5 rows), every load of q, k, v "
               "in flight at once (16 bytes a thread where D % 4 == 0) from any B, H, row strides; one warp a query "
               "row, one key a lane, an exact softmax over shuffles, lane l accumulating columns l, l + 32, ...; the "
               "output written as (B, N, H, D)",
        note="tiled_*: the tiled cc_fwd_kernel on the same inputs over the same calls; floor_*: an empty kernel "
             "launched the same way; library_ms: SDPA's forward on the same fp32 inputs; max_abs_err over every short "
             "case of phases 6b, 11b and B*H = 65,552",
        shapes=list(short_res.values()), gt_pose=pose_res, many_heads=[many["f32_d24_short"]]))
    table["kernels"].append(dict(
        name="attn_cc_short_bwd", route="cuda", source="recondet3d_torch/csrc/attn_cuda_core.cu",
        replaces="recondet3d/ops/attention.py:185", also_replaces="recondet3d/ops/attention.py:231",
        status="ported+checked", launches=short_bwd_n, max_abs_err=short_err,
        **{key: large[f"short_bwd_{key}"] * short_bwd_n for key in ("ms", "host_ms")},
        **{key: large[f"{key.replace('_ms', '')}_bwd_ms"] * short_bwd_n for key in ("plain_ms", "library_ms")},
        **{key: large[f"{key.replace('_host_ms', '')}_bwd_host_ms"] * short_bwd_n
           for key in ("plain_host_ms", "library_host_ms")},
        floor_ms=large["floor_ms"] * short_bwd_n, floor_host_ms=large["floor_host_ms"] * short_bwd_n,
        tiled_ms=(large["dq_ms"] + large["dkv_ms"]) * short_bwd_n, tiled_call_ms=large["tiled_bwd_ms"] * short_bwd_n,
        tiled_host_ms=large["tiled_bwd_host_ms"] * short_bwd_n,
        bound_ms=large["short_bound_ms"]["bwd"] * short_bwd_n, bound_by=large["short_bound_by"]["bwd"],
        per=f"one GT-pose backward of da3-large (B=1: {short_bwd_n} launches at (1, 16, 6, 6) D=64)",
        design="fp32 on the CUDA cores, N, M <= 32: dq, dk and dv in one launch, one CTA a head (max(N, M) warps); "
               "the head's q, k, v, O, dO and lse in shared memory; warp i forms row i of P and dS (delta_i = dO_i . "
               "O_i in the kernel), then warp i sums dq_i and warp j dk_j and dv_j, one lane a column, in a fixed "
               "order (no atomics: the same bits run to run)",
        note="replaces the tiled dq and dk/dv kernels and delta's expression on this route; tiled_ms: their two "
             "kernels, tiled_call_ms the whole tiled call (delta's expression included), on the same inputs over the "
             "same calls; plain_ms: attention_bwd_plain; library_ms: SDPA's backward alone (dq, dk and dv)",
        gt_pose_backward=pose_bwd, shapes=list(short_res.values()), many_heads=[many["f32_d24_short"]]))
    cc_err = max([c["max_abs_err"] for c in cc_cam.values()] + [many["f32_d24"]["max_abs_err_out"]]
                 + [e["max_abs"] for c in any_d.values() for e in c["cuda_core_errors"].values()])
    table["kernels"].append(dict(
        name="attn_cc_fwd", route="cuda", source="recondet3d_torch/csrc/attn_cuda_core.cu",
        replaces="recondet3d/ops/attention.py:54", status="ported+checked", launches=0,
        max_abs_err=max([cc_err] + [c["max_abs_err"] for c in f32_cases.values()]),
        **{key: giant[key] * CAM_BLOCKS
           for key in ("ms", "host_ms", "plain_ms", "plain_host_ms", "library_ms", "library_host_ms", "bound_ms")},
        bound_by=giant["bound_by"],
        per=f"the GT-pose forward's {CAM_BLOCKS} calls at (2, 16, 6, 6) D=96, which the short kernel takes",
        design="CUDA cores, templated on fp32 / bf16 and ceil(D/32) output columns a lane: one CTA per (b*h, 8 query "
               "rows), K/V tiles of 64 through shared memory, one warp per query row, online softmax with expf",
        note="the _flash_kernel instances in fp32 past 32 rows (any D <= 256; no config builds them: launches 0 on "
             "every path); bf16 goes to the wgmma forward, and this kernel's bf16 instance is checked and timed beside "
             "it in the any-D rows; ms, plain_ms and library_ms (SDPA on the same fp32 inputs) are device time (calls "
             "queued behind a spin kernel); max_abs_err is over every tiled CUDA-core case, bf16 ones included",
        cam_enc_large_token_rel_l2=cam_large_err, shapes=list(f32_cases.values()),
        cc_cases=[dict(name=c["name"], shape=c["shape"], dtype=c["dtype"], ms=c["ms"]["fwd"],
                       bound_ms=c["bound_ms"]["fwd"],
                       bound_by=c["bound_by"]["fwd"], library_ms=c["library_ms"]["fwd"])
                  for c in cc_cam.values()]))
    cam, cam_dev = cc_cam["cam_enc_large_b1"], large
    for kind, fn_name, line in (("dq", "attn_cc_bwd_dq", 185), ("dkv", "attn_cc_bwd_dkv", 231)):
        n = CAM_BLOCKS
        table["kernels"].append(dict(
            name=fn_name, route="cuda", source="recondet3d_torch/csrc/attn_cuda_core.cu",
            replaces=f"recondet3d/ops/attention.py:{line}", status="ported+checked",
            launches=sum(pose_bwd_launches[f"attention_bwd_{kind}_cuda_core"].values()),
            max_abs_err=cc_err, ms=cam_dev[f"{kind}_ms"] * n, host_ms=cam_dev[f"{kind}_host_ms"] * n,
            plain_ms=cam_dev["plain_bwd_ms"] * n, plain_host_ms=cam_dev["plain_bwd_host_ms"] * n,
            bound_ms=cam["bound_ms"][kind] * n, bound_by=cam["bound_by"][kind],
            library_ms=cam_dev["library_bwd_ms"] * n, library_host_ms=cam_dev["library_bwd_host_ms"] * n,
            per=f"the GT-pose backward's {n} calls at (1, 16, 6, 6) D=64, which the short fused kernel takes",
            design="CUDA cores, templated like the forward: one warp per " + ("query" if kind == "dq" else "key")
                   + " row, tiles of 32 " + ("keys" if kind == "dq" else "queries") + " through shared memory, "
                   "no atomics (the same bits run to run)",
            note="ms, plain_ms (attention_bwd_plain) and library_ms (SDPA's backward alone) are device time (calls "
                 "queued behind a spin kernel, CUDA events) on the same fp32 inputs, the *host_ms keys the time a "
                 "call takes in a loop "
                 "of calls; plain_ms and library_ms compute dq, dk and dv together: the same numbers stand in both "
                 "rows; max_abs_err is over every tiled CUDA-core case; fp32 at N, M <= 32 goes to the short fused "
                 "kernel, bf16 to the wgmma kernels, and this kernel's bf16 instance is checked and timed beside them "
                 "in the any-D rows (cuda_core_ms)",
            shapes=[dict(name=c["name"], shape=c["shape"], dtype=c["dtype"], ms=c["ms"][kind],
                         device_ms=f32_cases[c["name"]][f"{kind}_ms"], bound_ms=c["bound_ms"][kind],
                         bound_by=c["bound_by"][kind], errors=c["errors"], plain_ms=c["plain_ms"],
                         library_ms=c["library_ms"]["bwd"]) for c in cc_cam.values()]
            + [dict(name=c["name"], shape=c["shape"], dtype="bfloat16", kv_len=c["kv_len"], scale=c["scale"],
                    ms=c["ms"][kind], bound_ms=c["bound_ms"][kind], bound_by=c["bound_by"][kind],
                    errors=c["errors"], plain_ms=c["plain_ms"]["bwd"], library_ms=c["library_ms"]["bwd"])
               for c in any_d.values() if c["routes"][kind] == "cuda_core"],
            many_heads=[many["f32_d24"]]))
    # the wgmma forward, dq and dk/dv at head dims other than 64 (bf16): no config of either package builds them, so
    # the main path launches them 0 times; their numbers are the headline case's, (1, 4, 4326, 128), one call each
    # (and (1, 4, 4326, 256) under "wide"), and the launches through flash_attention are counted in each case
    # (any_d_case)
    head, wide = any_d[ANY_D_HEADLINE], any_d[ANY_D_HEADLINE_WIDE]
    designs = dict(
        fwd="two consumer warpgroups and 128-key tiles at D <= 64, 64-key tiles at D <= 128, one consumer warpgroup "
            "a CTA past 128",
        dq="two consumer warpgroups of 64 query rows and four stages at D <= 64, one consumer warpgroup past it "
           "(stages 4 / 3 / 2 at D <= 128 / 192 / 256)",
        dkv="two consumer warpgroups of 64 keys at D <= 64, one at D <= 128; past 128 the chunks of dK and dV split "
            "between two CTAs a key tile (two chunks each), each recomputing S^T and dP^T over all of D")
    for kind, fn_name, line, routed, outputs in (
            ("fwd", "flash_attn_fwd_any_d", 54, "flash_attention_fwd", ("out",)),
            ("dq", "flash_bwd_dq_any_d", 185, "flash_attention_bwd_dq", ("dq",)),
            ("dkv", "flash_bwd_dkv_any_d", 231, "flash_attention_bwd_dkv", ("dk", "dv"))):
        cases = [c for c in any_d.values() if c["routes"][kind] == "wgmma"]
        lib_plain = "fwd" if kind == "fwd" else "bwd"
        table["kernels"].append(dict(
            name=fn_name, route="cuda",
            source="recondet3d_torch/csrc/" + ("flash_attn_fwd.cu" if kind == "fwd" else "flash_attn_bwd.cu"),
            replaces=f"recondet3d/ops/attention.py:{line}", status="ported+checked",
            launches=0,  # the main path's every launch is at D = 64: d64_launches fails the run otherwise
            max_abs_err=max(c["max_abs_err_out"] if kind == "fwd" else max(c["errors"][g]["max_abs"] for g in outputs)
                            for c in cases),
            ms=head["ms"][kind], plain_ms=head["plain_ms"][lib_plain],
            bound_ms=head["bound_ms"][kind], bound_by=head["bound_by"][kind],
            exp_floor_ms=head["exp_floor_ms"], cuda_core_ms=head["cuda_core_ms"][kind],
            library_ms=head["library_ms"][lib_plain],
            wide={key: wide[key][kind] if key in ("ms", "cuda_core_ms", "bound_ms") else wide[key][lib_plain]
                  for key in ("ms", "cuda_core_ms", "bound_ms", "plain_ms", "library_ms")},
            per="one call at (1, 4, 4326, 128) bf16 (wide: at (1, 4, 4326, 256))", wrapper=routed,
            design="wgmma + TMA + mbarriers, a template on ceil(D/64) 64-column chunks: " + designs[kind],
            note="cuda_core_ms: the CUDA-core kernel this replaces, on the same inputs in this call; library_ms: SDPA "
                 + ("forward" if kind == "fwd" else "backward alone (dq, dk and dv)") + "; plain_ms: "
                 + ("attention_plain" if kind == "fwd" else "attention_bwd_plain (dq, dk and dv)")
                 + "; max_abs_err: " + " and ".join(outputs) + " over every case, the bf16 gate "
                 "scales it by max(1, |value|)",
            shapes=[dict(name=c["name"], shape=c["shape"], kv_len=c["kv_len"], scale=c["scale"], ms=c["ms"][kind],
                         cuda_core_ms=c["cuda_core_ms"][kind], bound_ms=c["bound_ms"][kind],
                         bound_by=c["bound_by"][kind], exp_floor_ms=c["exp_floor_ms"],
                         library_ms=c["library_ms"]["fwd" if kind == "fwd" else "bwd"], errors=c["errors"],
                         max_abs_err_out=c["max_abs_err_out"], max_abs_err_lse=c["max_abs_err_lse"])
                    for c in any_d.values()],
            many_heads=[many["bf16_d128"]]))
    table["kernels"][0]["launches_finetune_steps"] = sum(ft_launches["fwd"].values())
    table["kernels"][0]["launches_train_steps"] = sum(tr_launches["fwd"].values())
    table["kernels"][1]["launches_finetune_steps"] = sum(ft_launches["fps"].values())
    table["kernels"][1]["launches_train_steps"] = sum(tr_launches["fps"].values())
    for row, kind in ((table["kernels"][0], "fwd"), (table["kernels"][1], "fps")):
        row["launches_full_loop_tiny"] = dict(train=sum(loop_tr[kind].values()), test=sum(loop_te[kind].values()))
        row["launches_full_loop_full_width"] = dict(train=sum(full_tr[kind].values()),
                                                    test=sum(full_te[kind].values()))
    api_long = list(api_res["f"]["long_cases"].values())
    table["kernels"][0].update(
        launches_da3_api=api_res["launches"], da3_api_per=f"{API_CALLS} API calls of 6 views (phase 20a)",
        da3_api_shapes=api_long,
        max_abs_err=max(table["kernels"][0]["max_abs_err"], max(c["max_abs_err"] for c in api_long)))
    short_row = next(r for r in table["kernels"] if r["name"] == "attn_cc_short_fwd")
    short_row.update(launches_da3_api_poses=api_res["f32_launches"], da3_api_case=api_res["f32_case"],
                     max_abs_err=max(short_row["max_abs_err"], api_res["f32_case"]["errors"]["short"]["max_abs_err"]))
    cc_row = next(r for r in table["kernels"] if r["name"] == "attn_cc_fwd")
    cc_row.update(max_abs_err=max(cc_row["max_abs_err"], api_res["f32_case"]["errors"]["tiled"]["max_abs_err"]))
    table["da3_api"] = {k: v for k, v in api_res.items() if k not in ("f32_case",)}
    table["da3_api"]["f"] = {k: v for k, v in api_res["f"].items() if k != "long_cases"}
    table["detection"] = det_res
    table["full_loop"] = {name: {k: v for k, v in res.items() if k not in ("logged", "train_tail", "test_tail")}
                          for name, res in (("tiny", loop_tiny), ("full_width", loop_full))}
    print(json.dumps(table), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
