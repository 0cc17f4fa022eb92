"""The port's benchmark: ``bench.py``'s workload on one NVIDIA GPU, one JSON line.

    python3 -m recondet3d_torch.tools.bench [--iters 10] [--seed 0]

What it builds and times is what ``bench.py`` (``build_pipeline``,
``measure``) builds and times for the JAX package: ResDet3D over
``da3nested-giant-large`` with random weights from ``--seed``, the
benchmark's refinement capacities and a voxel pre-reduce of 0.1 m; a
request is ``simple_test`` on B = 2 scenes of six 900x1600 camera images
(uniform noise from the seed: the card's machine reads no JPEGs) with the
point path driven by depth maps rendered from the checked-in reference
cloud (``data/anchor_scene.py``, bench.py's anchored composition). One
warm-up request, then ``--iters`` timed requests, each ending in
``torch.cuda.synchronize()``.

The last line is ``bench.py``'s JSON: ``metric``, ``value`` (camera-frames/s
at the fastest request), ``unit``, ``ms_min``, ``ms_mean``, ``batch``,
``per_iter_ms``, ``vs_baseline`` (null: the recorded baseline is the JAX
package's) and ``mfu_pct``: the floating-point operations of one request
over ``ms_min``, against the H100's dense bf16 peak of 989 TFLOP/s. The
operations are counted once: ``torch.utils.flop_counter.FlopCounterMode``
over one request counts the PyTorch operators, and the attention kernels,
which it cannot see (ctypes launches), add 4*N*M*D a head for each launch
counted by their wrappers. The line before it gives the two parts.

``--device cpu --size tiny`` runs the same code at the sizes of
``configs/resdet3d_tiny_test.py`` (da3-small, two views, small capacities)
for the CPU smoke test; there ``mfu_pct`` is null (no device peak applies)
and the times are the CPU's.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 tensor cores
BATCH = 2  # scenes a request: bench.py's throughput default
REFERENCE_POINTS = Path(__file__).resolve().parents[2] / "assets" / "bench_sample" / "reference_points.npz"
# bench.py build_pipeline: the refinement's capacities and the pre-reduce voxel
FULL = dict(preset="da3nested-giant-large", views=6, image_hw=(900, 1600), dtype=torch.bfloat16,
            refinement=dict(max_voxels=40960, occ_max_voxels=65536, stage_caps=(40960, 32768, 24576, 16384)),
            backbone=dict(voxel_pre_reduce=0.1))
# configs/resdet3d_tiny_test.py's refinement and point path, tests/test_bench_smoke.py's image size
TINY = dict(preset="da3-small", views=2, image_hw=(56, 84), dtype=torch.float32,
            refinement=dict(point_cloud_range=(-8.0, -8.0, -2.0, 8.0, 8.0, 2.0), voxel_size=(0.1, 0.1, 0.1),
                            max_voxels=1024, occ_max_voxels=512, occ_feature_shape=(20, 20, 8),
                            sparse_shape=(40, 160, 160), unet_channels=(32, 48, 64, 96),
                            stage_caps=(1024, 512, 384, 256), encoder_out_channels=16),
            backbone=dict(process_res=56, filter_range=(-30.0, -30.0, -5.0, 30.0, 30.0, 5.0), bq_anchor_points=64,
                          num_points=128, voxel_pre_reduce=0.5, pre_reduce_cap=4096))


def attention_kernel_flops() -> float:
    """4*N*M*D a head for every attention-kernel launch counted since the
    last ``reset_launch_counts()`` (forward kernels only: a request runs no
    backward)."""
    from recondet3d_torch.ops.attention import attention_fwd_cuda_core, flash_attention_fwd

    return sum(4.0 * B * H * N * M * D * n for wrapper in (flash_attention_fwd, attention_fwd_cuda_core)
               for (B, H, N, M, D), n in wrapper.launches_by_shape.items())


def build(size: dict, seed: int, device):
    from recondet3d_torch.models.detect import build_resdet3d

    gen = torch.Generator(device=device).manual_seed(seed)
    return build_resdet3d(size["preset"], dtype=size["dtype"], device=device, generator=gen,
                          refinement=size["refinement"], **size["backbone"])


def inputs(model, batch: int, views: int, image_hw, seed: int, device):
    """(images (B, V, H, W, 3) in 0..255, cam2lidar (B, V, 4, 4), anchored
    depth (B, V, ph, pw)) on ``device``."""
    from recondet3d_torch.data.anchor_scene import anchor_depth, rig_cam2lidar
    from recondet3d_torch.data.input_processor import compute_process_shape

    H, W = image_hw
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 255.0, (batch, views, H, W, 3)).astype(np.float32)
    c2l = rig_cam2lidar(batch)[:, :views]
    _, _, ph, pw = compute_process_shape(H, W, model.reconstruction_backbone.process_res)
    depth = anchor_depth(np.load(REFERENCE_POINTS)["points"], c2l, ph, pw, batch=batch, seed=seed)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (img, c2l, depth))


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def measure(model, size: dict, iters: int, seed: int, device) -> dict:
    """One warm-up and ``iters`` timed requests of ``model`` (built at
    ``size`` from ``seed``, as ``build`` does) on inputs from ``seed``;
    prints the operation count's two parts and returns ``bench.py``'s
    record."""
    from torch.utils.flop_counter import FlopCounterMode

    from recondet3d_torch.ops import fps as fps_ops
    from recondet3d_torch.ops.attention import reset_launch_counts

    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    views, image_hw = size["views"], size["image_hw"]
    img, c2l, depth = inputs(model, BATCH, views, image_hw, seed, device)

    def request():
        return model.simple_test(img, c2l, depth_override=depth)

    with torch.inference_mode():
        out = request()  # warm-up: kernels build and load here
        sync()
        if not bool(torch.isfinite(out["aux"]["occupancy_logits"]).all()):
            raise SystemExit("bench: non-finite occupancy logits")
        times = []
        for _ in range(iters):
            sync()
            t0 = time.perf_counter()
            request()
            sync()
            times.append(1e3 * (time.perf_counter() - t0))
        reset_launch_counts()
        fps_ops.reset_launch_counts()
        with FlopCounterMode(display=False) as counter:
            request()
        sync()
    torch_flops, kernel_flops = float(counter.get_total_flops()), attention_kernel_flops()
    ms_min, ms_mean = float(np.min(times)), float(np.mean(times))
    flops = torch_flops + kernel_flops
    print(json.dumps({"flops_per_request": flops, "flop_counter_mode": torch_flops,
                      "attention_kernels": kernel_flops, "device": str(device),
                      "card": card_line() if on_card else None}), flush=True)
    frames = BATCH * views
    return {
        "metric": (f"camera-frames/sec/chip, e2e ResDet3D ({size['preset']} depth + unprojection + ball-query/FPS + "
                   f"sparse-conv occupancy), {views}x{image_hw[0]}x{image_hw[1]} input, anchored depth "
                   f"composition, serial schedule, batch {BATCH}, PyTorch port on "
                   f"{torch.cuda.get_device_name(device) if on_card else 'cpu'}"),
        "value": round(frames / (ms_min / 1e3), 3),
        "unit": "frames/s/chip",
        "vs_baseline": None,
        "mfu_pct": round(100.0 * flops / (ms_min / 1e3) / PEAK_BF16_FLOPS, 2) if on_card else None,
        "ms_min": round(ms_min, 1),
        "ms_mean": round(ms_mean, 1),
        "batch": BATCH,
        "per_iter_ms": [round(t, 1) for t in times],
    }


def run(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Time ResDet3D requests of the port (bench.py's workload).")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", choices=("full", "tiny"), default="full",
                    help="full: bench.py's sizes; tiny: configs/resdet3d_tiny_test.py's, for the CPU smoke test")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    from recondet3d_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    size = FULL if args.size == "full" else TINY
    return measure(build(size, args.seed, device), size, args.iters, args.seed, device)


def main(argv=None) -> int:
    print(json.dumps(run(argv)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
