"""Fine-tuning step time on a fixed cloud, and the host cost of a flash launch.

    python -m recondet3d_torch.tools.finetune_step_time [steps]

Two measurements of whichever ``recondet3d_torch`` is first on ``sys.path``
(so that two trees can be compared in turns on one card:
``PYTHONPATH=<tree> python <this file>`` from each):

1. host microseconds per call of ``flash_attention_fwd``,
   ``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv`` at the B=1
   ViT-L local shape (6, 16, 721, 64), and of their C launchers alone
   (tensor maps, attributes and the launch, called through ``ctypes`` with
   the arguments made once): 300 calls queued without a synchronisation,
   the least mean of ten such rounds;
2. ``steps`` (default 4; 0 skips this part) fine-tuning steps of the
   configuration ``chip_smoke.py`` trains (da3-large unfrozen, depth head's
   last convolution x 0.1, AdamW lr 1e-4, one scene of six 900x1600 views,
   40,000 GT points, ``max_depth`` as built), each taken from the same
   state: the state after building is copied once and restored before every
   step, so every step sees the same weights and so the same point cloud,
   and its time does not drift with the cloud that training would grow. Per
   step: wall ms (host clock around the step, synchronised), the span of the
   step on the device (CUDA events), the stage times (forward, backward,
   optimizer, the FPS stages), the points a scene keeps at each stage of the
   point path, and the loss. Then one more step from that state under
   ``torch.profiler``: the device's busy ms (kernel time summed), and that
   of the flash-attention and FPS kernels.

One JSON line per measurement, then a summary line. Needs CUDA.
"""

from __future__ import annotations

import copy
import json
import sys
import time

import numpy as np
import torch

import recondet3d_torch
from recondet3d_torch.data.anchor_scene import rig_cam2lidar
from recondet3d_torch.models.detect import build_resdet3d
from recondet3d_torch.ops import attention
from recondet3d_torch.ops.attention import flash_attention_bwd_dkv, flash_attention_bwd_dq, flash_attention_fwd
from recondet3d_torch.train import Trainer
from recondet3d_torch.utils import stage_timer

REFINEMENT = dict(max_voxels=40960, occ_max_voxels=65536, stage_caps=(40960, 32768, 24576, 16384))
SHAPE = (6, 16, 721, 64)


def host_us_per_call(fn, calls=300, rounds=10):
    best = float("inf")
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return best


def launch_costs():
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(SHAPE, dtype=np.float32)).cuda().to(torch.bfloat16)
                   for _ in range(4))
    out, lse = flash_attention_fwd(q, k, v)
    delta = (do.float() * out.float()).sum(dim=-1)
    wrapper = dict(fwd=host_us_per_call(lambda: flash_attention_fwd(q, k, v)),
                   dq=host_us_per_call(lambda: flash_attention_bwd_dq(q, k, v, do, lse, delta)),
                   dkv=host_us_per_call(lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta)))
    # the C launchers alone; the dk/dv entry takes (q, qs, ..., mul, scale) since the Hopper
    # redesign and (q, ..., scale) before it: both are timed with a power-of-two scale. Since the
    # forward and dk/dv took any head dim their entries are `flash_attn_fwd_bf16` and
    # `flash_attn_bwd_dkv_bf16`, with D after (B, H, N, M), and since dq did `flash_attn_bwd_dq_bf16`
    o, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
    dims, stream = list(SHAPE[:3]) + [SHAPE[2]], torch.cuda.current_stream().cuda_stream
    any_d = "flash_attn_fwd_bf16" in attention._ARGTYPES
    fwd_name, dkv_name = ("flash_attn_fwd_bf16", "flash_attn_bwd_dkv_bf16") if any_d else \
        ("flash_attn_fwd_bf16_d64", "flash_attn_bwd_dkv_bf16_d64")
    dq_any_d = "flash_attn_bwd_dq_bf16" in attention._ARGTYPES
    dq_name = "flash_attn_bwd_dq_bf16" if dq_any_d else "flash_attn_bwd_dq_bf16_d64"
    d_arg = [SHAPE[3]] if any_d else []
    two_floats = any_d or len(attention._ARGTYPES[dkv_name]) == 17
    calls = dict(fwd=(fwd_name, (q, k, v, None, o, lse), d_arg, [0.125]),
                 dq=(dq_name, (q, k, v, do, lse, delta, None, dq), d_arg if dq_any_d else [],
                     [0.125] * (len(attention._ARGTYPES[dq_name]) - 13 - dq_any_d)),
                 dkv=(dkv_name, ((q,) if two_floats else ()) + (q, k, v, do, lse, delta, None, dk, dv), d_arg,
                      [0.125] * (2 if two_floats else 1)))
    launcher = {}
    for key, (name, tensors, ints, floats) in calls.items():
        fn = attention._kernel_fn(name)
        args = [None if t is None else t.data_ptr() for t in tensors] + dims + ints + floats + [stream]
        launcher[key] = host_us_per_call(lambda: fn(*args))
    return dict(wrapper_us=wrapper, launcher_us=launcher)


def device_busy(trainer, state, saved, batch):
    """One step from ``saved`` under ``torch.profiler``: kernel ms summed,
    in all and for the flash-attention and FPS kernels."""
    from torch.profiler import ProfilerActivity, profile

    state.load_state_dict(saved)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.run(state, iter([batch]), max_steps=1)
        torch.cuda.synchronize()
    busy = dict(device_busy_ms=0.0, flash_ms=0.0, fps_ms=0.0)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = e.device_time_total / 1e3
            busy["device_busy_ms"] += ms
            busy["flash_ms"] += ms if "flash_" in e.name else 0.0
            busy["fps_ms"] += ms if "fps_kernel" in e.name else 0.0
    return busy


def train_batch(seed=500):
    """The batch of ``chip_smoke.py``'s fine-tuning phase."""
    img = np.random.default_rng(seed).uniform(0.0, 255.0, size=(2, 6, 900, 1600, 3)).astype(np.float32)[:1]
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-50, 50, (1, 40000, 3)).astype(np.float32)
    gt[..., 2] = rng.uniform(-4, 2, (1, 40000))
    return {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
            for k, v in dict(img=img, cam2lidar_rts=rig_cam2lidar(1), gt_points=gt).items()}


def fixed_state_steps(steps):
    model = build_resdet3d("da3-large", dtype=torch.bfloat16, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1), refinement=REFINEMENT,
                           voxel_pre_reduce=0.1, pre_reduce_cap=393216, bq_anchor_points=25000, num_points=40000,
                           freeze_da3=False)
    with torch.no_grad():
        model.reconstruction_backbone.da3.head.scratch.output_conv2._modules["2"].weight.mul_(0.1)
    trainer = Trainer(model=model, total_steps=1000, lr=1e-4, frozen_patterns=())
    state = trainer.init_state()
    saved = copy.deepcopy(state.state_dict())
    batch = train_batch()
    rows = []
    for i in range(steps + 1):  # the first is a warm-up
        state.load_state_dict(saved)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with stage_timer.collect() as stages:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            state, history = trainer.run(state, iter([batch]), max_steps=1)
            end.record()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        row = dict(step=i, warm_up=i == 0, wall_ms=wall, device_span_ms=start.elapsed_time(end),
                   stage_ms={k: v for k, v in stages.items() if "/" not in k},
                   valid_counts={k: [int(c) for c in v]
                                 for k, v in model.reconstruction_backbone.last_stage_counts.items()},
                   loss=history[-1]["loss"])
        print(json.dumps(dict(what="step", **row)), flush=True)
        rows.append(row)
    return rows[1:], device_busy(trainer, state, saved, batch)


def main() -> int:
    if not torch.cuda.is_available():
        print("finetune_step_time: CUDA is not available", file=sys.stderr)
        return 1
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    tree = recondet3d_torch.__file__
    costs = launch_costs()
    print(json.dumps(dict(what="host_us_per_call", tree=tree, shape=SHAPE, **costs)), flush=True)
    if steps == 0:
        return 0
    rows, busy = fixed_state_steps(steps)
    fps = [r["stage_ms"].get("fps_anchors", 0.0) + r["stage_ms"].get("fps_final", 0.0) for r in rows]
    wall, span = [r["wall_ms"] for r in rows], [r["device_span_ms"] for r in rows]
    print(json.dumps(dict(what="summary", tree=tree, **costs, steps=len(rows), wall_ms=wall,
                          wall_ms_median=float(np.median(wall)), device_span_ms=span,
                          device_span_ms_median=float(np.median(span)), fps_stage_ms=fps,
                          losses=[r["loss"] for r in rows], profiled_step=busy)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
