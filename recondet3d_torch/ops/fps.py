"""Furthest-point sampling as a hand-written Hopper kernel.

Replaces the Pallas TPU kernel ``_fps_kernel``
(``recondet3d/ops/fps_pallas.py:54``, wrapper
``furthest_point_sample_pallas`` at ``:256``): K exact furthest-point
selections over (N, 3) fp32 points with a validity mask, in one launch.

What bounds it on an H100: the K selections are strictly sequential and
each needs the argmax over all valid points, so the floor of any design is
K exchanges of a candidate between the parts of the card that hold the
points, not the 13 bytes a point read once, nor the K * n_valid distance
updates. ``csrc/fps.cu`` therefore runs one launch of thread-block
clusters of 16 CTAs: a cluster shares the valid points (in registers, and
in shared memory beyond 5,120 a CTA), and a selection costs one pass over a
CTA's share, a CTA argmax and one 20-byte record a CTA written into every
peer's shared memory (``st.async`` completing on the peer's mbarrier). When
the valid points do not fit in one cluster, the clusters exchange one
tagged record each through device memory as well. The kernel decides how
many clusters a cloud needs from its valid count; the launch has as many as
N could need (``launch_plan``), at most the 7 an H100 runs at once at a
CTA's full shared memory. Beyond what those hold on chip (1,404,928 rows), a
CTA's share runs past its shared memory: the rest stays in device memory
(the staging buffer and a min-distance beside each point) and streams on
every selection, up to ``MAX_POINTS`` rows (the Pallas kernel's stated
ceiling is about 5 M). The TPU kernel's lane planes, scalar
tournament and AABB block pruning answer that machine's costs and are not
carried over; results do not depend on them.

The kernel rounds and breaks ties exactly as
``ops.sampling.furthest_point_sample_plain`` does, so the two return the
same index sequence. This wrapper never falls back: on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

__all__ = ["furthest_point_sample_cuda", "exchange_probe", "launch_plan", "FpsPlan", "reset_launch_counts",
           "MAX_POINTS", "CLUSTER"]

MAX_POINTS = (1 << 23) - 2  # the kernel packs an index into 23 bits
# the launch shape csrc/fps.cu fixes: 16 CTAs a cluster, 512 threads a CTA, 10 points a thread in registers
CLUSTER = 16
REG_POINTS = 10 * 512
MAX_CLUSTERS = 7  # the most clusters of 16 CTAs an H100 runs at once at a CTA's full shared memory
_SMEM_LIMIT, _SMEM_FIXED = 232448, 2048  # a CTA's shared memory, and the part before the points
# points a CTA can hold: 16 B of {x, y, z, index} each in shared memory, and 4 B of min-distance beyond the registers
CTA_MAX_POINTS = (_SMEM_LIMIT - _SMEM_FIXED + 4 * REG_POINTS) // 20
_CTRL_HEAD, _SLOT_WORDS = 4, 2 * MAX_CLUSTERS * 4


class FpsPlan(NamedTuple):
    clusters: int  # clusters launched: as many as N points could need, at most MAX_CLUSTERS
    cta_cap: int  # points a CTA holds on chip
    smem_points: int  # of those, the points beyond the registers
    smem_bytes: int  # dynamic shared memory a CTA
    overflow: int  # points a CTA may own beyond cta_cap, kept in device memory (0 up to 1,404,928 rows)


def launch_plan(n: int) -> FpsPlan:
    """The launch for an N-row buffer, as if every row were valid: the
    fewest clusters whose CTAs hold N points on chip, at most
    ``MAX_CLUSTERS``; each CTA's on-chip capacity and shared memory; and,
    when N exceeds what those clusters hold, each CTA's overflow in device
    memory. Raises ValueError outside 1..``MAX_POINTS``."""
    if not 1 <= n <= MAX_POINTS:
        raise ValueError(f"fps kernel: N={n} (1..{MAX_POINTS})")
    clusters = min(MAX_CLUSTERS, -(-n // (CLUSTER * CTA_MAX_POINTS)))
    share = -(-n // (clusters * CLUSTER))
    cta_cap = min(share, CTA_MAX_POINTS)
    smem_points = max(0, cta_cap - REG_POINTS)
    return FpsPlan(clusters, cta_cap, smem_points, _SMEM_FIXED + 16 * cta_cap + 4 * smem_points, share - cta_cap)


@functools.lru_cache(maxsize=None)
def _lib():
    from recondet3d_torch.ops.build import load_kernels

    lib = load_kernels()["fps"]
    lib.fps_f32.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 6
    lib.fps_f32.restype = ctypes.c_int
    lib.fps_exchange_probe.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
    lib.fps_exchange_probe.restype = ctypes.c_int
    return lib


def furthest_point_sample_cuda(points: torch.Tensor, valid: torch.Tensor, start: torch.Tensor,
                               num_samples: int) -> torch.Tensor:
    """points (N, 3) fp32, valid (N,) bool, start (1,) int32 (the first
    selected index), all contiguous on one CUDA device -> (K,) int32.

    Each launch adds one to ``furthest_point_sample_cuda.launches`` and to
    ``furthest_point_sample_cuda.launches_by_shape[(N, K)]``; ``last_args``
    is the launch's ``(points, valid, start, K)``, ``last_plan`` its
    ``FpsPlan`` and ``last_ctrl`` a device tensor whose entries 2 and 3
    hold, once the kernel has run, the cluster size it ran with and the
    clusters it used.
    """
    if points.device.type != "cuda" or valid.device != points.device or start.device != points.device:
        raise ValueError(f"fps kernel: tensors on {points.device}/{valid.device}/{start.device}")
    N = points.shape[0]
    if points.dtype != torch.float32 or points.dim() != 2 or points.shape[1] != 3 or not points.is_contiguous():
        raise ValueError(f"fps kernel takes contiguous (N, 3) fp32 points; got {tuple(points.shape)} {points.dtype}")
    if valid.dtype != torch.bool or valid.shape != (N,) or not valid.is_contiguous():
        raise ValueError(f"fps kernel takes a contiguous ({N},) bool mask; got {tuple(valid.shape)} {valid.dtype}")
    if start.dtype != torch.int32 or start.numel() != 1:
        raise ValueError("fps kernel takes start as one int32 element")
    K = int(num_samples)
    if K < 1:
        raise ValueError(f"fps kernel: K={K}")
    plan = launch_plan(N)
    dev = points.device
    out = torch.empty(K, dtype=torch.int32, device=dev)
    staging = torch.empty((N, 4), dtype=torch.float32, device=dev)
    odist = torch.empty(N, dtype=torch.float32, device=dev) if plan.overflow else None
    ctrl = torch.zeros(_CTRL_HEAD + CLUSTER * plan.clusters, dtype=torch.int32, device=dev)
    slots = torch.zeros(_SLOT_WORDS, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().fps_f32(points.data_ptr(), valid.data_ptr(), start.data_ptr(), N, K, plan.clusters,
                             plan.cta_cap, plan.cta_cap + plan.overflow, plan.smem_points, staging.data_ptr(),
                             None if odist is None else odist.data_ptr(), ctrl.data_ptr(), slots.data_ptr(),
                             out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fps kernel launch failed: cudaError {err} (N={N}, K={K}, {plan})")
    fn = furthest_point_sample_cuda
    fn.launches += 1
    fn.launches_by_shape[(N, K)] = fn.launches_by_shape.get((N, K), 0) + 1
    fn.last_args, fn.last_plan, fn.last_ctrl = (points, valid, start, K), plan, ctrl
    return out


def exchange_probe(num_samples: int, clusters: int = 1, device="cuda") -> None:
    """Launch the kernel with its points compiled out: K - 1 steps of the
    exchange of ``clusters`` clusters alone (1: the cluster exchange; 2 or 3:
    with the second level through device memory). Timed by the caller, this
    is the latency floor of K sequential selections in this design. Not
    counted as a kernel launch."""
    dev = torch.device(device)
    out = torch.empty(int(num_samples), dtype=torch.int32, device=dev)
    ctrl = torch.zeros(_CTRL_HEAD + CLUSTER * clusters, dtype=torch.int32, device=dev)
    slots = torch.zeros(_SLOT_WORDS, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = _lib().fps_exchange_probe(int(num_samples), int(clusters), ctrl.data_ptr(), slots.data_ptr(),
                                        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fps exchange probe launch failed: cudaError {err}")


def reset_launch_counts() -> None:
    fn = furthest_point_sample_cuda
    fn.launches, fn.launches_by_shape = 0, {}
    fn.last_args = fn.last_plan = fn.last_ctrl = None


reset_launch_counts()
