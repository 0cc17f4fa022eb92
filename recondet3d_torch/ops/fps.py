"""Furthest-point sampling as a hand-written Hopper kernel.

Replaces the Pallas TPU kernel ``_fps_kernel``
(``recondet3d/ops/fps_pallas.py:54``, wrapper
``furthest_point_sample_pallas`` at ``:256``): K exact furthest-point
selections over (N, 3) fp32 points with a validity mask, in one launch.

What bounds it on an H100: the K selections are strictly sequential and
each needs the argmax over all N points, so the floor is K grid-wide
exchanges, not the 13 bytes a point that are read once, nor the K*N
distance updates. ``csrc/fps.cu`` therefore runs one persistent
cooperative launch of a few dozen blocks (at most one per SM): each block
keeps its share of the valid points, their indices and their running
min-distances in shared memory for the whole launch, and a selection costs
one pass over that share, a block argmax and one 64-bit word per block
exchanged through L2. The TPU kernel's lane planes, scalar tournament and
AABB block pruning answer that machine's costs and are not carried over;
results do not depend on them.

The kernel rounds and breaks ties exactly as
``ops.sampling.furthest_point_sample_plain`` does, so the two return the
same index sequence. This wrapper never falls back: on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["furthest_point_sample_cuda", "exchange_probe", "reset_launch_counts", "MAX_POINTS"]

MAX_POINTS = (1 << 22) - 2  # the kernel packs an index into 22 bits
_SMEM_POINTS = (232448 - 1024) // 20  # rows one block can keep resident (20 B each), as csrc/fps.cu sizes it
_SLOTS = 2048  # 64-bit exchange words: two per block, at most one block per SM
_THREADS = 512
_BLOCKS = 0  # 0: the kernel's default (44, more where a share would not fit in shared memory)


@functools.lru_cache(maxsize=None)
def _lib():
    from recondet3d_torch.ops.build import load_kernels

    lib = load_kernels()["fps"]
    lib.fps_f32.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
                            + [ctypes.c_int, ctypes.c_void_p])
    lib.fps_f32.restype = ctypes.c_int
    lib.fps_exchange_probe.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.fps_exchange_probe.restype = ctypes.c_int
    return lib


def furthest_point_sample_cuda(points: torch.Tensor, valid: torch.Tensor, start: torch.Tensor,
                               num_samples: int, threads: int = _THREADS, blocks: int = _BLOCKS) -> torch.Tensor:
    """points (N, 3) fp32, valid (N,) bool, start (1,) int32 (the first
    selected index), all contiguous on one CUDA device -> (K,) int32.

    Each launch adds one to ``furthest_point_sample_cuda.launches`` and to
    ``furthest_point_sample_cuda.launches_by_shape[(N, K)]``.
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
    if not 1 <= N <= MAX_POINTS or K < 1:
        raise ValueError(f"fps kernel: N={N} (1..{MAX_POINTS}), K={K}")
    sms = torch.cuda.get_device_properties(points.device).multi_processor_count
    if N > sms * (_SMEM_POINTS // 32) * 32:
        raise ValueError(f"fps kernel: N={N} rows do not fit the shared memory of {sms} blocks")
    out = torch.empty(K, dtype=torch.int32, device=points.device)
    slots = torch.zeros(_SLOTS, dtype=torch.int64, device=points.device)
    stream = torch.cuda.current_stream(points.device).cuda_stream
    with torch.cuda.device(points.device):
        err = _lib().fps_f32(points.data_ptr(), valid.data_ptr(), start.data_ptr(), N, K, int(threads),
                             int(blocks), out.data_ptr(), slots.data_ptr(), _SLOTS, stream)
    if err != 0:
        raise RuntimeError(f"fps kernel launch failed: cudaError {err} (N={N}, K={K}, threads={threads}, "
                           f"blocks={blocks})")
    fn = furthest_point_sample_cuda
    fn.launches += 1
    fn.launches_by_shape[(N, K)] = fn.launches_by_shape.get((N, K), 0) + 1
    return out


def exchange_probe(num_samples: int, device="cuda", threads: int = _THREADS, blocks: int = _BLOCKS) -> None:
    """Launch the kernel with its distance update compiled out: K - 1 rounds
    of the grid-wide exchange alone. Timed by the caller, this is the
    latency floor of K sequential selections on the card. Not counted as a
    kernel launch."""
    dev = torch.device(device)
    out = torch.empty(int(num_samples), dtype=torch.int32, device=dev)
    slots = torch.zeros(_SLOTS, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = _lib().fps_exchange_probe(int(num_samples), int(threads), int(blocks), out.data_ptr(), slots.data_ptr(),
                                        _SLOTS, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fps exchange probe launch failed: cudaError {err}")


def reset_launch_counts() -> None:
    furthest_point_sample_cuda.launches = 0
    furthest_point_sample_cuda.launches_by_shape = {}


reset_launch_counts()
