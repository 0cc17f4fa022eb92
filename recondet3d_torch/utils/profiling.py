"""Device-memory introspection (port of ``recondet3d/utils/profiling.py``):
``device_memory_snapshot`` reads ``torch.cuda`` for every visible card. The
program's spans are ``utils/stage_timer.py``'s.
"""

from __future__ import annotations

import gc

import torch

__all__ = ["device_memory_snapshot", "cleanup_device_memory"]


def device_memory_snapshot() -> dict:
    """Memory of every visible card, keyed by its device (``cuda:<i>``):
    bytes the caching allocator holds for tensors now and at its peak, and
    the card's total. Empty on a host without CUDA."""
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.mem_get_info(i)[1],
        }
    return out


def cleanup_device_memory():
    """Collect dead Python objects, then release the caching allocator's
    unused blocks (the reference's ``empty_cache``)."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
