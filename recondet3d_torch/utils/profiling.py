"""Profiling and device-memory introspection (port of
``recondet3d/utils/profiling.py``).

``StageTimer`` keeps totals over ``utils/stage_timer``'s device timing (CUDA
events around each ``stage`` inside ``collect()``); ``trace`` records a
``torch.profiler`` trace for TensorBoard; ``device_memory_snapshot`` reads
``torch.cuda`` for every visible card.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Dict

import torch

from recondet3d_torch.utils import stage_timer
from recondet3d_torch.utils.logger import get_logger

logger = get_logger("recondet3d_torch.profiling")

__all__ = ["StageTimer", "trace", "device_memory_snapshot", "cleanup_device_memory"]

class StageTimer:
    """Per-stage device time accumulated over ``collect`` blocks.

    >>> t = StageTimer()
    >>> with t.collect():
    ...     with t.stage("forward"):
    ...         out = model(x)
    >>> t.summary()  # seconds a call, per stage

    ``stage`` is ``utils/stage_timer.stage``, so the stages the point path
    and the refinement already mark are timed too (CUDA devices only)."""

    stage = staticmethod(stage_timer.stage)

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def collect(self):
        with stage_timer.collect() as times:
            yield
        for key, value in times.items():
            if key.endswith("/calls"):
                name = key[: -len("/calls")]
                self.counts[name] = self.counts.get(name, 0) + int(value)
            else:
                self.totals[key] = self.totals.get(key, 0.0) + 1e-3 * value

    def summary(self) -> Dict[str, float]:
        return {k: self.totals[k] / max(self.counts.get(k, 0), 1) for k in sorted(self.totals)}

    def log_summary(self):
        for k, v in self.summary().items():
            logger.info(f"{k}: {v * 1e3:.1f} ms avg over {self.counts[k]} calls")


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (CPU and, where there is one, CUDA
    activity), written to ``log_dir`` for TensorBoard's profiler plugin."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


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
