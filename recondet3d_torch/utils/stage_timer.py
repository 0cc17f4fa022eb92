"""Optional per-stage device timing of the point path and the refinement.

``with stage("ball_query"): ...`` costs one global lookup when timing is
off. Inside ``with collect() as times:`` every stage on a CUDA device
records a pair of CUDA events; on leaving the block the device is
synchronised once and ``times[name]`` holds the summed milliseconds and
``times[name + "/calls"]`` the number of calls.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch

__all__ = ["stage", "collect"]

_events: Optional[List[Tuple[str, "torch.cuda.Event", "torch.cuda.Event"]]] = None


@contextlib.contextmanager
def stage(name: str):
    if _events is None:
        yield
        return
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    try:
        yield
    finally:
        t1.record()
        _events.append((name, t0, t1))


@contextlib.contextmanager
def collect():
    """Time every ``stage`` entered inside the block (CUDA only)."""
    global _events
    if _events is not None:
        raise RuntimeError("stage_timer.collect() is not re-entrant")
    times: Dict[str, float] = {}
    _events = []
    try:
        yield times
    finally:
        events, _events = _events, None
        torch.cuda.synchronize()
        for name, t0, t1 in events:
            times[name] = times.get(name, 0.0) + t0.elapsed_time(t1)
            times[name + "/calls"] = times.get(name + "/calls", 0) + 1
