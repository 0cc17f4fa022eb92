"""Spans at the program's layer boundaries: ``with stage("ball_query"): ...``.

With neither ``collect()`` nor a profiler active, ``stage`` costs one global
lookup and one profiler check, and returns a shared do-nothing context.

Inside ``with collect() as times:`` every stage keeps a ``Span``: its name,
its parent (the enclosing open stage, or None), the unit it belongs to (the
id that the enclosing ``stage(..., unit=True)`` opened: a request or a train
step), host start and end (``time.perf_counter_ns``) and, where CUDA is
available, a pair of CUDA events. On leaving the block the device is
synchronised once and ``times`` holds, for every name:

- ``times[name]``: device ms summed (where CUDA is available),
- ``times[name + "/calls"]``: the number of spans,
- ``times[name + "/host_ms"]``: host wall ms summed,
- ``times[name + "/host_self_ms"]``: the same less the host time that its
  child spans cover;

``times.records`` holds the spans themselves, in the order they were opened.
Spans nest as the ``with`` blocks do, in one thread at a time.

While ``torch.profiler`` runs, every stage also opens a host range of its
name in the trace (a plain ``RecordFunction``, not a user annotation, so it
adds no device-side range), so the trace shows which stage held the host.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch

__all__ = ["Span", "stage", "collect"]

_recorder: Optional["_Recorder"] = None
_NULL = contextlib.nullcontext()
_profiler_enabled = torch.autograd._profiler_enabled


class Span:
    """One stage as ``collect`` recorded it; ``device_ms`` is None without
    CUDA, ``host_end_ns`` None while the stage is open."""

    __slots__ = ("name", "parent", "unit", "host_start_ns", "host_end_ns", "child_ns", "device_ms", "events")

    def __init__(self, name: str, parent: Optional["Span"], unit: Optional[int]):
        self.name, self.parent, self.unit = name, parent, unit
        self.host_start_ns = self.host_end_ns = None
        self.child_ns = 0
        self.device_ms = self.events = None

    @property
    def host_ms(self) -> float:
        return 1e-6 * (self.host_end_ns - self.host_start_ns)


class _Recorder:
    def __init__(self, device_time: bool):
        self.device_time = device_time
        self.spans: List[Span] = []
        self.open: List[Span] = []
        self.units = 0

    def enter(self, name: str, unit: bool) -> Span:
        parent = self.open[-1] if self.open else None
        if unit:
            uid, self.units = self.units, self.units + 1
        else:
            uid = None if parent is None else parent.unit
        span = Span(name, parent, uid)
        self.spans.append(span)
        self.open.append(span)
        if self.device_time:
            span.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            span.events[0].record()
        span.host_start_ns = time.perf_counter_ns()
        return span

    def exit(self, span: Span):
        span.host_end_ns = time.perf_counter_ns()
        if span.events is not None:
            span.events[1].record()
        self.open.pop()
        if span.parent is not None:
            span.parent.child_ns += span.host_end_ns - span.host_start_ns


class _Stage:
    __slots__ = ("name", "unit", "recorder", "span", "range")

    def __init__(self, name: str, unit: bool):
        self.name, self.unit = name, unit
        self.recorder = self.span = self.range = None

    def __enter__(self):
        if _profiler_enabled():
            self.range = torch._C._profiler._RecordFunctionFast(self.name)
            self.range.__enter__()
        self.recorder = _recorder
        if self.recorder is not None:
            self.span = self.recorder.enter(self.name, self.unit)

    def __exit__(self, *exc):
        if self.span is not None:
            self.recorder.exit(self.span)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def stage(name: str, unit: bool = False):
    """A span named ``name``; ``unit`` opens a new request or step id for
    the spans inside it."""
    if _recorder is None and not _profiler_enabled():
        return _NULL
    return _Stage(name, unit)


class Spans(dict):
    """``collect``'s flat dict, with the spans under ``records``."""

    records: List[Span]


@contextlib.contextmanager
def collect():
    """Record every ``stage`` entered inside the block, with each span's
    CUDA-event pair where CUDA is available."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("stage_timer.collect() is not re-entrant")
    rec = _Recorder(torch.cuda.is_available())
    times = Spans()
    times.records = rec.spans
    _recorder = rec
    try:
        yield times
    finally:
        _recorder = None
        if rec.device_time:
            torch.cuda.synchronize()
        _reduce(rec.spans, times)


def _reduce(spans: List[Span], times: Dict):
    for s in spans:
        n = s.name
        host = s.host_ms
        times[n + "/calls"] = times.get(n + "/calls", 0) + 1
        times[n + "/host_ms"] = times.get(n + "/host_ms", 0.0) + host
        times[n + "/host_self_ms"] = times.get(n + "/host_self_ms", 0.0) + host - 1e-6 * s.child_ns
        if s.events is not None:
            s.device_ms = s.events[0].elapsed_time(s.events[1])
            times[n] = times.get(n, 0.0) + s.device_ms
