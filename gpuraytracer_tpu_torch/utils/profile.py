"""Profiling: the GPU timestamp-query substrate analog.

Port of gpuraytracer_tpu/utils/profile.py. ``torch.profiler`` traces
(CUPTI on a GPU) replace jax.profiler; ``trace`` writes a Chrome trace
(chrome://tracing, Perfetto) into ``log_dir``, and ``annotate`` marks a
named range both in the trace (record_function) and as an NVTX range.
``device_summary`` reads a written trace: the device's busy time, the span
from the first device operation to the last, and the operations that took
the most device time. DeviceTimer in utils/timers.py covers the running
average per dispatch.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os

import torch

TRACE_FILE = "trace.json"
# Chrome-trace categories of the work that occupies the device.
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: str = "out/profile"):
    """Trace the enclosed scope (host, and the device where CUDA is
    available); yields the profiler, and writes log_dir/trace.json on
    exit."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str):
    """Named range inside a trace (the NAME_D3D12_OBJECT analog), also an
    NVTX range on a GPU."""
    with torch.profiler.record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


def device_summary(path: str, top: int = 5) -> dict:
    """From a Chrome trace: the device's busy ms (the union of its kernels,
    copies and sets), the span in ms from the first to the last of them, the
    busy share of that span, and the ``top`` operations by device ms
    ([(name, ms, count)]). A trace without device work gives zeros."""
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", []) if isinstance(events, dict) else events
    spans, by_name = [], collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATEGORIES:
            start, dur = float(e["ts"]), float(e.get("dur", 0.0))
            spans.append((start, start + dur))
            by_name[e.get("name", "?")][0] += dur
            by_name[e.get("name", "?")][1] += 1
    busy, end = 0.0, None
    for s, t in sorted(spans):  # union of the intervals
        if end is None or s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    span = (max(t for _, t in spans) - min(s for s, _ in spans)) if spans else 0.0
    ops = sorted(((n, us / 1e3, c) for n, (us, c) in by_name.items()), key=lambda x: -x[1])
    return {"busy_ms": busy / 1e3, "span_ms": span / 1e3,
            "busy_share": busy / span if span else 0.0, "top": ops[:top]}
