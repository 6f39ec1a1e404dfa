"""The traced run's reading of a ``torch.profiler`` trace, kept in memory.

The harness marks its own spans (``span``): the measured window
("window") and, inside it, its calls into each layer of the port, each
(while ``recording``) a (name, start, end) of the host's wall clock,
``time.time_ns``, the clock the profiler stamps its events with. On a GPU
the profiler records the device's activity alone (CUPTI: kernels, copies,
sets), so that the host runs at its untraced pace; ``Trace.from_profiler``
reads its events directly (no Chrome trace is written) and puts the
harness's spans beside them. Everything is in seconds.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from rtbench import stats

WINDOW = "window"
KERNEL = "kernel"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


_SPANS = None  # the spans of the window being recorded


@contextlib.contextmanager
def span(name: str):
    """A harness span around a call into the port."""
    t0 = time.time_ns()
    try:
        yield
    finally:
        if _SPANS is not None:
            _SPANS.append((name, t0 * 1e-9, time.time_ns() * 1e-9))


@contextlib.contextmanager
def recording():
    """Record every ``span`` of the enclosed scope; yields their list."""
    global _SPANS
    _SPANS = spans = []
    try:
        yield spans
    finally:
        _SPANS = None


def activity(e) -> str:
    """A profiler event's kind ("kernel", "gpu_memcpy", "gpu_memset", or
    another): its activity type where this PyTorch's events carry one,
    else told from its device and name."""
    if hasattr(e, "activity_type"):
        return str(e.activity_type())
    if not str(e.device_type()).endswith("CUDA"):
        return "cpu"
    name = e.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


@dataclasses.dataclass
class Trace:
    """device: [(kind, name, start, end)]; spans: [(name, start, end)] of
    the harness; window: (start, end) of WINDOW."""

    device: list
    spans: list
    window: tuple

    @classmethod
    def from_profiler(cls, prof, spans) -> "Trace":
        """The profiler's device events and the harness's recorded
        ``spans`` (``recording``), which hold the window."""
        device = []
        for e in prof.profiler.kineto_results.events():
            kind = activity(e)
            if kind in DEVICE_KINDS:
                start = e.start_ns() * 1e-9
                device.append((kind, e.name(), start, start + e.duration_ns() * 1e-9))
        windows = [(s, e) for n, s, e in spans if n == WINDOW]
        if len(windows) != 1:
            raise RuntimeError(f"{len(windows)} {WINDOW!r} spans recorded")
        return cls(device, [sp for sp in spans if sp[0] != WINDOW], windows[0])

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def _inside(self, kinds=DEVICE_KINDS):
        lo, hi = self.window
        return [(n, s, e) for k, n, s0, e0 in self.device if k in kinds
                for s, e in stats.clip([(s0, e0)], lo, hi)]

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which a kernel, copy or set ran."""
        return stats.union_seconds((s, e) for _, s, e in self._inside())

    @property
    def kernel_s(self) -> float:
        """Summed kernel durations inside the window."""
        return sum(e - s for _, s, e in self._inside((KERNEL,)))

    def device_ops(self, top: int = 10):
        return [[n, s] for n, s in stats.by_name(self._inside(), top)]

    def idle_gaps(self, top: int = 10):
        """Idle seconds of the device inside the window by the harness span
        the host was in."""
        lo, hi = self.window
        idle = stats.gaps([(s, e) for _, s, e in self._inside()], lo, hi)
        return [[n, s] for n, s in stats.attribute_gaps(idle, self.spans, top)]

    def span_seconds(self, name: str) -> float:
        return sum(e - s for n, s, e in self.spans if n == name)


def profiler(device):
    """A profiler of the device's activity alone (of the host's on a CPU,
    which has no device events)."""
    act = torch.profiler.ProfilerActivity
    return torch.profiler.profile(activities=[act.CUDA if device.type == "cuda" else act.CPU])
