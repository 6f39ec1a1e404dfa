"""Profiling: the program's own spans and counters, and torch.profiler traces.

Port of gpuraytracer_tpu/utils/profile.py, with an in-memory recorder of
the program's host work.

The recorder. ``span(name, **attrs)`` marks a stretch of host work at a
layer boundary, named ``<layer>.<what>`` (``apps.frame``, ``models.scene``,
``render.replay``, ``parallel.fence_wait``, ``kernels.load``, ...).
``recording()`` turns recording on for its scope and yields a
``Recording``; read it once the scope has ended:

- ``spans``: a ``Record`` of every span that ended in the scope, in the
  order begun: its ``seq`` (that order), name, ``start_ns`` and ``end_ns``
  on ``time.time_ns``, its ``parent`` (the ``seq`` of the enclosing span
  of its thread, or None), its ``frame`` (the ``frame`` attribute of the
  span itself or of the nearest enclosing span that has one:
  ``apps.frame`` carries the frame's index) and its other ``attrs``;
- the collector's passes in the scope (``gc.callbacks``), as ``gc`` spans
  with their ``generation`` and the objects ``collected``;
- ``marks``: one ``Mark`` (frame, host enqueue, device start, device end)
  for each frame that a parallel/pipeline.FramePipeline on a CUDA device
  submitted and waited on in the scope. The device's times come from
  timing-enabled CUDA events, put on the host clock from one anchor taken
  when recording starts (an event recorded on the idle current stream and
  synchronised, read against ``time.time_ns``; its error is at most
  ``anchor_error_ns``). Marks are kept apart from the spans: they are the
  device's, not the host's;
- ``by_name()``: each span name's count, seconds and self seconds (its
  seconds less those of its child spans).

``time.time_ns`` is the clock torch.profiler stamps its device events
with, so a span, a mark and a kernel in a profiler trace lie on one
timeline. The recorder keeps everything in memory, writes no file and
starts no thread. With recording off, ``span`` returns one shared no-op
context manager: it reads no clock and records nothing, after one check
of a global; the pipeline records one untimed event a frame, as ever. For
an operator, a breakdown of the host's frame by layer:

    with profile.recording() as rec:
        render_cli.frame_loop(pipe, state, config, range(100), dt=1 / 60)
        pipe.drain()
    for name, (count, seconds, self_seconds) in rec.by_name().items():
        print(name, count, 1e3 * self_seconds / 100, "ms a frame")

The set-up counters (kernels/build.py ``LOADS``, ``COMPILES``,
``LOAD_SECONDS``; render/program.py ``CAPTURES``, ``CAPTURE_SECONDS``) are
always on: they count only what set-up does.

Traces. ``trace`` writes a Chrome trace (chrome://tracing, Perfetto) of
its scope into ``log_dir``; ``device_summary`` reads one: the device's
busy time, the span from the first device operation to the last, and the
operations that took the most device time. DeviceTimer in utils/timers.py
covers the running average per dispatch.
"""

from __future__ import annotations

import array
import collections
import contextlib
import gc
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import torch

TRACE_FILE = "trace.json"
# Chrome-trace categories of the work that occupies the device.
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class Mark(NamedTuple):
    """A frame on the device: its frame id, when the host enqueued it, and
    when the device began and ended it (``time.time_ns``)."""

    frame: int | None
    enqueue_ns: int
    start_ns: int
    end_ns: int


class Record(NamedTuple):
    """A recorded span: ``seq``, its number in the order begun; ``parent``,
    the ``seq`` of the enclosing span of its thread (or None); ``frame``,
    the frame id (or None); ``attrs``, its attributes other than
    ``frame``."""

    seq: int
    name: str
    start_ns: int
    end_ns: int
    parent: int | None
    frame: int | None
    attrs: dict

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class Span:
    """The context manager that ``span`` returns while recording: an open
    span, kept as a Record when it ends."""

    __slots__ = ("_rec", "name", "attrs", "seq", "parent", "frame", "start_ns", "end_ns")

    def __init__(self, rec, name, attrs):
        self._rec, self.name, self.attrs = rec, name, attrs
        self.end_ns = None

    def __enter__(self):
        self._rec._begin(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        self._rec._end(self)
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
_RECORDING = None  # the Recording of the open recording() scope, if any
_NONE = -(2 ** 63)  # None in the int64 columns
_SPAN_FIELDS = 6  # seq, name id, start, end, parent, frame


def _int(x) -> int:
    return _NONE if x is None else x


def _opt(x: int):
    return None if x == _NONE else x


class Recording:
    """What ``recording()`` recorded (see the module docstring).

    Ended spans and marks are kept as int64 columns (``array``), and a
    span's attributes other than ``frame`` only where it has some: the
    recording allocates nothing that the collector tracks and keeps, so
    that it does not bring the collector's passes on sooner, and with them
    a full collection into the window it records."""

    def __init__(self):
        self._spans, self._marks = array.array("q"), array.array("q")
        self._names, self._name_ids, self._attrs = [], {}, {}
        self._seq = itertools.count()
        self.anchor_error_ns = None
        self._anchor = None  # (device, event, host ns)
        self._local = threading.local()
        self._gc_start = None

    @property
    def spans(self) -> list:
        """Every Record, in the order begun."""
        n, col = _SPAN_FIELDS, self._spans
        rows = sorted(col[i:i + n] for i in range(0, len(col), n))
        return [Record(seq, self._names[name], start, end, _opt(parent), _opt(frame),
                       self._attrs.get(seq, {}))
                for seq, name, start, end, parent, frame in rows]

    @property
    def marks(self) -> list:
        """Every Mark, in the order the frames were waited on."""
        col = self._marks
        return [Mark(_opt(col[i]), *col[i + 1:i + 4]) for i in range(0, len(col), 4)]

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _begin(self, s: Span) -> None:
        stack = self._stack()
        parent = stack[-1] if stack else None
        s.seq, s.parent = next(self._seq), None if parent is None else parent.seq
        s.frame = s.attrs.get("frame", None if parent is None else parent.frame)
        stack.append(s)

    def _end(self, s: Span) -> None:
        stack = self._stack()
        if stack and stack[-1] is s:
            stack.pop()
        elif s in stack:
            stack.remove(s)
        self._keep(s.seq, s.name, s.start_ns, s.end_ns, s.parent, s.frame, s.attrs)

    def _keep(self, seq, name, start_ns, end_ns, parent, frame, attrs) -> None:
        name_id = self._name_ids.get(name)
        if name_id is None:
            name_id = self._name_ids[name] = len(self._names)
            self._names.append(name)
        self._spans.extend((seq, name_id, start_ns, end_ns, _int(parent), _int(frame)))
        if len(attrs) > ("frame" in attrs):
            self._attrs[seq] = {k: v for k, v in attrs.items() if k != "frame"}

    def add(self, name: str, start_ns: int, end_ns: int, **attrs) -> None:
        """A span that has already ended, inside the thread's open span."""
        stack = self._stack()
        parent = stack[-1] if stack else None
        self._keep(next(self._seq), name, start_ns, end_ns,
                   None if parent is None else parent.seq,
                   attrs.get("frame", None if parent is None else parent.frame), attrs)

    def _gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_start = time.time_ns()
        elif self._gc_start is not None:
            self.add("gc", self._gc_start, time.time_ns(), generation=info["generation"],
                     collected=info["collected"])
            self._gc_start = None

    def _take_anchor(self) -> None:
        """The device clock's anchor on the current CUDA device, where CUDA
        is in use: of 8 events recorded on the idle stream, the one whose
        record and synchronise took the least host time, read at the
        middle of that time."""
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return
        device = torch.device("cuda", torch.cuda.current_device())
        stream = torch.cuda.current_stream(device)
        stream.synchronize()
        best = None
        for _ in range(8):
            event = torch.cuda.Event(enable_timing=True)
            t0 = time.time_ns()
            event.record(stream)
            event.synchronize()
            t1 = time.time_ns()
            if best is None or t1 - t0 < best[2] - best[1]:
                best = (event, t0, t1)
        event, t0, t1 = best
        self._anchor = (device, event, (t0 + t1) // 2)
        self.anchor_error_ns = (t1 - t0) // 2

    def frame_start(self, device):
        """For FramePipeline.submit, before the frame function runs: a
        timing-enabled event recorded on the device's current stream, with
        the frame id and the host's enqueue time; None where the anchor is
        on no such device."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if self._anchor is None or device != self._anchor[0]:
            return None
        stack = self._stack()
        frame = stack[-1].frame if stack else None
        event = torch.cuda.Event(enable_timing=True)
        t = time.time_ns()
        event.record(torch.cuda.current_stream(device))
        return frame, t, event

    def frame_end(self, start, end_event) -> None:
        """Once the frame's fence ``end_event`` (timing-enabled) has been
        waited on: its Mark."""
        frame, enqueue_ns, start_event = start
        _, anchor, anchor_ns = self._anchor
        self._marks.extend((_int(frame), enqueue_ns,
                            anchor_ns + round(anchor.elapsed_time(start_event) * 1e6),
                            anchor_ns + round(anchor.elapsed_time(end_event) * 1e6)))

    def by_name(self) -> dict:
        """{name: (count, seconds, self seconds)} of the spans, in the order
        first begun; a span's self seconds are its own less its children's."""
        spans = self.spans
        child = collections.defaultdict(int)
        for r in spans:
            if r.parent is not None:
                child[r.parent] += r.end_ns - r.start_ns
        out = {}
        for r in spans:
            n, total, own = out.get(r.name, (0, 0, 0))
            d = r.end_ns - r.start_ns
            out[r.name] = (n + 1, total + d, own + d - child[r.seq])
        return {k: (n, t * 1e-9, o * 1e-9) for k, (n, t, o) in out.items()}


def span(name: str, **attrs):
    """A context manager around a stretch of host work named ``name``
    (``<layer>.<what>``); recorded, with ``attrs``, only inside
    ``recording()``."""
    if _RECORDING is None:
        return _NO_SPAN
    return Span(_RECORDING, name, attrs)


def record(name: str, start_ns: int, end_ns: int) -> None:
    """Record a span that has already ended (``time.time_ns`` times read by
    the caller for its own use), only inside ``recording()``."""
    if _RECORDING is not None:
        _RECORDING.add(name, start_ns, end_ns)


def recording_now() -> Recording | None:
    """The open recording, or None: one check of a global."""
    return _RECORDING


@contextlib.contextmanager
def recording():
    """Record every span, collector pass and pipeline frame of the scope;
    yields the Recording (see the module docstring). Scopes do not nest."""
    global _RECORDING
    if _RECORDING is not None:
        raise RuntimeError("a recording is already open")
    rec = Recording()
    rec._take_anchor()
    _RECORDING = rec
    gc.callbacks.append(rec._gc)
    try:
        yield rec
    finally:
        gc.callbacks.remove(rec._gc)
        _RECORDING = None


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
