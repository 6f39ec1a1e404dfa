"""Frames-in-flight pipeline: the triple-buffered swapchain analog.

Port of gpuraytracer_tpu/parallel/pipeline.py. The reference keeps at most
3 frames in flight, fence-pacing the CPU against the GPU
(DeviceResources.cpp:770-792, Renderer.h:92). CUDA launches are already
asynchronous; this pipeline bounds the queue depth like the fence: it
records a CUDA event on the device's current stream after each frame's
work, and once more than ``frames_in_flight`` frames are queued, ``submit``
waits on the oldest frame's event alone (``Event.synchronize``), never on
the stream or the device, so host-side animation and uploads for the next
frames overlap device rendering. On the CPU every frame has run when its
render function returns, and the frames come back in order.

Inside utils/profile.recording(), each fence wait is a
``parallel.fence_wait`` span, and on a CUDA device each frame also records
a timing-enabled event before its frame function runs and a timing-enabled
fence, which give the recording the frame's Mark (host enqueue, device
start and end) once it has been waited on; outside, one untimed event a
frame.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Callable

import torch

from gpuraytracer_tpu_torch.utils import profile

DEFAULT_FRAMES_IN_FLIGHT = 3  # Renderer.h:92


class FramePipeline:
    def __init__(self, render_fn: Callable[..., Any],
                 frames_in_flight: int = DEFAULT_FRAMES_IN_FLIGHT, *, device="cuda"):
        if frames_in_flight < 1:
            raise ValueError("frames_in_flight must be >= 1")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but CUDA is not available")
        self._render = render_fn
        self.depth = frames_in_flight
        # (output, event or None, (recording, its frame start) or None), oldest first
        self._inflight = collections.deque()
        # Host seconds spent waiting on frame events (the fence), in all.
        self.wait_seconds = 0.0

    def _fence(self, timing: bool = False):
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event(enable_timing=timing)
        event.record(torch.cuda.current_stream(self.device))
        return event

    def _wait(self, event) -> None:
        if event is not None:
            t0 = time.time_ns()
            event.synchronize()
            t1 = time.time_ns()
            self.wait_seconds += (t1 - t0) * 1e-9
            profile.record("parallel.fence_wait", t0, t1)

    def _retire(self):
        """Wait for the oldest frame; returns its output."""
        out, event, mark = self._inflight.popleft()
        self._wait(event)
        if mark is not None:
            rec, start = mark
            rec.frame_end(start, event)
        return out

    def submit(self, *args, **kwargs):
        """Enqueue a frame; waits only when the pipeline is full (the
        move_to_next_frame fence wait). Returns (this frame's output, whose
        device work may still be running; the oldest frame's output once it
        has completed, else None)."""
        rec = profile.recording_now()
        start = rec.frame_start(self.device) if rec is not None else None
        out = self._render(*args, **kwargs)
        self._inflight.append((out, self._fence(start is not None),
                               None if start is None else (rec, start)))
        if len(self._inflight) > self.depth:
            return out, self._retire()
        return out, None

    def drain(self):
        """wait_for_gpu analog (DeviceResources.cpp:605-623): wait for every
        outstanding frame and return them oldest first."""
        done = []
        while self._inflight:
            done.append(self._retire())
        return done

    @property
    def in_flight(self) -> int:
        return len(self._inflight)
