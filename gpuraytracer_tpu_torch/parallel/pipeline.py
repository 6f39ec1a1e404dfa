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
"""

from __future__ import annotations

import collections
import time
from typing import Any, Callable

import torch

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
        self._inflight = collections.deque()  # (output, event or None), oldest first
        # Host seconds spent waiting on frame events (the fence), in all.
        self.wait_seconds = 0.0

    def _fence(self):
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    def _wait(self, event) -> None:
        if event is not None:
            t0 = time.perf_counter()
            event.synchronize()
            self.wait_seconds += time.perf_counter() - t0

    def submit(self, *args, **kwargs):
        """Enqueue a frame; waits only when the pipeline is full (the
        move_to_next_frame fence wait). Returns (this frame's output, whose
        device work may still be running; the oldest frame's output once it
        has completed, else None)."""
        out = self._render(*args, **kwargs)
        self._inflight.append((out, self._fence()))
        if len(self._inflight) > self.depth:
            done, event = self._inflight.popleft()
            self._wait(event)
            return out, done
        return out, None

    def drain(self):
        """wait_for_gpu analog (DeviceResources.cpp:605-623): wait for every
        outstanding frame and return them oldest first."""
        done = []
        while self._inflight:
            out, event = self._inflight.popleft()
            self._wait(event)
            done.append(out)
        return done

    @property
    def in_flight(self) -> int:
        return len(self._inflight)
