"""Timers: StepTimer, EmaTimer and DeviceTimer.

Port of gpuraytracer_tpu/utils/timers.py. Reference:
  StepTimer (QPC wall clock, fixed/variable timestep, 0.1 s delta clamp,
  leftover-tick accumulation, fps counting)  src/StepTimer.h:99-180
  DX::GPUTimer (timestamp queries, 0.95-EMA averages)
  src/PerformanceTimers.{h,cpp}

The host clock is the native runtime's monotonic clock
(runtime/hostrt.now_seconds). DeviceTimer times device work with CUDA
events, the timestamp-query analog: it folds a measurement into its
average only once the end event has completed (``torch.cuda.Event.query``),
so it never waits for the card inside a frame; ``drain`` waits for the rest
after the loop.
"""

from __future__ import annotations

import collections
from typing import Callable, Optional

import torch

from gpuraytracer_tpu_torch.runtime import hostrt

# Ticks per second of the reference's fixed-point tick unit
# (StepTimer.h ticks_per_second = 1e7, i.e. 100 ns ticks).
TICKS_PER_SECOND = 10_000_000
MAX_DELTA_SECONDS = 0.1  # delta clamp after pauses/breakpoints


class StepTimer:
    """Variable- or fixed-timestep frame timer."""

    def __init__(self, clock: Callable[[], float] = hostrt.now_seconds,
                 fixed_time_step: bool = False, target_delta_seconds: float = 1.0 / 60.0):
        self._clock = clock
        self._last = clock()
        self._elapsed = 0.0  # delta of the last tick
        self._total = 0.0
        self._leftover = 0.0
        self._frame_count = 0
        self._fps = 0
        self._frames_this_second = 0
        self._second_counter = 0.0
        self.fixed_time_step = fixed_time_step
        self.target_delta_seconds = target_delta_seconds

    def tick(self, update: Optional[Callable[[float], None]] = None) -> None:
        now = self._clock()
        delta = now - self._last
        self._last = now
        self._second_counter += delta
        delta = min(delta, MAX_DELTA_SECONDS)  # clamp after a pause or breakpoint

        frames = self._frame_count
        if self.fixed_time_step:
            # Snap to the target within 1/4000 s, as the reference does, to
            # avoid drift against vsync-style cadences.
            if abs(delta - self.target_delta_seconds) < 1.0 / 4000.0:
                delta = self.target_delta_seconds
            self._leftover += delta
            while self._leftover >= self.target_delta_seconds:
                self._elapsed = self.target_delta_seconds
                self._total += self.target_delta_seconds
                self._leftover -= self.target_delta_seconds
                self._frame_count += 1
                if update:
                    update(self.target_delta_seconds)
        else:
            self._elapsed = delta
            self._total += delta
            self._leftover = 0.0
            self._frame_count += 1
            if update:
                update(delta)

        if self._frame_count != frames:
            self._frames_this_second += self._frame_count - frames
        if self._second_counter >= 1.0:
            self._fps = self._frames_this_second
            self._frames_this_second = 0
            self._second_counter %= 1.0

    def reset_elapsed_time(self) -> None:
        self._last = self._clock()
        self._leftover = 0.0
        self._fps = 0
        self._frames_this_second = 0
        self._second_counter = 0.0

    @property
    def elapsed_seconds(self) -> float:
        return self._elapsed

    @property
    def total_seconds(self) -> float:
        return self._total

    @property
    def frame_count(self) -> int:
        return self._frame_count

    @property
    def frames_per_second(self) -> int:
        return self._fps


class EmaTimer:
    """Running-average span timer: new = lerp(avg, sample, 0.05), i.e. the
    reference GPU timer's 0.95 retention (PerformanceTimers.cpp:34-37)."""

    SMOOTHING = 0.95

    def __init__(self, clock: Callable[[], float] = hostrt.now_seconds):
        self._clock = clock
        self._start: Optional[float] = None
        self._last_ms = 0.0
        self._avg_ms = 0.0
        self._samples = 0

    def start(self) -> None:
        self._start = self._clock()

    def stop(self) -> float:
        if self._start is None:
            raise RuntimeError("stop() without start()")
        ms = (self._clock() - self._start) * 1e3
        self._start = None
        return self._add(ms)

    def _add(self, ms: float) -> float:
        self._last_ms = ms
        if self._samples == 0:
            self._avg_ms = ms
        else:
            self._avg_ms = self.SMOOTHING * self._avg_ms + (1.0 - self.SMOOTHING) * ms
        self._samples += 1
        return ms

    @property
    def last_ms(self) -> float:
        return self._last_ms

    @property
    def average_ms(self) -> float:
        return self._avg_ms

    @property
    def samples(self) -> int:
        return self._samples


class DeviceTimer(EmaTimer):
    """Times the device work enqueued between ``start`` and ``stop``.

    On a CUDA device each span is a pair of CUDA events recorded on the
    current stream; ``stop`` records the end event, folds every span whose
    end event has completed into the average (oldest first) and returns the
    newest folded span's ms, never waiting for the card. ``drain`` waits for
    the spans still pending. On the CPU (``device`` "cpu") it is the host
    clock's EmaTimer."""

    def __init__(self, device="cuda", clock: Callable[[], float] = hostrt.now_seconds):
        super().__init__(clock)
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        if self._cuda and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but CUDA is not available")
        self._open = None
        self._pending = collections.deque()

    def _event(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record(torch.cuda.current_stream(self.device))
        return e

    def start(self) -> None:
        if not self._cuda:
            return super().start()
        self._open = self._event()

    def stop(self) -> float:
        if not self._cuda:
            return super().stop()
        if self._open is None:
            raise RuntimeError("stop() without start()")
        self._pending.append((self._open, self._event()))
        self._open = None
        self.poll()
        return self._last_ms

    def stop_after(self, value) -> float:
        """Wait for the stream that produced ``value`` (a tensor or a tuple
        of them: the current stream of each one's CUDA device), then
        ``stop`` and return the span's ms. A host sync by design, as the
        reference's block_until_ready."""
        values = value if isinstance(value, (tuple, list)) else (value,)
        for dev in {v.device for v in values if isinstance(v, torch.Tensor)}:
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
        ms = self.stop()
        if self._cuda:
            self.drain()
            ms = self._last_ms
        return ms

    def poll(self) -> int:
        """Fold the completed spans; returns how many are still pending."""
        while self._pending and self._pending[0][1].query():
            start, end = self._pending.popleft()
            self._add(start.elapsed_time(end))
        return len(self._pending)

    def drain(self) -> None:
        """Wait for every pending span (after the frame loop) and fold it."""
        for _, end in self._pending:
            end.synchronize()
        self.poll()

    @property
    def pending(self) -> int:
        return len(self._pending)
