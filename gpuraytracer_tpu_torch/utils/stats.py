"""Frame statistics — the calculate_frame_stats analog.

Port of gpuraytracer_tpu/utils/stats.py. The DXR reference averages fps over
1-second windows and derives "~Million Primary Rays/s" = W*H*fps/1e6
(Renderer.cpp:374-399); the dispatch-time variant W*H/(ms*1e3) mirrors
RendererRaytracingHelper.h:673-678 (NumMRaysPerSecond).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional


def mrays_per_second_from_fps(width: int, height: int, fps: float) -> float:
    return width * height * fps / 1e6


def mrays_per_second_from_dispatch_ms(width: int, height: int, dispatch_ms: float) -> float:
    return width * height / (dispatch_ms * 1e3)


@dataclasses.dataclass
class FrameStatsSnapshot:
    fps: float
    mrays_per_second: float
    frame_count: int
    window_seconds: float


class FrameStats:
    """1 Hz fps / Mrays aggregation with an on-update callback (the
    window-title update analog)."""

    def __init__(self, width: int, height: int,
                 on_update: Optional[Callable[[FrameStatsSnapshot], None]] = None,
                 clock: Callable[[], float] = time.monotonic, window_seconds: float = 1.0):
        self.width = width
        self.height = height
        self._on_update = on_update
        self._clock = clock
        self._window = window_seconds
        self._window_start = clock()
        self._frames_in_window = 0
        self._total_frames = 0
        self.latest: Optional[FrameStatsSnapshot] = None

    def frame_rendered(self) -> Optional[FrameStatsSnapshot]:
        self._frames_in_window += 1
        self._total_frames += 1
        now = self._clock()
        elapsed = now - self._window_start
        if elapsed < self._window:
            return None
        fps = self._frames_in_window / elapsed
        snap = FrameStatsSnapshot(
            fps=fps, mrays_per_second=mrays_per_second_from_fps(self.width, self.height, fps),
            frame_count=self._total_frames, window_seconds=elapsed)
        self.latest = snap
        self._window_start = now
        self._frames_in_window = 0
        if self._on_update:
            self._on_update(snap)
        return snap

    def status_line(self, device_description: str = "") -> str:
        if self.latest is None:
            return f"fps: --    ~Million Primary Rays/s: --    [{device_description}]"
        return (f"fps: {self.latest.fps:.2f}    "
                f"~Million Primary Rays/s: {self.latest.mrays_per_second:.2f}    "
                f"[{device_description}]")
