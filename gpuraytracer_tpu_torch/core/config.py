"""Render configuration (port of gpuraytracer_tpu/core/config.py).

Defaults equal the reference's compile-time constants (main.cpp:14,
Renderer.cpp:46, Renderer.h:92, 105-107). ``device`` stands in the place of
the reference's ``platform``: the torch device that renders ("cuda",
"cuda:N" or "cpu"); there is no automatic fallback between devices
(parallel/device.pick_device).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 1280
    height: int = 720
    max_recursion_depth: int = 3
    animate_geometry: bool = True
    animate_camera: bool = False
    animate_light: bool = False
    device: str = "cuda"
    # Frames in flight of the CLI's frame pipeline (Renderer.h:92).
    frames_in_flight: int = 3
    # Framebuffer format: "float32" (radiance) or "rgba8" (the
    # R8G8B8A8_UNORM backbuffer analog).
    output_format: str = "float32"

    @property
    def aspect_ratio(self) -> float:
        return self.width / self.height

    def with_size(self, width: int, height: int) -> "RenderConfig":
        return dataclasses.replace(self, width=width, height=height)

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
