"""Render configuration (port of gpuraytracer_tpu/core/config.py).

Defaults equal the reference's compile-time constants (main.cpp:14,
Renderer.cpp:46, Renderer.h:105-107). ``device`` names the torch device
that renders; there is no automatic fallback between devices.
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

    @property
    def aspect_ratio(self) -> float:
        return self.width / self.height
