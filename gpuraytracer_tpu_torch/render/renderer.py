"""Renderer orchestration: viewport + scene + size-dependent resources.

Port of gpuraytracer_tpu/render/renderer.py. The reference recreates its
window-size-dependent resources on resize (Renderer.cpp:150-161); here
those are the aspect-dependent scene constants, rebuilt when the viewport
changes size. Each frame animates the scene arrays to the requested time
and renders them on the renderer's device: through the CUDA frame kernel
on a GPU, through the wavefront on the CPU.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from gpuraytracer_tpu_torch.accel.instances import Scene
from gpuraytracer_tpu_torch.core.types import MAX_RAY_RECURSION_DEPTH
from gpuraytracer_tpu_torch.utils.event import Viewport
from gpuraytracer_tpu_torch.utils.log import get_logger

log = get_logger("renderer")


class Renderer:
    """Owns a Viewport and the per-size scene state; listens to resize."""

    def __init__(self, width: int, height: int, *, device,
                 scene_factory: Optional[Callable] = None,
                 animate: Optional[Callable] = None,
                 max_depth: int = MAX_RAY_RECURSION_DEPTH):
        from gpuraytracer_tpu_torch.models import builtin

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but CUDA is not available")
        self._factory = scene_factory or builtin.build_scene
        self._animate = animate if animate is not None else builtin.animate_arrays
        self._max_depth = max_depth
        self.viewport = Viewport(width, height)
        # Weak-method listener: a dropped Renderer detaches itself.
        self.viewport.on_size_changed.attach(self.on_size_changed)
        self._create_size_dependent_resources()

    def _create_size_dependent_resources(self) -> None:
        w, h = self.viewport.width, self.viewport.height
        scene = self._factory(aspect=w / h, elapsed_time=0.0, device=self.device)
        self._layout = scene.layout
        self._arrays = scene.arrays

    def on_size_changed(self, width: int, height: int) -> None:
        log.info("resize -> %dx%d (rebuilding size-dependent resources)", width, height)
        self._create_size_dependent_resources()

    def resize(self, width: int, height: int) -> None:
        """No-op sizes are ignored; real changes rebuild the scene constants."""
        self.viewport.resize(width, height)

    def render(self, elapsed_time: float = 0.0):
        """One frame at the current size: the (H, W, 4) float32 radiance
        image on the renderer's device (asynchronous on a GPU)."""
        from gpuraytracer_tpu_torch.render import trace

        arrays = self._arrays
        if self._animate is not False:
            arrays = self._animate(arrays, elapsed_time)
        w, h = self.viewport.width, self.viewport.height
        return trace.render_frame(Scene(self._layout, arrays), w, h, max_depth=self._max_depth)

    @property
    def size(self):
        return self.viewport.width, self.viewport.height
