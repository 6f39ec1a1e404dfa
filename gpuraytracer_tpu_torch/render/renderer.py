"""Renderer orchestration: viewport + scene + size-dependent resources.

Port of gpuraytracer_tpu/render/renderer.py. The reference recreates its
window-size-dependent resources on resize (Renderer.cpp:150-161); here
those are the aspect-dependent scene constants and the compiled frame
program, rebuilt when the viewport changes size. Each frame animates the
scene arrays to the requested time and renders them on the renderer's
device, as the reference's jitted step (animate, then render_frame): on a
GPU one replay of a captured frame program (render/program.py), whose
animation is row 10 (kernels/frame_state.py) and whose frame takes the
scene's route (the CUDA frame kernel, or the wavefront); on the CPU the
same frame eagerly, through the wavefront.
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
        # The step's programs (the reference's self._step = jax.jit(step)),
        # by program.key; a resize drops them, as the reference recompiles.
        self._programs = {}
        self._time = torch.zeros(1, dtype=torch.float32, device=self.device)

    def on_size_changed(self, width: int, height: int) -> None:
        log.info("resize -> %dx%d (rebuilding size-dependent resources)", width, height)
        self._create_size_dependent_resources()

    def resize(self, width: int, height: int) -> None:
        """No-op sizes are ignored; real changes rebuild the scene constants."""
        self.viewport.resize(width, height)

    def step(self):
        """The frame program of the current size and knobs (built at its
        first use; render/program.py), which renders the frame at the time
        in ``self._time``."""
        from gpuraytracer_tpu_torch.render import program

        w, h = self.viewport.width, self.viewport.height
        scene = Scene(self._layout, self._arrays)
        k = program.key(scene)
        if k not in self._programs:
            self._programs[k] = program.animated_frames(
                scene, self._animate, self._time, width=w, height=h, max_depth=self._max_depth,
                label=f"Renderer step {w}x{h} depth {self._max_depth}")
        return self._programs[k]

    def render(self, elapsed_time: float = 0.0):
        """One frame at the current size: the (H, W, 4) float32 radiance
        image on the renderer's device (asynchronous on a GPU). The time goes
        into the program's time buffer by ``fill_`` (a kernel argument: no
        upload, no host sync)."""
        prog = self.step()
        self._time.fill_(elapsed_time)
        return prog()

    @property
    def size(self):
        return self.viewport.width, self.viewport.height
