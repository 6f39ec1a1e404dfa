"""The interactive viewer: the port's CLI frame loop
(``apps/render_cli.frame_loop`` over ``parallel/pipeline.FramePipeline``
and ``apps/render_cli.frame_to_host``) in a closed loop: each frame is
ticked by a fixed dt, its scene built on the host
(``models/animate.AnimationState.scene``), rendered by one replay of the
CLI's frame program, converted to RGBA8 on the card and copied to pinned
host memory (the present); the next frame is ticked as soon as the
pipeline has room. No frame is written to disk.

The mix's parameters (``traffic/*.json``): ``frame_dt_s``,
``start_time_s`` (the range the first frame's geometry time is drawn
from), ``frames_in_flight``, ``animate_camera``, ``animate_light``,
``animate_geometry`` and ``warmup_frames``.

A frame's latency runs from its tick (the start of its scene build) to
the loop's receipt of its presented bytes. The seed draws the start time
and which presented frame the check compares (uniformly among all, by
reservoir sampling).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rtbench import compare, core, tracing
from rtbench.generators import WindowResult, launches


class Generator:
    def __init__(self, run: core.Run):
        self.run = run
        self.cfg, self.p = run.cell.config, run.cell.traffic
        self.result = None
        if self.cfg["port_scene"] != "builtin":
            raise ValueError("the viewer's frame loop renders the built-in scene only")

    def _state(self, cls):
        state = cls.initial()
        state.geometry_time = self.t0
        return state

    def setup(self) -> None:
        from gpuraytracer_tpu_torch.apps import render_cli
        from gpuraytracer_tpu_torch.core.config import RenderConfig
        from gpuraytracer_tpu_torch.models.animate import AnimationState
        from gpuraytracer_tpu_torch.parallel.pipeline import FramePipeline

        run, cfg, p = self.run, self.cfg, self.p
        rng = np.random.default_rng(run.seed)
        self.t0 = float(rng.uniform(*p["start_time_s"]))
        self.pick = rng
        self.dt = float(p["frame_dt_s"])
        self.config = RenderConfig(
            width=run.width, height=run.height, max_recursion_depth=int(cfg["max_depth"]),
            animate_geometry=bool(p["animate_geometry"]),
            animate_camera=bool(p["animate_camera"]), animate_light=bool(p["animate_light"]),
            device=str(run.device), frames_in_flight=int(p["frames_in_flight"]))
        self.render = render_cli.frame_to_host(self.config, run.device)
        scene_s = self.scene_s = []

        class TimedState(AnimationState):
            """The port's animation state with the harness's spans around
            its tick and its scene build."""

            def tick(self, delta_seconds, config):
                with tracing.span("tick"):
                    s = super().tick(delta_seconds, config)
                s.__class__ = TimedState
                return s

            def scene(self, aspect, *, device):
                t = time.perf_counter()
                with tracing.span("scene"):
                    out = super().scene(aspect, device=device)
                scene_s.append(time.perf_counter() - t)
                return out

        class TimedPipeline(FramePipeline):
            """The port's pipeline with a span around its fence waits."""

            def _wait(self, event):
                with tracing.span("fence_wait"):
                    super()._wait(event)

        self.state_cls, self.pipe_cls = TimedState, TimedPipeline
        warm = FramePipeline(self.render, self.config.frames_in_flight, device=run.device)
        render_cli.frame_loop(warm, self._state(AnimationState), self.config,
                              range(int(p["warmup_frames"])), dt=self.dt)
        warm.drain()
        scene_s.clear()

    def _submit(self, scene):
        with tracing.span("render"):
            return self.render(scene)

    def window(self) -> None:
        from gpuraytracer_tpu_torch.apps import render_cli
        from gpuraytracer_tpu_torch.render import program

        pipe = self.pipe_cls(self._submit, self.config.frames_in_flight, device=self.run.device)
        ticked, done = [], {}
        chosen = [None]

        def received(j, out):
            done[j] = time.perf_counter()
            if self.pick.random() * (len(done)) < 1.0:
                chosen[0] = (j, out)

        before = program.counters()
        with tracing.span("window"):
            t_start = time.perf_counter()
            deadline = t_start + self.run.seconds

            def frames():
                i = 0
                while time.perf_counter() < deadline:
                    ticked.append(time.perf_counter())
                    yield i
                    i += 1

            render_cli.frame_loop(pipe, self._state(self.state_cls), self.config, frames(),
                                  dt=self.dt, on_frame=received)
            n = len(ticked)
            rest = pipe.drain()
            for j, out in zip(range(n - len(rest), n), rest):
                received(j, out)
            t_end = time.perf_counter()
        self.chosen = chosen[0]
        self.result = WindowResult(
            frames=len(done), seconds=t_end - t_start, attempted=n,
            launches=launches(before, program.counters()),
            latencies_s=[done[j] - ticked[j] for j in range(n) if j in done],
            wait_s=pipe.wait_seconds, scene_s=list(self.scene_s))

    def release(self) -> None:
        self.render = None

    def check(self, stand_in=None) -> dict:
        """{"present_gap_pct": the share (%) of the chosen presented frame's
        pixels off the reference's RGBA8 (compare.u8_gap_pct),
        "frames_lost": frames ticked but never presented}. ``stand_in(desc,
        state)``, where given, renders the (H, W, 4) f32 frame whose RGBA8
        is compared in the program's place (the control)."""
        from rtbench.reference import scene as ref_scene
        from rtbench.reference import trace as ref_trace

        run, cfg, p = self.run, self.cfg, self.p
        desc = ref_scene.SceneDescription(cfg["scene"])
        j, got = self.chosen
        state = ref_scene.ViewerState(desc, self.t0)
        for _ in range(j + 1):
            state.tick(self.dt, camera=bool(p["animate_camera"]), light=bool(p["animate_light"]),
                       geometry=bool(p["animate_geometry"]))
        scene = desc.scene(run.width / run.height, state.geometry_time, camera=state.camera,
                           light_position=state.light, device=run.device)
        ref = ref_trace.to_rgba8(ref_trace.render(scene, cfg["route"], run.width, run.height,
                                                  max_depth=int(cfg["max_depth"])))
        if stand_in is not None:
            got = ref_trace.to_rgba8(stand_in(desc, state))
        if not isinstance(got, torch.Tensor):
            got = torch.from_numpy(np.asarray(got))
        return {"present_gap_pct": compare.u8_gap_pct(got, ref),
                "frames_lost": self.result.attempted - self.result.frames}
