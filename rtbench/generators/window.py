"""Offline animation rendering: windows of animated frames, each one replay
of the port's window program (``render/program.animated_frames`` with a
checksum), in a closed loop.

The mix's parameters (``traffic/*.json``): ``frames_per_window`` n,
``frame_dt_s`` (frame i of the run at t0 + dt i, continuing across
windows), ``start_time_s`` (the range t0 is drawn from), ``in_flight``
(windows in flight: a window's checksum is read before the window that
many later is submitted), ``check_frames`` (frames of the compared window
that the check compares), ``min_frame_ms`` (sizes the table of frame
times) and ``warmup_windows`` (at least ``in_flight`` + 1: the set-up
holds as many windows' outputs at once as the window does). The window
submission is the port's bench's (``apps/bench_suite._timed_window``):
every frame feeds the device checksum, and the host reads a window's
checksum only when it has to.

Every window keeps every frame it renders (``keep`` is all of them), so
the program cannot tell which frame is compared. The seed draws t0, the
window the check compares (uniformly among the windows submitted, by
reservoir sampling as they are submitted) and, once the window has closed,
which of its frames.
"""

from __future__ import annotations

import collections
import math
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
        self.nonfinite = 0

    def setup(self) -> None:
        from gpuraytracer_tpu_torch.render import program

        run, cfg, p = self.run, self.cfg, self.p
        dev = run.device
        scene, animate = core.load_module("scenes", cfg["port_scene"]).build(cfg, dev)
        self.draw()
        n = int(p["frames_per_window"])
        self.depth = int(p["in_flight"])
        self.max_windows = math.ceil(run.seconds * 1e3 / (n * float(p["min_frame_ms"]))) + 2
        idx = np.arange(self.max_windows * n, dtype=np.float64)
        self.table_host = (self.t0 + float(p["frame_dt_s"]) * idx).astype(np.float32).reshape(
            self.max_windows, n)
        self.table = torch.from_numpy(self.table_host).to(dev)
        self.times = self.table[0].clone()
        self.prog = program.animated_frames(
            scene, animate, self.times, width=run.width, height=run.height,
            max_depth=int(cfg["max_depth"]), checksum=True, keep=tuple(range(n)),
            label=f"rtbench {run.cell.name}")
        self.prog.build()
        self._warm_up(int(p["warmup_windows"]))
        self.nonfinite = 0  # counted over the window only

    def _warm_up(self, windows: int) -> None:
        """Submit ``windows`` windows with as many outputs alive at once as
        the window holds at most (those in flight, the one submitted and
        the check's chosen one), so that the allocator holds their memory
        before the window."""
        held, inflight = [], collections.deque()
        for w in range(windows):
            if len(inflight) == self.depth:
                self._read(inflight.popleft())
            out = self._submit(w)
            (inflight if held else held).append(out)
        for out in (*held, *inflight):
            self._read(out)

    def draw(self) -> None:
        """What the seed sets before the window: t0; ``pick`` draws the
        window the check compares during the window and its frames after
        it (``frames_compared``)."""
        rng = np.random.default_rng(self.run.seed)
        self.t0 = float(rng.uniform(*self.p["start_time_s"]))
        self.pick = rng

    def frames_compared(self) -> tuple:
        """The frames of the chosen window that the check compares, drawn
        from the seed once the window has closed."""
        n = int(self.p["frames_per_window"])
        return tuple(sorted(int(k) for k in self.pick.choice(
            n, size=min(int(self.p["check_frames"]), n), replace=False)))

    def _submit(self, w: int):
        self.times.copy_(self.table[w])
        return self.prog()

    def _read(self, out) -> None:
        """Wait for a window by reading its checksum."""
        if not bool(torch.isfinite(out[0]).item()):
            self.nonfinite += 1

    def window(self) -> None:
        from gpuraytracer_tpu_torch.render import program

        n = int(self.p["frames_per_window"])
        before = program.counters()
        inflight = collections.deque()
        w, chosen = 0, None
        with tracing.span("window"):
            t_start = time.perf_counter()
            deadline = t_start + self.run.seconds
            while time.perf_counter() < deadline:
                if len(inflight) == self.depth:
                    with tracing.span("checksum_read"):
                        self._read(inflight.popleft()[1])
                if w >= self.max_windows:
                    raise RuntimeError(f"the table of frame times holds {self.max_windows} "
                                       f"windows: lower the mix's min_frame_ms")
                with tracing.span("submit"):
                    out = self._submit(w)
                inflight.append((w, out))
                if self.pick.random() * (w + 1) < 1.0:
                    chosen = (w, out[2:])
                w += 1
            while inflight:
                with tracing.span("checksum_read"):
                    self._read(inflight.popleft()[1])
            t_end = time.perf_counter()
        self.chosen = chosen
        self.compared = self.frames_compared()
        self.result = WindowResult(frames=w * n, seconds=t_end - t_start, attempted=w * n,
                                   launches=launches(before, program.counters()))

    def release(self) -> None:
        self.prog.close()
        self.prog = self.table = self.times = None

    def frames_to_check(self):
        """[(time, the program's (H, W, 4) f32 image)] of the frames
        compared."""
        w, images = self.chosen
        return [(float(self.table_host[w][k]), images[k]) for k in self.compared]

    def check(self, stand_in=None) -> dict:
        """{"frame_gap_pct": the largest share (%) of a compared frame's
        pixels off the reference (compare.f32_gap_pct), "nonfinite_windows":
        the windows whose checksum was not finite}. ``stand_in(desc, t)``,
        where given, renders the frame that is compared in the program's
        place (the control, control.stand_in)."""
        from rtbench.reference import scene as ref_scene
        from rtbench.reference import trace as ref_trace

        run, cfg = self.run, self.cfg
        desc = ref_scene.SceneDescription(cfg["scene"])
        gaps = []
        for t, img in self.frames_to_check():
            scene = desc.scene(run.width / run.height, t, device=run.device)
            ref = ref_trace.render(scene, cfg["route"], run.width, run.height,
                                   max_depth=int(cfg["max_depth"]))
            got = img if stand_in is None else stand_in(desc, t)
            gaps.append(compare.f32_gap_pct(got, ref))
            del ref
        return {"frame_gap_pct": max(gaps), "nonfinite_windows": self.nonfinite}
