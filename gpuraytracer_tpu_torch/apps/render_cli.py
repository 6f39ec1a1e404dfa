"""CLI renderer: the main.cpp + Window frame-loop analog.

Port of gpuraytracer_tpu/apps/render_cli.py. Each frame steps the
reference's per-frame sequence: tick the timer, animate the state
(Renderer::on_update), upload the constants, trace, present. The state is
ticked before the frame renders, so frame i of a run from ``--time t``
with ``--dt dt`` is at t + (i+1)*dt. Without ``--dt`` the step is the wall
clock's (utils/timers.StepTimer, clamped to 0.1 s).

Frames in flight: the frame loop never waits for the card inside a frame.
The per-frame constants go up through pinned memory (core/upload.py), each
frame's image is converted to RGBA8 on the device and copied to pinned host
memory on the same stream, and the pipeline (parallel/pipeline.py) waits
only on the CUDA event of the frame ``--frames-in-flight`` frames back. The
host reads a frame's bytes only after the pipeline has returned it as
completed, and hands them to the native async PNG writer
(runtime/hostrt.py), which encodes and writes while the card renders. A
status line in the reference's window-title format is logged once a
second.

Usage:
  python -m gpuraytracer_tpu_torch.apps.render_cli --device cuda \
      --width 1920 --height 1080 --frames 16 --out out/frames

``--device cuda`` (the default) renders through the CUDA kernels and fails
when no GPU is present; ``--device cpu`` renders through the PyTorch
wavefront. ``--checkpoint PATH`` saves the animation state after the run,
``--resume PATH`` continues from one (the frame numbers continue too).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from gpuraytracer_tpu_torch.utils import profile
from gpuraytracer_tpu_torch.utils.log import get_logger

log = get_logger("render_cli")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="torch device: cuda, cuda:N or cpu")
    p.add_argument("--width", type=int, default=1280)  # main.cpp:14 defaults
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--out", type=str, default="out/frames")
    p.add_argument("--time", type=float, default=0.0, help="animation start time (s)")
    p.add_argument("--dt", type=float, default=None,
                   help="fixed time step (s); default: the wall clock")
    p.add_argument("--depth", type=int, default=3, help="max recursion depth")
    p.add_argument("--animate-camera", action="store_true")
    p.add_argument("--animate-light", action="store_true")
    p.add_argument("--no-animate-geometry", action="store_true")
    p.add_argument("--frames-in-flight", type=int, default=3)
    p.add_argument("--checkpoint", type=str, default="",
                   help="write the animation state here after the run")
    p.add_argument("--resume", type=str, default="",
                   help="resume the animation state from a checkpoint file")
    return p.parse_args(argv)


def tick(state, config, dt=None, timer=None):
    """The next frame's state: ticked by ``dt``, or by the timer's wall-clock
    step when ``dt`` is None."""
    if dt is not None:
        return state.tick(dt, config)
    timer.tick()
    return state.tick(timer.elapsed_seconds, config)


def frame_loop(pipe, state, config, frames, *, dt=None, timer=None, on_frame=None):
    """The frame loop over the frame indices ``frames``: tick the state,
    build its scene on the pipeline's device, submit it. ``on_frame(i,
    out)`` gets each frame's output as the pipeline returns it completed,
    oldest first; the frames still in flight stay in the pipeline (drain
    it: they are the last ``pipe.in_flight`` indices). Returns the last
    state. Each frame's body is an ``apps.frame`` span (utils/profile.py)
    with the frame's index."""
    for i in frames:
        with profile.span("apps.frame", frame=i):
            state = tick(state, config, dt, timer)
            _, done = pipe.submit(state.scene(config.aspect_ratio, device=pipe.device))
            if done is not None and on_frame is not None:
                on_frame(i - pipe.depth, done)
    return state


def frame_to_host(config, device):
    """The pipeline's frame function: render the scene's arrays through
    ``trace.make_renderer`` over the builtin layout (the reference's CLI,
    apps/render_cli.py:99 there: on a GPU a replay of the captured frame
    program), then, on a GPU, convert the image to RGBA8 on the card and
    enqueue its copy into pinned host memory on the same stream (valid once
    the frame's event has completed); on the CPU, the reference's host
    conversion. The conversion and the copy are an ``apps.present`` span
    (utils/profile.py)."""
    from gpuraytracer_tpu_torch.models import builtin
    from gpuraytracer_tpu_torch.render import trace
    from gpuraytracer_tpu_torch.utils import png

    renderer = trace.make_renderer(builtin.LAYOUT, config.width, config.height,
                                   max_depth=config.max_recursion_depth)

    def render(scene):
        img = renderer(scene.arrays)
        with profile.span("apps.present"):
            if device.type != "cuda":
                return png.image_f32_to_rgba8(img.numpy())
            rgba = png.image_to_rgba8(img)
            host = torch.empty(rgba.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(rgba, non_blocking=True)
            return host

    return render


def main(argv=None) -> int:
    args = parse_args(argv)
    from gpuraytracer_tpu_torch.core.config import RenderConfig
    from gpuraytracer_tpu_torch.models.animate import AnimationState
    from gpuraytracer_tpu_torch.parallel import device as device_mod
    from gpuraytracer_tpu_torch.parallel.pipeline import FramePipeline
    from gpuraytracer_tpu_torch.runtime import hostrt
    from gpuraytracer_tpu_torch.utils import checkpoint, introspect
    from gpuraytracer_tpu_torch.utils.stats import FrameStats
    from gpuraytracer_tpu_torch.utils.timers import StepTimer

    config = RenderConfig(
        width=args.width, height=args.height, max_recursion_depth=args.depth,
        animate_geometry=not args.no_animate_geometry,
        animate_camera=args.animate_camera, animate_light=args.animate_light,
        device=args.device, frames_in_flight=args.frames_in_flight,
    )
    info = device_mod.pick_device(config.device)
    log.info("device: %s", info.description)
    os.makedirs(args.out, exist_ok=True)

    start_frame = 0
    if args.resume:
        state, _, start_frame = checkpoint.load(args.resume)
        log.info("resumed at frame %d, t=%.3f s", start_frame, state.geometry_time)
    else:
        state = AnimationState.initial()
        state.geometry_time = args.time
    scene0 = state.scene(config.aspect_ratio, device=info.device)
    log.info("%s", introspect.describe_backend(scene0))
    for line in introspect.describe_scene(scene0).splitlines():
        log.info("%s", line)

    pipe = FramePipeline(frame_to_host(config, info.device), config.frames_in_flight,
                         device=info.device)
    stats = FrameStats(config.width, config.height,
                       on_update=lambda s: log.info("%s", stats.status_line(info.description)))
    timer = StepTimer(fixed_time_step=args.dt is not None,
                      target_delta_seconds=args.dt or (1.0 / 60.0))
    writer = hostrt.AsyncFrameWriter(config.frames_in_flight)

    def flush(i, rgba):
        writer.submit(os.path.join(args.out, f"frame_{i:05d}.png"), np.asarray(rgba))
        stats.frame_rendered()

    end = start_frame + args.frames
    try:
        state = frame_loop(pipe, state, config, range(start_frame, end), dt=args.dt,
                           timer=timer, on_frame=flush)
        rest = pipe.drain()
        for i, rgba in zip(range(end - len(rest), end), rest):
            flush(i, rgba)
    finally:
        writer.close()
    if writer.errors:
        log.error("%d of %d frame(s) failed to write", writer.errors, args.frames)
        return 1

    if args.checkpoint:
        checkpoint.save(args.checkpoint, state, config, end)
        log.info("checkpoint -> %s", args.checkpoint)
    log.info("rendered %d frame(s) at %dx%d on %s -> %s (%s writer)", args.frames,
             config.width, config.height, info.description, args.out,
             "native" if hostrt.available() else "Python")
    return 0


if __name__ == "__main__":
    sys.exit(main())
