"""CLI renderer: animate, render and write PNG frames of the builtin scene.

Port of gpuraytracer_tpu/apps/render_cli.py: each frame ticks the
animation state (Renderer::on_update), builds the scene and renders it.

Usage:
  python -m gpuraytracer_tpu_torch.apps.render_cli --device cuda \
      --width 1920 --height 1080 --frames 16 --out out/frames

``--device cuda`` renders through the CUDA frame kernel and fails when no
GPU is present; ``--device cpu`` renders through the PyTorch wavefront.
Frames advance by a fixed time step, so a run is reproducible.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from gpuraytracer_tpu_torch.utils import png
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
    p.add_argument("--dt", type=float, default=1.0 / 60.0, help="time step per frame (s)")
    p.add_argument("--depth", type=int, default=3, help="max recursion depth")
    p.add_argument("--animate-camera", action="store_true")
    p.add_argument("--animate-light", action="store_true")
    p.add_argument("--no-animate-geometry", action="store_true")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from gpuraytracer_tpu_torch.core.config import RenderConfig
    from gpuraytracer_tpu_torch.models.animate import AnimationState
    from gpuraytracer_tpu_torch.render import trace

    config = RenderConfig(
        width=args.width, height=args.height, max_recursion_depth=args.depth,
        animate_geometry=not args.no_animate_geometry,
        animate_camera=args.animate_camera, animate_light=args.animate_light,
        device=args.device,
    )
    dev = torch.device(config.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log.info("device: %s (%s)", dev, name)
    os.makedirs(args.out, exist_ok=True)
    state = AnimationState.initial()
    state.geometry_time = args.time
    for i in range(args.frames):
        start = time.perf_counter()
        scene = state.scene(config.aspect_ratio, device=dev)
        img = trace.render_frame(scene, config.width, config.height,
                                 max_depth=config.max_recursion_depth).cpu()  # waits
        ms = (time.perf_counter() - start) * 1e3
        path = os.path.join(args.out, f"frame_{i:05d}.png")
        png.write_png(path, img.numpy())
        log.info("frame %d t=%.4f s: %.2f ms (host clock, incl. copy) -> %s",
                 i, state.geometry_time, ms, path)
        state = state.tick(args.dt, config)
    log.info("rendered %d frame(s) at %dx%d on %s -> %s",
             args.frames, args.width, args.height, name, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
