"""Seconds of set-up spent capturing the port's frame programs (each
program's eager warm-up run, its CUDA graph's capture and instantiation),
less the kernel libraries loaded inside them, which setup_libs_s counts:
the port's set-up counter render/program.CAPTURE_SECONDS, read after the
window, where it holds what set-up captured (nothing is captured inside
the window). None where the port has no such counter."""

import importlib


def read(run):
    program = importlib.import_module("gpuraytracer_tpu_torch.render.program")
    return getattr(program, "CAPTURE_SECONDS", None)
