"""Seconds of set-up spent loading the port's kernel libraries (the hash
of their sources, nvcc where it ran, ctypes.CDLL): the port's set-up
counter kernels/build.LOAD_SECONDS, read after the window, where it holds
what set-up loaded (nothing loads inside the window). None where the port
has no such counter."""

import importlib


def read(run):
    build = importlib.import_module("gpuraytracer_tpu_torch.kernels.build")
    return getattr(build, "LOAD_SECONDS", None)
