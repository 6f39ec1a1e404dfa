"""The frame's least time on the card over its kernel time, in %: the
bound per frame of the configuration's frozen work count
(work/<config>.json: max(FLOPs / 67 TFLOP/s, bytes / 3.35 TB/s)) over
kernel_ms_per_frame. No work file, no reading."""

from rtbench import core


def read(run):
    if run.work is None or run.trace is None or not run.trace.kernel_s:
        return None
    kernel_ms = core.load_module("metrics", "kernel_ms_per_frame").read(run)
    return 100.0 * run.work["bound_ms_per_frame"] / kernel_ms
