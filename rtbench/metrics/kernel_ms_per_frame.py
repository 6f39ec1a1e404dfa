"""Device kernel time per frame, in ms: the summed durations of the
kernels the profiler saw inside the traced window, over its frames."""


def read(run):
    if run.trace is None or not run.trace.kernel_s or not run.generator.result.frames:
        return None
    return 1e3 * run.trace.kernel_s / run.generator.result.frames
