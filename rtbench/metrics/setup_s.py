"""Seconds from the process start to the first timed frame: imports, the
port's kernel libraries, the scene, the cell's program captured and
warmed, pinned buffers."""


def read(run):
    return run.setup_s
