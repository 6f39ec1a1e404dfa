"""The benchmark's own tests (``python -m pytest rtbench/tests``): on the
CPU at tiny sizes, and, marked ``cuda``, on the card. They import neither
JAX nor the JAX package."""

import dataclasses

import pytest

from rtbench import core

TINY = (24, 16)


def tiny_cell(name: str, **traffic) -> core.Cell:
    """A cell of BENCHMARK.json with its traffic's windows cut to a CPU's
    pace (``traffic`` overrides)."""
    cell = core.Cell.find(name)
    p = dict(cell.traffic)
    if p["generator"] == "window":
        p.update(frames_per_window=3, warmup_windows=0)
    else:
        p.update(warmup_frames=1)
    p.update(traffic)
    return dataclasses.replace(cell, traffic=p)


@pytest.fixture
def run_tiny():
    def run(name, seed=20261018, seconds=0.05, traced=False, **traffic):
        return core.execute(tiny_cell(name, **traffic), seed, seconds, traced, device="cpu",
                            t_start=0.0, size=TINY)

    return run
