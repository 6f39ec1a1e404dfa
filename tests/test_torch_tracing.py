"""The port's span and counter recorder (utils/profile.py) on the CPU: the
no-op outside a recording, spans nested with their parents and frame ids,
the collector's passes, the viewer's frame loop by layer, and the set-up
counters of kernels/build.py and render/program.py."""

import gc
import time
from pathlib import Path
from unittest import mock

import pytest
import torch

from gpuraytracer_tpu_torch.apps import render_cli
from gpuraytracer_tpu_torch.core.config import RenderConfig
from gpuraytracer_tpu_torch.kernels import build
from gpuraytracer_tpu_torch.models.animate import AnimationState
from gpuraytracer_tpu_torch.parallel.pipeline import FramePipeline
from gpuraytracer_tpu_torch.render import program, trace
from gpuraytracer_tpu_torch.utils import profile


def _no_clock():
    raise AssertionError("the clock was read outside a recording")


def test_span_outside_a_recording_is_the_shared_no_op(monkeypatch):
    assert profile.recording_now() is None
    monkeypatch.setattr(profile.time, "time_ns", _no_clock)
    off = profile.span("apps.frame", frame=3)
    assert off is profile.span("models.scene")
    with off as inside:
        assert inside is None
    profile.record("parallel.fence_wait", 0, 1)
    monkeypatch.undo()
    with profile.recording() as rec:
        pass
    assert [s.name for s in rec.spans if s.name != "gc"] == []
    assert profile.recording_now() is None


def test_spans_nest_with_parents_and_frame_ids_and_gc_passes():
    with profile.recording() as rec:
        with pytest.raises(RuntimeError):
            with profile.recording():
                pass
        with profile.span("apps.frame", frame=7):
            with profile.span("models.scene") as scene:
                with profile.span("models.tables", n=2):
                    pass
            profile.record("parallel.fence_wait", scene.end_ns, scene.end_ns + 1000)
            gc.collect(0)
        with profile.span("kernels.load", lib="x"):
            pass
    spans = {s.name: s for s in rec.spans}
    frame, tables = spans["apps.frame"], spans["models.tables"]
    assert [s.seq for s in rec.spans] == sorted(s.seq for s in rec.spans)
    assert frame.parent is None and frame.frame == 7
    assert spans["models.scene"].parent == frame.seq
    assert tables.parent == spans["models.scene"].seq
    assert tables.frame == 7 and tables.attrs == {"n": 2}
    assert spans["parallel.fence_wait"].parent == frame.seq
    assert spans["kernels.load"].frame is None and spans["kernels.load"].attrs == {"lib": "x"}
    assert frame.start_ns <= tables.start_ns <= tables.end_ns <= frame.end_ns
    passes = [s for s in rec.spans if s.name == "gc" and s.parent == frame.seq]
    assert any(s.attrs["generation"] == 0 for s in passes)
    assert all(s.frame == 7 and "collected" in s.attrs for s in passes)
    n, seconds, own = rec.by_name()["apps.frame"]
    children = sum(s.seconds for s in rec.spans if s.parent == frame.seq)
    assert n == 1 and own == pytest.approx(seconds - children, abs=1e-9)
    assert profile.recording_now() is None and rec._gc not in gc.callbacks


def test_recording_keeps_nothing_the_collector_counts():
    # What the collector tracks and keeps brings its passes on sooner.
    gc.disable()
    try:
        with profile.recording() as rec:
            before = gc.get_count()[0]
            for i in range(500):
                with profile.span("apps.frame", frame=i):
                    with profile.span("models.scene"):
                        pass
                    profile.record("parallel.fence_wait", i, i + 1)
            grown = gc.get_count()[0] - before
    finally:
        gc.enable()
    assert len(rec.spans) == 1500 and grown < 10


def test_frame_loop_records_each_frame_by_layer(monkeypatch):
    # The frame itself is a stand-in: the loop's spans are what is checked.
    monkeypatch.setattr(trace, "render_frame",
                        lambda scene, w, h, **kw: torch.zeros((h, w, 4)))
    config = RenderConfig(width=8, height=6, max_recursion_depth=1, device="cpu",
                          frames_in_flight=2)
    pipe = FramePipeline(render_cli.frame_to_host(config, torch.device("cpu")), 2,
                         device="cpu")
    with profile.recording() as rec:
        render_cli.frame_loop(pipe, AnimationState.initial(), config, range(5, 8), dt=1 / 60)
        pipe.drain()
    assert rec.marks == []
    names = ("apps.frame", "models.tick", "models.scene", "models.constants",
             "models.transforms", "models.tables", "render.frame", "apps.present")
    for i in (5, 6, 7):
        got = [s.name for s in rec.spans if s.frame == i and s.name != "gc"]
        assert sorted(got) == sorted(names), (i, got)
    name = {s.seq: s.name for s in rec.spans}
    parents = {s.name: name[s.parent] for s in rec.spans
               if s.frame == 5 and s.parent is not None}
    assert parents["models.transforms"] == "models.scene"
    assert parents["apps.present"] == parents["models.scene"] == "apps.frame"


def test_set_up_counters_count_loads_compiles_and_captures(monkeypatch):
    assert not {name for _, name in program.counters()} & {
        "LOADS", "COMPILES", "LOAD_SECONDS", "CAPTURES", "CAPTURE_SECONDS"}

    def compile_kernel(name, *variant):
        t = time.perf_counter()
        while time.perf_counter() - t < 0.005:
            pass
        return Path("lib_tracing_test.so"), ""

    monkeypatch.setattr(build, "compile_kernel", compile_kernel)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: mock.MagicMock())
    monkeypatch.setattr(program.FrameProgram, "_capture_graph",
                        lambda self: build.load("tracing_test_lib", defines=(self.label,)))
    before = (build.LOADS, build.LOAD_SECONDS, program.CAPTURES, program.CAPTURE_SECONDS)
    with profile.recording() as rec:
        program.FrameProgram(lambda: None, "cpu", label=f"counted {time.time_ns()}")._capture()
    loads, load_s, captures, capture_s = (
        a - b for a, b in zip((build.LOADS, build.LOAD_SECONDS, program.CAPTURES,
                               program.CAPTURE_SECONDS), before))
    assert (loads, captures) == (1, 1)
    assert load_s >= 0.005 and 0.0 <= capture_s < load_s
    spans = {s.name: s for s in rec.spans}
    assert spans["kernels.load"].parent == spans["render.capture"].seq
    assert spans["kernels.load"].attrs == {"lib": "tracing_test_lib"}


def test_compiles_counts_nvcc_runs_only(monkeypatch, tmp_path):
    ran = []
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "run", lambda cmd, **kw: ran.append(cmd) or
                        build.subprocess.CompletedProcess(cmd, 0, "", "ptxas info"))
    before = build.COMPILES
    build.compile_kernel("frame_state")
    build.compile_kernel("frame_state")  # the build exists: no nvcc
    assert build.COMPILES - before == len(ran) == 1
