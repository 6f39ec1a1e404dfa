"""The port's spans taken into a traced run (``rtbench.tools.spans``), on
the CPU at a tiny size: the program's metrics and breakdown where the port
has the recorder, and the harness's run unchanged where it has none (as
on a port from before the recorder)."""

import pytest

from rtbench import core, tracing
from rtbench.generators import WindowResult
from rtbench.tests.conftest import TINY, tiny_cell
from rtbench.tools import spans

SPEC = core.load_json(core.CHECKOUT / "BENCHMARK.json")
VIEWER = next(w["name"] for w in SPEC["workloads"] if w["name"].endswith(".viewer"))
HOST_SPAN_METRICS = {"scene_host_ms_per_frame.viewer", "render_host_ms_per_frame.viewer",
                     "present_host_ms_per_frame.viewer"}
SET_UP_METRICS = {"setup_libs_s", "setup_capture_s"}
NEW = HOST_SPAN_METRICS | SET_UP_METRICS | {"queue_wait_ms_p95.viewer"}


def _old_cpu_readable(cell):
    return {m["name"] for m in SPEC["per_layer"]
            if ("workloads" not in m or cell in m["workloads"]) and m["name"] not in NEW
            and not m["name"].split(".")[0].startswith(("kernel_", "device_"))}


def _run_spans(seed=20261019):
    return spans.execute(tiny_cell(VIEWER), seed, 0.05, device="cpu", t_start=0.0, size=TINY)


def test_a_traced_tiny_viewer_run_takes_the_program_spans_in():
    out, program = _run_spans()
    assert out["correct"], out["checks"]
    got = set(out["metrics"])
    assert HOST_SPAN_METRICS | SET_UP_METRICS | _old_cpu_readable(VIEWER) <= got
    assert "queue_wait_ms_p95.viewer" not in got  # the CPU has no device marks
    assert out["metrics"]["scene_host_ms_per_frame.viewer"]["value"] > 0
    idle = {name for name, _ in out["breakdown"]["idle_gaps"]}
    assert idle & {"models.transforms", "models.constants", "render.frame", "apps.present"}
    assert {"apps.frame", "models.tick", "models.scene", "apps.present"} <= set(program["names"])
    assert program["counters_in_window"] == {"LOADS": 0, "COMPILES": 0, "CAPTURES": 0}
    assert program["marks"] == 0 and program["queue_wait_ms"] is None


def test_without_the_recorder_the_runs_are_the_harness_alone(monkeypatch):
    from gpuraytracer_tpu_torch.kernels import build
    from gpuraytracer_tpu_torch.render import program as port_program
    from gpuraytracer_tpu_torch.utils import profile

    monkeypatch.delattr(profile, "recording")
    monkeypatch.delattr(build, "LOAD_SECONDS")
    monkeypatch.delattr(port_program, "CAPTURE_SECONDS")
    out, program = _run_spans()
    assert out["correct"], out["checks"]
    assert _old_cpu_readable(VIEWER) <= set(out["metrics"])
    assert not set(out["metrics"]) & NEW and program == {}
    out = core.execute(tiny_cell(VIEWER), 20261019, 0.05, True, device="cpu", t_start=0.0,
                       size=TINY)
    assert out["correct"] and _old_cpu_readable(VIEWER) <= set(out["metrics"])
    assert not set(out["metrics"]) & NEW


def _run(trace, frames=4):
    class D:
        result = WindowResult(frames=frames, seconds=1.0, attempted=frames, launches=4)

    return core.Run(cell=None, seed=0, seconds=1.0, traced=True, device=None, width=2,
                    height=2, generator=D(), trace=trace)


def test_the_program_readers():
    t = tracing.Trace(device=[], spans=[("scene", 0.0, 0.5), ("models.scene", 0.1, 0.3),
                                        ("models.scene", 0.6, 0.7), ("apps.present", 0.8, 0.9)],
                      window=(0.0, 1.0))
    run = _run(t)
    read = {name: core.load_module("metrics", name).read for name in NEW}
    assert read["scene_host_ms_per_frame.viewer"](run) == pytest.approx(75.0)
    assert read["present_host_ms_per_frame.viewer"](run) == pytest.approx(25.0)
    assert read["render_host_ms_per_frame.viewer"](run) is None
    assert read["queue_wait_ms_p95.viewer"](run) is None
    t.marks = [(i, 0.0, 0.001 * i, 0.5) for i in range(1, 21)]
    assert read["queue_wait_ms_p95.viewer"](run) == pytest.approx(19.0)
    for name in NEW - SET_UP_METRICS:
        assert read[name](_run(None)) is None
