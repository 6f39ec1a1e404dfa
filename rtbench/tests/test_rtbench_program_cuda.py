"""The port's spans and marks on the card (``python -m pytest rtbench/tests
-m cuda``): they share the profiler's clock, and nothing is loaded,
compiled or captured inside a cell's window."""

import json
import subprocess
import sys

import pytest
import torch

from rtbench import core, tracing

CELLS = tuple(w["name"] for w in core.load_json(core.CHECKOUT / "BENCHMARK.json")["workloads"])
TOLERANCE_S = 50e-6
SLEEP_CYCLES = 400_000  # about 0.2 ms at the H100's clock


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _device_ops(prof, spans):
    """The profiler's device events, (kind, name, start_s, end_s), over a
    window that holds every span."""
    window = ("window", min(s for _, s, _ in spans) - 1.0, max(e for _, _, e in spans) + 1.0)
    return sorted(tracing.Trace.from_profiler(prof, spans + [window]).device,
                  key=lambda d: d[2])


@pytest.mark.cuda
def test_a_span_contains_its_kernel_on_the_profiler_clock():
    from gpuraytracer_tpu_torch.utils import profile

    dev = _device()
    torch.cuda._sleep(SLEEP_CYCLES)  # loads the kernel before the profiler starts
    torch.cuda.synchronize(dev)
    prof = tracing.profiler(dev)
    prof.start()
    with profile.recording() as rec:
        for _ in range(8):
            with profile.span("probe"):
                torch.cuda._sleep(SLEEP_CYCLES)
                torch.cuda.synchronize(dev)
    prof.stop()
    spans = [(s.name, s.start_ns * 1e-9, s.end_ns * 1e-9) for s in rec.spans
             if s.name == "probe"]
    kernels = [d for d in _device_ops(prof, spans) if d[0] == "kernel"]
    assert len(spans) == len(kernels) == 8, kernels
    for (_, s, e), (_, name, ks, ke) in zip(spans, kernels):
        assert 0.0 <= ks - s <= TOLERANCE_S and 0.0 <= e - ke <= TOLERANCE_S, \
            (name, 1e6 * (ks - s), 1e6 * (e - ke))


@pytest.mark.cuda
def test_each_frames_device_start_mark_precedes_its_first_operation():
    from gpuraytracer_tpu_torch.parallel.pipeline import FramePipeline
    from gpuraytracer_tpu_torch.utils import profile

    dev = _device()
    x = torch.zeros(1024, device=dev)

    def frame():  # the frame's first device operation is the sleep
        torch.cuda._sleep(SLEEP_CYCLES)
        return x * 2

    pipe = FramePipeline(frame, 3, device=dev)
    frame()
    x.add_(1)
    torch.cuda.synchronize(dev)
    prof = tracing.profiler(dev)
    prof.start()
    with profile.recording() as rec:
        for i in range(24):
            with profile.span("apps.frame", frame=i):
                x.add_(1)  # the host's work before the frame, on the same stream
                pipe.submit()
        pipe.drain()
    prof.stop()
    assert [m.frame for m in rec.marks] == list(range(24))
    spans = [(s.name, s.start_ns * 1e-9, s.end_ns * 1e-9) for s in rec.spans]
    sleeps = [d for d in _device_ops(prof, spans) if "sleep" in d[1].lower()
              or "spin" in d[1].lower()]
    assert len(sleeps) == 24, sorted({d[1] for d in _device_ops(prof, spans)})
    for m, (_, _, ks, ke) in zip(rec.marks, sleeps):
        start, end = m.start_ns * 1e-9, m.end_ns * 1e-9
        assert 0.0 <= ks - start <= TOLERANCE_S, (m.frame, 1e6 * (ks - start))
        assert end >= ke - TOLERANCE_S and m.start_ns >= m.enqueue_ns
    # Three frames in flight of 0.2 ms each: later frames wait on the card.
    assert max(m.start_ns - m.enqueue_ns for m in rec.marks) > 100_000


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_nothing_is_loaded_or_captured_in_the_window(cell, tmp_path):
    _device()
    out_file = tmp_path / "program.json"
    proc = subprocess.run([sys.executable, "-m", "rtbench.tools.spans", "--workload", cell,
                           "--seed", "2147483671", "--seconds", "1", "--out", str(out_file)],
                          cwd=core.CHECKOUT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    program = json.loads(out_file.read_text())
    assert out["correct"], out["checks"]
    assert program["counters_in_window"] == {"LOADS": 0, "COMPILES": 0, "CAPTURES": 0}
    assert not {"render.capture", "kernels.load"} & set(program["names"])
    metrics = out["metrics"]
    assert metrics["setup_libs_s"]["value"] + metrics["setup_capture_s"]["value"] < \
        metrics["setup_s"]["value"]
    if cell.endswith(".viewer"):
        assert program["marks"] > 0 and "queue_wait_ms_p95.viewer" in metrics
