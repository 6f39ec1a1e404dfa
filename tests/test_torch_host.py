"""The port's host modules on the CPU, against the JAX package's own
functions where those need no JAX render: timers (utils/timers.py), the
native runtime (runtime/hostrt.{cpp,py}: clock, PNG encoder, async
writer), the frame pipeline, device selection, debug mode, recovery,
introspection, checkpoints, profiling, the config and the preview server
(apps/serve.py) at 16x9."""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from gpuraytracer_tpu.models import builtin as j_builtin
from gpuraytracer_tpu.runtime import hostrt as j_hostrt
from gpuraytracer_tpu.utils import introspect as j_introspect
from gpuraytracer_tpu.utils import png as j_png
from gpuraytracer_tpu.utils import timers as j_timers
from gpuraytracer_tpu_torch.apps import serve
from gpuraytracer_tpu_torch.core.config import RenderConfig
from gpuraytracer_tpu_torch.models import builtin
from gpuraytracer_tpu_torch.models.animate import AnimationState
from gpuraytracer_tpu_torch.parallel import device as device_mod
from gpuraytracer_tpu_torch.parallel.pipeline import FramePipeline
from gpuraytracer_tpu_torch.parallel.recovery import (
    DeviceLostError,
    DeviceTimeoutError,
    RecoveringExecutor,
)
from gpuraytracer_tpu_torch.render import trace
from gpuraytracer_tpu_torch.runtime import hostrt
from gpuraytracer_tpu_torch.utils import checkpoint, debug, introspect, png, profile, timers

RNG_SEED = 20261017


def _image(h, w, c, seed=RNG_SEED):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), dtype=np.uint8)


# -- timers -------------------------------------------------------------------

def _script(seed):
    """Clock deltas: ordinary frames, a pause past the clamp, deltas near the
    fixed step (the snap), zero deltas and enough time for fps windows."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.0, 0.05, 120).tolist() + [5.0, 0.0, 1 / 60, 1 / 60 + 1e-4, 0.3]
            + rng.uniform(0.0, 0.02, 60).tolist())


@pytest.mark.parametrize("fixed", [False, True], ids=["variable", "fixed"])
def test_step_timer_matches_the_reference(fixed):
    now = [0.0]
    port = timers.StepTimer(clock=lambda: now[0], fixed_time_step=fixed,
                            target_delta_seconds=1 / 60)
    ref = j_timers.StepTimer(clock=lambda: now[0], fixed_time_step=fixed,
                             target_delta_seconds=1 / 60)
    port_updates, ref_updates = [], []
    for delta in _script(7):
        now[0] += delta
        port.tick(port_updates.append)
        ref.tick(ref_updates.append)
        assert (port.elapsed_seconds, port.total_seconds, port.frame_count,
                port.frames_per_second, port._leftover) == \
            (ref.elapsed_seconds, ref.total_seconds, ref.frame_count, ref.frames_per_second,
             ref._leftover)
    assert port_updates == ref_updates
    assert port.frames_per_second > 0
    port.reset_elapsed_time()
    ref.reset_elapsed_time()
    assert (port._leftover, port.frames_per_second) == (ref._leftover, ref.frames_per_second)


def test_step_timer_clamps_and_accumulates_leftover_ticks():
    now = [0.0]
    t = timers.StepTimer(clock=lambda: now[0], fixed_time_step=True, target_delta_seconds=0.01)
    updates = []
    now[0] = 0.035
    t.tick(updates.append)
    assert len(updates) == 3 and t._leftover == pytest.approx(0.005)
    now[0] = 5.0  # a pause: the delta clamps to 0.1 s, ten more steps
    t.tick(updates.append)
    assert len(updates) == 13


def test_ema_timer_matches_the_reference():
    now = [0.0]
    port, ref = timers.EmaTimer(clock=lambda: now[0]), j_timers.EmaTimer(clock=lambda: now[0])
    for span in np.random.default_rng(3).uniform(0.001, 0.05, 40):
        port.start(), ref.start()
        now[0] += span
        assert port.stop() == ref.stop()
        assert (port.last_ms, port.average_ms) == (ref.last_ms, ref.average_ms)
    with pytest.raises(RuntimeError):
        port.stop()


def test_device_timer_on_the_cpu_is_the_host_ema_and_needs_cuda_for_events():
    now = [0.0]
    t = timers.DeviceTimer("cpu", clock=lambda: now[0])
    t.start()
    now[0] = 0.010
    assert t.stop() == pytest.approx(10.0)
    assert t.pending == 0 and t.samples == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            timers.DeviceTimer("cuda")


# -- native host runtime ------------------------------------------------------

def test_native_runtime_builds_and_its_clock_is_monotonic():
    assert hostrt.available()
    a = hostrt.now_seconds()
    b = hostrt.now_seconds()
    assert b >= a
    assert abs(hostrt.now_seconds() - time.monotonic()) < 1.0  # both CLOCK_MONOTONIC


@pytest.mark.parametrize("shape", [(1, 1, 4), (17, 23, 4), (5, 301, 3), (131, 200, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_png_bytes_equal_the_reference(tmp_path, shape):
    """Odd sizes, RGB and RGBA; 131x200x4 spans two stored deflate blocks."""
    img = _image(*shape)
    port_path, ref_path = tmp_path / "port.png", tmp_path / "ref.png"
    hostrt.write_png(str(port_path), img)
    j_hostrt.write_png(str(ref_path), img)
    assert port_path.read_bytes() == ref_path.read_bytes()
    np.testing.assert_array_equal(np.asarray(Image.open(port_path)), img)
    assert png.encode_png(img) == j_png.encode_png(img)


def test_rgba8_conversion_on_the_device_equals_the_host_bytes():
    rng = np.random.default_rng(RNG_SEED)
    img = rng.normal(0.5, 0.7, (9, 13, 4)).astype(np.float32)
    img[0, :4, 0] = [0.5, 1.0, 0.0, np.float32(128 / 256)]  # 127.5 rounds half to even
    want = j_png.image_f32_to_rgba8(img)
    np.testing.assert_array_equal(png.image_f32_to_rgba8(img), want)
    np.testing.assert_array_equal(png.image_to_rgba8(torch.from_numpy(img)).numpy(), want)


def test_async_writer_writes_every_frame_and_stays_bounded(tmp_path):
    img = _image(31, 47, 4)
    paths = [str(tmp_path / f"f{i}.png") for i in range(12)]
    peak = 0
    with hostrt.AsyncFrameWriter(2) as w:
        assert w.native
        for p in paths:
            w.submit(p, img)
            peak = max(peak, w.queued)
        w.drain()
        assert w.queued == 0
    assert peak <= 2 + 1  # the queue's depth plus the frame being written
    assert (w.frames_written, w.errors) == (12, 0)
    hostrt.write_png(str(tmp_path / "ref.png"), img)
    ref = (tmp_path / "ref.png").read_bytes()
    assert all(open(p, "rb").read() == ref for p in paths)


def test_async_writer_counts_a_failed_write(tmp_path):
    with hostrt.AsyncFrameWriter(2) as w:
        w.submit(str(tmp_path / "missing" / "f.png"), _image(4, 4, 4))
        w.submit(str(tmp_path / "ok.png"), _image(4, 4, 4))
    assert (w.frames_written, w.errors) == (1, 1)
    with hostrt.AsyncFrameWriter(1) as w, pytest.raises(ValueError):
        w.submit(str(tmp_path / "x.png"), np.zeros((4, 4), np.uint8))


def test_runtime_falls_back_to_python_without_the_library(tmp_path, monkeypatch):
    monkeypatch.setattr(hostrt, "_load", lambda: None)
    img = _image(5, 7, 4)
    hostrt.write_png(str(tmp_path / "a.png"), img)
    assert (tmp_path / "a.png").read_bytes() == png.encode_png(img)
    with hostrt.AsyncFrameWriter(2) as w:
        assert not w.native
        w.submit(str(tmp_path / "b.png"), img)
    assert (w.frames_written, w.errors) == (1, 0)
    assert hostrt.now_seconds() > 0


# -- frames in flight, devices ------------------------------------------------

def test_frame_pipeline_bounds_depth():
    calls = []

    def render(i):
        calls.append(i)
        return torch.tensor([i])

    pipe = FramePipeline(render, frames_in_flight=2, device="cpu")
    completed = []
    for i in range(5):
        _, done = pipe.submit(i)
        if done is not None:
            completed.append(int(done[0]))
    assert completed == [0, 1, 2] and calls == list(range(5))
    assert [int(r[0]) for r in pipe.drain()] == [3, 4]
    assert pipe.in_flight == 0
    with pytest.raises(ValueError):
        FramePipeline(render, frames_in_flight=0, device="cpu")


def test_pick_device():
    info = device_mod.pick_device("cpu")
    assert info.platform == "cpu" and info.is_software and info.device == torch.device("cpu")
    for name in ("auto", "tpu"):
        with pytest.raises(ValueError):
            device_mod.pick_device(name)
    if torch.cuda.is_available():
        assert device_mod.pick_device("cuda").platform == "cuda"
    else:
        with pytest.raises(RuntimeError):
            device_mod.pick_device("cuda")
        with pytest.raises(RuntimeError):
            FramePipeline(lambda: None, device="cuda")


# -- debug mode ---------------------------------------------------------------

def test_validate_frame():
    debug.validate_frame(torch.ones(4, 4, 4))
    bad = torch.ones(4, 4, 4)
    bad[0, 0, 0] = float("nan")
    with pytest.raises(AssertionError):
        debug.validate_frame(bad)
    with pytest.raises(AssertionError):
        debug.validate_frame(-torch.ones(4, 4, 4))
    with pytest.raises(AssertionError):
        debug.validate_frame(torch.ones(4, 4, 3))


def test_checked_and_the_debug_layer_context():
    f = debug.checked(lambda x: x * 2.0)
    assert float(f(torch.tensor(2.0))) == 4.0
    with pytest.raises(FloatingPointError, match="output of"):
        debug.checked(lambda x: x / 0.0 * 0.0)(torch.tensor(1.0))
    assert not debug.nan_checks_enabled()
    with debug.debug_layer(nan_checks=True):
        assert debug.nan_checks_enabled()
        with debug.debug_layer(nan_checks=False):
            assert not debug.nan_checks_enabled()
    assert not debug.nan_checks_enabled()


def test_nan_trap_names_the_pass():
    """A NaN light: the shadow gate (kd > 0) is false on every lane, so the
    first pass whose outputs go non-finite is level 0's shading."""
    scene = builtin.build_scene(aspect=1.0, elapsed_time=0.7, light_position=(0.0, float("nan"),
                                                                             -20.0, 0.0),
                                device="cpu")
    img = trace.render_frame(scene, 2, 2, max_depth=2)
    with pytest.raises(AssertionError):
        debug.validate_frame(img)
    with debug.debug_layer():
        with pytest.raises(FloatingPointError, match="level 0 shading"):
            trace.render_frame(scene, 2, 2, max_depth=2)


# -- recovery -----------------------------------------------------------------

def _flaky(failures, error, value=lambda x: x * 10):
    """make_step whose first ``failures`` builds raise ``error``."""
    builds = []

    def make_step():
        builds.append(1)
        n = len(builds)

        def step(x):
            if n <= failures:
                raise error
            return value(x)

        return step

    return make_step


def test_recovery_passthrough():
    ex = RecoveringExecutor(lambda: (lambda x: x + 1))
    assert ex(1) == 2 and ex.recoveries == 0


@pytest.mark.parametrize("error", [
    RuntimeError("frame kernel launch failed: CUDA error 9 (invalid configuration argument)"),
    torch.AcceleratorError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"),
], ids=["launch", "accelerator", "oom"])
def test_recovery_rebuilds_after_a_cuda_error(error):
    lost, restored = [], []
    ex = RecoveringExecutor(_flaky(2, error), max_retries=3, retry_delay_seconds=0.0,
                            on_device_lost=lambda: lost.append(1),
                            on_device_restored=lambda: restored.append(1))
    assert ex(2) == 20
    assert ex.recoveries == 2 and len(lost) == len(restored) == 2


def test_recovery_gives_up():
    ex = RecoveringExecutor(_flaky(10, RuntimeError("CUDA error: unspecified launch failure")),
                            max_retries=1, retry_delay_seconds=0.0)
    with pytest.raises(DeviceLostError):
        ex(1)


@pytest.mark.parametrize("error", [
    ValueError("bad frame size"), TypeError("expected a Scene"),
    NotImplementedError("distance code 12 has no CUDA device function"),
    RuntimeError("The size of tensor a (3) must match the size of tensor b (4)"),
    ConnectionResetError("socket reset"),
], ids=["value", "type", "not-implemented", "shape", "oserror"])
def test_programming_errors_stay_fatal(error):
    ex = RecoveringExecutor(_flaky(1, error), max_retries=3, retry_delay_seconds=0.0)
    with pytest.raises(type(error)):
        ex(1)
    assert ex.recoveries == 0


def test_watchdog_times_out_a_wedged_step():
    release = threading.Event()

    def wedge():
        release.wait(timeout=30.0)  # wedged until abandoned

    builds = []

    def make_step():
        builds.append(1)
        first = len(builds) == 1
        return lambda x: (wedge(), x * 7)[1] if first else x * 7

    ex = RecoveringExecutor(make_step, max_retries=2, retry_delay_seconds=0.0,
                            watchdog_seconds=1.0)
    try:
        assert ex(1) == 7 and ex.recoveries == 1
    finally:
        release.set()
        ex.close()
    assert issubclass(DeviceTimeoutError, RuntimeError)


# -- introspection, checkpoints, config, profiling ------------------------------

def test_describe_scene_is_the_reference_text():
    port = introspect.describe_scene(builtin.build_scene(aspect=1.0, device="cpu"))
    ref = j_introspect.describe_scene(j_builtin.build_scene(aspect=1.0, elapsed_time=0.0))
    assert port == ref
    assert "10 procedural geometries + ground plane" in port and "GROUND_PLANE" in port
    backend = introspect.describe_backend(builtin.build_scene(aspect=1.0, device="cpu"))
    assert "torch" in backend and "route=" in backend


def test_checkpoint_roundtrip_and_resume(tmp_path):
    cfg = RenderConfig(width=320, height=180, animate_camera=True, animate_light=True)
    state = AnimationState.initial().tick(0.5, cfg)
    path = str(tmp_path / "ckpt.json")
    checkpoint.save(path, state, cfg, frame_index=42)
    assert not (tmp_path / "ckpt.json.tmp").exists()
    assert json.loads((tmp_path / "ckpt.json").read_text())["format_version"] == 1
    state2, cfg2, idx = checkpoint.load(path)
    assert (idx, cfg2) == (42, cfg)
    assert state2.geometry_time == state.geometry_time
    np.testing.assert_array_equal(state2.camera.eye, state.camera.eye)
    np.testing.assert_array_equal(state2.light_position, state.light_position)
    a, b = state.tick(0.5, cfg), state2.tick(0.5, cfg)
    assert a.geometry_time == b.geometry_time
    np.testing.assert_array_equal(a.camera.up, b.camera.up)
    bad = json.loads((tmp_path / "ckpt.json").read_text())
    bad["format_version"] = 2
    (tmp_path / "bad.json").write_text(json.dumps(bad))
    with pytest.raises(ValueError):
        checkpoint.load(str(tmp_path / "bad.json"))


def test_render_config():
    cfg = RenderConfig()
    assert (cfg.width, cfg.height, cfg.frames_in_flight, cfg.output_format, cfg.device) == \
        (1280, 720, 3, "float32", "cuda")
    assert cfg.with_size(64, 32).aspect_ratio == 2.0
    assert cfg.replace(frames_in_flight=1).frames_in_flight == 1


def test_profile_trace_and_device_summary(tmp_path):
    with profile.trace(str(tmp_path)), profile.recording() as rec:
        with profile.span("work"):
            torch.ones(4) + 1
    assert (tmp_path / profile.TRACE_FILE).stat().st_size > 0
    assert [s.name for s in rec.spans if s.name != "gc"] == ["work"]
    events = [{"ph": "X", "cat": "kernel", "name": "a", "ts": 0, "dur": 10},
              {"ph": "X", "cat": "kernel", "name": "b", "ts": 5, "dur": 10},
              {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 30, "dur": 10},
              {"ph": "X", "cat": "cpu_op", "name": "d", "ts": 0, "dur": 100}]
    (tmp_path / "t.json").write_text(json.dumps({"traceEvents": events}))
    s = profile.device_summary(str(tmp_path / "t.json"), top=2)
    assert s["busy_ms"] == pytest.approx(0.025) and s["span_ms"] == pytest.approx(0.040)
    assert s["busy_share"] == pytest.approx(0.625)
    assert [n for n, _, _ in s["top"]] == ["a", "b"]


# -- the preview server ---------------------------------------------------------

def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, b""


def test_preview_server_on_the_cpu():
    srv = serve.PreviewServer(16, 9, device="cpu", host="127.0.0.1", port=0).start()
    try:
        deadline = time.monotonic() + 120
        code, body = _get(srv.port, "/frame.png")
        while code != 200 and time.monotonic() < deadline:
            time.sleep(0.05)
            code, body = _get(srv.port, "/frame.png")
        assert code == 200, srv.state.status
        assert Image.open(io.BytesIO(body)).size == (16, 9)
        assert _get(srv.port, "/stats")[1].startswith(b"fps:")
        assert _get(srv.port, "/resize?w=4&h=4")[0] == 400
        assert _get(srv.port, "/resize?w=8000&h=100")[0] == 400
        assert _get(srv.port, "/resize?w=x&h=9")[0] == 400
        assert _get(srv.port, "/")[0] == 200
    finally:
        srv.close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            serve.PreviewServer(16, 9, device="cuda", host="127.0.0.1", port=0)
