"""The harness driven end to end on the CPU at a tiny size (its look for a
card skipped): sound runs come out correct, and a run with the timed path
broken underneath comes out not correct, for each fault a cell can have."""

import pytest
import torch

from rtbench import core
from rtbench.tests.conftest import TINY, tiny_cell

SPEC = core.load_json(core.CHECKOUT / "BENCHMARK.json")
CELLS = tuple(w["name"] for w in SPEC["workloads"])
ANIM = tuple(c for c in CELLS if c.endswith(".anim64"))
VIEWER = tuple(c for c in CELLS if c.endswith(".viewer"))


def _names(metrics, cell):
    return {m["name"] for m in metrics if "workloads" not in m or cell in m["workloads"]}


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell, run_tiny):
    out = run_tiny(cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == _names(SPEC["end_to_end"], cell)


def _cpu_readable(name):
    # The CPU has no device trace: what the kernels did is read on the card.
    return not name.split(".")[0].startswith(("kernel_", "device_"))


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_the_per_layer_metrics(cell, run_tiny):
    out = run_tiny(cell, traced=True)
    assert out["correct"]
    wanted = {n for n in _names(SPEC["per_layer"], cell) if _cpu_readable(n)}
    assert wanted and wanted <= set(out["metrics"])
    assert not set(out["metrics"]) & _names(SPEC["end_to_end"], cell)
    assert out["device"]["window_s"] > 0
    if cell in VIEWER:
        assert {name for name, _ in out["breakdown"]["idle_gaps"]} & {"render", "scene", "tick"}


def _frozen_state(monkeypatch):
    """A step that returns its state unchanged: every frame renders the
    run's first animation state."""
    from gpuraytracer_tpu_torch.kernels import frame_state
    from gpuraytracer_tpu_torch.models import animate

    real = frame_state.advance
    first = {}

    def advance(pack, anim, arrays, times, index=0, **kw):
        first.setdefault("t", times[:1].clone())
        return real(pack, anim, arrays, first["t"], 0, **kw)

    monkeypatch.setattr(frame_state, "advance", advance)
    monkeypatch.setattr(animate.AnimationState, "tick", lambda self, dt, config: self)


def _half_left_out(monkeypatch):
    """Half of the batch left out: the lower half of every frame's rows."""
    from gpuraytracer_tpu_torch.render import trace

    real = trace.render_frame

    def render_frame(*a, **kw):
        img = real(*a, **kw).clone()
        img[img.shape[0] // 2:] = 0.0
        return img

    monkeypatch.setattr(trace, "render_frame", render_frame)


def _answer_altered(monkeypatch):
    """An answer altered where it is produced: each frame 2% brighter."""
    from gpuraytracer_tpu_torch.render import trace

    real = trace.render_frame
    monkeypatch.setattr(trace, "render_frame", lambda *a, **kw: real(*a, **kw) * 1.02)


FAULTS = {"frozen_state": _frozen_state, "half_left_out": _half_left_out,
          "answer_altered": _answer_altered}


def _half_the_frames_left_out(monkeypatch):
    """Half of a window's frames left out: every second frame is not
    rendered, and its image is the one before it."""
    from gpuraytracer_tpu_torch.render import trace

    real = trace.render_frame
    last = []

    def render_frame(*a, **kw):
        if len(last) % 2 == 0:
            last.append(real(*a, **kw))
        else:
            last.append(last[-1].clone())
        return last[-1]

    monkeypatch.setattr(trace, "render_frame", render_frame)


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, run_tiny, monkeypatch):
    FAULTS[fault](monkeypatch)
    # Seconds enough for a second window (or a few viewer frames), so that
    # the frame checked is not the run's very first.
    out = run_tiny(cell, seconds=4.0)
    assert not out["correct"], out["checks"]


def _window_run(cell, seed, **traffic):
    """A tiny run of a window cell, driven step by step: (its generator,
    the check's readings, the cell's limits)."""
    run = core.new_run(tiny_cell(cell, **traffic), seed, 0.3, False, device="cpu", size=TINY)
    gen = run.generator
    gen.setup()
    gen.window()
    gen.release()
    return gen, gen.check(), run.cell.limits["checks"]


@pytest.mark.parametrize("cell", ANIM)
def test_half_the_frames_left_out_fails_every_run_that_compares_one(cell, monkeypatch):
    """The program keeps every frame and is not told which is compared; a
    run fails where the seed's draw, made after the window, lands on a
    frame left out, which half of the draws do."""
    _half_the_frames_left_out(monkeypatch)
    outcomes = []
    for seed in range(2 ** 33, 2 ** 33 + 8):
        gen, found, limits = _window_run(cell, seed, frames_per_window=4)
        left_out = any(k % 2 for k in gen.compared)
        assert (found["frame_gap_pct"] > limits["frame_gap_pct"]["limit"]) == left_out, \
            (seed, gen.compared, found)
        outcomes.append(left_out)
    assert any(outcomes) and not all(outcomes)


def test_the_seed_sets_the_start_and_the_frames_compared():
    def drawn(seed):
        d = core.new_run(tiny_cell(ANIM[0], frames_per_window=64), seed, 0.0, False,
                         device="cpu", size=TINY).generator
        d.draw()
        return d.t0, d.frames_compared()

    a, b = drawn(2 ** 33 + 1), drawn(2 ** 33 + 2)
    assert a == drawn(2 ** 33 + 1) and a != b
    assert all(0.0 <= t0 < 60.0 for t0, _ in (a, b))
    assert all(0 <= k < 64 for _, ks in (a, b) for k in ks)
