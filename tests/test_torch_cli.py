"""The port's CLI (gpuraytracer_tpu_torch/apps/render_cli.py) on the CPU at
8x8, against the JAX package's host code (AnimationState.tick,
checkpoint.save; no JAX render):

- the tick order (ROADMAP Q3.8): frame 0 of ``--time 0.7 --dt 0.1`` is the
  render of the state ticked once, as the reference's CLI renders it;
- the animation the CLI renders over 4 frames with --animate-camera
  --animate-light is the reference's AnimationState.tick sequence;
- 1 and 3 frames in flight write the same PNG bytes;
- 2 + 2 frames resumed from a checkpoint end on the unbroken run's PNG,
  also when the checkpoint was written by the reference's checkpoint.save.

The loop and resume cases render at depth 1 to stay cheap (~0.2 s a frame
here); the tick-order case at the default depth 3.
"""

import numpy as np
import pytest
import torch

from gpuraytracer_tpu.core.config import RenderConfig as JRenderConfig
from gpuraytracer_tpu.models.animate import AnimationState as JAnimationState
from gpuraytracer_tpu.utils import checkpoint as j_checkpoint
from gpuraytracer_tpu_torch.apps import render_cli
from gpuraytracer_tpu_torch.core.config import RenderConfig
from gpuraytracer_tpu_torch.models.animate import AnimationState
from gpuraytracer_tpu_torch.render import trace
from gpuraytracer_tpu_torch.runtime import hostrt
from gpuraytracer_tpu_torch.utils import checkpoint, png

SIZE = 8
LOOP = ["--time", "0.7", "--dt", "0.1", "--depth", "1"]


def run(out, *args):
    assert render_cli.main(["--device", "cpu", "--width", str(SIZE), "--height", str(SIZE),
                            "--out", str(out), *args]) == 0
    return out


def frame(out, i):
    return (out / f"frame_{i:05d}.png").read_bytes()


@pytest.fixture(scope="module")
def unbroken(tmp_path_factory):
    """4 frames at 3 in flight, depth 1."""
    return run(tmp_path_factory.mktemp("unbroken"), *LOOP, "--frames", "4")


def test_cli_frame0_is_the_state_ticked_once(tmp_path):
    out = run(tmp_path / "cli", "--time", "0.7", "--dt", "0.1", "--frames", "1")
    cfg = RenderConfig(width=SIZE, height=SIZE)
    state = AnimationState.initial()
    state.geometry_time = 0.7
    state = state.tick(0.1, cfg)
    img = trace.render_frame(state.scene(cfg.aspect_ratio, device="cpu"), SIZE, SIZE)
    want = tmp_path / "want.png"
    hostrt.write_png(str(want), png.image_f32_to_rgba8(img.numpy()))
    assert frame(out, 0) == want.read_bytes()


def test_cli_animation_is_the_reference_tick_sequence(tmp_path, monkeypatch):
    seen = []

    def record(scene, width, height, max_depth=3):
        c = scene.arrays.constants
        seen.append((c.elapsed_time.numpy().copy(), c.camera_position.numpy().copy(),
                     c.light_position.numpy().copy(), c.projection_to_world.numpy().copy()))
        return torch.zeros(height, width, 4)

    monkeypatch.setattr(trace, "render_frame", record)
    run(tmp_path, "--time", "0.7", "--dt", "0.1", "--frames", "4", "--animate-camera",
        "--animate-light")
    assert len(seen) == 4
    jcfg = JRenderConfig(width=SIZE, height=SIZE, animate_camera=True, animate_light=True)
    ref = JAnimationState.initial()
    ref.geometry_time = 0.7
    f32 = np.float32
    for t, cam, light, p2w in seen:
        ref = ref.tick(0.1, jcfg)
        assert t == f32(ref.geometry_time)
        np.testing.assert_array_equal(cam, np.asarray(tuple(ref.camera.eye) + (1.0,), f32))
        np.testing.assert_array_equal(light, np.asarray(ref.light_position, f32))
        np.testing.assert_array_equal(p2w, ref.camera.projection_to_world(1.0).astype(f32))


def test_cli_frames_in_flight_write_the_same_pngs(tmp_path, unbroken):
    one = run(tmp_path, *LOOP, "--frames", "4", "--frames-in-flight", "1")
    for i in range(4):
        assert frame(one, i) == frame(unbroken, i), i


def test_cli_resumed_run_ends_on_the_unbroken_png(tmp_path, unbroken):
    ckpt = str(tmp_path / "state.json")
    out = tmp_path / "split"
    run(out, *LOOP, "--frames", "2", "--checkpoint", ckpt)
    run(out, *LOOP, "--frames", "2", "--resume", ckpt)
    assert sorted(p.name for p in out.iterdir()) == [f"frame_{i:05d}.png" for i in range(4)]
    assert frame(out, 3) == frame(unbroken, 3)


def test_cli_resumes_from_a_reference_checkpoint(tmp_path, unbroken):
    jcfg = JRenderConfig(width=SIZE, height=SIZE)
    ref = JAnimationState.initial()
    ref.geometry_time = 0.7
    ref = ref.tick(0.1, jcfg).tick(0.1, jcfg)
    path = str(tmp_path / "ref.json")
    j_checkpoint.save(path, ref, jcfg, frame_index=2)

    state, cfg, index = checkpoint.load(path)
    assert index == 2
    assert (cfg.width, cfg.height, cfg.frames_in_flight) == (SIZE, SIZE, 3)
    assert state.geometry_time == ref.geometry_time
    for a, b in ((state.camera.eye, ref.camera.eye), (state.camera.at, ref.camera.at),
                 (state.camera.up, ref.camera.up), (state.light_position, ref.light_position)):
        np.testing.assert_array_equal(a, b)
    out = run(tmp_path / "resumed", *LOOP, "--frames", "2", "--resume", path)
    assert frame(out, 3) == frame(unbroken, 3)
