"""The band renderer's frame programs (parallel/sharding.py
``_BandPrograms``) on the CPU, which has no graphs, so each program runs
its frame function eagerly: the same code a CUDA replay captured.

At 32x16 with 2 and 4 bands on ``["cpu"] * n``: the program path's
gathered frame is the eager bands' (``sharding.render_bands``) and the
whole frame's bit for bit, in plain and compact mode (the compacted mode at
8 steps, so that every band queues); the mean radiance is the eager bands'
sums added in band order bit for bit; a built program's frame makes no
upload (``to_device``, ``torch.tensor`` and ``torch.as_tensor`` of host
data patched to raise, as tests/test_torch_program.py checks its
programs); a changed GPURT_FRAME_MODE builds a new program; one program
serves every band of a device that repeats in the mesh; the counters a
program's frame adds (and a capture would record for its replays) are the
eager bands'. tests/test_torch_sharding.py holds the banded frame to the
JAX golden through the same programs; tests/test_torch_program_cuda.py
and chip_smoke.py phase 14 replay them on the card.
"""

import sys

import numpy as np
import pytest
import torch

from gpuraytracer_tpu_torch.core import upload
from gpuraytracer_tpu_torch.kernels import frame_kernel
from gpuraytracer_tpu_torch.models import builtin
from gpuraytracer_tpu_torch.parallel import sharding
from gpuraytracer_tpu_torch.render import program, trace

W, H = 32, 16
T_ANIM = 0.3
CAP_STEPS = 8
# The checks of a program's upkeep (the mean, uploads, keys, counters)
# render at depth 1: the builtin frame costs the CPU seconds a level.
DEPTH = 1
MODES = {"plain": {}, "compact": {"GPURT_FRAME_MODE": "compact",
                                  "GPURT_COMPACT_BUDGET": str(CAP_STEPS)}}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_knobs(monkeypatch):
    for k, _ in program.knobs():
        monkeypatch.delenv(k)


@pytest.fixture(scope="module")
def scene():
    return builtin.build_scene(aspect=W / H, elapsed_time=T_ANIM, device="cpu")


@pytest.fixture(scope="module")
def whole_frames():
    """The whole frame of each mode, rendered once (mode -> image)."""
    return {}


def _eager(scene, n):
    return sharding.render_bands(scene, W, H, n, range(n))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("n", [2, 4])
def test_band_programs_equal_the_eager_bands_and_the_whole_frame(scene, whole_frames,
                                                                 monkeypatch, mode, n):
    for k, v in MODES[mode].items():
        monkeypatch.setenv(k, v)
    if mode not in whole_frames:
        queued = frame_kernel.QUEUED_LANES
        whole_frames[mode] = trace.render_frame(scene, W, H)
        assert mode == "plain" or frame_kernel.QUEUED_LANES > queued
    eager = _eager(scene, n)
    render = sharding.make_sharded_renderer(scene.layout, W, H, sharding.make_mesh(["cpu"] * n))
    bands = render(scene.arrays)
    assert len(render.programs) == 1
    assert all(torch.equal(a, b) for a, b in zip(bands.images, eager))
    assert np.array_equal(sharding.gather_image(bands), whole_frames[mode].numpy())
    render.close()
    assert render.programs == {}


@pytest.mark.parametrize("n", [2, 4])
def test_mean_radiance_is_the_eager_bands(scene, n):
    render = sharding.make_sharded_renderer(scene.layout, W, H, sharding.make_mesh(["cpu"] * n),
                                            max_depth=DEPTH, compute_stats=True)
    bands, mean = render(scene.arrays)
    total = None
    for image in sharding.render_bands(scene, W, H, n, range(n), max_depth=DEPTH):
        part = torch.sum(image[..., :3], dtype=torch.float32)
        total = part if total is None else total + part
    assert mean.dim() == 0 and mean.dtype == torch.float32
    assert torch.equal(mean, total / (W * H * 3))


def _refuse(*args, **kwargs):
    raise AssertionError("a host upload inside a built band program's frame")


def test_built_band_program_makes_no_upload(scene, monkeypatch):
    render = sharding.make_sharded_renderer(scene.layout, W, H, sharding.make_mesh(["cpu"] * 2),
                                            max_depth=DEPTH, compute_stats=True)
    render(scene.arrays)  # builds the program; uploads the constant tables once
    as_tensor = torch.as_tensor

    def host_only(x, *args, **kwargs):
        if not isinstance(x, torch.Tensor):
            _refuse()
        return as_tensor(x, *args, **kwargs)

    for mod in list(sys.modules.values()):
        if getattr(mod, "__name__", "").startswith("gpuraytracer_tpu_torch") \
                and getattr(mod, "to_device", None) is upload.to_device:
            monkeypatch.setattr(mod, "to_device", _refuse)
    monkeypatch.setattr(torch, "tensor", _refuse)
    monkeypatch.setattr(torch, "as_tensor", host_only)
    bands, mean = render(scene.arrays)
    assert len(bands.images) == 2 and mean.dim() == 0


def test_a_changed_frame_mode_builds_a_new_program(scene, monkeypatch):
    render = sharding.make_sharded_renderer(scene.layout, W, H, sharding.make_mesh(["cpu"] * 2),
                                            max_depth=DEPTH)
    plain = sharding.gather_image(render(scene.arrays))
    render(scene.arrays)
    assert len(render.programs) == 1
    monkeypatch.setenv("GPURT_FRAME_MODE", "compact")
    compact = sharding.gather_image(render(scene.arrays))
    assert len(render.programs) == 2
    monkeypatch.setenv("GPURT_FRAME_MODE", "defer")  # the compact route on a mesh
    defer = sharding.gather_image(render(scene.arrays))
    assert len(render.programs) == 3
    assert np.array_equal(compact, plain) and np.array_equal(defer, plain)


def test_a_repeated_device_shares_one_program(scene):
    # Band i on mesh[i]: a mesh that repeats one device four times is one
    # program over the four bands (a graph belongs to one device).
    mesh = sharding.make_mesh(["cpu"] * 4)
    render = sharding.make_sharded_renderer(scene.layout, W, H, mesh, max_depth=DEPTH)
    render(scene.arrays)
    ((_, prog),) = render.programs.values()
    assert "bands [0, 1, 2, 3] of 4" in prog.label


def test_program_counters_equal_the_eager_bands(scene, monkeypatch):
    # The compacted mode's host code counts host syncs and queued lanes on
    # the CPU: a program's frame adds what the eager bands add, and the
    # deltas a capture records (what each replay adds) are the same.
    monkeypatch.setenv("GPURT_FRAME_MODE", "compact")
    monkeypatch.setenv("GPURT_COMPACT_BUDGET", str(CAP_STEPS))

    def delta(fn):
        before = program.counters()
        fn()
        return {k: v - before[k] for k, v in program.counters().items() if v != before[k]}

    render = sharding.make_sharded_renderer(scene.layout, W, H, sharding.make_mesh(["cpu"] * 2),
                                            max_depth=DEPTH)
    render(scene.arrays)
    eager = delta(lambda: sharding.render_bands(scene, W, H, 2, range(2), max_depth=DEPTH))
    assert eager.get((frame_kernel, "HOST_SYNCS"), 0) > 0
    assert delta(lambda: render(scene.arrays)) == eager
    ((_, prog),) = render.programs.values()
    _, deltas = program.run_counted(prog.fn)
    assert deltas == eager
