"""Frame programs (render/program.py) and row 10 (kernels/frame_state.py)
on the CPU.

Row 10's plain version (the animator, then the pack's per-frame fields)
is held to the JAX package's animate then pack_frame_params
(gpuraytracer_tpu/kernels/frame_kernel.py:1321) for the builtin scene, the
five bench scenes and the three mesh scenes at 8 times, among them 0 and
the metaball cycle's turning point (t = 6, half of the 12 s cycle), the
reference as one jitted program of the eight frames, as it runs them:
every field within 4 ulps of max(|value|, scale), scale 8 for b2l_rows
(its translation column sums products of centres up to 6 in magnitude,
which XLA contracts into FMAs and the port rounds one by one, so its error
is the terms' and not the sum's) and 1 for the others (the two sides take
cos, sin and the time's division from different libraries, an ulp apart
at most). ``pack_static`` with the
per-frame fields written in is ``pack_frame`` of the animated scene bit
for bit.

A program's frame on the CPU (which has no graphs, so it runs eagerly) is
``render_frame``'s bit for bit, makes no upload once the program is built
(``to_device``, ``torch.tensor`` and ``torch.as_tensor`` of host data
patched to raise: the CPU's stand-in for "capturable"), returns frames that
a later call leaves alone, and a changed GPURT_* knob builds a new program.
A capture's counter deltas, which a replay adds, are the eager frame's.
The card's checks are tests/test_torch_program_cuda.py and chip_smoke.py
phase 17.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuraytracer_tpu.kernels import frame_kernel as j_frame
from gpuraytracer_tpu.models import builder as j_builder
from gpuraytracer_tpu.models import builtin as j_builtin
from gpuraytracer_tpu.models import scenes as j_scenes
from gpuraytracer_tpu.accel.instances import Scene as JScene
from gpuraytracer_tpu_torch.accel.instances import Scene
from gpuraytracer_tpu_torch.apps import bench_suite
from gpuraytracer_tpu_torch.core import upload
from gpuraytracer_tpu_torch.kernels import frame_kernel, frame_state
from gpuraytracer_tpu_torch.models import builtin, meshes, scenes
from gpuraytracer_tpu_torch.render import program, trace
from gpuraytracer_tpu_torch.render.renderer import Renderer

W, H = 32, 18
ASPECT = W / H
TIMES = (0.0, 0.033, 0.7, 1.3, 2.112, 6.0, 9.9, 31.7)
NAMES = (["builtin"] + [c.name for c in scenes.BENCH_CONFIGS]
         + [c.name for c in meshes.MESH_CONFIGS])
MESH_BUILDERS = {"mesh_octahedra": meshes.octahedra_builder,
                 "mesh_heightfield_512": meshes.heightfield_512_builder,
                 "mesh_heightfield_sdf": meshes.heightfield_sdf_builder}
ULPS = 4
# The magnitude each field's ulps are counted at, at least (see above).
SCALE = {"t": 1.0, "b2l_rows": 8.0, "l2b_rot": 1.0, "mb_params": 1.0}


def port_scene(name):
    """(scene at t = 0 on the CPU, its animator) of the port."""
    if name == "builtin":
        return builtin.build_scene(aspect=ASPECT, device="cpu"), builtin.animate_arrays
    cfg = (meshes.get_config(name) if name in MESH_BUILDERS else scenes.get_config(name))
    b = cfg.builder()
    return b.build(ASPECT, 0.0, device="cpu"), b.animator()


def jax_scene(name):
    """The same of the JAX package."""
    if name == "builtin":
        return j_builtin.build_scene(ASPECT, 0.0), j_builtin.animate_arrays
    b = (MESH_BUILDERS[name](j_builder) if name in MESH_BUILDERS
         else j_scenes.get_config(name).builder())
    return b.build(ASPECT, 0.0), b.animator()


def frame_fields_of(pack):
    g, m = pack.num_geometries, pack.num_materials
    off = frame_kernel.param_offsets(g, m)
    p = pack.params.numpy()
    return (p[0:1], p[off["b2l"]: off["b2l"] + 12 * g], p[off["l2b"]: off["l2b"] + 9 * g],
            p[off["mb"]: off["mb"] + 12])


@pytest.mark.parametrize("name", NAMES)
def test_row_10_plain_version_matches_the_reference(name):
    scene, animate = port_scene(name)
    j_scene0, j_animate = jax_scene(name)

    def reference(t):
        blocks, _ = j_frame.pack_frame_params(JScene(j_scene0.layout,
                                                     j_animate(j_scene0.arrays, t)))
        return blocks[0], blocks[1], blocks[4]

    # The eight frames in one compiled program of the reference.
    refs = jax.jit(jax.vmap(reference))(jnp.asarray(TIMES, dtype=jnp.float32))
    pack = frame_kernel.pack_static(scene)
    times = torch.tensor(TIMES, dtype=torch.float32)
    for i, t in enumerate(TIMES):
        frame_state.advance(pack, animate, scene.arrays, times, i)  # the plain version
        want = (np.asarray([np.float32(t)]),) + tuple(np.asarray(r[i]).reshape(-1) for r in refs)
        for field, got, ref_v in zip(("t", "b2l_rows", "l2b_rot", "mb_params"),
                                     frame_fields_of(pack), want):
            bound = ULPS * np.spacing(np.maximum(np.abs(ref_v), np.float32(SCALE[field])))
            assert got.shape == ref_v.shape, field
            assert (np.abs(got - ref_v) <= bound).all(), (name, t, field,
                                                          float(np.abs(got - ref_v).max()))


@pytest.mark.parametrize("name", NAMES)
def test_static_pack_with_frame_fields_is_pack_frame(name):
    scene, animate = port_scene(name)
    pack = frame_kernel.pack_static(scene)
    times = torch.tensor(TIMES, dtype=torch.float32)
    for i, t in enumerate(TIMES):
        frame_state.advance_plain(pack, animate, scene.arrays, times, i)
        want = frame_kernel.pack_frame(Scene(scene.layout, animate(scene.arrays, t)))
        assert torch.equal(pack.params, want.params), (name, t)
        assert torch.equal(pack.layout, want.layout) and torch.equal(pack.tri, want.tri)


def test_repack_of_the_animated_arrays_is_pack_frame():
    scene, animate = port_scene("mesh_octahedra")
    pack = frame_kernel.pack_static(scene)
    animated = Scene(scene.layout, animate(scene.arrays, 1.3))
    frame_kernel.repack(pack, animated)
    want = frame_kernel.pack_frame(animated)
    assert torch.equal(pack.params, want.params) and torch.equal(pack.tri, want.tri)


def tiny_renderer():
    """The builtin Renderer at 8x6, depth 1: the builtin frame costs the CPU
    seconds a level at 32x18."""
    return Renderer(8, 6, device="cpu", max_depth=1)


def test_renderer_and_make_renderer_equal_render_frame():
    # Depth 1: the builtin frame costs the CPU seconds a level.
    r = Renderer(W, H, device="cpu", max_depth=1)
    render = trace.make_renderer(builtin.LAYOUT, W, H, max_depth=1)
    base = builtin.build_scene(aspect=ASPECT, device="cpu")
    for t in (0.7, 6.0):
        want = trace.render_frame(Scene(builtin.LAYOUT, builtin.animate_arrays(base.arrays, t)),
                                  W, H, max_depth=1)
        assert torch.equal(r.render(t), want), t
    assert torch.equal(render(builtin.animate_arrays(base.arrays, t)), want)


def test_window_program_equals_eager_frames():
    cfg = scenes.get_config("single_sphere_plane_256")
    b = cfg.builder()
    scene, animate = b.build(ASPECT, 0.0, device="cpu"), b.animator()
    prog = bench_suite.window_program(scene, animate, 3, animated=cfg.animated, width=W, height=H,
                                      max_depth=cfg.max_depth, keep=(0, 2))
    acc, sums, first, last = prog()
    eager = [trace.render_frame(Scene(scene.layout, animate(scene.arrays, t)), W, H,
                                max_depth=cfg.max_depth)
             for t in bench_suite.frame_times(3, cfg.animated)]
    assert torch.equal(first, eager[0]) and torch.equal(last, eager[2])
    assert torch.equal(sums, torch.stack([torch.sum(img) for img in eager]))
    want = torch.zeros(())
    for img in eager:
        want = want + torch.sum(img)
    assert torch.equal(acc, want)


def _refuse(*args, **kwargs):
    raise AssertionError("a host upload inside a built program's frame")


@pytest.mark.parametrize("kind", ["renderer", "builder_renderer", "window"])
def test_built_program_makes_no_upload(monkeypatch, kind):
    if kind == "window":
        cfg = scenes.get_config("single_sphere_plane_256")
        b = cfg.builder()
        prog = bench_suite.window_program(b.build(ASPECT, 0.0, device="cpu"), b.animator(), 2,
                                          animated=cfg.animated, width=W, height=H,
                                          max_depth=cfg.max_depth)
        call = prog
    else:
        if kind == "renderer":
            r = tiny_renderer()
        else:
            cfg = scenes.get_config("analytic_grid_720p")
            r = Renderer(W, H, device="cpu", scene_factory=cfg.build,
                         animate=cfg.builder().animator(), max_depth=cfg.max_depth)
        call = lambda: r.render(1.3)  # noqa: E731
    call()  # builds the program; uploads the constant tables once
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
    call()


def test_returned_frames_stay_after_later_calls():
    r = tiny_renderer()
    a, b = r.render(0.5), r.render(2.0)
    a0, b0 = a.clone(), b.clone()
    r.render(4.0)
    assert torch.equal(a, a0) and torch.equal(b, b0) and not torch.equal(a, b)


def test_a_changed_knob_builds_a_new_program(monkeypatch):
    monkeypatch.delenv("GPURT_FRAME_MODE", raising=False)
    r = tiny_renderer()
    plain = r.render(0.7)
    assert len(r._programs) == 1
    r.render(0.7)
    assert len(r._programs) == 1
    monkeypatch.setenv("GPURT_FRAME_MODE", "compact")
    compact = r.render(0.7)
    assert len(r._programs) == 2
    assert torch.equal(compact, plain)  # compact mode equals plain bit for bit
    r.resize(16, 9)
    assert r._programs == {}


def test_capture_deltas_are_the_eager_frames(monkeypatch):
    # The compact mode's host code counts its host syncs and queued lanes on
    # the CPU: the deltas a capture records (and takes back) are what one
    # eager frame adds.
    monkeypatch.setenv("GPURT_FRAME_MODE", "compact")
    scene = builtin.build_scene(aspect=8 / 6, elapsed_time=0.7, device="cpu")

    def frame():
        return trace.render_frame(scene, 8, 6, max_depth=1)

    before = program.counters()
    frame()
    eager = {k: v - before[k] for k, v in program.counters().items() if v != before[k]}
    assert eager.get((frame_kernel, "HOST_SYNCS"), 0) > 0
    mark = program.counters()
    out, deltas = program.run_counted(frame)
    assert program.counters() == mark  # taken back
    assert deltas == eager and out.shape == (6, 8, 4)
    program._add(deltas)
    assert program.counters() == {k: v + deltas.get(k, 0) for k, v in mark.items()}
