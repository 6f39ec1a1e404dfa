"""The last public functions of the JAX package that the port had no
counterpart for, held to the JAX functions on the CPU.

The numeric functions take inputs made with numpy from a fixed seed
through the eager JAX function and the port's: clamp, vec3, vec4,
op_union, sd_plane and the registry order exactly; cross, smin and smax
within 2 ulps relative (one product or quotient more or less rounded in
the other library's order) or 1e-7 absolute; get_distance at the
tolerances of tests/test_torch_core.py (codes 0-6: 4 ulps relative or 1e-6
absolute) and tests/test_torch_fractal.py (codes 7, 8 op by op: 8 ulps).
pack_params is held to the JAX pack_params on the builtin arrays at the
bound of tests/test_torch_program.py's row-10 test. The host utilities
are checked as tests/test_utils.py checks the reference's. Nothing here
jits a switch over every branch.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuraytracer_tpu.core import hlsl as j_hlsl
from gpuraytracer_tpu.geometry import registry as j_registry
from gpuraytracer_tpu.geometry import sdf as j_sdf
from gpuraytracer_tpu.kernels import frame_kernel as j_frame
from gpuraytracer_tpu.kernels import megakernel as j_megakernel
from gpuraytracer_tpu.kernels import scene_kernel as j_scene_kernel
from gpuraytracer_tpu.models import builtin as j_builtin
from gpuraytracer_tpu_torch.core import hlsl
from gpuraytracer_tpu_torch.core.types import IntersectorKind
from gpuraytracer_tpu_torch.geometry import registry, sdf
from gpuraytracer_tpu_torch.kernels import frame_kernel, scene_kernel
from gpuraytracer_tpu_torch.models import builtin, meshes
from gpuraytracer_tpu_torch.parallel import device
from gpuraytracer_tpu_torch.utils import png, timers
from gpuraytracer_tpu_torch.utils.event import Event, Viewport

EPS32 = float(np.finfo(np.float32).eps)
SEED = 20261018
N = 1024


def _rng():
    return np.random.default_rng(SEED)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(port, ref, *, rtol=0.0, atol=0.0):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol, atol=atol)


def _ulps(a, b):
    a = np.asarray(a).view(np.int32).astype(np.int64)
    b = np.asarray(b).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def test_hlsl_clamp_cross_vec3_vec4():
    rng = _rng()
    x, a, b = (rng.normal(size=(N, 3)).astype(np.float32) for _ in range(3))
    _close(hlsl.clamp(_t(x), -0.5, 0.75), j_hlsl.clamp(jnp.asarray(x), -0.5, 0.75))
    _close(hlsl.cross(_t(a), _t(b)), j_hlsl.cross(jnp.asarray(a), jnp.asarray(b)),
           rtol=2 * EPS32, atol=1e-7)
    cols = [x[:, 0], x[:, 1], np.float32(2.5), x[:, 2]]
    _close(hlsl.vec3(*map(_t, cols[:3])), j_hlsl.vec3(*map(jnp.asarray, cols[:3])))
    _close(hlsl.vec4(*map(_t, cols)), j_hlsl.vec4(*map(jnp.asarray, cols)))
    # A Python scalar broadcasts, in the tensors' dtype.
    got = hlsl.vec4(_t(cols[0]), _t(cols[1]), 2.5, _t(cols[3]))
    assert got.dtype == torch.float32 and tuple(got.shape) == (N, 4)
    _close(got, j_hlsl.vec4(*map(jnp.asarray, cols)))


def test_sdf_operators_and_plane():
    rng = _rng()
    d1, d2 = (rng.uniform(-2, 2, size=N).astype(np.float32) for _ in range(2))
    p = rng.uniform(-2, 2, size=(N, 3)).astype(np.float32)
    _close(sdf.op_union(_t(d1), _t(d2)), j_sdf.op_union(jnp.asarray(d1), jnp.asarray(d2)))
    _close(sdf.sd_plane(_t(p)), j_sdf.sd_plane(jnp.asarray(p)))
    for k in (0.05, 0.3, 1.0):
        for name in ("smin", "smax"):
            _close(getattr(sdf, name)(_t(d1), _t(d2), k),
                   getattr(j_sdf, name)(jnp.asarray(d1), jnp.asarray(d2), k),
                   rtol=2 * EPS32, atol=1e-7)


@pytest.mark.parametrize("code", sorted(j_sdf.DISTANCE_FUNCTIONS))
def test_get_distance_dispatches_every_code(code):
    assert sorted(sdf.DISTANCE_FUNCTIONS) == sorted(j_sdf.DISTANCE_FUNCTIONS)
    p = _rng().uniform(-1.1, 1.1, size=(N, 3)).astype(np.float32)
    got = sdf.get_distance(_t(p), code).numpy()
    assert got.shape == (N,) and got.dtype == np.float32
    assert np.array_equal(got, sdf.DISTANCE_FUNCTIONS[code](_t(p)).numpy())
    if code in sdf.AABB_WINDOWED_CODES:  # the fractals, op by op
        with jax.disable_jit():
            want = np.asarray(j_sdf.get_distance(jnp.asarray(p), code))
        assert _ulps(got, want).max() <= 8
    else:
        _close(got, j_sdf.get_distance(jnp.asarray(p), np.int32(code)), rtol=4 * EPS32, atol=1e-6)


def test_dense_code_is_the_reference_order():
    ref = j_registry.registered()
    assert [registry.dense_code(k, p) for k, p in ref] == list(range(len(ref)))
    assert [j_registry.dense_code(k, p) for k, p in ref] == list(range(len(ref)))
    # The port's one more entry, the shared TRIANGLE one, sorts last.
    mine = registry.registered()
    assert mine[:len(ref)] == tuple((IntersectorKind(k), p) for k, p in ref)
    assert mine[len(ref):] == ((IntersectorKind.TRIANGLE, 0),)
    assert registry.dense_code(IntersectorKind.TRIANGLE, 5) == len(ref)


def test_intersect_switch_equals_intersect_on_every_code():
    # 256 rays toward the unit box (the marches cost the CPU most here); the
    # code as a Python int and as a 0-d tensor on alternate entries.
    n = 256
    rng = _rng()
    o = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    d = -o + rng.uniform(-0.5, 0.5, size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    active = rng.uniform(size=n) < 0.9
    kw = dict(t_min=0.0, t_max=torch.full((n,), 1e4), cull_backface=True, step_scale=1.0,
              elapsed_time=torch.tensor(0.7), active=torch.from_numpy(active))
    entries = registry.registered()
    for code, (kind, prim) in enumerate(entries):
        if kind == IntersectorKind.TRIANGLE:
            continue  # needs a scene's mesh; its dispatch is checked below
        want = registry.intersect(kind, prim, _t(o), _t(d), **kw)
        got = registry.intersect_switch(torch.tensor(code) if code % 2 else code, _t(o), _t(d),
                                        **kw)
        assert bool(want[0].any()), (kind, prim)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (kind, prim)
        assert (got[2] is None) == (want[2] is None)
        if want[2] is not None:
            assert torch.equal(got[2], want[2])
    # Out of range clamps to the ends, as lax.switch clamps its index.
    seen = []
    real = registry.intersect
    try:
        registry.intersect = lambda kind, prim, *a, **k: seen.append((kind, prim))
        for c in (-3, len(entries) - 1, len(entries) + 4):
            registry.intersect_switch(c, _t(o), _t(d), **kw)
    finally:
        registry.intersect = real
    assert seen == [entries[0], entries[-1], entries[-1]]


def test_pack_params_matches_the_reference():
    t = 0.7
    j_arrays = j_builtin.build_scene(16 / 9, t).arrays
    want = j_scene_kernel.pack_params(j_arrays, jnp.float32(t))
    for elapsed in (t, torch.tensor(t)):
        got = scene_kernel.pack_params(builtin.build_scene(aspect=16 / 9, elapsed_time=t,
                                                           device="cpu").arrays, elapsed)
        assert len(got) == 5
        for name, g, w in zip(("b2l_rows", "l2b_rot", "step_scales", "aabbs", "mb_params"),
                              got, want):
            w = np.asarray(w)
            bound = 4 * np.spacing(np.maximum(np.abs(w), np.float32(
                8.0 if name == "b2l_rows" else 1.0)))
            assert g.shape == w.shape and g.dtype == torch.float32, name
            assert (np.abs(g.numpy() - w) <= bound).all(), name


def test_merged_shadow_enabled_and_compact_enabled(monkeypatch):
    for value in ("", "0", "1"):
        monkeypatch.setenv("GPURT_MERGED_SHADOW", value)
        assert scene_kernel.merged_shadow_enabled() == j_scene_kernel.merged_shadow_enabled()
    for value in ("", "plain", "compact", "defer", "bogus"):
        monkeypatch.setenv("GPURT_FRAME_MODE", value)
        assert frame_kernel.compact_enabled() == j_frame.compact_enabled(), value


def test_fused_eligible_follows_the_reference(monkeypatch):
    # The reference also asks whether Pallas runs natively (a TPU); the
    # port routes by the tensor's device instead, so that term is set true.
    monkeypatch.setattr(j_megakernel, "pallas_available", lambda: True)
    scene = builtin.build_scene(aspect=16 / 9, device="cpu")
    j_scene = j_builtin.build_scene(16 / 9, 0.0)
    big = meshes.get_config("mesh_heightfield_sdf").build(16 / 9, 0.0, device="cpu")
    for disable in ("", "1"):
        monkeypatch.setenv("GPURT_DISABLE_FUSED", disable)
        assert frame_kernel.fused_eligible(scene) == j_frame.fused_eligible(j_scene) == (not disable)
        assert frame_kernel.fused_eligible(big, origins_ndim=2) is False
        assert frame_kernel.fused_eligible(scene) == (trace_route(scene) == "frame")


def trace_route(scene):
    from gpuraytracer_tpu_torch.render import trace

    return trace.frame_route(scene)[0]


def test_device_platforms_id_and_count():
    assert device.available_platforms()[-1] == "cpu"
    assert ("cuda" in device.available_platforms()) == torch.cuda.is_available()
    info = device.pick_device("cpu")
    assert info.id == 0 and device.device_count("cpu") == 1
    if torch.cuda.is_available():
        assert device.pick_device("cuda:0").id == 0
        assert device.device_count("cuda") == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError):
            device.device_count("cuda")


def test_material_table_row():
    mats = builtin.build_scene(aspect=1.0, device="cpu").arrays.materials
    row = mats.row(3)
    assert torch.equal(row.albedo, mats.albedo[3])
    assert float(row.step_scale) == float(mats.step_scale[3])
    ids = torch.tensor([0, 2, 2])
    assert torch.equal(mats.row(ids).specular_power, mats.specular_power[ids])


def test_event_detach_and_listener_count():
    ev = Event()
    seen = []
    fn = seen.append
    ev.attach(fn)
    ev(1)
    ev.detach(fn)
    ev(2)
    assert seen == [1] and ev.listener_count == 0

    class Listener:
        def __init__(self):
            self.seen = []

        def on_evt(self, v):
            self.seen.append(v)

    a, b = Listener(), Listener()
    ev.attach(a.on_evt)
    ev.attach(b.on_evt)
    assert ev.listener_count == 2
    ev.detach(a.on_evt)  # a bound method held weakly
    ev("x")
    assert a.seen == [] and b.seen == ["x"] and ev.listener_count == 1
    del b
    gc.collect()
    ev("y")  # the dead listener drops out
    assert ev.listener_count == 0


def test_viewport_set_title():
    vp = Viewport(640, 360)
    assert vp.title == "gpuraytracer_tpu"
    vp.set_title("fps 60.0")
    assert vp.title == "fps 60.0" and (vp.width, vp.height) == (640, 360)


@pytest.mark.parametrize("channels", [3, 4])
def test_write_png_roundtrip(tmp_path, channels):
    rgba = _rng().integers(0, 256, size=(7, 5, channels), dtype=np.uint8)
    path = str(tmp_path / "f.png")
    png.write_png(path, rgba)
    from PIL import Image

    with Image.open(path) as im:
        assert np.array_equal(np.asarray(im), rgba)


def test_device_timer_stop_after_on_the_cpu():
    clock = iter([1.0, 1.25]).__next__
    timer = timers.DeviceTimer("cpu", clock=clock)
    timer.start()
    out = torch.ones(3) * 2
    assert timer.stop_after(out) == pytest.approx(250.0)
    assert timer.last_ms == pytest.approx(250.0)
