"""The port's extension fractals (geometry/fractal.py) against the JAX
package's gpuraytracer_tpu.geometry.fractal, and their registration.

Points are seeded uniformly over the local AABB [-1, 1]^3 and a margin
around it. Against the reference evaluated op by op (jax.disable_jit: no
fusion, so no contraction of multiply-adds), the two agree to a few ulps
(<= 8; the remaining difference is log's last bit). Against the jitted
reference, which the renders run and which contracts multiply-adds, they
agree to 1e-5 absolute (near the surface the estimate is a difference of
nearly equal terms, so the relative error of a jitted value is large).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuraytracer_tpu.geometry import fractal as j_fractal
from gpuraytracer_tpu_torch.geometry import fractal, sdf

NAMES = ["distance_mandelbulb", "distance_julia_quaternion"]
# The reference dispatch's answers on the registry entries' seeded rays
# (test_registry_matches_reference_table), written by running this file:
# JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_fractal.py
REGISTRY_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "golden_torch_registry_dispatch.npz")


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(5)
    return rng.uniform(-1.1, 1.1, size=(4096, 3)).astype(np.float32)


def ulps(a, b):
    a = a.view(np.int32).astype(np.int64)
    b = b.view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("name", NAMES)
def test_distance_matches_reference_op_by_op(name, points):
    with jax.disable_jit():
        want = np.asarray(getattr(j_fractal, name)(jnp.asarray(points)))
    got = getattr(fractal, name)(torch.from_numpy(points)).numpy()
    assert got.dtype == np.float32 and got.shape == (points.shape[0],)
    same_sign = np.sign(got) == np.sign(want)
    assert same_sign.all()
    assert ulps(got, want).max() <= 8
    assert (got == want).mean() > 0.9


@pytest.mark.parametrize("name", NAMES)
def test_distance_matches_jitted_reference(name, points):
    want = np.asarray(jax.jit(getattr(j_fractal, name))(jnp.asarray(points)))
    got = getattr(fractal, name)(torch.from_numpy(points)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_julia_inside_the_set_is_just_inside():
    # The origin never escapes: the estimate is the "just inside" -1e-3
    # (scaled by 1/1.1), as in the reference.
    got = fractal.distance_julia_quaternion(torch.zeros(1, 3))
    assert got.item() == pytest.approx(-1e-3 / 1.1)


def test_fractals_are_registered_as_aabb_windowed():
    for code, fn in ((7, fractal.distance_mandelbulb), (8, fractal.distance_julia_quaternion)):
        assert sdf.DISTANCE_FUNCTIONS[code] is fn
        assert code not in sdf.ESCAPE_SAFE_CODES
        assert code in sdf.AABB_WINDOWED_CODES
    assert not sdf.AABB_WINDOWED_CODES & sdf.ESCAPE_SAFE_CODES
    with pytest.raises(ValueError, match="aabb_windowed"):
        sdf.register_distance_function(9, fractal.distance_mandelbulb)
    assert 9 not in sdf.DISTANCE_FUNCTIONS


def test_extension_relax_reads_the_knob_at_call_time(monkeypatch):
    assert sdf.relax_for_code(7) == pytest.approx(1.6)
    assert sdf.relax_for_code(3) == 1.0
    monkeypatch.setenv("GPURT_RELAX", "1.2")
    assert sdf.relax_for_code(8) == pytest.approx(1.2)
    assert sdf.relax_for_code(8, occlusion=True) == pytest.approx(1.6)  # shadow omega wins
    monkeypatch.setenv("GPURT_RELAX", "0.5")
    assert sdf.relax_for_code(7) == 1.0


def test_windowed_flag_reaches_the_kernel_buffers():
    # The frame and scene kernels read the window per geometry from the
    # layout buffer, set from the registration, not from the code.
    from gpuraytracer_tpu_torch.kernels import frame_kernel
    from gpuraytracer_tpu_torch.models import scenes

    scene = scenes.get_config("fractal_mandelbulb_julia_1080p").build(1.0, 0.0, device="cpu")
    pack = frame_kernel.pack_frame(scene)
    g = pack.num_geometries
    rows = pack.layout[frame_kernel.I_HEADER:][:g * frame_kernel.GEO_STRIDE].reshape(g, -1)
    for (kind, code, *_, windowed, _, _) in rows.tolist():
        assert windowed == int(kind == 2 and code in sdf.AABB_WINDOWED_CODES)
    assert sum(r[9] for r in rows.tolist()) == 2


def _registry_keys():
    from gpuraytracer_tpu_torch.geometry import registry

    return [(int(k), c) for k, c in registry.registered()]


def _dispatch_case(key):
    """The seeded local rays of a registry entry, its queries ((occlusion,
    level): closest at level 1 and, for a marched code, occlusion at level
    0) and, for the mesh entry (kind 3), the seeded 16-face mesh's
    (positions, indices)."""
    mesh = None
    if key[0] == 3:
        mrng = np.random.default_rng(9)
        positions = mrng.uniform(-1, 1, size=(12, 3)).astype(np.float32)
        indices = mrng.integers(0, 12, size=(16, 3)).astype(np.uint32)
        mesh = (positions, indices)
    rng = np.random.default_rng(6 + 16 * key[0] + key[1])
    n = 128
    o = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    aim = rng.uniform(-0.6, 0.6, size=(n, 3)).astype(np.float32)
    d = (aim - o) / np.linalg.norm(aim - o, axis=-1, keepdims=True)
    t_max = np.full((n,), 10.0, np.float32)
    queries = ((False, 1), (True, 0)) if key[0] == 2 else ((False, 1),)
    return o, d, t_max, queries, mesh


def _reference_dispatch(key):
    """{name: array} of the reference's per-geometry dispatch
    (accel/traverse._dispatch_procedural) on the entry's rays and queries:
    the rays, then per query its hit, t and, where it returns one, its
    normal."""
    from gpuraytracer_tpu.accel import traverse as j_traverse
    from gpuraytracer_tpu.geometry import trimesh as j_trimesh

    o, d, t_max, queries, mesh = _dispatch_case(key)
    j_mesh = None if mesh is None else j_trimesh.from_indexed(*mesh)
    out = {"o": o, "d": d}
    for occlusion, level in queries:
        want = j_traverse._dispatch_procedural(
            key[0], key[1], jnp.asarray(o), jnp.asarray(d), t_min=0.0, t_max=jnp.asarray(t_max),
            cull=True, step_scale=1.0, elapsed_time=0.7, gate=jnp.ones((o.shape[0],), bool),
            max_steps=96, occlusion=occlusion, level=level, mesh=j_mesh)
        q = f"{int(occlusion)}{level}"
        out[f"hit{q}"], out[f"t{q}"] = np.asarray(want[0]), np.asarray(want[1])
        if len(want) > 2 and want[2] is not None:
            out[f"normal{q}"] = np.asarray(want[2])
    return out


@pytest.fixture(scope="module")
def registry_golden():
    return np.load(REGISTRY_GOLDEN)


@pytest.mark.parametrize("key", _registry_keys(), ids=lambda k: f"kind{k[0]}-code{k[1]}")
def test_registry_matches_reference_table(key, registry_golden):
    # The port's one (kind, code) -> intersector table holds the reference
    # registry's entries, and each entry returns the hits of the reference's
    # per-geometry dispatch (accel/traverse._dispatch_procedural: window,
    # budget, relaxation) on seeded local rays, closest at level 1 and, for
    # the marched codes (whose budget and relaxation the query selects),
    # occlusion at level 0; the reference's answers are read from
    # REGISTRY_GOLDEN (written by running this file), whose rays must be
    # these. The reference dispatches a triangle mesh outside
    # its registry (in _dispatch_procedural); the port's table holds it as
    # one more entry, checked here on a seeded 16-face mesh. The
    # reference's program contracts multiply-adds
    # and the port's does not, which moves a march crossing by a step on a
    # few rays: hits agree on >= 98% of rays, t within 1e-3 + 1e-4 * t where
    # both hit (as tests/test_torch_scene_kernel.py); where t agrees to 1e-5
    # (>= 95% of those), normals within 1e-5, or 5e-3 for a march's normal (a
    # finite difference of f32 distances at offset 5.8e-5: one ulp of a
    # distance moves it ~2e-3).
    from gpuraytracer_tpu.geometry import registry as j_registry
    from gpuraytracer_tpu_torch.geometry import registry, trimesh

    assert [k for k in _registry_keys() if k[0] != 3] == [
        (int(k), c) for k, c in j_registry.registered()]
    o, d, t_max, queries, mesh = _dispatch_case(key)
    if mesh is not None:
        mesh = trimesh.from_indexed(*mesh)
    ref = {name[len(f"{key[0]}_{key[1]}_"):]: registry_golden[name] for name in registry_golden.files
           if name.startswith(f"{key[0]}_{key[1]}_")}
    np.testing.assert_array_equal(o, ref["o"])
    np.testing.assert_array_equal(d, ref["d"])
    for occlusion, level in queries:
        cull = True
        got = registry.intersect(
            key[0], key[1], torch.from_numpy(o), torch.from_numpy(d), t_min=0.0,
            t_max=torch.from_numpy(t_max), cull_backface=cull, step_scale=1.0,
            elapsed_time=torch.tensor(0.7), natural_budget=96, occlusion=occlusion,
            level=level, mesh=mesh)
        q = f"{int(occlusion)}{level}"
        hit, want_hit = got[0].numpy(), ref[f"hit{q}"]
        assert (hit == want_hit).mean() >= 0.98 and hit.any()
        both = hit & want_hit
        np.testing.assert_allclose(got[1].numpy()[both], ref[f"t{q}"][both],
                                   rtol=1e-4, atol=1e-3)
        if got[2] is not None and f"normal{q}" in ref:
            same = both & (np.abs(got[1].numpy() - ref[f"t{q}"]) <= 1e-5)
            assert same.sum() >= 0.95 * both.sum()
            np.testing.assert_allclose(got[2].numpy()[same], ref[f"normal{q}"][same],
                                       rtol=0, atol=5e-3 if key[0] == 2 else 1e-5)


if __name__ == "__main__":
    np.savez_compressed(REGISTRY_GOLDEN, **{
        f"{key[0]}_{key[1]}_{name}": x for key in _registry_keys()
        for name, x in _reference_dispatch(key).items()})
    print(REGISTRY_GOLDEN)
