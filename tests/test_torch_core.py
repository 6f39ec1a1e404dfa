"""The port's point functions against the JAX reference, point by point.

Inputs are made with numpy from a fixed seed and go through the eager JAX
function and its PyTorch counterpart on the CPU. Eager JAX runs op by op,
as the port does, so most results agree to the bit; each test states its
tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpuraytracer_tpu.accel import instances as j_inst
from gpuraytracer_tpu.core import camera as j_cam
from gpuraytracer_tpu.core import hlsl as j_hlsl
from gpuraytracer_tpu.geometry import metaballs as j_mb
from gpuraytracer_tpu.geometry import sdf as j_sdf
from gpuraytracer_tpu.models import builtin as j_builtin
from gpuraytracer_tpu.render import checkers as j_checkers
from gpuraytracer_tpu.render import shade as j_shade
from gpuraytracer_tpu_torch.accel import instances as t_inst
from gpuraytracer_tpu_torch.core import camera as t_cam
from gpuraytracer_tpu_torch.core import hlsl as t_hlsl
from gpuraytracer_tpu_torch.geometry import metaballs as t_mb
from gpuraytracer_tpu_torch.geometry import sdf as t_sdf
from gpuraytracer_tpu_torch.render import checkers as t_checkers
from gpuraytracer_tpu_torch.render import shade as t_shade

EPS32 = float(np.finfo(np.float32).eps)
SEED = 20261016
# One batch size throughout: eager JAX compiles each op once per shape, so
# shared shapes keep the reference side cheap.
N = 4096


def _rng():
    return np.random.default_rng(SEED)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(port, ref, *, rtol=0.0, atol=0.0):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol, atol=atol)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def test_hlsl_fmod_truncates_like_the_reference():
    # Exact: fmod is correctly rounded; signs follow the dividend.
    rng = _rng()
    x = rng.uniform(-5, 5, size=N).astype(np.float32)
    y = rng.choice(np.float32([0.05, 0.075, 0.5, 1.0, 2.0, -0.5]), size=N)
    _close(t_hlsl.fmod(_t(x), _t(y)), j_hlsl.fmod(jnp.asarray(x), jnp.asarray(y)))


def test_hlsl_normalize_and_reflect():
    # Division-form normalize and reflect: within 1e-7 absolute on unit
    # vectors (the same ops in the same order; a last-ulp difference of the
    # sqrt or sum is all that may differ).
    rng = _rng()
    v = rng.normal(size=(N, 3)).astype(np.float32) * 3.0
    v[0] = 0.0  # the exact-zero guard
    n = _unit(rng, N)
    _close(t_hlsl.normalize(_t(v)), j_hlsl.normalize(jnp.asarray(v)), atol=1e-7)
    _close(t_hlsl.reflect(_t(v), _t(n)), j_hlsl.reflect(jnp.asarray(v), jnp.asarray(n)),
           rtol=2 * EPS32, atol=1e-7)


def test_generate_camera_rays():
    # Camera rays of the builtin camera at seeded pixels of a 96x54 frame,
    # within 1e-7.
    rng = _rng()
    w, h = 96, 54
    p2w = j_builtin.default_camera().projection_to_world(w / h).astype(np.float32)
    eye = np.asarray(tuple(j_builtin.default_camera().eye) + (1.0,), np.float32)
    xs = rng.integers(0, w, size=N).astype(np.int32)
    ys = rng.integers(0, h, size=N).astype(np.int32)
    jo, jd = j_cam.generate_camera_rays(jnp.asarray(xs), jnp.asarray(ys), w, h, eye, p2w)
    to, td = t_cam.generate_camera_rays(_t(xs), _t(ys), w, h, _t(eye), _t(p2w))
    _close(to, jo, atol=1e-7)
    _close(td, jd, atol=1e-7)


def test_ray_to_local_and_normal_to_world():
    # Explicit row math in the reference's association: within 2 ulp
    # relative plus 1e-7 absolute, for builtin instances at t=0.7.
    rng = _rng()
    tr = j_builtin.build_instance_transforms(0.7)
    o = rng.uniform(-20, 20, size=(N, 3)).astype(np.float32)
    d = _unit(rng, N)
    n = _unit(rng, N)
    for g in (0, 1, 9):  # scaled, rotated + scaled, uniformly scaled
        b2l = np.asarray(tr.blas_to_local[g])
        l2b = np.asarray(tr.local_to_blas[g])
        jo, jd = j_inst.ray_to_local(jnp.asarray(o), jnp.asarray(d), jnp.asarray(b2l))
        to, td = t_inst.ray_to_local(_t(o), _t(d), _t(b2l))
        _close(to, jo, rtol=2 * EPS32, atol=1e-6)
        _close(td, jd, rtol=2 * EPS32, atol=1e-7)
        _close(t_inst.normal_to_world(_t(n), _t(l2b)),
               j_inst.normal_to_world(jnp.asarray(n), jnp.asarray(l2b)),
               rtol=2 * EPS32, atol=1e-7)


_SDF_NAMES = (
    "distance_mini_spheres",
    "distance_intersected_round_cube",
    "distance_square_torus",
    "distance_twisted_torus",
    "distance_cog",
    "distance_cylinder",
    "distance_fractal_pyramid",
)


@pytest.mark.parametrize("name", _SDF_NAMES)
def test_sdf_distance_functions(name):
    # 4096 seeded points around the unit AABB: within 4 ulp relative or 1e-6
    # absolute (sin/cos/atan2/pow may differ by an ulp between libraries).
    rng = _rng()
    p = rng.uniform(-1.6, 1.6, size=(N, 3)).astype(np.float32)
    ref = getattr(j_sdf, name)(jnp.asarray(p))
    port = getattr(t_sdf, name)(_t(p))
    _close(port, ref, rtol=4 * EPS32, atol=1e-6)


@pytest.mark.parametrize("name", ("distance_mini_spheres", "distance_intersected_round_cube"))
def test_sdf_normal(name):
    # Tetrahedral normal in the reference's association, on the functions
    # built from correctly rounded ops only (sqrt, fmod, min/max): within
    # 1e-6. (Through pow or sin, a last-ulp distance difference is divided
    # by the 5.8e-5 offset and moves the normal by up to ~1e-3.)
    rng = _rng()
    p = rng.uniform(-1.2, 1.2, size=(N, 3)).astype(np.float32)
    ref = j_sdf.calculate_normal(jnp.asarray(p), getattr(j_sdf, name))
    port = t_sdf.calculate_normal(_t(p), getattr(t_sdf, name))
    _close(port, ref, atol=1e-6)


def test_metaball_potential_and_animation():
    # Quintic falloff with the reference's x^3, x^4, x^5 products: 2 ulp
    # relative / 1e-7 absolute; keyframe animation at t=0.7 to 1e-7.
    rng = _rng()
    p = rng.uniform(-1.0, 1.0, size=(N, 3)).astype(np.float32)
    jc, jr = j_mb.animated_metaballs(0.7)
    tc, tr = t_mb.animated_metaballs(torch.tensor(0.7))
    _close(tc, jc, atol=1e-7)
    _close(tr, jr)
    for j in range(3):
        c = np.asarray(jc[j])
        _close(t_mb.metaball_potential(_t(p), _t(c), tr[j]),
               j_mb.metaball_potential(jnp.asarray(p), jnp.asarray(c), jr[j]),
               rtol=2 * EPS32, atol=1e-7)


def test_phong_fresnel_fog():
    # Shading on seeded hits: Phong within 1e-6 (pow may differ by an ulp),
    # Fresnel within 1e-6, fog within 1e-7.
    rng = _rng()
    n = N
    albedo = rng.uniform(0, 1, size=(n, 4)).astype(np.float32)
    normal = _unit(rng, n)
    shadow = rng.uniform(size=n) < 0.3
    hit = rng.uniform(-10, 10, size=(n, 3)).astype(np.float32)
    ray = _unit(rng, n)
    light = np.float32([0.0, 18.0, -20.0])
    amb = np.float32([0.25, 0.25, 0.25, 1.0])
    dif = np.float32([0.6, 0.6, 0.6, 1.0])
    kd, ks, sp = (rng.uniform(0, 1, size=n).astype(np.float32) for _ in range(3))
    sp = (sp * 60.0).astype(np.float32)
    args = (albedo, normal, shadow, hit, ray, light, amb, dif, kd, ks, sp)
    ref = j_shade.phong_lighting(*(jnp.asarray(a) for a in args))
    port = t_shade.phong_lighting(*(_t(a) for a in args))
    _close(port, ref, atol=1e-6)
    _close(t_shade.fresnel_reflectance_schlick(_t(ray), _t(normal), _t(albedo[:, :3])),
           j_shade.fresnel_reflectance_schlick(jnp.asarray(ray), jnp.asarray(normal),
                                               jnp.asarray(albedo[:, :3])), atol=1e-6)
    t = rng.uniform(0, 400, size=n).astype(np.float32)
    _close(t_shade.fog_factor(_t(t)), j_shade.fog_factor(jnp.asarray(t)), atol=1e-7)


def test_analytical_checkers():
    # Box-filtered checkers on seeded plane hits seen from the builtin camera:
    # within 1e-5 (floor/frac of world coordinates amplify a last-ulp
    # difference of the ray differentials by the 50x ratio).
    rng = _rng()
    w, h, n = 96, 54, N
    p2w = j_builtin.default_camera().projection_to_world(w / h).astype(np.float32)
    eye = np.asarray(tuple(j_builtin.default_camera().eye) + (1.0,), np.float32)
    hit = np.stack([rng.uniform(-30, 30, n), np.zeros(n), rng.uniform(-30, 30, n)],
                   axis=-1).astype(np.float32)
    up = np.tile(np.float32([0.0, 1.0, 0.0]), (n, 1))
    px = rng.integers(0, w, size=n).astype(np.int32)
    py = rng.integers(0, h, size=n).astype(np.int32)
    ref = j_checkers.analytical_checkers(jnp.asarray(hit), jnp.asarray(up), jnp.asarray(px),
                                         jnp.asarray(py), w, h, eye, p2w)
    port = t_checkers.analytical_checkers(_t(hit), _t(up), _t(px), _t(py), w, h,
                                          _t(eye), _t(p2w))
    _close(port, ref, atol=1e-5)


def test_render_config_defaults_to_the_card():
    # An entry point runs on the card unless the caller asks for the CPU;
    # the rest of RenderConfig follows the reference's defaults.
    from gpuraytracer_tpu.core.config import RenderConfig as JConfig
    from gpuraytracer_tpu_torch.core.config import RenderConfig

    config = RenderConfig()
    assert config.device == "cuda"
    ref = JConfig()
    assert (config.width, config.height, config.max_recursion_depth) == (
        ref.width, ref.height, ref.max_recursion_depth)
    assert RenderConfig(device="cpu").device == "cpu"
