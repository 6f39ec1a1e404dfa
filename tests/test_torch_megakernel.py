"""The per-geometry march kernel (kernels/megakernel.py; row 7 of the
kernel table in PERF.md) and the per-geometry route.

- ``sphere_trace_plain`` against the reference's
  megakernel.sphere_trace_tiles in interpret mode (as tests/test_kernels.py
  runs it on the CPU), on one 16x128 batch per case, for codes 6 (a
  reference SDF with the escape bound) and 7 (the AABB-windowed, relaxed
  mandelbulb), closest and occlusion under a capped budget, with what the
  per-geometry route passes (geometry/registry's SDF entry): equal hit
  masks and t within 1e-5. Normals within 1e-3 on >= 99% of the valid
  hits and within 5e-2 on all: the tetrahedral normal is a finite
  difference of f32 distances at offset 5.8e-5, the reference's program
  contracts multiply-adds and the port's does not, and on the mandelbulb
  an ulp of a distance moves a normal by ~2e-3. A capped occlusion hit
  (t = 0 on both sides) takes its normal at the ray origin, where no caller
  reads it and where the difference of two nearly equal distances far
  from the surface leaves only a few bits: its normal is not compared.
- The wrappers run their plain versions on a CPU tensor, launch nothing
  and refuse malformed inputs.
- accel/traverse.per_geometry_route with plain passes, on the 544-face
  scene (models/meshes.py mesh_heightfield_sdf): at level 0 it gives what
  the scene pass gives (same budgets; equal ids, t within 1e-6), at every
  level the level-0 result (the route marches every level at the level-0
  budget), and a 96x54 frame rendered through it stays within the image
  bar of the golden that the XLA path (per-level budgets) rendered.

On a GPU (the ``cuda`` marker) the march kernel is held to its plain
version on ray batches for every SDF code, and the route's frame to the
route's plain version, with its exact launch counts.
"""

import os

import numpy as np
import pytest
import torch

from gpuraytracer_tpu_torch.accel import traverse
from gpuraytracer_tpu_torch.core import camera as cam
from gpuraytracer_tpu_torch.core import hlsl
from gpuraytracer_tpu_torch.geometry import analytic, sdf
from gpuraytracer_tpu_torch.kernels import megakernel, scene_kernel
from gpuraytracer_tpu_torch.models import meshes
from gpuraytracer_tpu_torch.render import trace

HERE = os.path.dirname(os.path.abspath(__file__))
W, H = 96, 54
T_ANIM = 0.7
SCENE = "mesh_heightfield_sdf"


def batch(code):
    """A 16x128 grid of +z rays at the unit box (the reference test's), with
    the march window of an AABB-windowed code."""
    ys, xs = np.meshgrid(np.linspace(-1.2, 1.2, 16), np.linspace(-1.2, 1.2, 128), indexing="ij")
    o = np.stack([xs, ys, np.full_like(xs, -3.0)], axis=-1).astype(np.float32).reshape(-1, 3)
    d = np.zeros_like(o)
    d[:, 2] = 1.0
    gate = np.ones(o.shape[0], bool)
    t_max = np.full(o.shape[0], 1e4, np.float32)
    t_start = None
    if code in sdf.AABB_WINDOWED_CODES:
        lo, hi = analytic.aabb_interval(torch.from_numpy(o), torch.from_numpy(d),
                                        torch.tensor([-1.0] * 3), torch.tensor([1.0] * 3))
        t_start = lo.clamp(min=0.0).numpy()
        t_max = np.minimum(t_max, hi.numpy())
        gate &= (hi > lo).numpy() & (t_max > t_start)
    return o, d, gate, t_max, t_start


def spec(code, occlusion):
    """The static arguments the per-geometry route passes for a geometry of
    natural budget 512 (so an occlusion march is capped)."""
    steps, capped = sdf.march_budget(512, occlusion=occlusion, level=0)
    return dict(prim_code=code, cull_backface=code not in sdf.AABB_WINDOWED_CODES,
                max_steps=steps, relax=sdf.relax_for_code(code, occlusion=occlusion),
                capped_hit=capped)


@pytest.mark.parametrize("occlusion", [False, True], ids=["closest", "occlusion"])
@pytest.mark.parametrize("code", [6, 7])
def test_plain_matches_reference_kernel(code, occlusion):
    import jax.numpy as jnp
    from gpuraytracer_tpu.kernels import megakernel as j_mega

    o, d, gate, t_max, t_start = batch(code)
    kw = spec(code, occlusion)
    assert kw["capped_hit"] == occlusion
    hit, t, n = megakernel.sphere_trace_plain(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(gate),
        torch.from_numpy(t_max), 0.9,
        t_start=None if t_start is None else torch.from_numpy(t_start), **kw)
    shape = (16, 128)
    j_hit, j_t, j_n = j_mega.sphere_trace_tiles(
        jnp.asarray(o.reshape(shape + (3,))), jnp.asarray(d.reshape(shape + (3,))),
        jnp.asarray(gate.reshape(shape)), jnp.asarray(t_max.reshape(shape)), 0.9,
        t_start=None if t_start is None else jnp.asarray(t_start.reshape(shape)),
        interpret=True, unroll=1, **kw)
    j_hit = np.asarray(j_hit).reshape(-1)
    j_t = np.asarray(j_t).reshape(-1)
    j_n = np.asarray(j_n).reshape(-1, 3)
    np.testing.assert_array_equal(hit.numpy(), j_hit)
    assert j_hit.any() and not j_hit.all()
    np.testing.assert_allclose(t.numpy()[j_hit], j_t[j_hit], rtol=0, atol=1e-5)
    assert np.isinf(t.numpy()[~j_hit]).all()
    # A capped march reports a hit at t = 0, as the reference writes it.
    capped = j_hit & (j_t == 0.0)
    np.testing.assert_array_equal(t.numpy()[capped], 0.0)
    assert capped.any() == occlusion
    valid = j_hit & ~capped
    dn = np.abs(n.numpy()[valid] - j_n[valid]).max(axis=-1)
    assert (dn <= 1e-3).mean() >= 0.99 and dn.max() <= 5e-2, dn.max()


def test_wrappers_run_plain_versions_on_cpu():
    o, d, gate, t_max, _ = batch(6)
    o, d, gate, t_max = map(torch.from_numpy, (o, d, gate, t_max))
    launches = (megakernel.LAUNCHES, megakernel.MESH_LAUNCHES)
    kw = spec(6, False)
    got = megakernel.sphere_trace_tiles(o, d, gate, t_max, 0.9, **kw)
    want = megakernel.sphere_trace_plain(o, d, gate, t_max, 0.9, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(got[0].any())
    assert torch.equal(got[2][~got[0]], torch.zeros_like(got[2][~got[0]]))  # miss normal
    with pytest.raises(ValueError, match="t_max"):
        megakernel.sphere_trace_tiles(o, d, gate, t_max.double(), 0.9, **kw)
    with pytest.raises(ValueError, match="gate"):
        megakernel.sphere_trace_tiles(o, d, gate[:-1], t_max, 0.9, **kw)
    with pytest.raises(ValueError, match="rows"):
        megakernel.trimesh_closest(torch.zeros(4, 9), o, d, gate, t_max)
    assert (megakernel.LAUNCHES, megakernel.MESH_LAUNCHES) == launches


@pytest.fixture(scope="module")
def route_rays():
    """512 camera rays through seeded pixels of the 544-face scene, their
    level-0 closest hits, and shadow rays off them."""
    scene = meshes.get_config(SCENE).build(W / H, T_ANIM, device="cpu")
    assert not traverse._scene_kernel_eligible(scene)
    rng = np.random.default_rng(21)
    pix = torch.from_numpy(rng.choice(W * H, size=512, replace=False))
    c = scene.arrays.constants
    o, d = cam.generate_camera_rays(pix % W, pix // W, W, H, c.camera_position,
                                    c.projection_to_world)
    hit = traverse.closest_hit(o, d, scene, level=0, plain=True)
    hp = o + hit.t[:, None] * d
    shadow = hlsl.normalize(c.light_position[:3] - hp)
    return scene, o, d, hp, shadow, hit.hit


@pytest.mark.parametrize("occlusion", [False, True], ids=["closest", "occlusion"])
def test_per_geometry_route_matches_scene_pass_at_level_0(route_rays, occlusion):
    scene, o, d, hp, shadow, hit = route_rays
    if occlusion:
        o, d, active = hp, shadow, hit
    else:
        active = None
    _, ob, db, act, t0 = traverse.pass_inputs(o, d, scene, active=active, occlusion=occlusion)
    want = scene_kernel.scene_closest_plain(scene, ob, db, act, t0, level=0,
                                            accept_first=occlusion)
    assert bool((want[2] >= 0).any())
    for level in (0, 1):
        got = traverse.per_geometry_route(plain=True)(scene, ob, db, act, t0, level=level,
                                                      accept_first=occlusion)
        assert torch.equal(got[2], want[2])
        hits = want[2] >= 0
        if not occlusion:
            torch.testing.assert_close(got[0][hits], want[0][hits], rtol=0, atol=1e-6)
            torch.testing.assert_close(got[1][hits], want[1][hits], rtol=0, atol=1e-6)


def test_per_geometry_route_calls_each_geometry_once_over_all_rays(route_rays, monkeypatch):
    # One march call per SDF geometry and one mesh call per mesh in a pass,
    # each over all the pass's rays behind its gate: the launch count of a
    # frame on the GPU does not depend on which rays a gate admits.
    scene, o, d, *_ = route_rays
    calls = []

    def recorder(kind, fn):
        def record(*args, **kw):
            rays = args[0] if kind == "march" else args[1]  # the mesh entry takes rows first
            calls.append((kind, rays.shape[0]))
            return fn(*args, **kw)
        return record

    monkeypatch.setattr(megakernel, "sphere_trace_plain",
                        recorder("march", megakernel.sphere_trace_plain))
    monkeypatch.setattr(megakernel, "trimesh_closest_plain",
                        recorder("mesh", megakernel.trimesh_closest_plain))
    _, ob, db, act, t0 = traverse.pass_inputs(o, d, scene)
    act = act & (torch.arange(act.shape[0]) % 2 == 0)  # half the rays gated out
    traverse.per_geometry_route(plain=True)(scene, ob, db, act, t0, level=2)
    n_sdf = sum(int(k) == 2 for k in scene.layout.kinds)
    assert sorted(calls) == [("march", o.shape[0])] * n_sdf + [("mesh", o.shape[0])] * len(
        scene.arrays.meshes)


def test_per_geometry_route_frame_within_golden_bar(monkeypatch):
    # The route marches bounce levels at the level-0 budget where the XLA
    # path that rendered the golden caps them: only marches that need more
    # steps than the bounce cap move, which keeps the frame within the bar.
    calls = []

    def route(scene, plain, pack):
        calls.append(1)
        return traverse.per_geometry_route(plain=True)

    monkeypatch.setattr(traverse, "_procedural_pass", route)
    cfg = meshes.get_config(SCENE)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        img = trace.render_wavefront(cfg.build(W / H, T_ANIM, device="cpu"), W, H,
                                     max_depth=cfg.max_depth).numpy()
    finally:
        torch.set_num_threads(n)
    assert len(calls) == 5  # 3 closest + 2 occlusion passes
    ref = np.load(os.path.join(HERE, f"golden_torch_{SCENE}_96x54_t0p7.npz"))["image"]
    diff = np.abs(img - ref).max(axis=-1)
    flipped = diff > 1e-3
    assert flipped.mean() < 0.02, f"{flipped.sum()} pixels flipped"
    agree = diff[~flipped]
    assert agree.max() <= 1e-3 and (agree < 1e-5).mean() > 0.75


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the march kernel has no CPU build)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("occlusion", [False, True], ids=["closest", "occlusion"])
@pytest.mark.parametrize("code", list(range(9)))
def test_march_kernel_matches_plain_on_cuda(cuda_device, code, occlusion):
    # The shipped build contracts multiply-adds, which moves a march
    # crossing by a step on a few rays (chip_smoke.py's ray-batch bar).
    rng = np.random.default_rng(40 + code)
    o = rng.uniform(-3.0, 3.0, size=(65536, 3)).astype(np.float32)
    aim = rng.uniform(-0.6, 0.6, size=(65536, 3)).astype(np.float32)
    d = (aim - o) / np.linalg.norm(aim - o, axis=-1, keepdims=True)
    o, d = torch.from_numpy(o).to(cuda_device), torch.from_numpy(d).to(cuda_device)
    gate = torch.ones(o.shape[0], dtype=torch.bool, device=cuda_device)
    t_max = torch.full((o.shape[0],), 10.0, device=cuda_device)
    kw = spec(code, occlusion)
    launches = megakernel.LAUNCHES
    k_hit, k_t, _ = megakernel.sphere_trace_tiles(o, d, gate, t_max, 0.9, **kw)
    torch.cuda.synchronize()
    assert megakernel.LAUNCHES == launches + 1
    p_hit, p_t, _ = megakernel.sphere_trace_plain(o, d, gate, t_max, 0.9, **kw)
    assert float((k_hit == p_hit).float().mean()) >= 0.98
    dt = (k_t - p_t).abs()[k_hit & p_hit]
    assert dt.numel() > 0 and float((dt <= 1e-3).float().mean()) >= 0.98


@pytest.mark.cuda
def test_per_geometry_route_matches_plain_on_cuda(cuda_device):
    scene = meshes.get_config(SCENE).build(W / H, T_ANIM, device=cuda_device)
    before = (megakernel.LAUNCHES, megakernel.MESH_LAUNCHES, scene_kernel.LAUNCHES)
    img = trace.render_frame(scene, W, H)
    torch.cuda.synchronize()
    # 3 closest + 2 occlusion passes, each one march launch per SDF
    # geometry (2) and one mesh launch (1); the scene kernel never runs.
    assert (megakernel.LAUNCHES - before[0], megakernel.MESH_LAUNCHES - before[1],
            scene_kernel.LAUNCHES - before[2]) == (10, 5, 0)
    plain = trace.render_wavefront(scene, W, H, plain=True)
    diff = (img - plain).abs().amax(dim=-1).cpu().numpy()
    flipped = diff > 1e-3
    assert flipped.mean() < 0.02
    agree = diff[~flipped]
    assert agree.max() <= 1e-3 and (agree < 1e-5).mean() > 0.75
