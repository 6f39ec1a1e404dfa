"""The per-geometry route's kernels (kernels/megakernel.py: the pass entry,
row 7 of the kernel table in PERF.md, and the mesh entry) and the route.

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
- ``route_pass`` (the pass entry's wrapper) runs its plain version on a
  CPU tensor, launches nothing and refuses malformed inputs; the route at
  level 0 against the JAX package's XLA closest_hit / any_hit at level 0
  (accel/traverse.py:317, :398; the same budgets) on the 512 rays above,
  read from tests/golden_torch_route_level0.npz (written by running this
  file: JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_megakernel.py,
  so that no JAX traversal compiles here): equal geometry ids and
  occlusion, t within 1e-6 + 1e-5 * t (test_torch_trimesh.py's bound:
  the reference's dot products are jnp.sums whose order XLA picks), mesh
  and plane normals within 1e-6 (a tie of faces within that t bound would
  be named; these rays have none), march normals within 1e-3 on >= 99% of
  their hits and 5e-2 on all (the march kernel's bar above).

On a GPU (the ``cuda`` marker) the march kernel is held to its plain
version on ray batches for every SDF code, and its march specialized on
the code to the generic march's build (-DGPRT_SPHERE_MARCH_GENERIC) bit
for bit, with no host sync; the pass entry to the
unculled face loop's build (-DGPRT_FACE_LOOP_GLOBAL) bit for bit and to
its plain version on these rays (equal ids; t within 1e-3 but where
contraction moves a march crossing); the route on the card to the JAX
golden above; the mesh entry to the unculled loop on the heightfield's
faces with grazing rays; and the route's frame to the route's plain
version, with its exact launch counts.
"""

import os

import numpy as np
import pytest
import torch

from gpuraytracer_tpu_torch.accel import traverse
from gpuraytracer_tpu_torch.core import camera as cam
from gpuraytracer_tpu_torch.core import hlsl
from gpuraytracer_tpu_torch.geometry import analytic, sdf
from gpuraytracer_tpu_torch.kernels import build, frame_kernel, megakernel, scene_kernel
from gpuraytracer_tpu_torch.models import meshes
from gpuraytracer_tpu_torch.render import trace

HERE = os.path.dirname(os.path.abspath(__file__))
W, H = 96, 54
T_ANIM = 0.7
SCENE = "mesh_heightfield_sdf"
ROUTE_GOLDEN = os.path.join(HERE, "golden_torch_route_level0.npz")


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


def _route_rays(device="cpu"):
    """512 camera rays through seeded pixels of the 544-face scene, their
    level-0 closest hits, and shadow rays off them: (scene, o, d, hit
    points, shadow directions, hit mask)."""
    scene = meshes.get_config(SCENE).build(W / H, T_ANIM, device=device)
    assert not traverse._scene_kernel_eligible(scene)
    rng = np.random.default_rng(21)
    pix = torch.from_numpy(rng.choice(W * H, size=512, replace=False)).to(device)
    c = scene.arrays.constants
    o, d = cam.generate_camera_rays(pix % W, pix // W, W, H, c.camera_position,
                                    c.projection_to_world)
    hit = traverse.closest_hit(o, d, scene, level=0, plain=True)
    hp = o + hit.t[:, None] * d
    shadow = hlsl.normalize(c.light_position[:3] - hp)
    return scene, o, d, hp, shadow, hit.hit


@pytest.fixture(scope="module")
def route_rays():
    return _route_rays()


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


def test_route_pass_runs_plain_version_on_cpu(route_rays):
    scene, o, d, hp, shadow, hit = route_rays
    launches = (megakernel.PASS_LAUNCHES, megakernel.LAUNCHES, megakernel.MESH_LAUNCHES)
    for (oo, dd, act, occ) in ((o, d, None, False), (hp, shadow, hit, True)):
        _, ob, db, a, t0 = traverse.pass_inputs(oo, dd, scene, active=act, occlusion=occ)
        got = megakernel.route_pass(scene, ob, db, a, t0, level=2, accept_first=occ)
        want = megakernel.route_pass_plain(scene, ob, db, a, t0, accept_first=occ)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert bool((got[2] >= 0).any())
    assert (megakernel.PASS_LAUNCHES, megakernel.LAUNCHES, megakernel.MESH_LAUNCHES) == launches
    assert traverse.per_geometry_route(plain=True) is megakernel.route_pass_plain
    _, ob, db, a, t0 = traverse.pass_inputs(o, d, scene)
    with pytest.raises(ValueError, match="t0"):
        megakernel.route_pass(scene, ob, db, a, t0.double())
    with pytest.raises(ValueError, match="active"):
        megakernel.route_pass(scene, ob, db, a[:-1], t0)
    with pytest.raises(ValueError, match="d_blas"):
        megakernel.route_pass(scene, ob, db[:, :2], a, t0)
    with pytest.raises(ValueError, match="no megakernel"):
        megakernel.route_residency(frame_kernel.pack_frame(scene))
    assert (megakernel.PASS_LAUNCHES, megakernel.LAUNCHES, megakernel.MESH_LAUNCHES) == launches


@pytest.mark.parametrize("occlusion", [False, True], ids=["closest", "occlusion"])
def test_route_matches_reference_xla_at_level_0(route_rays, occlusion, monkeypatch):
    # The wavefront's traversal with the pass function of the route's
    # wrapper (its plain version here, on CPU tensors) against the JAX
    # package's XLA traversal at level 0.
    scene, o, d, hp, shadow, hit = route_rays
    ref = np.load(ROUTE_GOLDEN)
    for name, x in (("o", o), ("d", d), ("hp", hp), ("shadow", shadow), ("active", hit)):
        np.testing.assert_array_equal(x.numpy(), ref[name], name)
    monkeypatch.setattr(traverse, "_procedural_pass",
                        lambda scene, plain, pack: traverse.per_geometry_route(False, pack))
    if occlusion:
        occ = traverse.any_hit(hp, shadow, scene, active=hit, level=0).numpy()
        np.testing.assert_array_equal(occ, ref["occluded"])
        assert occ.any() and not occ[hit.numpy()].all()
        return
    rec = traverse.closest_hit(o, d, scene, level=0)
    gid, t, n = rec.geometry_id.numpy(), rec.t.numpy(), rec.normal.numpy()
    np.testing.assert_array_equal(gid, ref["gid"])
    hits = gid >= 0
    assert np.abs(t - ref["t"])[hits].max() <= (1e-6 + 1e-5 * np.abs(ref["t"]))[hits].max()
    assert (np.abs(t - ref["t"]) <= 1e-6 + 1e-5 * np.abs(ref["t"]))[hits].all()
    kinds = np.array([int(k) for k in scene.layout.kinds] + [-1])  # the plane last
    marched = hits & np.isin(kinds[np.where(hits, gid, -1)], (1, 2))
    exact = hits & ~marched
    assert marched.any() and (kinds[gid[exact]] == 3).any()
    np.testing.assert_allclose(n[exact], ref["normal"][exact], rtol=0, atol=1e-6)
    dn = np.abs(n[marched] - ref["normal"][marched]).max(axis=-1)
    assert (dn <= 1e-3).mean() >= 0.99 and dn.max() <= 5e-2, dn.max()


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
@pytest.mark.parametrize("occlusion", [False, True], ids=["closest", "occlusion"])
@pytest.mark.parametrize("code", list(range(9)))
def test_specialized_march_equals_the_generic_build_on_cuda(cuda_device, code, occlusion):
    rng = np.random.default_rng(60 + code)
    o = rng.uniform(-3.0, 3.0, size=(65536, 3)).astype(np.float32)
    aim = rng.uniform(-0.6, 0.6, size=(65536, 3)).astype(np.float32)
    d = (aim - o) / np.linalg.norm(aim - o, axis=-1, keepdims=True)
    o, d = torch.from_numpy(o).to(cuda_device), torch.from_numpy(d).to(cuda_device)
    gate = torch.from_numpy(rng.random(65536) < 0.05).to(cuda_device)
    t_max = torch.full((o.shape[0],), 10.0, device=cuda_device)
    kw = spec(code, occlusion)
    if code in sdf.AABB_WINDOWED_CODES:
        lo, hi = analytic.aabb_interval(o, d, torch.full((3,), -1.0, device=cuda_device),
                                        torch.full((3,), 1.0, device=cuda_device))
        kw["t_start"], t_max = lo.clamp(min=0.0), torch.minimum(t_max, hi)
        gate &= (hi > lo) & (t_max > kw["t_start"])
    generic = megakernel.sphere_trace_tiles(
        o, d, gate, t_max, 0.9, lib=build.load("megakernel", defines=megakernel.GENERIC_DEFINES),
        **kw)
    launches = megakernel.LAUNCHES
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        coded = megakernel.sphere_trace_tiles(o, d, gate, t_max, 0.9, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert megakernel.LAUNCHES == launches + 1
    assert int(gate.sum()) > 0
    assert all(torch.equal(x, y) for x, y in zip(coded, generic))


@pytest.mark.cuda
def test_per_geometry_route_matches_plain_on_cuda(cuda_device):
    scene = meshes.get_config(SCENE).build(W / H, T_ANIM, device=cuda_device)
    before = (megakernel.LAUNCHES, megakernel.MESH_LAUNCHES, megakernel.PASS_LAUNCHES,
              scene_kernel.LAUNCHES)
    img = trace.render_frame(scene, W, H)
    torch.cuda.synchronize()
    # 3 closest + 2 occlusion passes, one pass-entry launch each; the
    # one-geometry entries and the scene kernel never run.
    assert (megakernel.LAUNCHES - before[0], megakernel.MESH_LAUNCHES - before[1],
            megakernel.PASS_LAUNCHES - before[2], scene_kernel.LAUNCHES - before[3]) == (0, 0, 5, 0)
    plain = trace.render_wavefront(scene, W, H, plain=True)
    diff = (img - plain).abs().amax(dim=-1).cpu().numpy()
    flipped = diff > 1e-3
    assert flipped.mean() < 0.02
    agree = diff[~flipped]
    assert agree.max() <= 1e-3 and (agree < 1e-5).mean() > 0.75


def _marched(scene, gid):
    """Which rays' winner is a marched geometry (SDF or volumetric)."""
    kinds = torch.tensor([int(k) for k in scene.layout.kinds] + [-1], device=gid.device)
    return (gid >= 0) & torch.isin(kinds[torch.where(gid >= 0, gid, -1)],
                                   torch.tensor([1, 2], device=gid.device))


@pytest.mark.cuda
@pytest.mark.parametrize("occlusion", [False, True], ids=["closest", "occlusion"])
def test_route_pass_matches_plain_on_cuda(cuda_device, occlusion):
    # The shipped face loop gives the unculled loop's rays bit for bit;
    # against the plain version, every ray's geometry id, every exact hit's
    # t within 1e-3, and a march's t within 1e-3 but where contraction moved
    # its crossing by a step (at most 1% of the marched hits).
    scene, o, d, hp, shadow, hit = _route_rays(cuda_device)
    oo, dd, act = (hp, shadow, hit) if occlusion else (o, d, None)
    _, ob, db, a, t0 = traverse.pass_inputs(oo, dd, scene, active=act, occlusion=occlusion)
    launches = megakernel.PASS_LAUNCHES
    out = megakernel.route_pass(scene, ob, db, a, t0, accept_first=occlusion)
    unculled = megakernel.route_pass(scene, ob, db, a, t0, accept_first=occlusion,
                                     lib=build.load("megakernel", faces_global=True))
    torch.cuda.synchronize()
    assert megakernel.PASS_LAUNCHES == launches + 2
    assert all(torch.equal(x, y) for x, y in zip(out, unculled))
    pt, _, pg = megakernel.route_pass_plain(scene, ob, db, a, t0, accept_first=occlusion)
    kt, _, kg = out
    assert torch.equal(kg, pg) and bool((pg >= 0).any())
    far = (kt - pt).abs() > 1e-3
    marched = _marched(scene, pg)
    assert not bool((far & (pg >= 0) & ~marched).any())
    assert int((far & marched).sum()) <= 0.01 * int(marched.sum()), int((far & marched).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("occlusion", [False, True], ids=["closest", "occlusion"])
def test_route_pass_matches_reference_xla_on_cuda(cuda_device, occlusion):
    # The route on the card (one pass-entry launch a pass) against the JAX
    # package's XLA traversal at level 0 on the golden's 512 rays: equal ids
    # and occlusion, exact hits' t within the CPU test's 1e-6 + 1e-5 t, mesh
    # and plane normals within 1e-6; the marches within 1e-3 in t on >= 99%
    # of their hits (contraction can move a crossing by a step) and their
    # normals within the CPU test's bar.
    scene = meshes.get_config(SCENE).build(W / H, T_ANIM, device=cuda_device)
    ref = np.load(ROUTE_GOLDEN)
    on = {k: torch.from_numpy(ref[k]).to(cuda_device) for k in ("o", "d", "hp", "shadow",
                                                                "active")}
    launches = megakernel.PASS_LAUNCHES
    if occlusion:
        occ = traverse.any_hit(on["hp"], on["shadow"], scene, active=on["active"], level=0)
        torch.cuda.synchronize()
        assert megakernel.PASS_LAUNCHES == launches + 1
        np.testing.assert_array_equal(occ.cpu().numpy(), ref["occluded"])
        return
    rec = traverse.closest_hit(on["o"], on["d"], scene, level=0)
    torch.cuda.synchronize()
    assert megakernel.PASS_LAUNCHES == launches + 1
    gid, t, n = (x.cpu().numpy() for x in (rec.geometry_id, rec.t, rec.normal))
    np.testing.assert_array_equal(gid, ref["gid"])
    hits = gid >= 0
    marched = _marched(scene, rec.geometry_id).cpu().numpy()
    exact = hits & ~marched
    dt = np.abs(t - ref["t"])
    assert (dt <= 1e-6 + 1e-5 * np.abs(ref["t"]))[exact].all()
    np.testing.assert_allclose(n[exact], ref["normal"][exact], rtol=0, atol=1e-6)
    assert marched.any() and (dt[marched] <= 1e-3).mean() >= 0.99
    dn = np.abs(n[marched] - ref["normal"][marched]).max(axis=-1)
    assert (dn <= 1e-3).mean() >= 0.99 and dn.max() <= 5e-2, dn.max()


@pytest.mark.cuda
def test_mesh_entry_face_loops_agree_on_cuda(cuda_device):
    # The 544-face heightfield's rows and seeded rays, a third of them
    # grazing a face: staging and the chunk skip change no ray against the
    # unculled loop (the -DGPRT_FACE_LOOP_GLOBAL build).
    scene = meshes.get_config(SCENE).build(W / H, T_ANIM, device=cuda_device)
    rows = scene.arrays.meshes[0].rows().contiguous()
    o, d, t_max = (torch.from_numpy(x).to(cuda_device)
                   for x in seeded_face_rays(rows.cpu().numpy(), 6144, seed=3))
    gate = torch.ones(o.shape[0], dtype=torch.bool, device=cuda_device)
    outs = [megakernel.trimesh_closest(rows, o, d, gate, t_max, lib=lib)
            for lib in (None, build.load("megakernel", faces_global=True))]
    assert all(torch.equal(x, y) for x, y in zip(*outs))
    # Against the plain version on the rays that graze no face: on a
    # grazing ray det is rounding noise, which the shipped build's
    # contraction turns into another answer on some of them.
    p_hit, p_t, _ = megakernel.trimesh_closest_plain(rows, o, d, gate, t_max)
    aimed = torch.arange(o.shape[0], device=cuda_device) % 3 != 0
    assert float((outs[0][0] == p_hit)[aimed].float().mean()) >= 0.99 and bool(p_hit.any())


def seeded_face_rays(rows, n, seed):
    """(o, d, t_max) of n seeded local rays at a mesh's (F, 12) f32 rows:
    two thirds aimed at a random point of a random face from up to 3 units
    away, one third grazing a random face (a direction in its plane, tilted
    off it so that det = dot(e1, d x e2) lies between 1e-12 and 1e-6, either
    sign), from a point of the face's plane up to 1 unit before it."""
    rng = np.random.default_rng(seed)
    f = rng.integers(0, rows.shape[0], size=n)
    v0, e1, e2 = rows[f, 0:3], rows[f, 3:6], rows[f, 6:9]
    a, b = rng.random((2, n, 1))
    a, b = np.where(a + b > 1.0, 1.0 - a, a), np.where(a + b > 1.0, 1.0 - b, b)
    p = v0 + a * e1 + b * e2
    o = p + rng.uniform(-3.0, 3.0, size=(n, 3))
    d = p - o
    graze = np.arange(n) % 3 == 0
    nrm = np.cross(e1, e2)
    nh = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
    inplane = rng.normal(size=(n, 3))
    inplane -= (inplane * nh).sum(-1, keepdims=True) * nh
    inplane /= np.linalg.norm(inplane, axis=-1, keepdims=True)
    det = 10.0 ** rng.uniform(-12.0, -6.0, size=(n, 1)) * rng.choice([-1.0, 1.0], size=(n, 1))
    tilt = -det / np.linalg.norm(nrm, axis=-1, keepdims=True)  # det = -dot(d, e1 x e2)
    d_g = inplane + tilt * nh
    o_g = p - rng.uniform(0.0, 1.0, size=(n, 1)) * d_g
    o, d = np.where(graze[:, None], o_g, o), np.where(graze[:, None], d_g, d)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = rng.uniform(1.0, 8.0, size=n)
    return o.astype(np.float32), d.astype(np.float32), t_max.astype(np.float32)


if __name__ == "__main__":
    # Write the JAX package's XLA traversal at level 0 on the route's rays.
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from gpuraytracer_tpu.accel import traverse as j_traverse
    from gpuraytracer_tpu.models import builder as j_builder

    scene, o, d, hp, shadow, hit = _route_rays()
    j_scene = meshes.heightfield_sdf_builder(j_builder).build(W / H, T_ANIM)
    rec = j_traverse.closest_hit(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), j_scene, level=0)
    occ = j_traverse.any_hit(jnp.asarray(hp.numpy()), jnp.asarray(shadow.numpy()), j_scene,
                             active=jnp.asarray(hit.numpy()), level=0)
    np.savez_compressed(ROUTE_GOLDEN, o=o.numpy(), d=d.numpy(), hp=hp.numpy(),
                        shadow=shadow.numpy(), active=hit.numpy(),
                        t=np.asarray(rec.t, np.float32), normal=np.asarray(rec.normal, np.float32),
                        gid=np.asarray(rec.geometry_id, np.int64), occluded=np.asarray(occ))
    print(ROUTE_GOLDEN)
