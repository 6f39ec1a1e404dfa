"""The compacted frame modes, GPURT_FRAME_MODE=compact|defer (kernel-table
rows 2-4: the reference's frame_kernel.render_frame_compact,
render_frame_deferred and _shadow_queue_kernel), on the CPU, where each of
the port's kernels runs its plain version under the same host code.

- The capped march: for every SDF code, closest and occlusion, on one
  seeded 16x128 batch at 8 steps, the port's capped lanes
  (sdf.sphere_trace's ``return_capped``) are the reference's: the lanes
  that hit under the XLA sphere_trace's ``capped_hit=True`` and not under
  ``capped_hit=False`` (gpuraytracer_tpu/geometry/sdf.py:782-788). Hits
  agree, and t within 1e-5 where neither run capped: the two programs
  differ in the last ulp of a distance (XLA contracts multiply-adds). Both
  sides march with the escape bound, codes 7 and 8 too, so that two JAX
  programs (a switch over the nine distance functions, unrelaxed and
  relaxed) cover the 18 cases.
- The capped traversal (scene_kernel.scene_closest_plain with a step cap
  and a dirty mask) against the uncapped one on builtin rays: some lanes
  are dirty, and every other lane is bit for bit the uncapped answer (a
  march that resolves within its cap is a strict prefix of the full one).
- The slice on the builtin frame, 96x54, t = 0.7, depth 3 (the
  reference's tests/test_compact.py and test_defer.py, mirrored without
  running its Pallas kernels): compact equals the plain frame bit for bit
  at cap 8 and at the default cap; defer is within 4e-6 (the reference's
  bar; on the CPU it is exact); both pass the image bar against the
  committed golden; a queue that overflows renders the plain kernel; a
  scene no cap can touch takes the plain kernel at once.
- The routes: GPURT_FRAME_MODE reaches only fused-eligible scenes and
  raises on no CUDA route; GPURT_MERGED_SHADOW raises on no route either
  and moves no scene to another one.

On a GPU (the ``cuda`` marker) the compact, dense and defer entries of
csrc/frame_kernel.cu and the queue kernel of csrc/scene_kernel.cu are held
to their plain versions.
"""

import os

import numpy as np
import pytest
import torch

from gpuraytracer_tpu_torch.accel import traverse
from gpuraytracer_tpu_torch.core import camera as cam
from gpuraytracer_tpu_torch.core import hlsl
from gpuraytracer_tpu_torch.core.types import AnalyticPrimitive, IntersectorKind
from gpuraytracer_tpu_torch.geometry import sdf
from gpuraytracer_tpu_torch.kernels import frame_kernel, scene_kernel
from gpuraytracer_tpu_torch.models import builder, builtin, meshes
from gpuraytracer_tpu_torch.render import trace

HERE = os.path.dirname(os.path.abspath(__file__))
W, H = 96, 54
T_ANIM = 0.7
ULP_BAR = 4e-6  # tests/test_defer.py
MARCH_STEPS = 8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_bar(img, ref):
    """The image bar of tests/test_frame_kernel.py."""
    diff = np.abs(np.asarray(img, np.float32) - np.asarray(ref, np.float32)).max(axis=-1)
    flipped = diff > 1e-3
    assert flipped.mean() < 0.02, f"{flipped.sum()} pixels flipped"
    agree = diff[~flipped]
    assert agree.max() <= 1e-3
    assert (agree < 1e-5).mean() > 0.75


# ---------------------------------------------------------------------------
# The capped march against the reference's XLA sphere_trace
# ---------------------------------------------------------------------------

def march_batch():
    """One seeded 16x128 batch of rays aimed at the local unit box."""
    rng = np.random.default_rng(44)
    o = rng.uniform(-3.0, 3.0, size=(16 * 128, 3)).astype(np.float32)
    aim = rng.uniform(-0.6, 0.6, size=(16 * 128, 3)).astype(np.float32)
    d = (aim - o) / np.linalg.norm(aim - o, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


MARCH_CASES = [(code, occ) for code in range(9) for occ in (False, True)]


@pytest.fixture(scope="module")
def reference_marches():
    """{(code, occlusion): (hit, t, capped)} of the reference's XLA
    sphere_trace at MARCH_STEPS steps; capped = hit under capped_hit=True
    and not under capped_hit=False."""
    import jax
    import jax.numpy as jnp
    from gpuraytracer_tpu.geometry import sdf as j_sdf
    import gpuraytracer_tpu.geometry.fractal  # noqa: F401  (registers codes 7, 8)

    fns = [j_sdf.DISTANCE_FUNCTIONS[c] for c in range(9)]
    o, d = (jnp.asarray(x) for x in march_batch())
    programs = {}
    out = {}
    for code, occ in MARCH_CASES:
        relax = sdf.relax_for_code(code, occlusion=occ)
        if relax not in programs:
            def run(o, d, i, capped_hit, relax=relax):
                return j_sdf.sphere_trace(
                    o, d, lambda p: jax.lax.switch(i, fns, p), step_scale=0.9, t_max=10.0,
                    cull_backface=True, max_steps=MARCH_STEPS, relax=relax,
                    capped_hit=capped_hit, escape_bound=True, unroll=1)[:2]
            programs[relax] = jax.jit(run)
        hit_c, _ = programs[relax](o, d, jnp.asarray(code), jnp.asarray(True))
        hit, t = programs[relax](o, d, jnp.asarray(code), jnp.asarray(False))
        hit, hit_c = np.asarray(hit), np.asarray(hit_c)
        out[(code, occ)] = (hit, np.asarray(t), hit_c & ~hit)
    return out


@pytest.mark.parametrize("code, occlusion", MARCH_CASES,
                         ids=[f"{c}-{'occlusion' if o else 'closest'}" for c, o in MARCH_CASES])
def test_capped_march_matches_reference(reference_marches, code, occlusion):
    j_hit, j_t, j_capped = reference_marches[(code, occlusion)]
    o, d = (torch.from_numpy(x) for x in march_batch())
    n = o.shape[0]
    hit, t, capped = sdf.sphere_trace(
        o, d, sdf.DISTANCE_FUNCTIONS[code], step_scale=0.9, t_max=torch.full((n,), 10.0),
        cull_backface=True, active=torch.ones(n, dtype=torch.bool), max_steps=MARCH_STEPS,
        escape_bound=True, relax=sdf.relax_for_code(code, occlusion=occlusion),
        return_capped=True)
    assert j_capped.any()
    np.testing.assert_array_equal(capped.numpy(), j_capped)
    np.testing.assert_array_equal(hit.numpy(), j_hit)
    both = j_hit & ~j_capped
    np.testing.assert_allclose(t.numpy()[both], j_t[both], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# The capped traversal is a strict prefix of the plain one
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def builtin_rays():
    """1024 seeded camera rays of the 96x54 builtin frame, their level-0
    hits, and the reflection and shadow rays off them."""
    scene = builtin.build_scene(aspect=W / H, elapsed_time=T_ANIM, device="cpu")
    pix = torch.from_numpy(np.random.default_rng(5).choice(W * H, size=1024, replace=False))
    c = scene.arrays.constants
    o, d = cam.generate_camera_rays(pix % W, pix // W, W, H, c.camera_position,
                                    c.projection_to_world)
    hit = traverse.closest_hit(o, d, scene, level=0, plain=True)
    hp = o + hit.t[:, None] * d
    return scene, o, d, hp, hlsl.reflect(d, hit.normal), \
        hlsl.normalize(c.light_position[:3] - hp), hit.hit


PREFIX_CASES = [("closest", 0), ("closest", 1), ("accept_first", 0), ("accept_first", 1)]


@pytest.mark.parametrize("kind, level", PREFIX_CASES, ids=[f"{k}-{lv}" for k, lv in PREFIX_CASES])
def test_capped_pass_is_a_strict_prefix(builtin_rays, kind, level):
    scene, o, d, hp, refl, shadow, hit = builtin_rays
    occlusion = kind == "accept_first"
    if occlusion:
        rays, active = (hp, shadow), hit
    else:
        rays, active = ((o, d), None) if level == 0 else ((hp, refl), hit)
    _, ob, db, act, t0 = traverse.pass_inputs(*rays, scene, active=active, occlusion=occlusion)
    want = scene_kernel.scene_closest_plain(scene, ob, db, act, t0, level=level,
                                            accept_first=occlusion)
    dirty = torch.zeros(ob.shape[0], dtype=torch.int32)
    got = scene_kernel.scene_closest_plain(scene, ob, db, act, t0, level=level,
                                           accept_first=occlusion, budget_cap=MARCH_STEPS,
                                           dirty=dirty, kill_on_cap=True)
    clean = dirty == 0
    assert int((~clean).sum()) > 0
    assert bool((want[2][clean] >= 0).any())
    for g, w in zip(got, want):
        assert torch.equal(g[clean], w[clean])


# ---------------------------------------------------------------------------
# The slice: builtin 96x54, depth 3, against the plain frame and the golden
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def builtin_frame():
    pack = frame_kernel.pack_frame(builtin.build_scene(aspect=W / H, elapsed_time=T_ANIM,
                                                       device="cpu"))
    golden = np.load(os.path.join(HERE, "golden_builtin_96x54_t0p7.npz"))["image"]
    return pack, frame_kernel.render_frame_plain(pack, width=W, height=H), golden


@pytest.mark.parametrize("cap", [MARCH_STEPS, None], ids=["cap8", "default_cap"])
def test_compact_equals_plain(builtin_frame, cap):
    pack, plain, golden = builtin_frame
    syncs = frame_kernel.HOST_SYNCS
    img, count = frame_kernel.render_frame_compact(pack, width=W, height=H, budget_cap=cap,
                                                   debug_count=True)
    assert count > 0
    assert frame_kernel.HOST_SYNCS == syncs + 1
    assert torch.equal(img, plain)
    assert_bar(img.numpy(), golden)


@pytest.mark.parametrize("cap", [MARCH_STEPS, None], ids=["cap8", "default_cap"])
def test_deferred_within_ulp_of_plain(builtin_frame, cap):
    pack, plain, golden = builtin_frame
    img, count = frame_kernel.render_frame_deferred(pack, width=W, height=H, shadow_cap=cap,
                                                    debug_count=True)
    assert count > 0
    assert float((img - plain).abs().max()) < ULP_BAR
    assert_bar(img.numpy(), golden)


class FallbackSpy:
    """Stands in for the plain kernel: records its calls and returns a
    sentinel image, so a test sees whether (and how) the frame fell back."""

    def __init__(self):
        self.calls, self.image = [], None

    def __call__(self, pack, *, width, height, max_depth, row_offset=0, local_height=None):
        # A whole frame here: the band (row_offset, local_height) is all of it.
        assert row_offset == 0 and local_height in (None, height), (row_offset, local_height)
        self.calls.append((width, height, max_depth))
        self.image = torch.zeros(height, width, 4)
        return self.image


def test_compact_overflow_renders_the_plain_kernel(monkeypatch):
    # cap 1 dirties more of a 128x96 frame than one 4096-lane queue holds.
    w, h = 128, 96
    pack = frame_kernel.pack_frame(builtin.build_scene(aspect=w / h, elapsed_time=T_ANIM,
                                                       device="cpu"))
    spy = FallbackSpy()
    monkeypatch.setattr(frame_kernel, "render_frame_tiles", spy)
    dense = frame_kernel.DENSE_LAUNCHES
    img, count = frame_kernel.render_frame_compact(pack, width=w, height=h, budget_cap=1,
                                                   cap_lanes=4096, debug_count=True)
    assert count > 4096 == frame_kernel.queue_capacity(w, h, 4096)
    assert spy.calls == [(w, h, 3)] and img is spy.image
    assert frame_kernel.DENSE_LAUNCHES == dense


def test_deferred_overflow_renders_the_plain_kernel(monkeypatch):
    # A one-row queue tile makes the capacity 64 lanes a level, which the
    # unknown lanes of a 48x27 frame at shadow cap 1 exceed.
    w, h = 48, 27
    pack = frame_kernel.pack_frame(builtin.build_scene(aspect=w / h, elapsed_time=T_ANIM,
                                                       device="cpu"))
    monkeypatch.setattr(frame_kernel, "TILE_ROWS", 1)
    monkeypatch.setattr(frame_kernel, "TILE_COLS", 64)
    spy = FallbackSpy()
    monkeypatch.setattr(frame_kernel, "render_frame_tiles", spy)
    img, count = frame_kernel.render_frame_deferred(pack, width=w, height=h, shadow_cap=1,
                                                    cap_lanes=64, debug_count=True)
    assert count > 64 == frame_kernel.queue_capacity(w, h, 64)
    assert spy.calls == [(w, h, 3)] and img is spy.image


def test_uncappable_scene_short_circuits():
    # Closed forms only: no march can be capped, so both modes render the
    # plain kernel at once (frame_kernel.py:860-889, :1136-1157).
    b = builder.SceneBuilder()
    b.add_instance(builder.InstanceSpec(
        kind=IntersectorKind.ANALYTIC, prim_type=int(AnalyticPrimitive.SPHERES),
        aabb_min=(-1.0, -1.0, -1.0), aabb_max=(1.0, 1.0, 1.0),
        material=builder.Material((0.2, 0.9, 0.2, 1.0))))
    pack = frame_kernel.pack_frame(b.build(2.0, 0.0, device="cpu"))
    w, h = 32, 16
    plain = frame_kernel.render_frame_plain(pack, width=w, height=h, max_depth=2)
    before = (frame_kernel.HOST_SYNCS, frame_kernel.QUEUED_LANES)
    for render in (frame_kernel.render_frame_compact, frame_kernel.render_frame_deferred):
        img, count = render(pack, width=w, height=h, max_depth=2, debug_count=True)
        assert count == 0 and torch.equal(img, plain)
    assert (frame_kernel.HOST_SYNCS, frame_kernel.QUEUED_LANES) == before


# ---------------------------------------------------------------------------
# Routes
# ---------------------------------------------------------------------------

def instance_scene(n_materials):
    """n_materials closed-form instances, each with its own material."""
    b = builder.SceneBuilder()
    for k in range(n_materials):
        b.add_instance(builder.InstanceSpec(
            kind=IntersectorKind.ANALYTIC, prim_type=int(AnalyticPrimitive.SPHERES),
            aabb_min=(k - 8.0, -1.0, 0.0), aabb_max=(k - 7.0, 0.0, 1.0),
            material=builder.Material((0.05 * k, 0.5, 0.5, 1.0))))
    return b.build(1.0, 0.0, device="cpu")


@pytest.mark.parametrize("mode", ["compact", "defer"])
def test_frame_mode_reaches_only_fused_scenes(monkeypatch, mode):
    # The reference reads GPURT_FRAME_MODE only for a fused-eligible scene
    # (render/trace.py:226-247); every other scene takes its wavefront
    # route, and no route raises for the mode.
    monkeypatch.setenv("GPURT_FRAME_MODE", mode)
    fused = builtin.build_scene(aspect=1.0, device="cpu")
    many = instance_scene(16)  # 17 materials with the plane
    past_cap = meshes.get_config("mesh_heightfield_sdf").build(1.0, 0.0, device="cpu")
    assert trace.frame_route(fused) == ("frame", mode)
    assert trace.frame_route(many) == ("scene", "plain")
    assert trace.frame_route(past_cap) == ("per_geometry", "plain")
    with monkeypatch.context() as m:
        m.setenv("GPURT_DISABLE_FUSED", "1")
        assert trace.frame_route(fused) == ("scene", "plain")
        frame_kernel.check_kernel_covers(fused.layout, "scene")
    for scene in (fused, many, past_cap):
        frame_kernel.check_kernel_covers(scene.layout, trace.frame_route(scene)[0])
    # On the CPU a fused scene in the mode takes the mode's host code.
    calls = []
    monkeypatch.setattr(frame_kernel, f"render_frame_{'compact' if mode == 'compact' else 'deferred'}",
                        lambda pack, **kw: calls.append(kw) or torch.zeros(2, 2, 4))
    trace.render_frame(fused, 2, 2)
    assert calls == [dict(width=2, height=2, max_depth=3, row_offset=0, local_height=None)]


def test_merged_shadow_raises_only_on_the_kernels_that_reach_it(monkeypatch):
    # GPURT_MERGED_SHADOW raises on no route: the reference merges only in
    # its frame kernel family, where the merged banks are allocated
    # (frame_kernel._frame_scratch), and its scene kernel, which has no
    # banks (scene_kernel.py:1660-1661), marches in sequence and renders. The
    # knob moves no scene to another route, and a 17-material scene (the
    # scene kernel's route) renders on the CPU exactly what it renders
    # without it.
    fused = builtin.build_scene(aspect=1.0, device="cpu")
    many = instance_scene(16)
    past_cap = meshes.get_config("mesh_heightfield_sdf").build(1.0, 0.0, device="cpu")
    routes = [trace.frame_route(s) for s in (fused, many, past_cap)]
    image = trace.render_frame(many, 16, 9)
    monkeypatch.setenv("GPURT_MERGED_SHADOW", "1")
    assert [trace.frame_route(s) for s in (fused, many, past_cap)] == routes
    for scene, (route, _) in zip((fused, many, past_cap), routes):
        frame_kernel.check_kernel_covers(scene.layout, route)
    with monkeypatch.context() as m:
        m.setenv("GPURT_DISABLE_FUSED", "1")
        assert trace.frame_route(fused) == ("scene", "plain")
        frame_kernel.check_kernel_covers(fused.layout, "scene")
    assert routes[1] == ("scene", "plain")
    assert torch.equal(trace.render_frame(many, 16, 9), image)


def test_queue_capacity_follows_the_reference_rule():
    # 32x128 tiles, an eighth of the padded lanes, rounded up to a tile.
    assert frame_kernel.queue_capacity(1920, 1080) == 262144
    assert frame_kernel.queue_capacity(96, 54) == 4096
    assert frame_kernel.queue_capacity(128, 96, cap_lanes=1) == 4096
    assert frame_kernel.norm_caps(8) == (8, 8) and frame_kernel.norm_caps(None) == (None, None)


# ---------------------------------------------------------------------------
# On a GPU: each kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the frame-mode kernels have no CPU build)")
    return torch.device("cuda")


def counts():
    return (frame_kernel.LAUNCHES, frame_kernel.COMPACT_LAUNCHES, frame_kernel.DENSE_LAUNCHES,
            frame_kernel.DEFER_LAUNCHES, scene_kernel.QUEUE_LAUNCHES)


@pytest.mark.cuda
def test_compact_kernels_match_plain_on_cuda(cuda_device):
    w, h = 128, 72
    pack = frame_kernel.pack_frame(builtin.build_scene(aspect=w / h, elapsed_time=T_ANIM,
                                                       device=cuda_device))
    plain = frame_kernel.render_frame_tiles(pack, width=w, height=h)
    before = counts()
    img, count = frame_kernel.render_frame_compact(pack, width=w, height=h,
                                                   budget_cap=MARCH_STEPS, debug_count=True)
    torch.cuda.synchronize()
    assert count > 0
    assert tuple(a - b for a, b in zip(counts(), before)) == (0, 1, 1, 0, 0)
    assert_bar(img.cpu().numpy(), plain.cpu().numpy())
    # The dense pass runs the plain kernel's device code: the same pixels.
    _, dirty = frame_kernel.render_frame_capped(pack, width=w, height=h, budget_cap=MARCH_STEPS)
    q = torch.nonzero(dirty.reshape(-1)).squeeze(1).to(torch.int32)
    dense = frame_kernel.render_frame_dense(pack, (q % w).contiguous(), (q // w).contiguous(),
                                            width=w, height=h)
    assert torch.equal(dense, plain.reshape(-1, 4)[q.long()])
    _, p_dirty = frame_kernel.render_frame_capped_plain(pack, width=w, height=h,
                                                        budget_cap=MARCH_STEPS)
    assert float((dirty == p_dirty).float().mean()) >= 0.99


@pytest.mark.cuda
def test_deferred_kernels_match_plain_on_cuda(cuda_device):
    w, h = 128, 72
    pack = frame_kernel.pack_frame(builtin.build_scene(aspect=w / h, elapsed_time=T_ANIM,
                                                       device=cuda_device))
    plain = frame_kernel.render_frame_tiles(pack, width=w, height=h)
    before = counts()
    img, count = frame_kernel.render_frame_deferred(pack, width=w, height=h,
                                                    shadow_cap=MARCH_STEPS, debug_count=True)
    torch.cuda.synchronize()
    assert count > 0
    assert tuple(a - b for a, b in zip(counts(), before)) == (0, 0, 0, 1, 1)
    assert_bar(img.cpu().numpy(), plain.cpu().numpy())
    planes = frame_kernel.render_frame_deferred_main(pack, width=w, height=h,
                                                     shadow_cap=MARCH_STEPS)
    p_planes = frame_kernel.render_frame_deferred_plain(pack, width=w, height=h,
                                                        shadow_cap=MARCH_STEPS)
    assert float((planes.sinfo == p_planes.sinfo).float().mean()) >= 0.99
    idx = torch.nonzero((planes.sinfo[0].reshape(-1) & 3) == 2).squeeze(1)
    rays = planes.rays[0].reshape(-1, 6)[idx].contiguous()
    active = torch.ones(idx.shape[0], dtype=torch.bool, device=cuda_device)
    occ = scene_kernel.shadow_queue(pack, rays, active, rays.shape[0])
    p_occ = scene_kernel.shadow_queue_plain(pack, rays, active, rays.shape[0])
    assert float((occ == p_occ).float().mean()) >= 0.99
