"""The two-phase scene pass (kernel-table row 6: the reference's
scene_closest_tiles(two_phase=True), phases "main" and "finish") against
the port's single pass and against the reference.

- Level 0, the port's own forms: on seeded ray batches of the builtin
  scene, sdf_primitives_720p and the fractal scene (camera rays, closest;
  shadow rays, accept-first), the two-phase plain version
  (scene_kernel.scene_two_phase_plain) gives the single pass's answer on
  every ray, bit for bit, or the ray is one of the two named causes
  (``explain``): a ray whose metaball march the main pass capped (the
  finisher steps the metaballs over the interval clipped to the final best
  t, the single pass to the best t at the metaballs' turn), or a tie
  between two geometries at the same t (the strict-< reduction keeps
  whichever came first, and the two forms meet them in another order).
- Against the reference (the JAX package's two-phase Pallas kernel in
  interpret mode on the CPU, whose outputs on the same inputs are
  committed in tests/golden_torch_two_phase.npz, written by this file's
  ``__main__``: its calls take about a minute each): the main pass's
  dirty words (the reference's debug_dirty plane) agree on >= 98% of rays,
  counting as agreeing a ray that differs only in the metaball bit where
  the reference's closest-approach potential bound skips the march (the
  port marches it; a named, documented difference), the ray-batch bar (tests/test_scene_kernel.py:50-80 holds its Pallas
  kernel to the XLA path so; the two programs differ in the last ulp, which
  moves a march crossing at a silhouette); and at level 1 the port's
  two-phase answer agrees with the reference's two-phase answer on >= 98%
  of rays, hit t within 1e-3 + 1e-4 t where the geometry ids agree. At
  level 1 both differ from their own single passes where the finisher
  marches at the level-0 budget (closest: 160 steps where the single pass
  takes GPURT_MARCH_BUDGET_B = 128).

- The finisher's queue (scene_kernel.scene_finish_queue, its plain
  version on the CPU) holds every ray whose dirty word is not 0, once,
  ordered by the word's lowest set bit, on every committed batch; the plain
  finisher over the queued rays alone is scene_finish_plain over every ray,
  bit for bit.

On a GPU (the ``cuda`` marker) the main pass (csrc/scene_kernel.cu) and the
finish step (csrc/scene_finish.cu: the compaction, and the finisher over
its queue) are held to their plain versions; on the
builtin 1080p level-0 closest and shadow passes the finish step equals the
parent's one thread per ray (the -DGPRT_FINISH_PER_RAY build) bit for bit,
and the two-phase pass completes under
``torch.cuda.set_sync_debug_mode("error")``.
"""

import functools
import os

import numpy as np
import pytest
import torch

from gpuraytracer_tpu_torch.accel import traverse
from gpuraytracer_tpu_torch.accel.instances import ray_to_local
from gpuraytracer_tpu_torch.core import camera as cam
from gpuraytracer_tpu_torch.core import hlsl
from gpuraytracer_tpu_torch.core.types import METABALL_ISO_THRESHOLD, IntersectorKind
from gpuraytracer_tpu_torch.geometry import metaballs
from gpuraytracer_tpu_torch.kernels import frame_kernel, scene_kernel
from gpuraytracer_tpu_torch.models import builtin, scenes

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden_torch_two_phase.npz")
# 1024 seeded pixels of a FW x FH frame: one 8 x 128 block of the
# reference's tiles.
FW, FH = 160, 90
N_RAYS = 1024
T_ANIM = 0.7
SCENES = ("builtin", "sdf_primitives_720p", "fractal_mandelbulb_julia_1080p")
BATCHES = (("closest", 0), ("closest", 1), ("shadow", 0), ("shadow", 1))
# GPURT_MARCH_BUDGET_B at 16 steps: the single pass caps level-1 closest
# marches at 16 while the two-phase finisher marches them again at the
# level-0 budget, which shows the finisher's budget on many rays.
BOUNCE_16 = {"GPURT_MARCH_BUDGET_B": "16"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_scene(name, device="cpu"):
    if name == "builtin":
        return builtin.build_scene(aspect=FW / FH, elapsed_time=T_ANIM, device=device)
    return scenes.get_config(name).build(FW / FH, T_ANIM, device=device)


def make_batches(name):
    """{(kind, level): (o_blas, d_blas, active, t0)} of the camera rays
    through N_RAYS seeded pixels of the scene's FW x FH frame (closest,
    level 0), their reflections off the plain hits (closest, level 1) and
    shadow rays toward the light (accept-first)."""
    scene = port_scene(name)
    pix = np.random.default_rng(15).choice(FW * FH, size=N_RAYS, replace=False)
    px, py = torch.from_numpy(pix % FW), torch.from_numpy(pix // FW)
    c = scene.arrays.constants
    o, d = cam.generate_camera_rays(px, py, FW, FH, c.camera_position, c.projection_to_world)
    hit = traverse.closest_hit(o, d, scene, level=0, plain=True)
    hp = o + hit.t[:, None] * d
    rays = {("closest", 0): (o, d, None, False),
            ("closest", 1): (hp, hlsl.reflect(d, hit.normal), hit.hit, False)}
    for level in (0, 1):
        rays[("shadow", level)] = (hp, hlsl.normalize(c.light_position[:3] - hp), hit.hit, True)
    out = {}
    for key, (oo, dd, act, occlusion) in rays.items():
        _, ob, db, a, t0 = traverse.pass_inputs(oo, dd, scene, active=act, occlusion=occlusion)
        out[key] = (ob, db, a, t0)
    return out


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return dict(z)


def inputs(golden, name, kind, level):
    k = f"{name}/{kind}{level}/"
    return tuple(torch.from_numpy(golden[k + f]) for f in ("o_blas", "d_blas", "active", "t0"))


@functools.lru_cache(maxsize=None)
def port_scene_cached(name):
    return port_scene(name)


@functools.lru_cache(maxsize=None)
def golden_inputs(name, kind, level):
    with np.load(GOLDEN) as z:
        return inputs(z, name, kind, level)


@functools.lru_cache(maxsize=None)
def port_main(name, kind, level):
    """The port's plain main pass on the committed inputs, (best_t, normal,
    gid, dirty), computed once for the module."""
    return scene_kernel.scene_main_plain(port_scene_cached(name), *golden_inputs(name, kind, level),
                                         level=level, accept_first=kind == "shadow")


@functools.lru_cache(maxsize=None)
def port_passes(name, kind, level):
    """(single pass, two-phase form with its dirty words) of the port's plain
    versions on the committed inputs, computed once for the module: the
    two-phase form is scene_two_phase_plain's, the main pass then
    scene_finish_plain."""
    ob, db, a, t0 = golden_inputs(name, kind, level)
    scene = port_scene_cached(name)
    kw = dict(level=level, accept_first=kind == "shadow")
    *main, dirty = port_main(name, kind, level)
    return (scene_kernel.scene_closest_plain(scene, ob, db, a, t0, **kw),
            scene_kernel.scene_finish_plain(scene, ob, db, dirty, *main,
                                            accept_first=kw["accept_first"]) + (dirty,))


def explain(scene, single, two, dirty):
    """(metaball-step rays, tie rays, unexplained rays) among the rays whose
    (t, gid) differ between the single pass and the two-phase form."""
    (t1, _, g1), (t2, _, g2) = single[:3], two[:3]
    differ = (t1 != t2) | (g1 != g2)
    mb = torch.zeros_like(differ)
    for i, kind in enumerate(scene.layout.kinds):
        if kind == IntersectorKind.VOLUMETRIC:
            mb = mb | (((dirty >> min(i, 31)) & 1) != 0)
    tie = (g1 != g2) & (t1 == t2)
    return differ & mb, differ & ~mb & tie, differ & ~mb & ~tie


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("kind", ["closest", "shadow"])
def test_two_phase_plain_matches_single_at_level_0(name, kind):
    scene = port_scene_cached(name)
    single, (*two, dirty) = port_passes(name, kind, 0)
    single = list(single)
    assert int((dirty != 0).sum()) > 0  # the main pass capped some marches
    if kind == "shadow":
        # The answer is occluded or not; which geometry occludes first is not.
        single[2], two[2] = single[2] >= 0, two[2] >= 0
    mb, tie, unexplained = explain(scene, single, two, dirty)
    assert not bool(unexplained.any()), f"{int(unexplained.sum())} rays differ unexplained"
    same = ~(mb | tie)
    for s, t in zip(single, two):
        assert torch.equal(s[same], t[same])


def metaball_bound_empty(scene, o_blas, d_blas, t_max):
    """(rays, metaball geometry): the rays whose metaball march the
    reference's kernel skips because its closest-approach potential bound
    stays below the iso threshold (scene_kernel.py:751-772; the port marches
    them, so a capped one is dirty in the port only). The bound is taken
    over the interval clipped to t_max, a superset of the march's, so it
    proves no more rays empty than the reference's."""
    g = scene.layout.kinds.index(IntersectorKind.VOLUMETRIC)
    o, d = ray_to_local(o_blas, d_blas, scene.arrays.transforms.blas_to_local[g])
    centers, radii = metaballs.animated_metaballs(scene.arrays.constants.elapsed_time)
    tmin, tmax = metaballs.find_intersecting_metaballs(o, d, centers, radii, 0.0, t_max)
    dd = (d * d).sum(-1).clamp(min=1e-30)
    bound = torch.zeros_like(tmin)
    for c, r in zip(centers, radii):
        t_star = torch.minimum(torch.maximum(((c - o) * d).sum(-1) / dd, tmin), tmax)
        bound = bound + metaballs.metaball_potential(o + t_star[:, None] * d, c, r)
    return (tmax >= tmin) & (bound < METABALL_ISO_THRESHOLD - 1e-5), g


@pytest.mark.parametrize("name", SCENES)
def test_dirty_words_match_reference(golden, name):
    # A ray whose words differ only in the metaball bit, on a ray the
    # reference's potential bound proves empty, is the one named cause.
    scene = port_scene_cached(name)
    for kind, level in BATCHES:
        ob, db, a, t0 = inputs(golden, name, kind, level)
        dirty = port_passes(name, kind, level)[1][3]
        got, want = dirty.numpy(), golden[f"{name}/{kind}{level}/j2_dirty"]
        explained = np.zeros_like(got, dtype=bool)
        if IntersectorKind.VOLUMETRIC in scene.layout.kinds:
            empty, g = metaball_bound_empty(scene, ob, db, t0)
            explained = ((got ^ want) == (1 << g)) & ((got & (1 << g)) != 0) & empty.numpy()
        agree = float(((got == want) | explained).mean())
        assert agree >= 0.98, f"{kind} level {level}: dirty words agree on {agree:.4f}"
        assert (want != 0).any()


@pytest.mark.parametrize("name", SCENES)
def test_level_1_matches_reference_two_phase(golden, name):
    for kind in ("closest", "shadow"):
        k = f"{name}/{kind}1/"
        t, _, gid, _ = port_passes(name, kind, 1)[1]
        t, gid = t.numpy(), gid.numpy()
        jt, jg = golden[k + "j2_t"], golden[k + "j2_gid"]
        if kind == "shadow":
            gid, jg = gid >= 0, jg >= 0
        same = gid == jg
        assert same.mean() >= 0.98, f"{kind}: answers agree on {same.mean():.4f}"
        if kind == "closest":
            m = same & (jg >= 0)
            np.testing.assert_allclose(t[m], jt[m], rtol=1e-4, atol=1e-3)


def test_level_1_closest_differs_from_single_where_the_reference_does(golden, monkeypatch):
    # The finisher marches at the level-0 budget: at level 1 a closest ray
    # that the single pass leaves capped at the bounce budget can hit in
    # the two-phase form. With GPURT_MARCH_BUDGET_B=16 the reference's
    # two-phase answer moves away from its single pass on many rays, and
    # the port's forms move with it.
    for key, value in BOUNCE_16.items():
        monkeypatch.setenv(key, value)
    moved = 0
    for name in SCENES:
        k = f"{name}/closest1/"
        scene = port_scene_cached(name)
        ob, db, a, t0 = inputs(golden, name, "closest", 1)
        two = scene_kernel.scene_two_phase_plain(scene, ob, db, a, t0, level=1)[2].numpy()
        single = scene_kernel.scene_closest_plain(scene, ob, db, a, t0, level=1)[2].numpy()
        j2, j1 = golden[k + "b16_j2_gid"], golden[k + "b16_j1_gid"]
        assert (two == j2).mean() >= 0.98 and (single == j1).mean() >= 0.98
        j_moved = j2 != j1
        moved += int(j_moved.sum())
        assert ((two != single) == j_moved).mean() >= 0.98
    assert moved > 0


def test_wrapper_takes_two_phase_on_cpu(golden):
    scene = port_scene_cached("builtin")
    ob, db, a, t0 = inputs(golden, "builtin", "closest", 0)
    before = (scene_kernel.LAUNCHES, scene_kernel.MAIN_LAUNCHES, scene_kernel.FINISH_LAUNCHES)
    got = scene_kernel.scene_closest_tiles(scene, ob, db, a, t0, two_phase=True, debug_dirty=True)
    single, want = port_passes("builtin", "closest", 0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    got = scene_kernel.scene_closest_tiles(scene, ob, db, a, t0, debug_dirty=True)
    for g, w in zip(got, single):
        assert torch.equal(g, w)
    assert not bool(got[3].any())
    assert (scene_kernel.LAUNCHES, scene_kernel.MAIN_LAUNCHES,
            scene_kernel.FINISH_LAUNCHES) == before
    # A scene whose every march fits in PHASE_BUDGET takes the single pass.
    import dataclasses

    short = dataclasses.replace(scene, layout=dataclasses.replace(
        scene.layout, kinds=tuple(IntersectorKind.ANALYTIC if k == IntersectorKind.VOLUMETRIC
                                  else k for k in scene.layout.kinds),
        step_budgets=(64,) * scene.layout.num_procedural))
    assert scene_kernel.two_phase_runs(scene) and not scene_kernel.two_phase_runs(short)


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("kind, level", BATCHES)
def test_finish_queue_plain_holds_each_dirty_ray_once_in_key_order(name, kind, level):
    # The finisher's queue (on the CPU the wrapper's plain version): every
    # ray whose dirty word is not 0, once, ordered by its lowest set bit,
    # and in ray order within a key; the slots past the count hold -1.
    dirty = port_main(name, kind, level)[3]
    queue = scene_kernel.scene_finish_queue(dirty)
    n = int(queue.count[0])
    live = queue.idx[:n].long()
    assert n > 0 and torch.equal(torch.sort(live).values, torch.nonzero(dirty).squeeze(1))
    words, keys = dirty[live], scene_kernel.finish_key(dirty[live]).long()
    assert bool((((words >> keys) & 1) == 1).all())
    assert bool(((words & ((1 << keys) - 1)) == 0).all())
    assert bool((keys[1:] >= keys[:-1]).all())
    same = keys[1:] == keys[:-1]
    assert bool((live[1:] > live[:-1])[same].all())
    assert bool((queue.idx[n:] == -1).all())


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("kind", ["closest", "shadow"])
def test_queued_plain_finisher_is_scene_finish_plain(name, kind):
    # The plain finisher over the queued rays alone, scattered back, is
    # scene_finish_plain over every ray, bit for bit, at both levels.
    scene = port_scene_cached(name)
    for level in (0, 1):
        ob, db, _, _ = golden_inputs(name, kind, level)
        *main, dirty = port_main(name, kind, level)
        want = port_passes(name, kind, level)[1][:3]
        got = scene_kernel.scene_finish_queued_plain(
            scene, ob, db, dirty, scene_kernel.scene_finish_queue_plain(dirty), *main,
            accept_first=kind == "shadow")
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the scene kernel has no CPU build)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", SCENES)
def test_two_phase_kernels_match_plain_on_cuda(cuda_device, golden, name):
    scene = port_scene(name, cuda_device)
    pack = frame_kernel.pack_frame(scene)
    for kind, level in BATCHES:
        ob, db, a, t0 = (x.to(cuda_device) for x in inputs(golden, name, kind, level))
        kw = dict(level=level, accept_first=kind == "shadow")
        before = (scene_kernel.MAIN_LAUNCHES, scene_kernel.FINISH_LAUNCHES)
        kt, _, kg, kd = scene_kernel.scene_closest_tiles(scene, ob, db, a, t0, two_phase=True,
                                                         debug_dirty=True, pack=pack, **kw)
        torch.cuda.synchronize()
        assert (scene_kernel.MAIN_LAUNCHES, scene_kernel.FINISH_LAUNCHES) == (
            before[0] + 1, before[1] + 1)
        pt, _, pg, pd = scene_kernel.scene_two_phase_plain(scene, ob, db, a, t0, **kw)
        # The shipped build contracts multiply-adds (the ray-batch bar).
        assert float((kd == pd).float().mean()) >= 0.98
        same = kg == pg
        assert float(same.float().mean()) >= 0.98
        dt = (kt - pt).abs()[same & (pg >= 0)]
        assert dt.numel() == 0 or float((dt <= 1e-3).float().mean()) >= 0.98


def _1080p_passes(dev):
    """The builtin 1920x1080 frame's level-0 closest and shadow passes at t =
    0.2664 as the wavefront builds them: (scene, pack, {kind: (o, d, active,
    t0)})."""
    from gpuraytracer_tpu_torch.core.types import RAY_TMAX

    w, h = 1920, 1080
    scene = builtin.build_scene(aspect=w / h, elapsed_time=0.2664, device=dev)
    pack = frame_kernel.pack_frame(scene)
    px, py = cam.pixel_grid(w, h, dev)
    c = scene.arrays.constants
    o, d = cam.generate_camera_rays(px, py, w, h, c.camera_position, c.projection_to_world)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    hit_p, ob, db, act, t0 = traverse.pass_inputs(o, d, scene)
    st, _, sg = scene_kernel.scene_closest_tiles(scene, ob, db, act, t0, pack=pack)
    hp = o + torch.where(sg >= 0, st, torch.where(hit_p, t0, RAY_TMAX))[:, None] * d
    sd = hlsl.normalize(c.light_position[:3] - hp)
    _, obs, dbs, acts, t0s = traverse.pass_inputs(hp, sd, scene, active=(sg >= 0) | hit_p,
                                                  occlusion=True)
    return scene, pack, {"closest": (ob, db, act, t0), "shadow": (obs, dbs, acts, t0s)}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["closest", "shadow"])
def test_queued_finisher_equals_the_per_ray_build_at_1080p_on_cuda(cuda_device, kind):
    # The shipped finisher (the compaction, then one thread per queued ray,
    # launched over the queue's capacity) against the parent's one thread per
    # ray (the -DGPRT_FINISH_PER_RAY build) on the builtin 1080p level-0
    # pass: best_t, normal and gid bit for bit; the queue holds each dirty
    # ray once, in key order.
    from gpuraytracer_tpu_torch.kernels import build

    scene, pack, passes = _1080p_passes(cuda_device)
    ob, db, a, t0 = passes[kind]
    af = kind == "shadow"
    *main, dirty = scene_kernel.scene_main_pass(scene, ob, db, a, t0, accept_first=af, pack=pack)
    queued, per_ray = [x.clone() for x in main], [x.clone() for x in main]
    before = (scene_kernel.FINISH_LAUNCHES, scene_kernel.FINISH_QUEUE_LAUNCHES)
    scene_kernel.scene_finish(scene, ob, db, dirty, *queued, accept_first=af, pack=pack)
    scene_kernel.scene_finish(scene, ob, db, dirty, *per_ray, accept_first=af, pack=pack,
                              lib=build.load("scene_finish", finish_per_ray=True))
    torch.cuda.synchronize()
    assert (scene_kernel.FINISH_LAUNCHES, scene_kernel.FINISH_QUEUE_LAUNCHES) == (
        before[0] + 2, before[1] + 1)
    for got, want in zip(queued, per_ray):
        assert torch.equal(got, want)
    assert not all(torch.equal(q, m) for q, m in zip(queued, main))
    queue = scene_kernel.scene_finish_queue(dirty)
    n = int(queue.count[0])
    live = queue.idx[:n].long()
    assert n == int((dirty != 0).sum()) > 0
    assert torch.equal(torch.sort(live).values, torch.nonzero(dirty).squeeze(1))
    keys = scene_kernel.finish_key(dirty[live])
    assert bool((keys[1:] >= keys[:-1]).all())


@pytest.mark.cuda
def test_two_phase_pass_makes_no_host_sync_on_cuda(cuda_device):
    # The main pass, the compaction and the finisher over the queue read
    # nothing back.
    scene, pack, passes = _1080p_passes(cuda_device)
    ob, db, a, t0 = passes["closest"]
    kw = dict(two_phase=True, debug_dirty=True, pack=pack)
    want = scene_kernel.scene_closest_tiles(scene, ob, db, a, t0, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = scene_kernel.scene_closest_tiles(scene, ob, db, a, t0, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _write_golden():
    """Run the reference's two-phase and single Pallas scene kernels in
    interpret mode on every batch and commit their outputs with the
    inputs (about a minute a call on a CPU)."""
    import jax.numpy as jnp
    from gpuraytracer_tpu.kernels import scene_kernel as j_sk
    from gpuraytracer_tpu.models import builtin as j_builtin
    from gpuraytracer_tpu.models import scenes as j_scenes

    out = {}
    for name in SCENES:
        j_scene = (j_builtin.build_scene(aspect=FW / FH, elapsed_time=T_ANIM)
                   if name == "builtin" else j_scenes.get_config(name).build(FW / FH, T_ANIM))
        layout = j_scene.layout
        geoms = tuple((int(k), int(p)) for k, p in zip(layout.kinds, layout.prim_types))
        params = j_sk.pack_params(j_scene.arrays, j_scene.arrays.constants.elapsed_time)
        budgets = tuple(layout.step_budgets) if layout.step_budgets else None
        for (kind, level), (ob, db, a, t0) in make_batches(name).items():
            k = f"{name}/{kind}{level}/"
            for f, x in (("o_blas", ob), ("d_blas", db), ("active", a), ("t0", t0)):
                out[k + f] = x.numpy()
            shape = (N_RAYS // 128, 128)
            args = (jnp.asarray(ob.numpy().reshape(shape + (3,))),
                    jnp.asarray(db.numpy().reshape(shape + (3,))),
                    jnp.asarray(a.numpy().reshape(shape)), jnp.asarray(t0.numpy().reshape(shape)))
            runs = [("j2", True, {}), ("j1", False, {})]
            if (kind, level) == ("closest", 1):
                runs += [("b16_j2", True, BOUNCE_16), ("b16_j1", False, BOUNCE_16)]
            for tag, two, knobs in runs:
                # The reference reads the knobs when it traces: a run under
                # other knobs goes around jit's cache.
                fn = j_sk.scene_closest_tiles.__wrapped__ if knobs else j_sk.scene_closest_tiles
                os.environ.update(knobs)
                try:
                    t, _, gid, dirty = fn(
                        *args, *params, geoms=geoms, step_budgets=budgets,
                        accept_first=kind == "shadow", two_phase=two, debug_dirty=True,
                        interpret=True, level=level)
                finally:
                    for key in knobs:
                        del os.environ[key]
                out[k + tag + "_t"] = np.asarray(t).reshape(-1)
                out[k + tag + "_gid"] = np.asarray(gid).reshape(-1)
                if two:
                    out[k + tag + "_dirty"] = np.asarray(dirty).reshape(-1)
                print(k, tag, "dirty", int((np.asarray(dirty) != 0).sum()), flush=True)
    np.savez_compressed(GOLDEN, **out)


if __name__ == "__main__":
    _write_golden()
