"""The scene kernel's plain version against the JAX package's traversal.

kernels/scene_kernel.scene_closest_plain (reached through the port's
accel/traverse.closest_hit / any_hit with plain passes) must agree with
gpuraytracer_tpu.accel.traverse.closest_hit / any_hit on the CPU, which is
the reference's XLA path (the path every golden came from), on <= 2048
seeded rays: camera rays at level 0, and reflection and shadow rays off
their hits at levels 0 and 1. Both sides trace the same scene: the JAX
package's, carried into the port through SceneArrays.from_numpy and
SceneLayout.from_fields. The reference's answers are committed in
tests/golden_torch_scene_traversal.npz, so that no JAX traversal compiles
in the test run; ``JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_scene_kernel.py`` writes them again from the JAX package.

Tolerances: the two programs differ in the last ulp (XLA fuses and
contracts multiply-adds; the port does not), which moves a march crossing
by a step at silhouettes. So geometry ids must agree on >= 99% of rays,
occlusion on >= 99%, and hit t within 1e-3 + 1e-4 * t where ids agree.

On a GPU (the ``cuda`` marker) the CUDA scene kernel is held to its plain
version on the same kind of batches. The JAX package is imported inside the
reference tests only, so that test runs where JAX is not installed.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gpuraytracer_tpu_torch.accel import traverse
from gpuraytracer_tpu_torch.accel.instances import Scene, SceneArrays, SceneLayout
from gpuraytracer_tpu_torch.core import camera as cam
from gpuraytracer_tpu_torch.core.types import RAY_TMAX
from gpuraytracer_tpu_torch.kernels import frame_kernel, scene_kernel
from gpuraytracer_tpu_torch.models import scenes

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden_torch_scene_traversal.npz")
W, H = 96, 54
N_RAYS = 2048
T_ANIM = 0.7
LAYOUT_FIELDS = ("kinds", "prim_types", "has_plane", "clusters", "step_budgets",
                 "traversal_order", "material_ids")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def carry(ref_scene, device="cpu"):
    """The JAX package's Scene as the port's, field by field."""
    flat = {}

    def walk(obj, prefix):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if dataclasses.is_dataclass(v):
                walk(v, prefix + f.name + ".")
            elif f.name != "meshes":
                flat[prefix + f.name] = np.asarray(v)

    walk(ref_scene.arrays, "")
    layout = SceneLayout.from_fields({k: getattr(ref_scene.layout, k) for k in LAYOUT_FIELDS})
    return Scene(layout, SceneArrays.from_numpy(flat, device=device))


def ref_scene(name):
    from gpuraytracer_tpu.models import builtin as j_builtin
    from gpuraytracer_tpu.models import scenes as j_scenes

    if name == "builtin":
        return j_builtin.build_scene(aspect=W / H, elapsed_time=T_ANIM)
    return j_scenes.get_config(name).build(W / H, T_ANIM)


def camera_rays(scene, seed):
    """N_RAYS camera rays through seeded pixels of a W x H frame."""
    rng = np.random.default_rng(seed)
    pix = rng.choice(W * H, size=N_RAYS, replace=False)
    px = torch.from_numpy((pix % W).astype(np.int64))
    py = torch.from_numpy((pix // W).astype(np.int64))
    c = scene.arrays.constants
    o, d = cam.generate_camera_rays(px, py, W, H, c.camera_position, c.projection_to_world)
    return o.numpy(), d.numpy()


def j_closest(scene, o, d, level, active=None):
    import jax.numpy as jnp
    from gpuraytracer_tpu.accel import traverse as j_traverse

    hit = j_traverse.closest_hit(jnp.asarray(o), jnp.asarray(d), scene, level=level,
                                 active=None if active is None else jnp.asarray(active))
    return (np.asarray(hit.geometry_id), np.asarray(hit.t), np.asarray(hit.normal),
            np.asarray(hit.hit))


def j_any_hit(scene, o, d, level, active):
    import jax.numpy as jnp
    from gpuraytracer_tpu.accel import traverse as j_traverse

    return np.asarray(j_traverse.any_hit(jnp.asarray(o), jnp.asarray(d), scene, level=level,
                                         active=jnp.asarray(active)))


def budget_scene(j_scene):
    """The JAX scene with every instance at a 24-step budget."""
    budgets = (24,) * j_scene.layout.num_procedural
    return dataclasses.replace(j_scene, layout=dataclasses.replace(j_scene.layout,
                                                                   step_budgets=budgets))


def reference_answers():
    """The JAX package's traversal answers of every case below, keyed as
    the golden stores them (what ``__main__`` writes)."""
    out = {}
    for name in ("builtin", "fractal_mandelbulb_julia_1080p"):
        j_scene = ref_scene(name)
        o, d = camera_rays(carry(j_scene), seed=11)
        ref0 = j_closest(j_scene, o, d, level=0)
        light = np.asarray(j_scene.arrays.constants.light_position)
        hp, refl, shadow, hit = secondary_rays(ref0, o, d, light)
        for key, ref in (("ref0", ref0), ("ref1", j_closest(j_scene, hp, refl, level=1,
                                                            active=hit))):
            for field, v in zip(("gid", "t", "normal", "hit"), ref):
                out[f"{name}/{key}_{field}"] = v
        for level in (0, 1):
            out[f"{name}/any_hit{level}"] = j_any_hit(j_scene, hp, shadow, level, hit)
    j_scene = budget_scene(ref_scene("builtin"))
    o, d = camera_rays(carry(j_scene), seed=12)
    for field, v in zip(("gid", "t", "normal", "hit"), j_closest(j_scene, o, d, level=0)):
        out[f"budgets/ref0_{field}"] = v
    return out


def golden(prefix):
    """The reference's answers of one case from the committed golden:
    ``golden("builtin/ref0")`` is (gid, t, normal, hit)."""
    with np.load(GOLDEN) as g:
        if prefix.split("/")[1].startswith("any_hit"):
            return g[prefix]
        return tuple(g[f"{prefix}_{f}"] for f in ("gid", "t", "normal", "hit"))


def assert_closest_agrees(port_scene, ref, o, d, level, active=None):
    gid, t, _, _ = ref
    hit = traverse.closest_hit(torch.from_numpy(o), torch.from_numpy(d), port_scene,
                               level=level, plain=True,
                               active=None if active is None else torch.from_numpy(active))
    pg, pt = hit.geometry_id.numpy(), hit.t.numpy()
    same = pg == gid
    assert same.mean() >= 0.99, f"geometry ids agree on {same.mean():.4f}"
    assert (gid >= 0).any()
    hit_same = same & (gid >= 0)
    np.testing.assert_allclose(pt[hit_same], t[hit_same], rtol=1e-4, atol=1e-3)


def secondary_rays(ref, o, d, light):
    """Reflection and shadow rays off the reference's level-0 hits."""
    _, t, n, hit = ref
    hp = o + t[:, None] * d
    refl = d - 2.0 * np.sum(d * n, axis=-1, keepdims=True) * n
    to_light = light[None, :3] - hp
    shadow = to_light / np.linalg.norm(to_light, axis=-1, keepdims=True)
    return hp.astype(np.float32), refl.astype(np.float32), shadow.astype(np.float32), hit


@pytest.mark.parametrize("name", ["builtin", "fractal_mandelbulb_julia_1080p"])
def test_plain_pass_matches_reference_traversal(name):
    j_scene = ref_scene(name)
    port_scene = carry(j_scene)
    o, d = camera_rays(port_scene, seed=11)
    ref0 = golden(f"{name}/ref0")
    assert (ref0[0] >= 0).mean() > 0.5  # most camera rays hit something
    assert_closest_agrees(port_scene, ref0, o, d, level=0)

    light = port_scene.arrays.constants.light_position.numpy()
    hp, refl, shadow, hit = secondary_rays(ref0, o, d, light)
    assert_closest_agrees(port_scene, golden(f"{name}/ref1"), hp, refl, level=1, active=hit)
    for level in (0, 1):
        want = golden(f"{name}/any_hit{level}")
        got = traverse.any_hit(torch.from_numpy(hp), torch.from_numpy(shadow), port_scene,
                               level=level, active=torch.from_numpy(hit), plain=True).numpy()
        agree = (got == want).mean()
        assert agree >= 0.99, f"level {level}: occlusion agrees on {agree:.4f}"
        assert want.sum() > 0


def test_plain_pass_honours_step_budgets():
    # Per-instance budgets (SceneLayout.step_budgets) cap every march, as
    # the reference's traversal does; 24 steps leave many marches capped,
    # so a traversal that ignored them would disagree on many rays.
    j_scene = budget_scene(ref_scene("builtin"))
    port_scene = carry(j_scene)
    assert port_scene.layout.step_budgets == (24,) * j_scene.layout.num_procedural
    o, d = camera_rays(port_scene, seed=12)
    ref0 = golden("budgets/ref0")
    assert_closest_agrees(port_scene, ref0, o, d, level=0)
    free = traverse.closest_hit(torch.from_numpy(o), torch.from_numpy(d),
                                dataclasses.replace(port_scene, layout=dataclasses.replace(
                                    port_scene.layout, step_budgets=None)), plain=True)
    assert (free.geometry_id.numpy() != ref0[0]).sum() > 10  # the budgets move the image


def test_wrapper_runs_plain_version_on_cpu():
    scene = carry(ref_scene("builtin"))
    o, d = camera_rays(scene, seed=13)
    _, ob, db, active, t0 = traverse.pass_inputs(torch.from_numpy(o), torch.from_numpy(d), scene)
    launches = scene_kernel.LAUNCHES
    got = scene_kernel.scene_closest_tiles(scene, ob, db, active, t0, level=0)
    want = scene_kernel.scene_closest_plain(scene, ob, db, active, t0, level=0)
    assert scene_kernel.LAUNCHES == launches
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[2].dtype == torch.int32 and got[1].shape == (N_RAYS, 3)
    with pytest.raises(ValueError, match="t0"):
        scene_kernel.scene_closest_tiles(scene, ob, db, active, t0.double())


def test_shared_memory_cap_is_named():
    # The scene kernel copies only the traversal prefix of the buffers into
    # a block's shared memory, the frame kernel all of them. Where the copy
    # would not fit, the host lays the tables out in global memory instead
    # (the kernels read them in place, with no dynamic shared memory): a
    # layout chosen from the sizes, so every scene renders.
    g, m = 10, 17
    scene_b = frame_kernel.shared_bytes(g, m, shading=False)
    frame_b = frame_kernel.shared_bytes(g, m, shading=True)
    off = frame_kernel.param_offsets(g, m)
    assert scene_b == 4 * (off["mat"] + frame_kernel.I_HEADER + frame_kernel.GEO_STRIDE * g)
    assert frame_b == 4 * (off["total"] + frame_kernel.layout_size(g))
    # The material table is not in the scene kernel's copy.
    assert frame_kernel.shared_bytes(g, 64, shading=False) == scene_b
    assert frame_kernel.tables_in_shared(1000, 400, shading=False)
    assert frame_kernel.tables_in_shared(1000, 16, shading=True)
    # The last geometry count that fits with 16 materials, for each kernel.
    for shading, last in ((True, 1412), (False, 1452)):
        assert frame_kernel.shared_bytes(last, 16, shading=shading) <= frame_kernel.SHARED_BYTES_MAX
        assert frame_kernel.tables_in_shared(last, 16, shading=shading)
        assert not frame_kernel.tables_in_shared(last + 1, 16, shading=shading)
        # 1,600 geometries: global memory, and nothing raises.
        assert not frame_kernel.tables_in_shared(1600, 16, shading=shading)
    scene_x = scenes.instance_grid(40, 40, 8).build(16 / 9, 0.7, device="cpu")
    pack = frame_kernel.pack_frame(scene_x)
    assert pack.num_geometries == 1600
    frame_kernel.check_pack(pack)
    assert not frame_kernel.tables_in_shared(pack.num_geometries, pack.num_materials,
                                             shading=True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the scene kernel has no CPU build)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("accept_first", [False, True])
def test_scene_kernel_matches_plain_on_cuda(cuda_device, accept_first):
    from gpuraytracer_tpu_torch.models import scenes

    cfg = scenes.get_config("fractal_mandelbulb_julia_1080p")
    o, d = camera_rays(cfg.build(W / H, T_ANIM, device="cpu"), seed=14)
    scene = cfg.build(W / H, T_ANIM, device=cuda_device)
    pack = frame_kernel.pack_frame(scene)
    o, d = torch.from_numpy(o).to(cuda_device), torch.from_numpy(d).to(cuda_device)
    _, ob, db, active, t0 = traverse.pass_inputs(o, d, scene)
    if accept_first:
        # Every camera ray that reaches a fractal meets the plane behind it,
        # so probe occlusion over the full range, as a ray from above would.
        t0 = torch.full_like(t0, RAY_TMAX)
    launches = scene_kernel.LAUNCHES
    kt, _, kg = scene_kernel.scene_closest_tiles(scene, ob, db, active, t0, level=0,
                                                 accept_first=accept_first, pack=pack)
    torch.cuda.synchronize()
    assert scene_kernel.LAUNCHES == launches + 1
    pt, _, pg = scene_kernel.scene_closest_plain(scene, ob, db, active, t0, level=0,
                                                 accept_first=accept_first)
    # The shipped build contracts multiply-adds, which moves a march
    # crossing by a step on a few rays (chip_smoke.py's ray-batch bar).
    same = kg == pg
    assert float(same.float().mean()) >= 0.98
    dt = (kt - pt).abs()[same & (pg >= 0)]
    assert dt.numel() > 0 and float((dt <= 1e-3).float().mean()) >= 0.98


def _camera_pass(scene, w, h, device):
    """The level-0 closest pass of a w x h frame's camera rays."""
    px, py = cam.pixel_grid(w, h, device)
    c = scene.arrays.constants
    o, d = cam.generate_camera_rays(px, py, w, h, c.camera_position, c.projection_to_world)
    return traverse.pass_inputs(o.reshape(-1, 3), d.reshape(-1, 3), scene)[1:]


@pytest.mark.cuda
@pytest.mark.parametrize("w, h", [(320, 180), (321, 181)])
def test_scene_pass_matches_plain_at_ragged_sizes_on_cuda(cuda_device, w, h):
    # 321 x 181 rays end in a part block of 128.
    from gpuraytracer_tpu_torch.models import builtin

    scene = builtin.build_scene(aspect=w / h, elapsed_time=T_ANIM, device=cuda_device)
    ob, db, act, t0 = _camera_pass(scene, w, h, cuda_device)
    kt, kn, kg = scene_kernel.scene_closest_tiles(scene, ob, db, act, t0)
    second = scene_kernel.scene_closest_tiles(scene, ob, db, act, t0)
    torch.cuda.synchronize()
    # A second launch gives the same answers bit for bit.
    for a, b in zip((kt, kn, kg), second):
        assert torch.equal(a, b)
    pt, _, pg = scene_kernel.scene_closest_plain(scene, ob, db, act, t0)
    same = kg == pg
    assert float(same.float().mean()) >= 0.98
    dt = (kt - pt).abs()[same & (pg >= 0)]
    assert dt.numel() > 0 and float((dt <= 1e-3).float().mean()) >= 0.98


@pytest.mark.cuda
def test_scene_pass_past_shared_memory_on_cuda(cuda_device):
    # 1,600 instances: the scene kernel reads its tables from global memory.
    w, h = 64, 36
    scene = scenes.instance_grid(40, 40, 8).build(w / h, T_ANIM, device=cuda_device)
    pack = frame_kernel.pack_frame(scene)
    assert not frame_kernel.tables_in_shared(pack.num_geometries, pack.num_materials,
                                             shading=False)
    ob, db, act, t0 = _camera_pass(scene, w, h, cuda_device)
    kt, _, kg = scene_kernel.scene_closest_tiles(scene, ob, db, act, t0, pack=pack)
    torch.cuda.synchronize()
    pt, _, pg = scene_kernel.scene_closest_plain(scene, ob, db, act, t0)
    assert float((kg == pg).float().mean()) >= 0.98 and bool((pg >= 0).any())
    same = (kg == pg) & (pg >= 0)
    assert float(((kt - pt).abs()[same] <= 1e-3).float().mean()) >= 0.98


if __name__ == "__main__":
    # Writes tests/golden_torch_scene_traversal.npz: the JAX package's XLA
    # traversal answers of the cases above (CPU, a few minutes).
    np.savez_compressed(GOLDEN, **reference_answers())
    print(f"wrote {GOLDEN}")
