"""The merged occlusion march (GPURT_MERGED_SHADOW; the reference's
scene_kernel._march_sdf_multi, ROADMAP Q2.8) on the CPU.

Its plain version, scene_kernel.occluded_merged_plain (the closed forms and
metaballs first, then every SDF geometry's march advanced one sample per
turn with a kill on any valid crossing and the occluded-on-cap rule after
the loop), gives the sequential accept-first pass's answer
(scene_closest_plain(accept_first=True), gid >= 0) on every shadow ray:
the builtin scene, sdf_primitives_720p and the fractal scene at levels 0
and 1, with the default knobs and with GPURT_SHADOW_BUDGET=8 (every march
capped far below its natural budget, so the occluded-on-cap rule decides
many rays), and with a window of banks smaller than the scene's SDF count. The
reference's own test (tests/test_merged_shadow.py) holds its merged frame
to its sequential frame bit for bit; the port's answer is exact too.

Against the reference itself: the JAX package's merged Pallas frame
(GPURT_MERGED_SHADOW on, interpret mode, one 32 x 128 tile of a GW x GH
frame) of the builtin scene and sdf_primitives_720p is committed in
tests/golden_torch_merged_frame.npz, written by this file's ``__main__``
(its calls take one to two minutes each on a CPU). The port's plain frame
whose every occlusion pass runs occluded_merged_plain passes the image bar
against it. The fractal scene is left out there: the reference's Pallas
kernel marches its own forms of the two fractals (kernels/soa.py), while
the port follows geometry/fractal.py, as the goldens of its XLA path do,
and the two forms flip 3.5% of that scene's 576 pixels with or without
the knob.

The knob renders on every route (the reference's scene kernel marches in
sequence without the merged banks, scene_kernel.py:1660-1661); the frame
kernel family takes it where the reference does (frame_kernel.merges).

On a GPU (the ``cuda`` marker) the merged instantiations of the frame
kernel's plain and dense entries and of the occlusion queue give the
sequential frame and answers bit for bit (also on padded_sdf_showcase(28),
whose warps hold different sets of SDF geometries, in both contraction
builds), and the merged frame passes the image bar against the reference's
merged frame.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from gpuraytracer_tpu_torch.accel import traverse
from gpuraytracer_tpu_torch.core import camera as cam
from gpuraytracer_tpu_torch.core import hlsl
from gpuraytracer_tpu_torch.core.types import IntersectorKind
from gpuraytracer_tpu_torch.kernels import frame_kernel, scene_kernel
from gpuraytracer_tpu_torch.models import builtin, scenes
from gpuraytracer_tpu_torch.render import trace

W, H = 24, 14
T_ANIM = 0.7
SCENES = ("builtin", "sdf_primitives_720p", "fractal_mandelbulb_julia_1080p")
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "golden_torch_merged_frame.npz")
GW, GH = 32, 18  # one 32 x 128 tile of the reference's frame kernel
FRAME_SCENES = SCENES[:2]  # the fractals' forms differ (module docstring)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build(name, w=W, h=H, device="cpu"):
    if name == "builtin":
        return builtin.build_scene(aspect=w / h, elapsed_time=T_ANIM, device=device)
    return scenes.get_config(name).build(w / h, T_ANIM, device=device)


@functools.lru_cache(maxsize=None)
def scene_and_batch(name):
    scene = build(name)
    return scene, shadow_batch(scene)


def shadow_batch(scene):
    """The occlusion pass's inputs (o_blas, d_blas, active, t0) of the shadow
    rays off the plain level-0 hits of the scene's W x H camera rays."""
    px, py = cam.pixel_grid(W, H, "cpu")
    c = scene.arrays.constants
    o, d = cam.generate_camera_rays(px, py, W, H, c.camera_position, c.projection_to_world)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    hit = traverse.closest_hit(o, d, scene, level=0, plain=True)
    hp = o + hit.t[:, None] * d
    shadow = hlsl.normalize(c.light_position[:3] - hp)
    return traverse.pass_inputs(hp, shadow, scene, active=hit.hit, occlusion=True)[1:]


def max_depth(name):
    return 3 if name == "builtin" else scenes.get_config(name).max_depth


def assert_bar(img, ref):
    diff = np.abs(np.asarray(img, np.float32) - np.asarray(ref, np.float32)).max(axis=-1)
    flipped = diff > 1e-3
    assert flipped.mean() < 0.02, f"{flipped.sum()} pixels flipped"
    agree = diff[~flipped]
    assert agree.max() <= 1e-3
    assert (agree < 1e-5).mean() > 0.75


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as z:
        return dict(z)


def merged_occlusion(monkeypatch):
    """Send every occlusion pass of the plain wavefront through
    occluded_merged_plain (its answer as the gid any_hit reads: 0 where
    occluded, else -1); closest passes stay as they are."""
    real = traverse._procedural_pass

    def procedural_pass(scene, plain, pack):
        closest = real(scene, plain, pack)

        def run(scene, o_blas, d_blas, active, t0, *, level=0, accept_first=False, **kw):
            if not accept_first:
                return closest(scene, o_blas, d_blas, active, t0, level=level, **kw)
            occ = scene_kernel.occluded_merged_plain(scene, o_blas, d_blas, active, t0,
                                                     level=level)
            return None, None, torch.where(occ, 0, -1)

        return run

    monkeypatch.setattr(traverse, "_procedural_pass", procedural_pass)


def assert_merged_equals_sequential(name, level, window=scene_kernel.MERGE_WINDOW):
    scene, (ob, db, a, t0) = scene_and_batch(name)
    _, _, gid = scene_kernel.scene_closest_plain(scene, ob, db, a, t0, level=level,
                                                 accept_first=True)
    merged = scene_kernel.occluded_merged_plain(scene, ob, db, a, t0, level=level, window=window)
    assert merged.dtype == torch.bool and merged.shape == gid.shape
    assert torch.equal(merged, gid >= 0)
    return int(merged.sum())


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("level", [0, 1])
def test_merged_plain_matches_sequential(name, level):
    assert assert_merged_equals_sequential(name, level) > 0


@pytest.mark.parametrize("level", [0, 1])
def test_merged_plain_matches_sequential_with_capped_budgets(monkeypatch, level):
    # 8 steps cap every occlusion march far below its natural 512: a march
    # that spends them reports occluded, after the merged loop (more rays
    # than at 24 steps).
    monkeypatch.setenv("GPURT_SHADOW_BUDGET", "24")
    scene, (ob, db, a, t0) = scene_and_batch("builtin")
    free = scene_kernel.occluded_merged_plain(scene, ob, db, a, t0, level=level)
    monkeypatch.setenv("GPURT_SHADOW_BUDGET", "8")
    tight = scene_kernel.occluded_merged_plain(scene, ob, db, a, t0, level=level)
    assert int((tight & ~free).sum()) > 0  # the rule decides rays
    assert_merged_equals_sequential("builtin", level)


@pytest.mark.parametrize("window", [1, 3])
def test_merged_window_smaller_than_the_sdf_count(window):
    scene, _ = scene_and_batch("builtin")
    n_sdf = sum(k == IntersectorKind.SIGNED_DISTANCE for k in scene.layout.kinds)
    assert window < n_sdf
    assert_merged_equals_sequential("builtin", 0, window=window)


@pytest.mark.parametrize("name", FRAME_SCENES)
def test_merged_frame_matches_reference_merged_frame(monkeypatch, golden, name):
    pack = frame_kernel.pack_frame(build(name, GW, GH))
    kw = dict(width=GW, height=GH, max_depth=max_depth(name))
    seq = frame_kernel.render_frame_plain(pack, **kw)
    merged_occlusion(monkeypatch)
    img = frame_kernel.render_frame_plain(pack, **kw)
    assert torch.equal(img, seq)
    assert_bar(img, golden[name])


def test_knob_merges_where_the_reference_allocates_banks(monkeypatch):
    scene, _ = scene_and_batch("builtin")
    pack = frame_kernel.pack_frame(scene)
    assert not frame_kernel.merges(pack)
    monkeypatch.setenv("GPURT_MERGED_SHADOW", "1")
    assert frame_kernel.merges(pack)
    # One SDF geometry: the reference never merges (len(sdf_ids) >= 2).
    one = dataclasses.replace(pack, budgets=((IntersectorKind.SIGNED_DISTANCE, 512),
                                             (IntersectorKind.VOLUMETRIC, 512)))
    assert not frame_kernel.merges(one)
    for route in ("frame", "scene", "per_geometry"):
        frame_kernel.check_kernel_covers(scene.layout, route)
    # The CPU render path ignores the knob, as the reference's XLA path does.
    small = build("builtin", 8, 6)
    img = trace.render_frame(small, 8, 6)
    monkeypatch.delenv("GPURT_MERGED_SHADOW")
    assert torch.equal(img, trace.render_frame(small, 8, 6))


# ---------------------------------------------------------------------------
# On a GPU: the merged instantiations against the sequential ones
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the merged kernels have no CPU build)")
    return torch.device("cuda")


def merged_counts():
    return (frame_kernel.LAUNCHES, frame_kernel.MERGED_LAUNCHES, frame_kernel.DENSE_LAUNCHES,
            frame_kernel.MERGED_DENSE_LAUNCHES, scene_kernel.QUEUE_LAUNCHES,
            scene_kernel.MERGED_QUEUE_LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("name", SCENES)
def test_merged_frames_equal_sequential_on_cuda(cuda_device, monkeypatch, name):
    w, h = 128, 72
    pack = frame_kernel.pack_frame(build(name, w, h, cuda_device))
    kw = dict(width=w, height=h)
    seq = {"plain": frame_kernel.render_frame_tiles(pack, **kw),
           "compact": frame_kernel.render_frame_compact(pack, budget_cap=8, cap_lanes=w * h, **kw),
           "defer": frame_kernel.render_frame_deferred(pack, shadow_cap=8, cap_lanes=w * h, **kw)}
    monkeypatch.setenv("GPURT_MERGED_SHADOW", "1")
    before = merged_counts()
    merged = {"plain": frame_kernel.render_frame_tiles(pack, **kw),
              "compact": frame_kernel.render_frame_compact(pack, budget_cap=8, cap_lanes=w * h,
                                                           **kw),
              "defer": frame_kernel.render_frame_deferred(pack, shadow_cap=8, cap_lanes=w * h,
                                                          **kw)}
    torch.cuda.synchronize()
    after = merged_counts()
    # The plain, dense and queue entries each ran merged once, never in sequence.
    assert tuple(b - a for a, b in zip(before, after)) == (0, 1, 0, 1, 0, 1)
    for mode in seq:
        assert torch.equal(merged[mode], seq[mode]), mode


@pytest.mark.cuda
def test_merged_dense_and_repair_equal_sequential_past_geometry_28_on_cuda(cuda_device,
                                                                           monkeypatch):
    # padded_sdf_showcase(28): 28 closed forms first, the seven marches at
    # geometries 28-34, so that the lanes of a warp hold different sets of
    # SDF geometries and the merged march's turns pick among them. The
    # merged dense pass (compact at cap 8) and repair (defer at cap 8) give
    # the sequential frames bit for bit, in both contraction builds.
    from gpuraytracer_tpu_torch.kernels import build as kbuild

    w, h = 160, 90
    pack = frame_kernel.pack_frame(scenes.padded_sdf_showcase(28).build(w / h, T_ANIM,
                                                                        device=cuda_device))
    kw = dict(width=w, height=h, max_depth=max_depth("sdf_primitives_720p"))
    real = kbuild.load
    for fmad in (True, False):
        monkeypatch.setattr(kbuild, "load", lambda name, **k: real(name, **{**k, "fmad": fmad}))
        monkeypatch.delenv("GPURT_MERGED_SHADOW", raising=False)
        seq = (frame_kernel.render_frame_compact(pack, budget_cap=8, cap_lanes=w * h, **kw),
               frame_kernel.render_frame_deferred(pack, shadow_cap=8, cap_lanes=w * h, **kw))
        monkeypatch.setenv("GPURT_MERGED_SHADOW", "1")
        assert frame_kernel.merges(pack)
        before = merged_counts()
        merged = (frame_kernel.render_frame_compact(pack, budget_cap=8, cap_lanes=w * h, **kw),
                  frame_kernel.render_frame_deferred(pack, shadow_cap=8, cap_lanes=w * h, **kw))
        torch.cuda.synchronize()
        after = merged_counts()
        assert tuple(b - a for a, b in zip(before, after)) == (0, 0, 0, 1, 0, 1)
        for mode, x, y in zip(("compact", "defer"), merged, seq):
            assert torch.equal(x, y), f"{mode} fmad={fmad}"


@pytest.mark.cuda
def test_merged_queue_matches_plain_on_cuda(cuda_device, monkeypatch):
    scene = build("builtin", device=cuda_device)
    pack = frame_kernel.pack_frame(scene)
    ob, db, a, _ = (x.to(cuda_device) for x in scene_and_batch("builtin")[1])
    rays = torch.cat([torch.cat([ob, db], -1)] * 2).contiguous()
    active = torch.cat([a, a]).contiguous()
    seq = scene_kernel.shadow_queue(pack, rays, active, ob.shape[0])
    monkeypatch.setenv("GPURT_MERGED_SHADOW", "1")
    merged = scene_kernel.shadow_queue(pack, rays, active, ob.shape[0])
    plain = scene_kernel.shadow_queue_plain(pack, rays, active, ob.shape[0], merged=True)
    assert torch.equal(merged, seq)
    assert float((merged == plain).float().mean()) >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("name", FRAME_SCENES)
def test_merged_frame_matches_reference_on_cuda(cuda_device, monkeypatch, golden, name):
    from gpuraytracer_tpu_torch.kernels import build as kbuild

    pack = frame_kernel.pack_frame(build(name, GW, GH, cuda_device))
    monkeypatch.setenv("GPURT_MERGED_SHADOW", "1")
    before = frame_kernel.MERGED_LAUNCHES
    # The build without contraction: the plain frame's arithmetic, so its
    # few flips at this size are the plain frame's.
    img = frame_kernel.render_frame_tiles(pack, width=GW, height=GH, max_depth=max_depth(name),
                                          lib=kbuild.load("frame_kernel", fmad=False))
    assert frame_kernel.MERGED_LAUNCHES == before + 1
    assert_bar(img.cpu(), golden[name])


def _write_golden():
    """Render the reference's merged Pallas frame (GPURT_MERGED_SHADOW on)
    of each scene in interpret mode and commit it."""
    from gpuraytracer_tpu.kernels import frame_kernel as j_fk
    from gpuraytracer_tpu.kernels import scene_kernel as j_sk
    from gpuraytracer_tpu.models import builtin as j_builtin
    from gpuraytracer_tpu.models import scenes as j_scenes

    out = {}
    os.environ["GPURT_MERGED_SHADOW"] = "1"
    assert j_sk.merged_shadow_enabled()
    for name in FRAME_SCENES:
        j_scene = (j_builtin.build_scene(aspect=GW / GH, elapsed_time=T_ANIM)
                   if name == "builtin" else j_scenes.get_config(name).build(GW / GH, T_ANIM))
        smem_args, kw = j_fk.pack_frame_params(j_scene)
        # __wrapped__: the knob is read when the kernel traces, past jit's cache.
        out[name] = np.asarray(j_fk.render_frame_tiles.__wrapped__(
            *smem_args, width=GW, height=GH, max_depth=max_depth(name), cull_backface=True,
            interpret=True, **kw))
        print(name, out[name].shape, flush=True)
    np.savez_compressed(GOLDEN, **out)


if __name__ == "__main__":
    _write_golden()
