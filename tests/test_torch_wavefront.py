"""The wavefront's device form (render/trace.render_lanes) on the CPU.

On a GPU the wavefront routes render through ``render_lanes``: every lane
of the band under an active mask for the whole frame, the traversal
passes over every lane, and the work between them in the lane kernels of
csrc/wavefront.cu (kernels/wavefront.py), with no host sync. On the CPU
each of its wrappers runs its plain version, the PyTorch code of
``trace_radiance``'s level body over the active lanes, and the passes run
their plain versions; that is how these tests check the loop:

- its frame equals the compacted CPU wavefront (``trace_radiance``, which
  every golden test reads through frame_kernel.render_frame_plain) bit for
  bit on the same passes, at 32x18: builtin on the scene kernel's plain
  pass, a 16-instance scene of 17 materials (past the frame kernel's 16),
  and mesh_heightfield_sdf (544 faces) on its route's plain pass
  (megakernel.route_pass_plain);
- its 96x54 frames meet the JAX package's goldens at the repo's bar (fewer
  than 2% of pixels past 1e-3);
- its bands (row_offset, local_height) are the whole frame's rows bit for
  bit.

The lane kernels' CUDA source is rehearsed with g++ against these plain
versions in tests/test_torch_csrc_rehearsal.py; on the card chip_smoke.py
holds each kernel to its plain version and the frames to the plain-pass
wavefront. No JAX render runs here: the goldens are committed files.
"""

import os

import numpy as np
import pytest
import torch

from gpuraytracer_tpu_torch.accel import traverse
from gpuraytracer_tpu_torch.kernels import frame_kernel, megakernel, wavefront
from gpuraytracer_tpu_torch.models import builtin, meshes, scenes
from gpuraytracer_tpu_torch.render import trace

TESTS = os.path.dirname(os.path.abspath(__file__))
T_ANIM = 0.7


def _scene(name, w, h):
    """(scene unpacked from its frame pack, depth, route) of a case."""
    if name == "builtin":
        scene, depth = builtin.build_scene(aspect=w / h, elapsed_time=T_ANIM, device="cpu"), 3
    elif name == "instance_grid_17_materials":
        scene, depth = scenes.instance_grid(4, 4, 17).build(w / h, T_ANIM, device="cpu"), 3
    else:
        cfg = meshes.get_config(name)
        scene, depth = cfg.build(w / h, T_ANIM, device="cpu"), cfg.max_depth
    pack = frame_kernel.pack_frame(scene)
    route = "scene" if traverse._scene_kernel_eligible(scene) else "per_geometry"
    return frame_kernel.unpack_frame(pack), pack, depth, route


def _lanes(scene, w, h, depth, route, monkeypatch, **band):
    """render_lanes on the CPU with the route's passes: the scene kernel's
    (on the CPU its plain version, as the CPU route gives every scene) or
    the per-geometry route's (megakernel.route_pass, on the CPU
    megakernel.route_pass_plain). The compacted wavefront takes the same
    passes after this."""
    if route == "per_geometry":
        monkeypatch.setattr(traverse, "_procedural_pass",
                            lambda scene, plain, pack: megakernel.route_pass)
    return trace.render_lanes(scene, w, h, max_depth=depth, **band)


def _compacted(scene, pack, w, h, depth, route):
    """The compacted CPU wavefront on the route's plain passes: the frame
    kernel's plain version (the scene kernel's plain pass), or
    trace_radiance with the per-geometry route's (after ``_lanes``)."""
    if route == "per_geometry":
        return trace.render_wavefront(scene, w, h, max_depth=depth)
    return frame_kernel.render_frame_plain(pack, width=w, height=h, max_depth=depth)


W, H = 32, 18


@pytest.fixture(scope="module")
def builtin_frame():
    """(scene, depth, render_lanes' W x H builtin frame), shared by the
    cases that read it."""
    scene, _, depth, _ = _scene("builtin", W, H)
    return scene, depth, trace.render_lanes(scene, W, H, max_depth=depth)


@pytest.mark.parametrize("name", ["builtin", "instance_grid_17_materials",
                                  "mesh_heightfield_sdf"])
def test_device_loop_equals_the_compacted_wavefront(name, monkeypatch, builtin_frame):
    w, h = W, H
    scene, pack, depth, route = _scene(name, w, h)
    if name.startswith("instance_grid"):
        assert pack.num_materials > frame_kernel.MAX_MATERIALS
    assert route == ("per_geometry" if name.startswith("mesh") else "scene")
    wavefront.reset_launches()
    got = builtin_frame[2] if name == "builtin" else _lanes(scene, w, h, depth, route, monkeypatch)
    # The plain versions count no launch.
    assert set(wavefront.launches().values()) == {0}
    want = _compacted(scene, pack, w, h, depth, route)
    differ = (got != want).any(dim=-1)
    assert torch.equal(got, want), (
        f"{int(differ.sum())} of {w * h} pixels differ, max "
        f"{float((got - want).abs().max()):.3g}")


@pytest.mark.parametrize("name, golden", [
    ("builtin", "golden_builtin_96x54_t0p7.npz"),
    ("mesh_heightfield_sdf", "golden_torch_mesh_heightfield_sdf_96x54_t0p7.npz")])
def test_device_loop_meets_the_golden(name, golden, monkeypatch):
    w, h = 96, 54
    scene, _, depth, route = _scene(name, w, h)
    img = _lanes(scene, w, h, depth, route, monkeypatch)
    ref = torch.from_numpy(np.load(os.path.join(TESTS, golden))["image"])
    assert img.shape == ref.shape and bool(torch.isfinite(img).all())
    flipped = float(((img - ref).abs().amax(dim=-1) > 1e-3).float().mean())
    assert flipped < 0.02, f"{flipped:.4f} of pixels past 1e-3"


def test_bands_equal_the_whole_frame(builtin_frame):
    scene, depth, whole = builtin_frame
    bands = [trace.render_lanes(scene, W, H, max_depth=depth, row_offset=r, local_height=lh)
             for r, lh in ((0, 7), (7, 11))]
    assert [b.shape[0] for b in bands] == [7, 11]
    assert torch.equal(torch.cat(bands), whole)


def test_render_wavefront_keeps_the_compacted_cpu_path(monkeypatch):
    # On the CPU (and with plain or a frame mode's main pass on a GPU) the
    # wavefront stays trace_radiance; the device form is the GPU's.
    monkeypatch.setattr(trace, "render_lanes", lambda *a, **k: pytest.fail("device form"))
    scene, _, _, _ = _scene("builtin", 8, 6)
    img = trace.render_wavefront(scene, 8, 6, max_depth=1)
    assert img.shape == (6, 8, 4)


def test_lane_wrappers_run_plain_only_on_the_cpu():
    # A tensor on neither the CPU nor a CUDA device is refused, never run
    # by the plain version.
    scene, pack, _, _ = _scene("builtin", 8, 6)
    lanes = wavefront.start(scene, width=8, height=6)
    meta = wavefront.Lanes(*(x.to("meta") for x in lanes))
    answer = (torch.empty(48, device="meta"), torch.empty(48, 3, device="meta"),
              torch.empty(48, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="no wavefront kernel"):
        wavefront.hit(scene, pack, meta, answer)
    with pytest.raises(ValueError, match="no wavefront kernel"):
        wavefront.shade(scene, pack, meta, answer, None, None, level=0, max_depth=1, width=8,
                        height=6)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["builtin", "mesh_heightfield_sdf"])
def test_device_loop_on_cuda_makes_no_host_sync(name, monkeypatch):
    # On the card: the frame through render_frame's wavefront route with
    # every synchronizing torch call an error, exactly 5 pass launches and
    # the lane kernels' 6, and the plain-pass wavefront's frame at the bar.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the lane kernels have no CPU build)")
    from gpuraytracer_tpu_torch.kernels import scene_kernel

    monkeypatch.setenv("GPURT_DISABLE_FUSED", "1")
    w, h = 320, 180
    dev = torch.device("cuda")
    if name == "builtin":
        scene, depth = builtin.build_scene(aspect=w / h, elapsed_time=T_ANIM, device=dev), 3
    else:
        cfg = meshes.get_config(name)
        scene, depth = cfg.build(w / h, T_ANIM, device=dev), cfg.max_depth
    trace.render_frame(scene, w, h, max_depth=depth)  # kernel builds and loads
    torch.cuda.synchronize()
    wavefront.reset_launches()
    before = scene_kernel.LAUNCHES + megakernel.PASS_LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        img = trace.render_frame(scene, w, h, max_depth=depth)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert scene_kernel.LAUNCHES + megakernel.PASS_LAUNCHES - before == 5
    assert wavefront.launches() == {"wavefront_start": 1, "wavefront_hit": 2,
                                    "wavefront_shade": 3}
    plain = trace.render_wavefront(scene, w, h, max_depth=depth, plain=True)
    diff = (img - plain).abs().amax(dim=-1)
    flipped = diff > 1e-3
    assert float(flipped.float().mean()) < 0.02
    assert float((diff[~flipped] < 1e-5).float().mean()) > 0.75
