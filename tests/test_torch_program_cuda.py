"""Frame programs (render/program.py) on the card: each replayed program's
frames equal the eager frames through the same kernels bit for bit, at
320x180, on every route and in every mode (plain, compact and defer on the
frame route, GPURT_MERGED_SHADOW=1, the scene-kernel route under
GPURT_DISABLE_FUSED=1, the per-geometry route of mesh_heightfield_sdf),
and a replay makes no host sync (torch.cuda.set_sync_debug_mode("error")
raises on one). The Renderer's program animates with row 10
(kernels/frame_state.py), make_renderer's packs the caller's arrays in its
graph. The band renderer's programs (parallel/sharding.py) at 320x180 in 4
bands on cuda:0 (one graph over the four bands) equal the eager bands bit
for bit in plain mode, in compact mode with GPURT_COMPACT_BUDGET=1 (bands
whose queue overflows, where the gate launches the plain frame kernel over
the band from the device inside the graph) and on the per-geometry route,
with no host sync in a replay. Skips without a GPU; this file imports
nothing of JAX, so it runs on the GPU machine with --noconftest."""

import pytest
import torch

from gpuraytracer_tpu_torch.accel.instances import Scene
from gpuraytracer_tpu_torch.apps import bench_suite
from gpuraytracer_tpu_torch.kernels import frame_state
from gpuraytracer_tpu_torch.kernels import frame_kernel
from gpuraytracer_tpu_torch.models import builtin, meshes
from gpuraytracer_tpu_torch.parallel import sharding
from gpuraytracer_tpu_torch.render import trace
from gpuraytracer_tpu_torch.render.renderer import Renderer

W, H = 320, 180
TIMES = (0.0, 0.7, 6.0)
ROUTES = {"plain": ("builtin", {}), "compact": ("builtin", {"GPURT_FRAME_MODE": "compact"}),
          "defer": ("builtin", {"GPURT_FRAME_MODE": "defer"}),
          "merged": ("builtin", {"GPURT_MERGED_SHADOW": "1"}),
          "scene_kernel": ("builtin", {"GPURT_DISABLE_FUSED": "1"}),
          "per_geometry": ("mesh_heightfield_sdf", {})}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _renderer(name, dev):
    if name == "builtin":
        return Renderer(W, H, device=dev), builtin.build_scene(aspect=W / H, device=dev), \
            builtin.animate_arrays
    cfg = meshes.get_config(name)
    b = cfg.builder()
    return (Renderer(W, H, device=dev, scene_factory=cfg.build, animate=b.animator(),
                     max_depth=cfg.max_depth), cfg.build(W / H, 0.0, device=dev), b.animator())


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(ROUTES))
def test_program_equals_eager_on_every_route_on_cuda(cuda_device, monkeypatch, route):
    name, knobs = ROUTES[route]
    for k in ("GPURT_FRAME_MODE", "GPURT_MERGED_SHADOW", "GPURT_DISABLE_FUSED"):
        monkeypatch.delenv(k, raising=False)
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    r, scene, animate = _renderer(name, cuda_device)
    render = trace.make_renderer(scene.layout, W, H, max_depth=r._max_depth)
    r.render(0.0)  # builds the program (outside the sync check: the warm-up uploads)
    render(scene.arrays)
    launches = frame_state.LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [r.render(t) for t in TIMES]
        made = [render(animate(scene.arrays, t)) for t in TIMES]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert frame_state.LAUNCHES - launches == len(TIMES)
    assert len(r._programs) == 1
    for t, img, img2 in zip(TIMES, got, made):
        want = trace.render_frame(Scene(scene.layout, animate(scene.arrays, t)), W, H,
                                  max_depth=r._max_depth)
        assert torch.equal(img, want), (route, t)
        assert torch.equal(img2, want), (route, t)


@pytest.mark.cuda
def test_window_program_equals_eager_frames_on_cuda(cuda_device):
    cfg = meshes.get_config("mesh_octahedra")
    b = cfg.builder()
    scene, animate = b.build(W / H, 0.0, device=cuda_device), b.animator()
    prog = bench_suite.window_program(scene, animate, 8, animated=True, width=W, height=H,
                                      max_depth=cfg.max_depth, keep=(0, 7))
    prog.build()
    torch.cuda.set_sync_debug_mode("error")
    try:
        acc, sums, first, last = prog()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    eager = [trace.render_frame(Scene(scene.layout, animate(scene.arrays, t)), W, H,
                                max_depth=cfg.max_depth) for t in bench_suite.frame_times(8)]
    assert torch.equal(first, eager[0]) and torch.equal(last, eager[7])
    assert torch.equal(sums, torch.stack([torch.sum(img) for img in eager]))
    want = torch.zeros((), device=cuda_device)
    for img in eager:
        want = want + torch.sum(img)
    assert torch.equal(acc, want)
    assert prog.nodes is None or prog.nodes > 0


BAND_ROUTES = {"plain": ("builtin", {}),
               "compact overflowing": ("builtin", {"GPURT_FRAME_MODE": "compact",
                                                   "GPURT_COMPACT_BUDGET": "1"}),
               "per_geometry": ("mesh_heightfield_sdf", {})}


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(BAND_ROUTES))
def test_band_programs_equal_the_eager_bands_on_cuda(cuda_device, monkeypatch, route):
    name, knobs = BAND_ROUTES[route]
    for k in ("GPURT_FRAME_MODE", "GPURT_COMPACT_BUDGET", "GPURT_MERGED_SHADOW",
              "GPURT_DISABLE_FUSED"):
        monkeypatch.delenv(k, raising=False)
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    n = 4
    _, scene, animate = _renderer(name, cuda_device)
    render = sharding.make_sharded_renderer(scene.layout, W, H,
                                            sharding.make_mesh(["cuda:0"] * n),
                                            compute_stats=True)
    render(scene.arrays)  # builds the program (outside the sync check: the warm-up uploads)
    frames = [animate(scene.arrays, t) for t in TIMES]
    gated = frame_kernel.GATED_FALLBACK_LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [render(a) for a in frames]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(render.programs) == 1
    if "GPURT_COMPACT_BUDGET" in knobs:  # one gate a band, overflowing or not
        assert frame_kernel.GATED_FALLBACK_LAUNCHES - gated == n * len(TIMES)
    for t, a, (bands, mean) in zip(TIMES, frames, got):
        eager = sharding.render_bands(Scene(scene.layout, a), W, H, n, range(n))
        assert all(torch.equal(x, y) for x, y in zip(bands.images, eager)), (route, t)
        total = None
        for image in eager:
            part = torch.sum(image[..., :3], dtype=torch.float32)
            total = part if total is None else total + part
        assert torch.equal(mean, total / (W * H * 3)), (route, t)
    render.close()
