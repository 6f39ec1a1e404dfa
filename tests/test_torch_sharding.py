"""Row-band sharding in the port (parallel/sharding.py, the band arguments
of kernels/frame_kernel.py and render/trace.py, entry.dryrun_multichip),
on the CPU: the counterparts of tests/test_sharding.py.

Every pixel is rendered by its own chain of operations and nothing is
summed across pixels, so a band is the whole frame's rows bit for bit, on
the wavefront and in the compacted modes' plain versions; the bar here is
equality, where the reference's own test allows 1e-3 (its band and frame
programs are compiled apart). The banded 96x54 frame is held to the
committed golden, the reference's XLA render, at the frame bar of
tests/test_torch_frame.py. Nothing here renders with JAX.
"""

import os

import numpy as np
import pytest
import torch
from test_torch_frame import assert_bar

from gpuraytracer_tpu_torch import entry
from gpuraytracer_tpu_torch.kernels import frame_kernel
from gpuraytracer_tpu_torch.models import builtin
from gpuraytracer_tpu_torch.parallel import sharding
from gpuraytracer_tpu_torch.render import trace

HERE = os.path.dirname(os.path.abspath(__file__))
W, H = 64, 32
T_ANIM = 0.3
CAP_STEPS = 8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    return builtin.build_scene(aspect=W / H, elapsed_time=T_ANIM, device="cpu")


@pytest.fixture(scope="module")
def single(scene):
    return trace.render_frame(scene, W, H).numpy()


@pytest.mark.parametrize("n", [4, 8])
def test_sharded_equals_single(scene, single, n):
    mesh = sharding.make_mesh(["cpu"] * n)
    bands = sharding.make_sharded_renderer(scene.layout, W, H, mesh)(scene.arrays)
    assert bands.offsets == tuple(range(0, H, H // n))
    assert all(tuple(im.shape) == (H // n, W, 4) for im in bands.images)
    img = sharding.gather_image(bands)
    assert img.dtype == np.float32 and np.array_equal(img, single)


def test_sharded_compact_equals_the_whole_compact_frame(scene, monkeypatch):
    # The builtin scene takes the frame route, here in the compacted mode at
    # 8 steps: each band's queue holds dirty pixels, which its dense pass
    # resumes at their global rows.
    monkeypatch.setenv("GPURT_FRAME_MODE", "compact")
    monkeypatch.setenv("GPURT_COMPACT_BUDGET", str(CAP_STEPS))
    whole = frame_kernel.render_frame_compact(frame_kernel.pack_frame(scene), width=W, height=H)
    queued = frame_kernel.QUEUED_LANES
    render = sharding.make_sharded_renderer(scene.layout, W, H, sharding.make_mesh(["cpu"] * 4))
    img = sharding.gather_image(render(scene.arrays))
    assert frame_kernel.QUEUED_LANES > queued
    assert np.array_equal(img, whole.numpy())


def test_deferred_bands_equal_the_whole_deferred_frame(scene):
    pack = frame_kernel.pack_frame(scene)
    kw = dict(width=W, height=H, shadow_cap=CAP_STEPS, debug_count=True)
    whole, whole_count = frame_kernel.render_frame_deferred(pack, **kw)
    parts = [frame_kernel.render_frame_deferred(pack, row_offset=k * H // 2, local_height=H // 2,
                                                **kw) for k in range(2)]
    assert whole_count > 0 and sum(c for _, c in parts) == whole_count
    assert torch.equal(torch.cat([img for img, _ in parts]), whole)


def test_sharded_stats_mean_radiance(scene):
    render = sharding.make_sharded_renderer(scene.layout, W, H, sharding.make_mesh(["cpu"] * 2),
                                            compute_stats=True)
    bands, mean = render(scene.arrays)
    img = sharding.gather_image(bands)
    assert mean.dim() == 0 and mean.dtype == torch.float32
    assert float(mean) == pytest.approx(float(img[..., :3].mean(dtype=np.float64)), rel=1e-5)


def test_height_must_divide():
    mesh = sharding.make_mesh(["cpu"] * 8)
    with pytest.raises(ValueError):
        sharding.make_sharded_renderer(builtin.LAYOUT, W, 30, mesh)


def test_band_outside_the_frame_raises(scene):
    pack = frame_kernel.pack_frame(scene)
    for row_offset, local_height in ((-1, 4), (30, 4), (0, 0)):
        with pytest.raises(ValueError):
            frame_kernel.render_frame_tiles(pack, width=W, height=H, row_offset=row_offset,
                                            local_height=local_height)


def test_make_mesh_without_cuda_raises(monkeypatch):
    # No fallback hides the card: the default mesh is the CUDA devices, and a
    # named CUDA device that is absent is an error too.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        sharding.make_mesh()
    with pytest.raises(RuntimeError):
        sharding.make_mesh(["cuda:0"] * 2)


def test_banded_frame_matches_golden():
    w, h, n = 96, 54, 3
    scene = builtin.build_scene(aspect=w / h, elapsed_time=0.7, device="cpu")
    render = sharding.make_sharded_renderer(scene.layout, w, h, sharding.make_mesh(["cpu"] * n))
    img = sharding.gather_image(render(scene.arrays))
    assert img.shape == (h, w, 4)
    assert_bar(img, np.load(os.path.join(HERE, "golden_builtin_96x54_t0p7.npz"))["image"])


def test_dryrun_multichip_over_gloo_on_the_cpu():
    entry.dryrun_multichip(2, device="cpu", timeout=300)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the frame kernel's band entries have no CPU build)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plain", "compact", "defer"])
def test_band_entries_equal_the_whole_frame_on_cuda(cuda_device, mode, monkeypatch):
    # 4 bands of 18 rows (not a multiple of the 8-row block) of a 128x72
    # frame through the CUDA entries: the whole frame of the same mode bit
    # for bit, the compacted modes at 8 steps so that every band queues,
    # with queues that hold every pixel (a band that overflowed while the
    # whole frame did not would be the plain kernel's frame there).
    w, h, n = 128, 72, 4
    scene = builtin.build_scene(aspect=w / h, elapsed_time=0.7, device=cuda_device)
    pack = frame_kernel.pack_frame(scene)
    fn = {"plain": frame_kernel.render_frame_tiles,
          "compact": lambda p, **kw: frame_kernel.render_frame_compact(
              p, budget_cap=CAP_STEPS, cap_lanes=w * h, **kw),
          "defer": lambda p, **kw: frame_kernel.render_frame_deferred(
              p, shadow_cap=CAP_STEPS, cap_lanes=w * h, **kw)}[mode]
    whole = fn(pack, width=w, height=h)
    launches = frame_kernel.LAUNCHES
    bands = [fn(pack, width=w, height=h, row_offset=k * h // n, local_height=h // n)
             for k in range(n)]
    assert frame_kernel.LAUNCHES - launches == (n if mode == "plain" else 0)
    assert torch.equal(torch.cat(bands), whole)
    if mode == "plain":
        monkeypatch.setenv("GPURT_MERGED_SHADOW", "1")
        render = sharding.make_sharded_renderer(scene.layout, w, h,
                                                sharding.make_mesh(["cuda:0"] * n))
        assert np.array_equal(sharding.gather_image(render(scene.arrays)),
                              fn(pack, width=w, height=h).cpu().numpy())
