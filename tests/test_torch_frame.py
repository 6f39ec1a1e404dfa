"""The port's frame path: the CPU wavefront (the frame kernel's plain
version) against the committed goldens, which the reference's XLA path
rendered, and the CUDA frame kernel against the plain version on a GPU.

The bar is the one tests/test_frame_kernel.py holds the reference's Pallas
kernel to its XLA path: fewer than 2% of pixels with a max-channel |diff|
above 1e-3, every other pixel within 1e-3, and more than 75% of those within
1e-5. Two programs cannot agree bit for bit: the goldens come from a fused
XLA program that contracts multiply-adds into FMAs, and a last-ulp change
moves march crossings at silhouettes.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gpuraytracer_tpu_torch.core.types import IntersectorKind
from gpuraytracer_tpu_torch.kernels import frame_kernel
from gpuraytracer_tpu_torch.models import builtin
from gpuraytracer_tpu_torch.render import trace
from gpuraytracer_tpu_torch.render.renderer import Renderer

HERE = os.path.dirname(os.path.abspath(__file__))
W, H = 96, 54
T_ANIM = 0.7

# The exact-reference knobs of tests/test_golden_exact.py (EXACT_ENV): full
# 512-step budgets, no over-relaxation.
EXACT_ENV = {
    "GPURT_RELAX_SHADOW": "1.0",
    "GPURT_RELAX_REF": "1.0",
    "GPURT_SHADOW_BUDGET": "0",
    "GPURT_SHADOW_BUDGET_B": "0",
    "GPURT_MARCH_BUDGET": "0",
    "GPURT_MARCH_BUDGET_B": "0",
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    # The wavefront's tensors are small; intra-op threads only add overhead.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_bar(img, ref):
    diff = np.abs(np.asarray(img, np.float32) - np.asarray(ref, np.float32)).max(axis=-1)
    flipped = diff > 1e-3
    assert flipped.mean() < 0.02, f"{flipped.sum()} pixels flipped"
    agree = diff[~flipped]
    assert agree.max() <= 1e-3
    assert (agree < 1e-5).mean() > 0.75


def _render_cpu(width=W, height=H):
    scene = builtin.build_scene(aspect=width / height, elapsed_time=T_ANIM, device="cpu")
    return trace.render_frame(scene, width, height)


@pytest.mark.parametrize("golden, env", [
    ("golden_builtin_96x54_t0p7.npz", {}),
    ("golden_builtin_exact_96x54_t0p7.npz", EXACT_ENV),
], ids=["default_knobs", "exact_knobs"])
def test_render_frame_matches_golden(golden, env, monkeypatch):
    # The knobs are read at call time, so the exact case needs no subprocess.
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    img = _render_cpu()
    assert img.shape == (H, W, 4) and img.dtype == torch.float32
    assert_bar(img.numpy(), np.load(os.path.join(HERE, golden))["image"])


SMALL_W, SMALL_H = 24, 14


@pytest.fixture(scope="module")
def small_frame():
    scene = builtin.build_scene(aspect=SMALL_W / SMALL_H, elapsed_time=T_ANIM, device="cpu")
    return scene, trace.render_frame(scene, SMALL_W, SMALL_H)


def test_frame_kernel_wrapper_runs_plain_version_on_cpu(small_frame):
    # A CPU pack goes through the kernel's plain version on the scene
    # unpacked from the same buffers: the same image as render_frame, and
    # no kernel launch.
    scene, ref = small_frame
    launches = frame_kernel.LAUNCHES
    img = frame_kernel.render_frame_tiles(frame_kernel.pack_frame(scene),
                                          width=SMALL_W, height=SMALL_H)
    assert frame_kernel.LAUNCHES == launches
    assert torch.equal(img, ref)


def test_renderer_animates_and_resizes(small_frame):
    r = Renderer(SMALL_W, SMALL_H, device="cpu")
    assert torch.equal(r.render(T_ANIM), small_frame[1])
    # A resize rebuilds the aspect-dependent constants (no-op sizes do not).
    r.resize(12, 12)
    assert r.size == (12, 12)
    square = builtin.build_scene(aspect=1.0, device="cpu").arrays.constants
    assert torch.equal(r._arrays.constants.projection_to_world, square.projection_to_world)


def test_cuda_path_refuses_what_the_kernel_does_not_cover(monkeypatch):
    # render_frame on a GPU: fused-eligible scenes go to the frame kernel
    # (in every GPURT_FRAME_MODE), every other covered scene to the
    # wavefront (the scene kernel, or the per-geometry route past the mesh
    # face cap), and what no route covers raises, naming the unported
    # kernel. Meshes, the compacted frame modes and GPURT_MERGED_SHADOW are
    # covered on every route now.
    layout = builtin.LAYOUT
    frame_kernel.check_kernel_covers(layout)
    assert frame_kernel.fused_eligible_layout(layout, 11)
    for mode in ("compact", "defer"):
        with monkeypatch.context() as m:
            m.setenv("GPURT_FRAME_MODE", mode)
            frame_kernel.check_kernel_covers(layout)
    with monkeypatch.context() as m:
        m.setenv("GPURT_MERGED_SHADOW", "1")
        for route in ("frame", "scene", "per_geometry"):
            frame_kernel.check_kernel_covers(layout, route)
        assert frame_kernel.fused_eligible_layout(layout, 11)
    meshes = dataclasses.replace(
        layout, kinds=layout.kinds[:-1] + (IntersectorKind.TRIANGLE,))
    frame_kernel.check_kernel_covers(meshes)
    assert frame_kernel.fused_eligible_layout(meshes, 11, 512)
    assert not frame_kernel.fused_eligible_layout(meshes, 11, 513)
    # 17 unique materials, or GPURT_DISABLE_FUSED: the scene-kernel wavefront.
    assert not frame_kernel.fused_eligible_layout(layout, 17)
    with monkeypatch.context() as m:
        m.setenv("GPURT_DISABLE_FUSED", "1")
        frame_kernel.check_kernel_covers(layout)
        assert not frame_kernel.fused_eligible_layout(layout, 11)


def test_cuda_renderer_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the no-GPU refusal")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Renderer(8, 8, device="cuda")


def test_to_rgba8_saturates_and_rounds_half_even():
    img = torch.tensor([[[-0.5, 0.5 / 255.0, 1.5 / 255.0, 2.0]]])
    assert trace.to_rgba8(img).tolist() == [[[0, 0, 2, 255]]]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the frame kernel has no CPU build)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_frame_kernel_matches_plain_on_cuda(cuda_device):
    w, h = 128, 72
    scene = builtin.build_scene(aspect=w / h, elapsed_time=T_ANIM, device=cuda_device)
    pack = frame_kernel.pack_frame(scene)
    launches = frame_kernel.LAUNCHES
    img = frame_kernel.render_frame_tiles(pack, width=w, height=h)
    torch.cuda.synchronize()
    assert frame_kernel.LAUNCHES == launches + 1
    plain = frame_kernel.render_frame_plain(pack, width=w, height=h)
    assert torch.isfinite(img).all()
    assert_bar(img.cpu().numpy(), plain.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("w, h", [(320, 180), (321, 181)])
def test_frame_kernel_matches_plain_at_ragged_sizes_on_cuda(cuda_device, w, h):
    # 320x180 fills the 16x8 blocks; 321x181 leaves ragged blocks on the
    # right and bottom edges.
    scene = builtin.build_scene(aspect=w / h, elapsed_time=T_ANIM, device=cuda_device)
    pack = frame_kernel.pack_frame(scene)
    img = frame_kernel.render_frame_tiles(pack, width=w, height=h)
    torch.cuda.synchronize()
    assert torch.isfinite(img).all()
    plain = frame_kernel.render_frame_plain(pack, width=w, height=h)
    assert_bar(img.cpu().numpy(), plain.cpu().numpy())


@pytest.mark.cuda
def test_frame_kernel_launched_twice_gives_the_same_frame_on_cuda(cuda_device):
    # Two launches in a row render the same frame bit for bit, and the
    # card keeps at least one block of the kernel resident.
    w, h = 320, 180
    pack = frame_kernel.pack_frame(builtin.build_scene(aspect=w / h, elapsed_time=T_ANIM,
                                                       device=cuda_device))
    launches = frame_kernel.LAUNCHES
    first = frame_kernel.render_frame_tiles(pack, width=w, height=h)
    second = frame_kernel.render_frame_tiles(pack, width=w, height=h)
    torch.cuda.synchronize()
    assert frame_kernel.LAUNCHES == launches + 2
    assert torch.equal(first, second)
    per_sm, total = frame_kernel.residency(pack)
    assert per_sm >= 1 and total >= per_sm


@pytest.mark.cuda
def test_frame_kernel_renders_past_shared_memory_on_cuda(cuda_device):
    # 1,600 instances: the tables do not fit in a block's shared memory, so
    # the kernel reads them from global memory (and takes none).
    from gpuraytracer_tpu_torch.models import scenes

    w, h = 64, 36
    scene = scenes.instance_grid(40, 40, 8).build(w / h, T_ANIM, device=cuda_device)
    pack = frame_kernel.pack_frame(scene)
    assert not frame_kernel.tables_in_shared(pack.num_geometries, pack.num_materials,
                                             shading=True)
    img = frame_kernel.render_frame_tiles(pack, width=w, height=h)
    torch.cuda.synchronize()
    plain = frame_kernel.render_frame_plain(pack, width=w, height=h)
    assert_bar(img.cpu().numpy(), plain.cpu().numpy())
