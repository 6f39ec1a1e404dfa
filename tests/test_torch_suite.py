"""The five bench scenes through the port's wavefront on the CPU against
their committed goldens (tests/golden_<name>_96x54_t0p7.npz, rendered by
the reference's XLA path), the material gather of deduplicated tables, and
the bench's window.

The bar is the one tests/test_frame_kernel.py holds the reference's Pallas
kernel to its XLA path: fewer than 2% of pixels with a max-channel |diff|
above 1e-3, every other pixel within 1e-3, and more than 75% of those
within 1e-5.
"""

import dataclasses
import inspect
import os

import numpy as np
import pytest
import torch

from gpuraytracer_tpu_torch.accel.instances import Scene
from gpuraytracer_tpu_torch.core.types import MaterialTable
from gpuraytracer_tpu_torch.kernels import frame_kernel, scene_kernel
from gpuraytracer_tpu_torch.models import builtin, scenes
from gpuraytracer_tpu_torch.render import trace

HERE = os.path.dirname(os.path.abspath(__file__))
W, H = 96, 54


@pytest.fixture(autouse=True, scope="module")
def one_thread():
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


@pytest.mark.parametrize("name", [c.name for c in scenes.BENCH_CONFIGS])
def test_bench_scene_matches_golden(name):
    cfg = scenes.get_config(name)
    launches = (frame_kernel.LAUNCHES, scene_kernel.LAUNCHES)
    img = trace.render_frame(cfg.build(W / H, 0.7, device="cpu"), W, H, max_depth=cfg.max_depth)
    assert (frame_kernel.LAUNCHES, scene_kernel.LAUNCHES) == launches  # plain on the CPU
    assert img.shape == (H, W, 4) and bool(torch.isfinite(img).all())
    assert_bar(img.numpy(), np.load(os.path.join(HERE, f"golden_{name}_96x54_t0p7.npz"))["image"])


def test_material_gather_maps_through_material_ids():
    # The builtin scene's 11 geometry rows share 8 distinct materials.
    # Deduplicating the table (rows + layout.material_ids, as SceneBuilder
    # does) must render the same image: the gather maps each geometry id
    # through material_ids before indexing the table.
    w, h = 32, 18
    scene = builtin.build_scene(aspect=w / h, elapsed_time=0.7, device="cpu")
    mats = scene.arrays.materials
    rows = torch.cat([mats.albedo, torch.stack([mats.reflectance_coefficient,
                                                mats.diffuse_coefficient,
                                                mats.specular_coefficient,
                                                mats.specular_power], dim=-1)], dim=-1)
    uniq, ids = torch.unique(rows, dim=0, return_inverse=True)
    assert uniq.shape[0] < rows.shape[0]
    table = MaterialTable(albedo=uniq[:, :4], reflectance_coefficient=uniq[:, 4],
                          diffuse_coefficient=uniq[:, 5], specular_coefficient=uniq[:, 6],
                          specular_power=uniq[:, 7], step_scale=mats.step_scale)
    dedup = Scene(dataclasses.replace(scene.layout, material_ids=tuple(ids.tolist())),
                  dataclasses.replace(scene.arrays, materials=table))
    assert torch.equal(trace.render_frame(dedup, w, h), trace.render_frame(scene, w, h))


def test_bench_window_is_the_references_64_frames():
    # Mrays/s is taken over animated windows of the reference's length: 64
    # frames (gpuraytracer_tpu/apps/bench_suite.py, bench.py), in the
    # function and on the command line.
    from gpuraytracer_tpu.apps import bench_suite as ref
    from gpuraytracer_tpu_torch.apps import bench_suite

    want = inspect.signature(ref.bench_config).parameters["wall_chain"].default
    assert want == 64
    assert bench_suite.WALL_CHAIN == want
    assert inspect.signature(bench_suite.bench_config).parameters["wall_chain"].default == want
    assert bench_suite.build_parser().parse_args([]).wall_chain == want
