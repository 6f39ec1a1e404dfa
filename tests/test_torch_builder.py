"""The port's SceneBuilder and the five bench scenes against the JAX
package's (gpuraytracer_tpu.models.builder / scenes).

Each BENCH_CONFIG is built on both sides at t in {0, 0.7}: the layout
fields must be equal, and every scene array equal to 1e-6 (the transforms
go through cos/sin, which may differ by an ulp between libraries; every
other array is exact). The animator and the frame kernel's parameter
blocks are held to the reference the same way, and pack_frame/unpack_frame
must round-trip a deduplicated scene.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gpuraytracer_tpu.kernels import frame_kernel as j_frame
from gpuraytracer_tpu.models import builder as j_builder
from gpuraytracer_tpu.models import scenes as j_scenes
from gpuraytracer_tpu_torch.accel.instances import Scene, SceneArrays, SceneLayout
from gpuraytracer_tpu_torch.core.types import IntersectorKind
from gpuraytracer_tpu_torch.kernels import frame_kernel
from gpuraytracer_tpu_torch.models import builder, scenes

ASPECT = 96 / 54
NAMES = [c.name for c in scenes.BENCH_CONFIGS]
LAYOUT_FIELDS = ("kinds", "prim_types", "has_plane", "clusters", "step_budgets",
                 "traversal_order", "material_ids")


def flatten_reference(obj, prefix=""):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(flatten_reference(v, prefix + f.name + "."))
        elif f.name != "meshes":
            out[prefix + f.name] = np.asarray(v)
    return out


def assert_arrays_match(port: SceneArrays, ref_flat, atol=1e-6):
    got = port.to_numpy()
    assert sorted(got) == sorted(ref_flat)
    for key, want in ref_flat.items():
        assert got[key].shape == want.shape, key
        np.testing.assert_allclose(got[key], want, rtol=0, atol=atol, err_msg=key)


def test_bench_configs_match_reference():
    assert [(c.name, c.width, c.height, c.max_depth, c.animated) for c in scenes.BENCH_CONFIGS] == [
        (c.name, c.width, c.height, c.max_depth, c.animated) for c in j_scenes.BENCH_CONFIGS]
    assert scenes.get_config("metaballs_1080p").animated
    with pytest.raises(KeyError):
        scenes.get_config("no_such_scene")


@pytest.mark.parametrize("t", [0.0, 0.7])
@pytest.mark.parametrize("name", NAMES)
def test_scene_matches_reference(name, t):
    ref = j_scenes.get_config(name).build(ASPECT, t)
    port = scenes.get_config(name).build(ASPECT, t, device="cpu")
    for field in LAYOUT_FIELDS:
        assert getattr(port.layout, field) == getattr(ref.layout, field), field
    assert port.layout.plane_geometry_id == ref.layout.plane_geometry_id
    assert_arrays_match(port.arrays, flatten_reference(ref.arrays))
    # The layout also carries over from plain fields, unchanged.
    carried = SceneLayout.from_fields({f: getattr(ref.layout, f) for f in LAYOUT_FIELDS})
    assert carried == port.layout


@pytest.mark.parametrize("name", NAMES)
def test_animator_matches_reference(name):
    ref_b = j_scenes.get_config(name).builder()
    ref = ref_b.animator()(ref_b.build(ASPECT, 0.0).arrays, 1.3)
    port_b = scenes.get_config(name).builder()
    port = port_b.animator()(port_b.build(ASPECT, 0.0, device="cpu").arrays, 1.3)
    assert_arrays_match(port, flatten_reference(ref))


@pytest.mark.parametrize("name", NAMES)
def test_pack_frame_params_matches_reference(name):
    # The same scene on both sides (carried over), so the blocks agree to
    # 1e-7 (only the metaball animation is recomputed from elapsed_time).
    ref_scene = j_scenes.get_config(name).build(ASPECT, 0.7)
    arrays = SceneArrays.from_numpy(flatten_reference(ref_scene.arrays), device="cpu")
    port_scene = Scene(scenes.get_config(name).builder().layout, arrays)
    ref_blocks, ref_static = j_frame.pack_frame_params(ref_scene)
    blocks, static = frame_kernel.pack_frame_params(port_scene)
    assert len(blocks) == len(ref_blocks) == 8
    for got, want in zip(blocks, ref_blocks):
        assert tuple(got.shape) == tuple(np.shape(want))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7)
    assert static["geoms"] == ref_static["geoms"]
    assert static["plane_gid"] == ref_static["plane_gid"]
    assert frame_kernel.fused_eligible_layout(port_scene.layout, blocks[5].shape[0])


def test_pack_round_trip_of_deduplicated_scene():
    # The analytic grid has 16 instances + the plane (17 geometry rows) but
    # 4 unique materials: step_scale keeps one entry per geometry row and
    # the material slots ride in the int32 layout buffer.
    scene = scenes.get_config("analytic_grid_720p").build(ASPECT, 0.7, device="cpu")
    g, m = scene.layout.num_procedural, scene.arrays.materials.albedo.shape[0]
    assert (g, m) == (16, 4)
    pack = frame_kernel.pack_frame(scene)
    assert pack.layout.numel() == frame_kernel.layout_size(g)
    back = frame_kernel.unpack_frame(pack)
    assert back.layout.material_ids == scene.layout.material_ids
    assert back.layout.step_budgets == scene.layout.step_budgets
    mats, ref = back.arrays.materials, scene.arrays.materials
    assert mats.step_scale.shape == (g + 1,)
    for f in dataclasses.fields(mats):
        assert torch.equal(getattr(mats, f.name), getattr(ref, f.name)), f.name
    assert torch.equal(back.arrays.transforms.blas_to_local, scene.arrays.transforms.blas_to_local)
    # Packing the unpacked scene gives the same buffers.
    again = frame_kernel.pack_frame(back)
    assert torch.equal(again.params, pack.params) and torch.equal(again.layout, pack.layout)


def test_step_budgets_reach_the_layout_buffer():
    # The fractal scene's two DE fractals march with their own budget (96),
    # capped per level like every march, inside their unit box (column 9);
    # the sphere cluster keeps 512. No row is a mesh: the face-table columns
    # are (0, 0).
    scene = scenes.get_config("fractal_mandelbulb_julia_1080p").build(ASPECT, device="cpu")
    assert scene.layout.step_budgets == (96, 96, 512)
    pack = frame_kernel.pack_frame(scene)
    geo = pack.layout[frame_kernel.I_HEADER:][:frame_kernel.GEO_STRIDE * 3]
    rows = geo.reshape(3, frame_kernel.GEO_STRIDE).tolist()
    assert [r[2:] for r in rows] == ([[96, 96, 96, 64, 0, 1, 96, 1, 0, 0]] * 2
                                     + [[160, 128, 96, 64, 1, 1, 512, 0, 0, 0]])


def test_builder_refuses_meshes_and_empty_scenes():
    # (The name predates meshes: a mesh instance now builds, and only an
    # empty scene is refused.)
    with pytest.raises(ValueError, match="no instances"):
        builder.SceneBuilder().build(ASPECT, device="cpu")
    positions = [(0.0, 0.0, 0.0), (0.0, 0.0, 1.0), (1.0, 0.0, 0.0)]
    for indices in (np.asarray([[0, 1, 2]], np.uint16), np.asarray([[0, 1, 2]], np.uint32)):
        b = builder.SceneBuilder().add_mesh_instance(
            positions, indices, builder.Material((1, 1, 1, 1)),
            aabb_min=(-1.0, -1.0, -1.0), aabb_max=(1.0, 1.0, 1.0))
        ref = j_builder.SceneBuilder().add_mesh_instance(
            positions, indices, j_builder.Material((1, 1, 1, 1)),
            aabb_min=(-1.0, -1.0, -1.0), aabb_max=(1.0, 1.0, 1.0))
        scene, ref_scene = b.build(ASPECT, device="cpu"), ref.build(ASPECT)
        assert scene.layout.kinds == ref_scene.layout.kinds == (IntersectorKind.TRIANGLE,)
        assert scene.layout.prim_types == ref_scene.layout.prim_types == (0,)
        (mesh,), (ref_mesh,) = scene.arrays.meshes, ref_scene.arrays.meshes
        for f in ("v0", "e1", "e2", "n"):
            np.testing.assert_array_equal(getattr(mesh, f).numpy(), np.asarray(getattr(ref_mesh, f)))


def test_grid_cell_aabb_and_plane_less_layout():
    for args in ((0, 0), (3, 2, (4, 4, 4)), (1, 3, (2, 3, 2))):
        assert builder.grid_cell_aabb(*args) == j_builder.grid_cell_aabb(*args)
    b = scenes.get_config("single_sphere_plane_256").builder().without_plane()
    layout = b.layout
    assert not layout.has_plane and layout.material_ids == (0,)
    assert layout.kinds == (IntersectorKind.ANALYTIC,)
