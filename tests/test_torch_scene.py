"""The port's builtin scene, animation and frame-kernel packing against the
JAX reference.

The reference's SceneArrays, flattened to numpy by field name, carry over
into the port through ``SceneArrays.from_numpy``; they must equal the
port's own scene at t in {0, 0.7} to 1e-6 (the transforms go through
cos/sin, which may differ by an ulp between libraries; everything else is
exact).
"""

import dataclasses

import numpy as np
import pytest
import torch

from gpuraytracer_tpu.kernels import frame_kernel as j_frame
from gpuraytracer_tpu.models import builtin as j_builtin
from gpuraytracer_tpu_torch.accel.instances import SceneArrays
from gpuraytracer_tpu_torch.kernels import frame_kernel as t_frame
from gpuraytracer_tpu_torch.models import builtin as t_builtin

ASPECT = 96 / 54


def flatten_reference(obj, prefix=""):
    """The reference's (nested) dataclass of arrays as {dotted name: ndarray}."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(flatten_reference(v, prefix + f.name + "."))
        elif f.name != "meshes":
            out[prefix + f.name] = np.asarray(v)
    return out


def _assert_arrays_equal(port: SceneArrays, ref_flat, atol):
    got = port.to_numpy()
    assert sorted(got) == sorted(ref_flat)
    for key, ref in ref_flat.items():
        np.testing.assert_allclose(got[key], ref, rtol=0, atol=atol, err_msg=key)


@pytest.mark.parametrize("t", [0.0, 0.7])
def test_scene_matches_reference(t):
    ref = j_builtin.build_scene(aspect=ASPECT, elapsed_time=t)
    port = t_builtin.build_scene(aspect=ASPECT, elapsed_time=t, device="cpu")
    flat = flatten_reference(ref.arrays)
    carried = SceneArrays.from_numpy(flat, device="cpu")
    _assert_arrays_equal(carried, flat, atol=0.0)  # the converter is lossless
    _assert_arrays_equal(port.arrays, flat, atol=1e-6)
    assert port.layout.kinds == ref.layout.kinds
    assert port.layout.prim_types == ref.layout.prim_types
    assert port.layout.plane_geometry_id == ref.layout.plane_geometry_id


@pytest.mark.parametrize("t", [0.0, 0.7])
def test_animate_arrays_matches_reference(t):
    ref = j_builtin.animate_arrays(j_builtin.build_scene(aspect=ASPECT).arrays, t)
    port = t_builtin.animate_arrays(t_builtin.build_scene(aspect=ASPECT, device="cpu").arrays, t)
    _assert_arrays_equal(port, flatten_reference(ref), atol=1e-6)


def test_pack_frame_params_matches_reference():
    # Same scene on both sides (carried over), so the blocks agree to 1e-7
    # (only the metaball animation is recomputed from elapsed_time).
    ref_scene = j_builtin.build_scene(aspect=ASPECT, elapsed_time=0.7)
    arrays = SceneArrays.from_numpy(flatten_reference(ref_scene.arrays), device="cpu")
    port_scene = t_builtin.Scene(t_builtin.LAYOUT, arrays)
    ref_blocks, ref_static = j_frame.pack_frame_params(ref_scene)
    blocks, static = t_frame.pack_frame_params(port_scene)
    assert len(blocks) == len(ref_blocks) == 8
    for got, want in zip(blocks, ref_blocks):
        assert tuple(got.shape) == tuple(np.shape(want))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7)
    assert static["geoms"] == ref_static["geoms"]
    assert static["plane_gid"] == ref_static["plane_gid"]


def test_pack_frame_round_trip_and_budgets():
    scene = t_builtin.build_scene(aspect=ASPECT, elapsed_time=0.7, device="cpu")
    pack = t_frame.pack_frame(scene)
    off = t_frame.param_offsets(pack.num_geometries, pack.num_materials)
    assert pack.params.numel() == off["total"] and pack.params.dtype == torch.float32
    back = t_frame.unpack_frame(pack)
    assert back.layout.kinds == scene.layout.kinds
    assert back.layout.prim_types == scene.layout.prim_types
    for name in ("aabb_min", "aabb_max", "blas_offset", "plane_origin", "plane_size"):
        assert torch.equal(getattr(back.arrays, name), getattr(scene.arrays, name)), name
    assert torch.equal(back.arrays.transforms.blas_to_local, scene.arrays.transforms.blas_to_local)
    assert torch.equal(back.arrays.constants.elapsed_time, scene.arrays.constants.elapsed_time)
    # Per-geometry march budgets at the default knobs: radiance 160/128,
    # occlusion 96/64, and capped occlusion reports occluded at both levels;
    # then the natural budget (512), no AABB window (no extension code), no
    # face-table rows (no mesh), and the identity material slots.
    g = pack.num_geometries
    geo = pack.layout[t_frame.I_HEADER:t_frame.I_HEADER + g * t_frame.GEO_STRIDE]
    geo = geo.reshape(g, t_frame.GEO_STRIDE)
    assert geo[:, 2:].tolist() == [[160, 128, 96, 64, 1, 1, 512, 0, 0, 0]] * g
    assert pack.layout[t_frame.I_HEADER + g * t_frame.GEO_STRIDE:].tolist() == list(range(g + 1))
    assert pack.params[1].item() == 1.0 and pack.params[2].item() == pytest.approx(1.6)
    assert pack.params[5].item() == pytest.approx(1.6)  # the extension fractals' omega
