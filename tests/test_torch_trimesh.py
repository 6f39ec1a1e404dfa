"""Triangle meshes in the port against the JAX package's.

- geometry/trimesh.py (from_indexed, mt_face, intersect_trimesh) against
  gpuraytracer_tpu.geometry.trimesh on the same seeded buffers and rays,
  for 1, 8 and 16-face meshes, with and without the back-face cull: the
  face rows are equal bit for bit (the same numpy gather), hit masks are
  equal and t agrees within 1e-6 + 1e-5 * t; the normal is the winning
  face's n, or, where faces tie within that tolerance, one tying face's on
  each side (the random meshes hold coplanar faces of opposite winding). (The
  reference's dot is a jnp.sum whose order XLA picks; the port sums x, y,
  z in turn, as the Pallas mesh body and the CUDA one do. The two differ by
  an ulp of the dot's terms, which 1 / det scales up on grazing faces: up
  to 3.6e-6 * t on these meshes.)
- accel/traverse.pack_tri_rows, _total_mesh_faces and the route rule
  (fused eligibility, scene-kernel eligibility) against the reference for
  scenes of 64, 512 and 544 faces: the port's table is the reference's
  without its chunk padding (all-zero faces), and both route every scene
  alike (the reference's rule asked as its TPU would answer it).
- The three mesh scenes of models/meshes.py, built by the JAX package's
  SceneBuilder and carried across with SceneArrays.from_numpy, against the
  port's SceneBuilder scenes: every array within 1e-6 (transforms go
  through cos/sin).
- The port's CPU wavefront against committed goldens
  tests/golden_torch_mesh_<scene>_96x54_t0p7.npz under the image bar of
  tests/test_torch_suite.py. The goldens come from the reference's XLA path
  and are written, with every other reference the port is held to, by
      JAX_PLATFORMS=cpu python tools/torch_make_refs.py --goldens --force
  (running this file runs that command).

On a GPU (the ``cuda`` marker) the mesh body of the frame and scene
kernels is held to its plain version.
"""

import os

import numpy as np
import pytest
import torch

from gpuraytracer_tpu_torch.accel import traverse
from gpuraytracer_tpu_torch.accel.instances import SceneArrays
from gpuraytracer_tpu_torch.geometry import trimesh
from gpuraytracer_tpu_torch.kernels import frame_kernel, megakernel, scene_kernel
from gpuraytracer_tpu_torch.models import meshes
from gpuraytracer_tpu_torch.render import trace

HERE = os.path.dirname(os.path.abspath(__file__))
W, H = 96, 54
T_ANIM = 0.7
NAMES = [c.name for c in meshes.MESH_CONFIGS]
BUILDERS = {"mesh_octahedra": meshes.octahedra_builder,
            "mesh_heightfield_512": meshes.heightfield_512_builder,
            "mesh_heightfield_sdf": meshes.heightfield_sdf_builder}
LAYOUT_FIELDS = ("kinds", "prim_types", "has_plane", "clusters", "step_budgets",
                 "traversal_order", "material_ids")


def golden_path(name):
    return os.path.join(HERE, f"golden_torch_{name}_96x54_t0p7.npz")


def reference_scene(name, aspect=W / H):
    from gpuraytracer_tpu.models import builder as j_builder

    return BUILDERS[name](j_builder).build(aspect, T_ANIM)


def flatten_reference(obj, prefix=""):
    """A JAX dataclass as {"a.b": ndarray}, mesh k's rows as "meshes.k.v0"."""
    import dataclasses

    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.name == "meshes":
            for k, m in enumerate(v):
                out.update(flatten_reference(m, f"{prefix}meshes.{k}."))
        elif dataclasses.is_dataclass(v):
            out.update(flatten_reference(v, prefix + f.name + "."))
        else:
            out[prefix + f.name] = np.asarray(v)
    return out


def mesh_buffers(faces, seed, normals):
    """Seeded (positions, indices, normals or None) of a mesh of ``faces``
    faces over 12 vertices in [-1, 1]^3, u16 indices for an even seed and
    u32 for an odd one (random indices make some faces degenerate)."""
    rng = np.random.default_rng(seed)
    positions = rng.uniform(-1.0, 1.0, size=(12, 3)).astype(np.float32)
    indices = rng.integers(0, 12, size=(faces, 3)).astype(np.uint16 if seed % 2 == 0 else np.uint32)
    nrm = rng.normal(size=(12, 3)).astype(np.float32) if normals else None
    return positions, indices, nrm


def rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3.0, 3.0, size=(n, 3)).astype(np.float32)
    aim = rng.uniform(-0.8, 0.8, size=(n, 3)).astype(np.float32)
    d = (aim - o) / np.linalg.norm(aim - o, axis=-1, keepdims=True)
    t_max = rng.uniform(1.0, 8.0, size=n).astype(np.float32)
    return o, d.astype(np.float32), t_max


@pytest.mark.parametrize("normals", [False, True])
@pytest.mark.parametrize("faces", [1, 8, 16])
def test_from_indexed_matches_reference(faces, normals):
    from gpuraytracer_tpu.geometry import trimesh as j_trimesh

    positions, indices, nrm = mesh_buffers(faces, faces + int(normals), normals)
    mesh = trimesh.from_indexed(positions, indices, nrm)
    ref = j_trimesh.from_indexed(positions, indices, nrm)
    assert mesh.num_faces == ref.num_faces == faces
    for f in ("v0", "e1", "e2", "n"):
        np.testing.assert_array_equal(getattr(mesh, f).numpy(), np.asarray(getattr(ref, f)), f)
    assert torch.equal(mesh.rows(), torch.cat([mesh.v0, mesh.e1, mesh.e2, mesh.n], dim=-1))
    quad, ref_quad = trimesh.ground_quad_mesh((1.0, 0.0, 2.0), (3.0, 4.0)), \
        j_trimesh.ground_quad_mesh((1.0, 0.0, 2.0), (3.0, 4.0))
    for f in ("v0", "e1", "e2", "n"):
        np.testing.assert_array_equal(getattr(quad, f).numpy(), np.asarray(getattr(ref_quad, f)))


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("faces", [1, 8, 16])
def test_intersect_trimesh_matches_reference(faces, cull):
    import jax.numpy as jnp
    from gpuraytracer_tpu.geometry import trimesh as j_trimesh

    positions, indices, _ = mesh_buffers(faces, 20 + faces, False)
    mesh = trimesh.from_indexed(positions, indices)
    ref = j_trimesh.from_indexed(positions, indices)
    o, d, t_max = rays(512, 30 + faces + int(cull))
    to, td, tt = torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max)
    jo, jd, jt = jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)
    # One face at a time: exact hit masks, t within 1e-6 + 1e-5 * t.
    for f in range(faces):
        hit, t = trimesh.mt_face(to, td, mesh.v0[f], mesh.e1[f], mesh.e2[f], t_min=0.0,
                                 t_max=tt, cull_backface=cull)
        want_hit, want_t = map(np.asarray, j_trimesh._mt_face(
            jo, jd, ref.v0[f], ref.e1[f], ref.e2[f], ref.n[f], 0.0, jt, cull))
        np.testing.assert_array_equal(hit.numpy(), want_hit)
        np.testing.assert_allclose(t.numpy()[want_hit], want_t[want_hit], rtol=1e-5, atol=1e-6)
    # The closest face over the mesh.
    hit, t, n = trimesh.intersect_trimesh(to, td, mesh, t_min=0.0, t_max=tt, cull_backface=cull)
    want_hit, want_t, want_n = map(np.asarray, j_trimesh.intersect_trimesh(
        jo, jd, ref, t_min=0.0, t_max=jt, cull_backface=cull))
    np.testing.assert_array_equal(hit.numpy(), want_hit)
    assert want_hit.any() and not want_hit.all()
    np.testing.assert_allclose(t.numpy()[want_hit], want_t[want_hit], rtol=1e-5, atol=1e-6)
    assert np.isinf(t.numpy()[~want_hit]).all()
    face_t = torch.stack([trimesh.mt_face(to, td, mesh.v0[f], mesh.e1[f], mesh.e2[f], t_min=0.0,
                                          t_max=tt, cull_backface=cull)[1]
                          for f in range(faces)], dim=1)
    assert torch.equal(n[hit], mesh.n[face_t.argmin(dim=1)][hit])  # first face at the minimum
    tie = ((face_t - t[:, None]).abs() <= 1e-6 + 1e-5 * t[:, None]).numpy()
    same_n = (np.abs(want_n[:, None, :] - mesh.n.numpy()[None]) <= 1e-6).all(axis=-1)
    assert (tie & same_n)[want_hit].any(axis=1).all()
    # The mesh entry of csrc/megakernel.cu runs this on the CPU, behind a gate.
    gate = torch.from_numpy(np.arange(512) % 3 != 0)
    g_hit, g_t, g_n = megakernel.trimesh_closest(mesh.rows(), to, td, gate, tt, cull_backface=cull)
    assert torch.equal(g_hit, hit & gate)
    assert torch.equal(g_t[gate], t[gate]) and torch.equal(g_n[gate], n[gate])


@pytest.mark.parametrize("name,faces,fused", [("mesh_octahedra", 64, True),
                                               ("mesh_heightfield_512", 512, True),
                                               ("mesh_heightfield_sdf", 544, False)])
def test_face_table_and_route_match_reference(name, faces, fused, monkeypatch):
    import jax.numpy as jnp
    from gpuraytracer_tpu.accel import traverse as j_traverse
    from gpuraytracer_tpu.kernels import frame_kernel as j_frame
    from gpuraytracer_tpu.kernels import megakernel as j_mega

    ref = reference_scene(name)
    scene = meshes.get_config(name).build(W / H, T_ANIM, device="cpu")
    assert traverse._total_mesh_faces(scene) == j_traverse._total_mesh_faces(ref) == faces
    rows, offsets = traverse.pack_tri_rows(scene.arrays)
    ref_rows, ref_offsets = j_traverse.pack_tri_rows(ref.arrays)
    ref_rows = np.asarray(ref_rows)
    assert rows.shape == (faces, 12)
    assert [c for _, c in offsets] == [m.num_faces for m in scene.arrays.meshes]
    for (start, count), (r_start, r_count) in zip(offsets, ref_offsets):
        np.testing.assert_array_equal(rows[start:start + count].numpy(),
                                      ref_rows[r_start:r_start + count])
        # The reference pads a streamed mesh with all-zero faces, which
        # cannot hit; the port drops them.
        assert r_count >= count and not ref_rows[r_start + count:r_start + r_count].any()
    # The route rule, as the reference's TPU answers it.
    monkeypatch.setattr(j_mega, "pallas_available", lambda: True)
    m = scene.arrays.materials.albedo.shape[0]
    got = frame_kernel.fused_eligible_layout(scene.layout, m, traverse._total_mesh_faces(scene))
    assert got == fused == j_frame.fused_eligible_layout(ref.layout, m, faces)
    assert traverse._scene_kernel_eligible(scene) == fused == j_traverse._scene_kernel_eligible(
        jnp.zeros((2, 2, 3)), ref)
    # The packed buffers carry the table and each mesh row's (start, count).
    pack = frame_kernel.pack_frame(scene)
    assert torch.equal(pack.tri, rows) and pack.tri_offsets == offsets
    g = pack.num_geometries
    geo = pack.layout[frame_kernel.I_HEADER:][:g * frame_kernel.GEO_STRIDE].reshape(g, -1).tolist()
    for row, kind, code in zip(geo, scene.layout.kinds, scene.layout.prim_types):
        assert tuple(row[10:]) == (offsets[code] if kind == 3 else (0, 0))
    back = frame_kernel.unpack_frame(pack)
    for mesh, again in zip(scene.arrays.meshes, back.arrays.meshes):
        assert torch.equal(mesh.rows(), again.rows())


@pytest.mark.parametrize("name", NAMES)
def test_mesh_scene_matches_reference(name):
    ref = reference_scene(name)
    scene = meshes.get_config(name).build(W / H, T_ANIM, device="cpu")
    for field in LAYOUT_FIELDS:
        assert getattr(scene.layout, field) == getattr(ref.layout, field), field
    flat = flatten_reference(ref.arrays)
    carried = SceneArrays.from_numpy(flat, device="cpu")
    assert len(carried.meshes) == len(ref.arrays.meshes) == len(scene.arrays.meshes)
    got, want = scene.arrays.to_numpy(), carried.to_numpy()
    assert sorted(got) == sorted(want) == sorted(flat)
    for key in flat:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6, err_msg=key)


def assert_bar(img, ref):
    diff = np.abs(np.asarray(img, np.float32) - np.asarray(ref, np.float32)).max(axis=-1)
    flipped = diff > 1e-3
    assert flipped.mean() < 0.02, f"{flipped.sum()} pixels flipped"
    agree = diff[~flipped]
    assert agree.max() <= 1e-3
    assert (agree < 1e-5).mean() > 0.75


@pytest.mark.parametrize("name", NAMES)
def test_mesh_scene_matches_golden(name):
    cfg = meshes.get_config(name)
    launches = (frame_kernel.LAUNCHES, scene_kernel.LAUNCHES, megakernel.LAUNCHES,
                megakernel.MESH_LAUNCHES)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        img = trace.render_frame(cfg.build(W / H, T_ANIM, device="cpu"), W, H,
                                 max_depth=cfg.max_depth)
    finally:
        torch.set_num_threads(n)
    assert (frame_kernel.LAUNCHES, scene_kernel.LAUNCHES, megakernel.LAUNCHES,
            megakernel.MESH_LAUNCHES) == launches  # plain on the CPU
    assert img.shape == (H, W, 4) and bool(torch.isfinite(img).all())
    data = np.load(golden_path(name))
    assert int(data["max_depth"]) == cfg.max_depth
    assert_bar(img.numpy(), data["image"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the mesh body has no CPU build)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("disable_fused", [False, True])
def test_mesh_body_matches_plain_on_cuda(cuda_device, disable_fused, monkeypatch):
    # The frame kernel (fused) or the wavefront with the scene kernel
    # renders the octahedra; both hold to the plain version under the bar.
    if disable_fused:
        monkeypatch.setenv("GPURT_DISABLE_FUSED", "1")
    scene = meshes.get_config("mesh_octahedra").build(W / H, T_ANIM, device=cuda_device)
    before = (frame_kernel.LAUNCHES, scene_kernel.LAUNCHES)
    img = trace.render_frame(scene, W, H)
    torch.cuda.synchronize()
    after = (frame_kernel.LAUNCHES - before[0], scene_kernel.LAUNCHES - before[1])
    assert after == ((0, 5) if disable_fused else (1, 0))
    plain = frame_kernel.render_frame_plain(frame_kernel.pack_frame(scene), width=W, height=H)
    assert_bar(img.cpu().numpy(), plain.cpu().numpy())


if __name__ == "__main__":
    # Write the goldens from the reference's XLA path (JAX on the CPU).
    from tools import torch_make_refs

    raise SystemExit(torch_make_refs.main(["--goldens", "--force"]))
