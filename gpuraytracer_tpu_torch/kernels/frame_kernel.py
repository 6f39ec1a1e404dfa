"""The whole frame in one hand-written CUDA kernel (csrc/frame_kernel.cu).

Replaces the reference's fused Pallas frame kernel
(gpuraytracer_tpu/kernels/frame_kernel.py: render_frame_tiles /
_frame_kernel, plain mode) together with the scene-kernel device functions
it inlines. One CUDA thread renders one pixel: raygen, then per level the
plane test, the closest traversal, the material pick, the shadow ray, the
shading and the bounce, and one float4 store.

The same source holds the reference's compacted frame modes
(GPURT_FRAME_MODE, ``frame_mode``): ``render_frame_compact`` (its
render_frame_compact: a capped main pass that queues the dirty pixels, a
dense pass over the queue that resumes each pixel where the cap stopped
it, the plain kernel if the queue overflows) and ``render_frame_deferred``
(its render_frame_deferred: a main pass with capped occlusion that records
both shadow variants per level and queues the unknown lanes, the occlusion
repair of scene_kernel.shadow_queue_planes, and the recomposition). On a
GPU each mode is one stream-ordered chain of kernels: the queues and their
counts stay on the device, the overflow is decided there (a one-warp gate,
csrc/frame_gate.cu, that launches the plain kernel from the device only on
an overflow), and the host reads nothing back. Each of the kernels'
wrappers runs its plain version on a CPU tensor, where the modes' host
code reads the counts.

Under GPURT_MERGED_SHADOW=1 (``merges``) the plain entry and the dense
entry launch their instantiation whose occlusion traversal merges the SDF
marches (the reference's scene_kernel._march_sdf_multi, which its frame
kernel family runs where it allocates the merged banks); the image is the
sequential one. The plain versions ignore the knob, as the reference's XLA
path does.

Parameters reach the kernel as one contiguous f32 buffer and one int32
layout buffer (``pack_frame``), packed from the same blocks as the
reference's ``pack_frame_params``, and the mesh face table
(accel/traverse.pack_tri_rows); the scene kernel (scene_kernel.py) reads
the same buffers. On a CPU tensor the wrapper runs the kernel's
plain version — the wavefront ``render/trace.trace_radiance`` on the
scene unpacked from the same buffers; on a CUDA tensor it launches the
kernel or raises.

Every entry renders a band of rows (row-band sharding,
parallel/sharding.py; the reference's cvec[7,0] row offset and
local_height, frame_kernel.py:225-229, :696): ``row_offset`` (default 0)
and ``local_height`` (default None: the rest of the frame from the
offset, so the whole frame at offset 0). ``width`` and ``height`` stay the whole
frame's, which raygen and the checker filter read; images, planes, dirty
masks and the queues' pixel indices are the band's, in its own raster
order, and the queue capacity is the band's (``queue_capacity`` of its
rows). A band's pixels are the whole frame's at those rows bit for bit:
one thread per pixel, nothing summed across pixels.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import warnings
from typing import NamedTuple

import torch

from gpuraytracer_tpu_torch.accel import traverse
from gpuraytracer_tpu_torch.accel.instances import Scene, SceneArrays, SceneLayout
from gpuraytracer_tpu_torch.core.types import (
    InstanceTransforms,
    IntersectorKind,
    MAX_RAY_RECURSION_DEPTH,
    MaterialTable,
    SDF_MAX_STEPS,
    SceneConstants,
)
from gpuraytracer_tpu_torch.core.upload import to_device
from gpuraytracer_tpu_torch.geometry import metaballs, sdf, trimesh

# Kernel launches since import (or since a caller reset it), per entry of
# csrc/frame_kernel.cu; chip runs read them to show that a frame went
# through the kernels. MERGED_LAUNCHES and MERGED_DENSE_LAUNCHES count the
# plain and dense entries' merged instantiations (``merges``), LAUNCHES and
# DENSE_LAUNCHES their default ones (the dense entry serves the compact
# mode's ``render_frame_resume`` and ``render_frame_dense``).
# GATED_FALLBACK_LAUNCHES counts the overflow gate (csrc/frame_gate.cu;
# either instantiation; one per call, whether or not the gate launches the
# plain frame kernel from the device), COMPOSE_LAUNCHES the defer recomposition and BIN_LAUNCHES
# the queue binning (one kernel per call). HOST_SYNCS
# counts the compacted modes' reads of a queue's count on the host (the CPU
# path, and ``debug_count``); QUEUED_LANES the lanes those reads counted
# (compact: dirty; defer: unknown, summed over levels). On a GPU the bin
# entry adds each binned queue's counts to a device counter instead
# (``queued_lanes``); both modes bin every queue they build.
LAUNCHES = 0
MERGED_LAUNCHES = 0
COMPACT_LAUNCHES = 0
DENSE_LAUNCHES = 0
MERGED_DENSE_LAUNCHES = 0
DEFER_LAUNCHES = 0
GATED_FALLBACK_LAUNCHES = 0
COMPOSE_LAUNCHES = 0
BIN_LAUNCHES = 0
HOST_SYNCS = 0
QUEUED_LANES = 0
# Per CUDA device, the lanes that the binned device queues counted since
# import: a (1,) int64 tensor the bin entry's scan adds each count to.
_QUEUED_ON_DEVICE = {}

# Buffer layout, shared with csrc/traverse.cuh (keep in step).
# f32 header: elapsed_time, then (relax, fail_scale) of radiance and
# occlusion marches for the reference codes (relax_r, relax_s, fail_r,
# fail_s) and for the AABB-windowed codes (the same four), then padding.
F_HEADER = 12
# int32 header: G, M, plane_gid, has_plane, has_material_ids,
# has_step_budgets, 0, 0; then G geometry rows, then G + 1 material slots
# (the identity when the layout has no material_ids; padded with 0
# without a plane).
I_HEADER = 8
# kind, code, budget r0, r1, s0, s1, capped s0, s1, natural budget,
# AABB-windowed (the code is in sdf.AABB_WINDOWED_CODES), then a mesh's
# first row and number of rows in the face table (0, 0 for other kinds)
GEO_STRIDE = 12
MAX_MATERIALS = 16
# Most dynamic shared memory a block of either kernel may take (an H100's
# per-block opt-in limit); the buffers are copied there (``shared_bytes``)
# where they fit, and read from global memory where they do not
# (``tables_in_shared``).
SHARED_BYTES_MAX = 227 * 1024
# SDF codes with a device function in csrc/frame_math.cuh.
KERNEL_SDF_CODES = frozenset(range(9))
_BLOCKS = (("b2l", 12), ("l2b", 9), ("sscale", 1), ("aabb", 6))  # per geometry


def param_offsets(g: int, m: int) -> dict:
    """Offsets (in floats) of each block in the f32 parameter buffer."""
    off, at = {}, F_HEADER
    for name, width in _BLOCKS:
        off[name] = at
        at += g * width
    for name, size in (("mb", 12), ("mat", m * 8), ("p2w", 16), ("cvec", 32)):
        off[name] = at
        at += size
    off["total"] = at
    return off


@dataclasses.dataclass(frozen=True)
class FramePack:
    """The kernel's inputs: ``params`` (f32) and ``layout`` (int32), both
    1-D, contiguous and on the rendering device, plus their sizes, and the
    (F, 12) f32 mesh face table ``tri`` with each mesh slot's (start,
    count) in it (F = 0 without meshes), and on the host each geometry
    row's (kind, natural step budget), which the compacted modes read
    without a device sync."""

    params: torch.Tensor
    layout: torch.Tensor
    num_geometries: int
    num_materials: int
    tri: torch.Tensor
    tri_offsets: tuple = ()
    budgets: tuple = ()


# The compacted modes' defaults (the reference's COMPACT_BUDGET,
# COMPACT_CAP_DIV, SHADOW_CAP; GPURT_COMPACT_BUDGET and GPURT_SHADOW_CAP
# are read at call time).
COMPACT_BUDGET = 64
COMPACT_CAP_DIV = 8
SHADOW_CAP = 32
# The reference's TPU tile (scene_kernel.TILE_ROWS, TILE_COLS): kept only
# for the queue capacity rule (``queue_capacity``).
TILE_ROWS, TILE_COLS = 32, 128
# Step caps as the kernels take them: no SDF cap, no metaball cap.
NO_CAP = 2 ** 31 - 1


def frame_mode() -> str:
    """GPURT_FRAME_MODE as the reference reads it (default "plain")."""
    m = os.environ.get("GPURT_FRAME_MODE", "")
    if m in ("plain", "compact", "defer"):
        return m
    return "plain"


def compact_enabled() -> bool:
    """Whether GPURT_FRAME_MODE asks for a compacted mode (the reference's
    compact_enabled: "compact" or "defer")."""
    return frame_mode() != "plain"


def merged_shadow_enabled() -> bool:
    """GPURT_MERGED_SHADOW as the reference reads it ("1" on; default off)."""
    return os.environ.get("GPURT_MERGED_SHADOW", "") == "1"


def merges(pack: "FramePack") -> bool:
    """Whether the kernels that the reference gives the merged banks (the
    plain frame, the dense pass, the occlusion queue) merge the packed
    scene's occlusion marches: GPURT_MERGED_SHADOW=1 and at least two SDF
    geometries (scene_kernel.py:1653-1662)."""
    n_sdf = sum(kind == IntersectorKind.SIGNED_DISTANCE for kind, _ in pack.budgets)
    return merged_shadow_enabled() and n_sdf >= 2


def fused_eligible_layout(layout: SceneLayout, num_materials: int,
                          total_mesh_faces: int = 0) -> bool:
    """Whether the frame kernel renders the layout (the reference's
    fused_eligible_layout): GPURT_DISABLE_FUSED unset, at least one
    procedural instance, at most 16 unique materials and at most
    accel/traverse.TRI_FACE_TOTAL_CAP mesh faces. Every other scene that
    ``check_kernel_covers`` accepts goes through the wavefront: the scene
    kernel within the face cap, the per-geometry route past it."""
    return (
        not os.environ.get("GPURT_DISABLE_FUSED")
        and layout.num_procedural > 0
        and num_materials <= MAX_MATERIALS
        and total_mesh_faces <= traverse.TRI_FACE_TOTAL_CAP
    )


def fused_eligible(scene: Scene, origins_ndim: int = 3) -> bool:
    """Whether the frame kernel renders ``scene`` (the reference's
    fused_eligible): ``fused_eligible_layout`` of its layout, its material
    count and its mesh faces; render/trace.frame_route routes by it.
    ``origins_ndim`` is the reference's, and unused there too."""
    return fused_eligible_layout(scene.layout, scene.arrays.materials.albedo.shape[0],
                                 traverse._total_mesh_faces(scene))


def check_kernel_covers(layout: SceneLayout, route: str = "frame") -> None:
    """Raise, naming what has no CUDA form, for a CUDA frame that the
    kernels of its ``route`` do not render: "frame" (the frame kernel, in
    every GPURT_FRAME_MODE), "scene" (the wavefront with the scene kernel)
    or "per_geometry" (the wavefront on csrc/megakernel.cu). Every route
    renders under GPURT_MERGED_SHADOW: the frame kernel family merges
    (``merges``), the other two march in sequence, as the reference's scene
    kernel does without the merged banks (scene_kernel.py:1660-1661).
    Never falls back."""
    for kind, code in zip(layout.kinds, layout.prim_types):
        if kind == IntersectorKind.SIGNED_DISTANCE and int(code) not in KERNEL_SDF_CODES:
            raise NotImplementedError(
                f"distance code {int(code)} has no CUDA device function")


def frame_fields(arrays: SceneArrays):
    """The pack's per-frame half, the fields that move with the animation
    time: (t (1,), b2l_rows (G,12), l2b_rot (G,9), mb_params (3,4)), from
    the arrays' elapsed time and instance transforms (the metaball centres
    from the time: geometry/metaballs.animated_metaballs). Row 10
    (kernels/frame_state.py) writes the same fields on the device."""
    tr = arrays.transforms
    g = tr.blas_to_local.shape[0]
    b2l_rows = tr.blas_to_local[:, :3, :].reshape(g, 12)
    l2b_rot = tr.local_to_blas[:, :3, :3].reshape(g, 9)
    centers, radii = metaballs.animated_metaballs(arrays.constants.elapsed_time)
    mb_params = torch.cat([centers, radii[:, None]], dim=-1)
    return (arrays.constants.elapsed_time.reshape(1).to(torch.float32), b2l_rows, l2b_rot,
            mb_params)


def geometry_blocks(arrays: SceneArrays):
    """The per-geometry blocks that do not move with the animation time:
    (step_scales (G,), aabbs (G,6))."""
    g = arrays.transforms.blas_to_local.shape[0]
    return arrays.materials.step_scale[:g], torch.cat([arrays.aabb_min, arrays.aabb_max], dim=-1)


def _static_blocks(scene: Scene):
    """The parameter blocks that do not move with the animation time:
    (step_scales (G,), aabbs (G,6), materials (M,8), p2w (4,4), cvec (8,4))."""
    arrays, layout = scene.arrays, scene.layout
    step_scales, aabbs = geometry_blocks(arrays)
    mats = arrays.materials
    materials = torch.stack([
        mats.albedo[:, 0], mats.albedo[:, 1], mats.albedo[:, 2], mats.albedo[:, 3],
        mats.reflectance_coefficient, mats.diffuse_coefficient,
        mats.specular_coefficient, mats.specular_power,
    ], dim=-1)
    c = arrays.constants
    zeros = torch.zeros(4, dtype=torch.float32, device=aabbs.device)

    def row4(v):
        return torch.cat([v, zeros[: 4 - v.shape[0]]])

    if layout.has_plane:
        plane_o, plane_s = row4(arrays.plane_origin), row4(arrays.plane_size)
    else:  # an impossible rect: the plane test can never pass
        plane_o, plane_s = zeros, row4(torch.full((2,), -1.0, device=aabbs.device))
    cvec = torch.stack([
        row4(c.camera_position[:3]), row4(c.light_position[:3]),
        c.light_ambient_color, c.light_diffuse_color, row4(arrays.blas_offset),
        plane_o, plane_s, zeros,
    ])
    p2w = c.projection_to_world.reshape(4, 4)
    return step_scales, aabbs, materials, p2w, cvec


def pack_frame_params(scene: Scene):
    """Parameter blocks as the reference's pack_frame_params builds them:
    (b2l_rows (G,12), l2b_rot (G,9), step_scales (G,), aabbs (G,6),
    mb_params (3,4), materials (M,8), p2w (4,4), cvec (8,4)), plus the
    static fields (geoms, plane_gid)."""
    _, b2l_rows, l2b_rot, mb_params = frame_fields(scene.arrays)
    step_scales, aabbs, materials, p2w, cvec = _static_blocks(scene)
    blocks = (b2l_rows, l2b_rot, step_scales, aabbs, mb_params, materials, p2w, cvec)
    layout = scene.layout
    static = dict(
        geoms=tuple((int(k), int(p)) for k, p in zip(layout.kinds, layout.prim_types)),
        plane_gid=int(layout.plane_geometry_id),
    )
    return blocks, static


def _param_blocks(scene: Scene, fields):
    """Every block of the f32 buffer after the header, in order, with the
    per-frame ``fields`` (``frame_fields``'s last three) in their places."""
    b2l_rows, l2b_rot, mb_params = fields
    step_scales, aabbs, materials, p2w, cvec = _static_blocks(scene)
    blocks = (b2l_rows, l2b_rot, step_scales, aabbs, mb_params, materials, p2w, cvec)
    return [b.reshape(-1).to(torch.float32) for b in blocks]


def _relax_header() -> list:
    """The header's march constants after the time (F_HEADER - 1 floats),
    from the march knobs read now: (relax, fail_scale) of radiance and
    occlusion marches for the reference codes, then the windowed codes."""
    relax = []
    for windowed in (False, True):
        relax_r = sdf.march_relax(windowed, occlusion=False)
        relax_s = sdf.march_relax(windowed, occlusion=True)
        relax += [relax_r, relax_s, (1.0 - relax_r) * relax_r, (1.0 - relax_s) * relax_s]
    return relax + [0.0, 0.0, 0.0]


def pack_static(scene: Scene) -> FramePack:
    """The static half of ``pack_frame``, built once per frame program
    (render/program.py): one f32 parameter buffer + one int32 layout buffer
    on the scene's device, with every host upload of the pack (the layout
    buffer, the header's march constants) and the blocks that do not move
    with the animation time; the per-frame fields (``frame_fields``: the
    header's time, b2l_rows, l2b_rot, mb_params) are zero until
    ``write_frame_fields`` or row 10 (kernels/frame_state.py) writes them.
    The march knobs (budgets per level, relaxation, capped-hit occlusion)
    are read here, as the wavefront reads them."""
    layout = scene.layout
    arrays = scene.arrays
    tri, tri_offsets = traverse.pack_tri_rows(arrays)
    g = arrays.transforms.blas_to_local.shape[0]
    m = arrays.materials.albedo.shape[0]
    dev = arrays.aabb_min.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    fields = (zero.expand(g, 12), zero.expand(g, 9), zero.expand(3, 4))
    # The header and the layout buffer go up without a host sync
    # (core/upload.to_device).
    params = torch.cat([zero.reshape(1), to_device(_relax_header(), dev)]
                       + _param_blocks(scene, fields))
    geoms = tuple((int(k), int(p)) for k, p in zip(layout.kinds, layout.prim_types))
    ints = [g, m, int(layout.plane_geometry_id), int(layout.has_plane),
            int(layout.material_ids is not None), int(layout.step_budgets is not None), 0, 0]
    budgets = []
    for i, (kind, code) in enumerate(geoms):
        natural = layout.step_budgets[i] if layout.step_budgets else SDF_MAX_STEPS
        budgets.append((kind, natural))
        rb0, _ = sdf.march_budget(natural, occlusion=False, level=0)
        rb1, _ = sdf.march_budget(natural, occlusion=False, level=1)
        sb0, sc0 = sdf.march_budget(natural, occlusion=True, level=0)
        sb1, sc1 = sdf.march_budget(natural, occlusion=True, level=1)
        windowed = kind == IntersectorKind.SIGNED_DISTANCE and code in sdf.AABB_WINDOWED_CODES
        faces = tri_offsets[code] if kind == IntersectorKind.TRIANGLE else (0, 0)
        ints += [kind, code, rb0, rb1, sb0, sb1, int(sc0), int(sc1), natural, int(windowed),
                 *faces]
    slots = list(layout.material_ids) if layout.material_ids is not None else list(range(g + 1))
    ints += slots + [0] * (g + 1 - len(slots))
    layout_buf = to_device(ints, dev, torch.int32)
    return FramePack(params=params.contiguous(), layout=layout_buf, num_geometries=g,
                     num_materials=m, tri=tri, tri_offsets=tri_offsets, budgets=tuple(budgets))


def write_frame_fields(pack: FramePack, fields) -> FramePack:
    """Write ``frame_fields``'s four per-frame fields into the pack's
    parameter buffer, in place (stream-ordered copies on its device, no
    upload); returns the pack. Row 10's plain version."""
    t, b2l_rows, l2b_rot, mb_params = fields
    g = pack.num_geometries
    off = param_offsets(g, pack.num_materials)
    p = pack.params
    p[0:1].copy_(t)
    p[off["b2l"]: off["b2l"] + 12 * g].copy_(b2l_rows.reshape(-1))
    p[off["l2b"]: off["l2b"] + 9 * g].copy_(l2b_rot.reshape(-1))
    p[off["mb"]: off["mb"] + 12].copy_(mb_params.reshape(-1))
    return pack


def repack(pack: FramePack, scene: Scene) -> FramePack:
    """Every block of ``pack``'s parameter buffer after the header's march
    constants, and its mesh face table, from ``scene``'s arrays, in place
    (torch ops on the device, no upload): what a frame program over a
    caller's arrays runs in its graph (trace.make_renderer). The layout
    buffer and the march constants stay ``pack_static``'s."""
    t, *fields = frame_fields(scene.arrays)
    p = pack.params
    p[0:1].copy_(t)
    p[F_HEADER:].copy_(torch.cat(_param_blocks(scene, fields)))
    if pack.tri.numel():
        pack.tri.copy_(traverse.pack_tri_rows(scene.arrays)[0])
    return pack


def pack_frame(scene: Scene) -> FramePack:
    """One f32 parameter buffer + one int32 layout buffer on the scene's
    device: ``pack_static`` with the scene's per-frame fields written in
    (``write_frame_fields``). The march knobs (budgets per level,
    relaxation, capped-hit occlusion) are read here, at call time, as the
    wavefront reads them."""
    return write_frame_fields(pack_static(scene), frame_fields(scene.arrays))


def layout_size(g: int) -> int:
    """Length of the int32 layout buffer for g procedural geometries."""
    return I_HEADER + GEO_STRIDE * g + g + 1


def shared_bytes(g: int, m: int, *, shading: bool) -> int:
    """Bytes of shared memory a block copies the buffers into: all of both
    for the frame kernel (``shading``), for the scene kernel only their
    traversal prefix (up to the material table; the geometry rows)."""
    off = param_offsets(g, m)
    floats = off["total"] if shading else off["mat"]
    ints = layout_size(g) if shading else I_HEADER + GEO_STRIDE * g
    return 4 * (floats + ints)


def tables_in_shared(g: int, m: int, *, shading: bool) -> bool:
    """The layout of a launch's scene tables, chosen on the host from their
    size: True where they fit in a block's shared memory (the kernel
    copies them there), False past SHARED_BYTES_MAX (about 1,410
    geometries for the frame kernel, 1,452 for the scene kernel), where the
    kernel reads them from global memory and takes no dynamic shared
    memory. Either way the scene renders."""
    return shared_bytes(g, m, shading=shading) <= SHARED_BYTES_MAX


def unpack_frame(pack: FramePack) -> Scene:
    """The Scene a FramePack encodes (inverse of ``pack_frame`` for every
    field the renderer reads), on the pack's device."""
    g, m = pack.num_geometries, pack.num_materials
    p = pack.params
    ints = pack.layout.tolist()
    off = param_offsets(g, m)

    def blk(name, *shape):
        n = 1
        for s in shape:
            n *= s
        return p[off[name]: off[name] + n].reshape(shape)

    geo = [ints[I_HEADER + GEO_STRIDE * i: I_HEADER + GEO_STRIDE * (i + 1)] for i in range(g)]
    has_plane = bool(ints[3])
    slots = ints[I_HEADER + GEO_STRIDE * g:][:g + int(has_plane)]
    layout = SceneLayout(
        kinds=tuple(IntersectorKind(r[0]) for r in geo),
        prim_types=tuple(r[1] for r in geo), has_plane=has_plane,
        step_budgets=tuple(r[8] for r in geo) if ints[5] else None,
        material_ids=tuple(slots) if ints[4] else None,
    )
    cvec = blk("cvec", 8, 4)
    mat = blk("mat", m, 8)
    last_row = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=p.dtype, device=p.device)
    b2l = torch.cat([blk("b2l", g, 3, 4), last_row.expand(g, 1, 4)], dim=1)
    l2b = torch.zeros(g, 4, 4, dtype=p.dtype, device=p.device)
    l2b[:, :3, :3] = blk("l2b", g, 3, 3)
    l2b[:, 3, 3] = 1.0
    # One step_scale per geometry row; the plane's is never read (1.0).
    step_scale = torch.ones(g + int(has_plane), dtype=p.dtype, device=p.device)
    step_scale[:g] = blk("sscale", g)
    rows = pack.tri
    meshes = tuple(trimesh.TriangleMesh(v0=rows[a:a + c, 0:3], e1=rows[a:a + c, 3:6],
                                        e2=rows[a:a + c, 6:9], n=rows[a:a + c, 9:12])
                   for a, c in pack.tri_offsets)
    one = torch.ones(1, dtype=p.dtype, device=p.device)
    aabb = blk("aabb", g, 6)
    arrays = SceneArrays(
        constants=SceneConstants(
            projection_to_world=blk("p2w", 4, 4),
            camera_position=torch.cat([cvec[0, :3], one]),
            light_position=cvec[1].clone(),
            light_ambient_color=cvec[2].clone(),
            light_diffuse_color=cvec[3].clone(),
            reflectance=p.new_zeros(()),
            elapsed_time=p[0].clone(),
        ),
        materials=MaterialTable(
            albedo=mat[:, 0:4], reflectance_coefficient=mat[:, 4],
            diffuse_coefficient=mat[:, 5], specular_coefficient=mat[:, 6],
            specular_power=mat[:, 7], step_scale=step_scale,
        ),
        transforms=InstanceTransforms(local_to_blas=l2b, blas_to_local=b2l),
        aabb_min=aabb[:, :3], aabb_max=aabb[:, 3:],
        blas_offset=cvec[4, :3].clone(),
        plane_origin=cvec[5, :3].clone(), plane_size=cvec[6, :2].clone(),
        meshes=meshes,
    )
    return Scene(layout=layout, arrays=arrays)


def render_frame_plain(pack: FramePack, *, width: int, height: int,
                       max_depth: int = MAX_RAY_RECURSION_DEPTH, row_offset: int = 0,
                       local_height: int | None = None):
    """The kernel's plain PyTorch version on the same packed inputs: the
    wavefront (render/trace.render_wavefront) with plain traversal passes
    on the unpacked scene, on the pack's device, over the band's rows."""
    from gpuraytracer_tpu_torch.render import trace

    return trace.render_wavefront(unpack_frame(pack), width, height, max_depth=max_depth,
                                  plain=True, row_offset=row_offset, local_height=local_height)


def check_pack(pack: FramePack) -> None:
    """Raise unless the pack's buffers are what the CUDA kernels read."""
    g, m = pack.num_geometries, pack.num_materials
    p, lay = pack.params, pack.layout
    if p.dtype != torch.float32 or lay.dtype != torch.int32:
        raise TypeError(f"params must be float32 and layout int32, got {p.dtype}, {lay.dtype}")
    if p.device != lay.device:
        raise ValueError(f"params on {p.device} but layout on {lay.device}")
    if p.dim() != 1 or lay.dim() != 1 or not (p.is_contiguous() and lay.is_contiguous()):
        raise ValueError("params and layout must be 1-D contiguous tensors")
    if not (0 < g and 0 < m):
        raise ValueError(f"unsupported sizes: {g} geometries, {m} materials")
    if p.numel() != param_offsets(g, m)["total"] or lay.numel() != layout_size(g):
        raise ValueError(f"buffer sizes {p.numel()}/{lay.numel()} do not match "
                         f"{g} geometries and {m} materials")
    tri = pack.tri
    if tri.dtype != torch.float32 or tri.device != p.device or tri.dim() != 2 \
            or tri.shape[1] != 12 or not tri.is_contiguous():
        raise ValueError(f"tri must be a contiguous (F, 12) float32 tensor on {p.device}, got "
                         f"{tuple(tri.shape)} {tri.dtype} on {tri.device}")
    if sum(c for _, c in pack.tri_offsets) != tri.shape[0]:
        raise ValueError(f"tri_offsets {pack.tri_offsets} do not cover {tri.shape[0]} faces")


def band_height(height: int, row_offset: int = 0, local_height: int | None = None) -> int:
    """The rows of the band [row_offset, row_offset + local_height) of a
    frame of ``height`` rows (``local_height`` None: the rest of the frame
    from the offset); raises ValueError unless the band lies in the frame
    and holds a row."""
    lh = height - row_offset if local_height is None else local_height
    if row_offset < 0 or lh <= 0 or row_offset + lh > height:
        raise ValueError(f"band of {lh} rows at row {row_offset} is not inside a frame of "
                         f"{height} rows")
    return lh


# Counters of a -DGPRT_COUNT_SIMT build (csrc/frame_math.cuh): lane-samples
# and warp-sample shares (units of 2**-SIMT_SHIFT) of SIMT_BUCKETS buckets
# (level * 2 + 1 for occlusion queries, level * 2 for closest ones), then
# the total warp-samples.
SIMT_BUCKETS = 16
SIMT_SHIFT = 20
SIMT_COUNTERS = 2 * SIMT_BUCKETS + 1


def ops_pointer(ops):
    """The device address of a counting build's counters (a contiguous
    int64 CUDA tensor: (1,) for -DGPRT_COUNT_OPS, (SIMT_COUNTERS,) for
    -DGPRT_COUNT_SIMT) or NULL."""
    if ops is None:
        return ctypes.c_void_p(None)
    if ops.dtype != torch.int64 or ops.dim() != 1 or ops.device.type != "cuda" \
            or not ops.is_contiguous():
        raise ValueError("ops must be a 1-D contiguous int64 CUDA tensor")
    return ctypes.c_void_p(ops.data_ptr())


def simt_efficiency(counts) -> dict:
    """SIMT efficiency from a -DGPRT_COUNT_SIMT build's counters: per
    bucket (level, "closest" or "occlusion") that marched, and "all",
    (lane-samples / (32 x warp-samples), lane-samples, warp-samples)."""
    c = [int(x) for x in counts.tolist()]
    out = {}
    for b in range(SIMT_BUCKETS):
        lanes, share = c[2 * b], c[2 * b + 1] / 2 ** SIMT_SHIFT
        if lanes:
            out[(b // 2, "occlusion" if b % 2 else "closest")] = (lanes / (32 * share), lanes,
                                                                   share)
    lanes, warps = sum(c[0:2 * SIMT_BUCKETS:2]), c[-1]
    out["all"] = (lanes / (32 * warps) if warps else 0.0, lanes, warps)
    return out


def render_frame_tiles(pack: FramePack, *, width: int, height: int,
                       max_depth: int = MAX_RAY_RECURSION_DEPTH, lib=None, ops=None,
                       row_offset: int = 0, local_height: int | None = None):
    """(local_height, W, 4) f32 radiance image of the packed frame's band
    (the whole (H, W, 4) frame by default).

    CUDA: launches csrc/frame_kernel.cu on the current stream (``lib``: a
    loaded build of it, default the shipped one; ``ops``: the counters a
    counting build adds to), its merged instantiation where ``merges`` says
    so, and counts the launch in LAUNCHES or MERGED_LAUNCHES. CPU: runs
    ``render_frame_plain``."""
    global LAUNCHES, MERGED_LAUNCHES
    check_pack(pack)
    lh = band_height(height, row_offset, local_height)
    dev = pack.params.device
    if dev.type == "cpu":
        return render_frame_plain(pack, width=width, height=height, max_depth=max_depth,
                                  row_offset=row_offset, local_height=lh)
    lib = _launch_setup(pack, width, height, max_depth, lib)
    out = torch.empty((lh, width, 4), dtype=torch.float32, device=dev)
    merged = merges(pack)
    _raise_on(lib.gprt_frame_render(*_buffers(pack), _ptr(out), width, height, row_offset, lh,
                                    max_depth, pack.num_geometries, pack.num_materials,
                                    int(_shared(pack)), int(merged), ops_pointer(ops),
                                    *_where(dev)), lib, "frame kernel")
    if merged:
        MERGED_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out


def residency(pack: FramePack, lib=None, *, dense: bool = False) -> tuple:
    """(blocks per SM, blocks in all) of the frame kernel (``dense``: the
    dense entry) that the card keeps resident for the packed scene, as
    ``render_frame_tiles`` (``render_frame_resume``) launches it (its merged
    instantiation where ``merges`` says so); launches nothing."""
    check_pack(pack)
    dev = pack.params.device
    if dev.type != "cuda":
        raise ValueError(f"no frame kernel for device {dev}")
    from gpuraytracer_tpu_torch.kernels import build

    lib = lib if lib is not None else build.load("frame_kernel")
    per_sm, total = ctypes.c_int(0), ctypes.c_int(0)
    _raise_on(lib.gprt_frame_residency(pack.num_geometries, pack.num_materials,
                                       int(_shared(pack)), int(merges(pack)), int(dense),
                                       dev.index,
                                       ctypes.byref(per_sm), ctypes.byref(total)), lib,
              "frame kernel residency")
    return per_sm.value, total.value


def _shared(pack: FramePack) -> bool:
    return tables_in_shared(pack.num_geometries, pack.num_materials, shading=True)


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def _buffers(pack: FramePack):
    return _ptr(pack.params), _ptr(pack.layout), _ptr(pack.tri)


def _where(dev):
    return dev.index, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _raise_on(rc, lib, what):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({lib.gprt_error_string(rc).decode()})")


def _launch_setup(pack: FramePack, width, height, max_depth, lib, name: str = "frame_kernel"):
    """Check a CUDA launch of an entry of csrc/frame_kernel.cu (or of
    csrc/<name>.cu); returns the library (``lib``, default the shipped
    build)."""
    dev = pack.params.device
    if dev.type != "cuda":
        raise ValueError(f"no frame kernel for device {dev}")
    if width <= 0 or height <= 0 or not 1 <= max_depth <= 8:
        raise ValueError(f"bad frame size {width}x{height} or depth {max_depth}")
    if pack.num_materials > MAX_MATERIALS:
        raise ValueError(f"{pack.num_materials} materials: the frame kernel takes at most "
                         f"{MAX_MATERIALS} (render_frame routes such scenes to the wavefront)")
    from gpuraytracer_tpu_torch.kernels import build

    return lib if lib is not None else build.load(name)


# ---------------------------------------------------------------------------
# The compacted frame modes (GPURT_FRAME_MODE=compact|defer)
# ---------------------------------------------------------------------------

def norm_caps(cap):
    """A step-cap spec as the reference's _norm_caps reads it: None, an int
    for both passes, or (closest, shadow)."""
    if cap is None:
        return (None, None)
    if isinstance(cap, int):
        return (cap, cap)
    return tuple(cap)


def queue_capacity(width: int, height: int, cap_lanes: int | None = None) -> int:
    """Lanes a compacted mode's queue holds before the frame overflows to the
    plain kernel: the reference's rule (frame_kernel.py:924-929), computed
    on the lane count of its 32x128 tiles, so that the overflow triggers on
    the frames where the reference's does. The padding is a TPU schedule;
    the port keeps it only for this decision. A band takes its own rows as
    ``height`` (the reference's lh, :853, :1125)."""
    tile = TILE_ROWS * TILE_COLS
    lanes = (height + (-height) % TILE_ROWS) * (width + (-width) % TILE_COLS)
    cap = cap_lanes if cap_lanes is not None else max(tile, lanes // COMPACT_CAP_DIV)
    cap = cap + (-cap) % tile
    return min(cap, lanes + (-lanes) % tile)


def _kernel_caps(caps, mb_caps, k):
    """(SDF cap, metaball cap) of pass k (0 closest, 1 occlusion) as the
    kernels take them: NO_CAP, METABALL_MAX_STEPS for none."""
    sdf_cap, mb_cap = caps[k], mb_caps[k]
    return (NO_CAP if sdf_cap is None else int(sdf_cap),
            metaballs.METABALL_MAX_STEPS if mb_cap is None else int(mb_cap))


def render_frame_capped_plain(pack: FramePack, *, width: int, height: int,
                              max_depth: int = MAX_RAY_RECURSION_DEPTH, budget_cap,
                              mb_budget_cap=None, row_offset: int = 0,
                              local_height: int | None = None):
    """Plain version of compact's main pass (``render_frame_capped``): the
    wavefront with ``trace.MainPass`` on the unpacked scene. Returns the
    band's (h, W, 4) image, wrong at the dirty pixels, and its (h, W) int32
    dirty mask."""
    from gpuraytracer_tpu_torch.render import trace

    caps, mb_caps = norm_caps(budget_cap), norm_caps(mb_budget_cap)
    main = trace.MainPass(closest=(caps[0], mb_caps[0]), shadow=(caps[1], mb_caps[1]))
    return trace.render_wavefront(unpack_frame(pack), width, height, max_depth=max_depth,
                                  plain=True, main=main, row_offset=row_offset,
                                  local_height=local_height)


def render_frame_capped(pack: FramePack, *, width: int, height: int,
                        max_depth: int = MAX_RAY_RECURSION_DEPTH, budget_cap,
                        mb_budget_cap=None, lib=None, ops=None, row_offset: int = 0,
                        local_height: int | None = None):
    """Compact's main pass, (image, dirty mask) as ``render_frame_capped_plain``
    gives them: on CUDA the compact entry of csrc/frame_kernel.cu (counted
    in COMPACT_LAUNCHES), on the CPU the plain version."""
    check_pack(pack)
    band = dict(row_offset=row_offset, local_height=band_height(height, row_offset, local_height))
    if pack.params.device.type == "cpu":
        return render_frame_capped_plain(pack, width=width, height=height, max_depth=max_depth,
                                         budget_cap=budget_cap, mb_budget_cap=mb_budget_cap,
                                         **band)
    out, dirty, _ = _compact_launch(pack, width, height, max_depth, budget_cap, mb_budget_cap,
                                    None, lib, ops, **band)
    return out, dirty


def _compact_launch(pack, width, height, max_depth, budget_cap, mb_budget_cap, cap, lib, ops, *,
                    row_offset, local_height):
    """One launch of the compact entry over a band: (image, dirty mask,
    None) without a queue capacity ``cap``, else (image, None,
    CompactQueue)."""
    global COMPACT_LAUNCHES
    dev = pack.params.device
    lib = _launch_setup(pack, width, height, max_depth, lib)
    caps, mb_caps = norm_caps(budget_cap), norm_caps(mb_budget_cap)
    out = torch.empty((local_height, width, 4), dtype=torch.float32, device=dev)
    dirty = queue = None
    null = ctypes.c_void_p(None)
    if cap is None:
        dirty = torch.empty((local_height, width), dtype=torch.int32, device=dev)
        q_args = (_ptr(dirty), null, null, 0)
    else:
        words = _queue_words(1, 32, dev)
        queue = CompactQueue(torch.empty((cap, QUEUE_ENTRY_WORDS), dtype=torch.int32, device=dev),
                             words[:1], words[1:])
        q_args = (null, _ptr(queue.entries), _ptr(queue.count), cap)
    _raise_on(lib.gprt_frame_compact(
        *_buffers(pack), _ptr(out), *q_args, width, height, row_offset, local_height, max_depth,
        pack.num_geometries, pack.num_materials, int(_shared(pack)),
        *_kernel_caps(caps, mb_caps, 0),
        *_kernel_caps(caps, mb_caps, 1), ops_pointer(ops), *_where(dev)), lib, "compact kernel")
    COMPACT_LAUNCHES += 1
    return out, dirty, queue


def render_frame_dense_plain(pack: FramePack, qpx, qpy, *, width: int, height: int,
                             max_depth: int = MAX_RAY_RECURSION_DEPTH):
    """Plain version of the dense pass (``render_frame_dense``): the plain
    frame at the queued pixels (qpx, qpy (N,) int32; -1 marks padding,
    which gets zeros), traced as the wavefront traces the whole frame.
    Returns (N, 4) f32."""
    from gpuraytracer_tpu_torch.core import camera as cam
    from gpuraytracer_tpu_torch.render import trace

    scene = unpack_frame(pack)
    out = torch.zeros((qpx.shape[0], 4), dtype=torch.float32, device=qpx.device)
    q = torch.nonzero(qpx >= 0).squeeze(1)
    px, py = qpx[q].to(torch.int64), qpy[q].to(torch.int64)
    c = scene.arrays.constants
    o, d = cam.generate_camera_rays(px, py, width, height, c.camera_position,
                                    c.projection_to_world)
    out[q] = trace.trace_radiance(o, d, px, py, width, height, scene, max_depth=max_depth)
    return out


def render_frame_dense(pack: FramePack, qpx, qpy, *, width: int, height: int,
                       max_depth: int = MAX_RAY_RECURSION_DEPTH, lib=None, ops=None):
    """The plain frame's colour at each queued pixel (qpx, qpy (N,) int32
    contiguous, -1 for padding), rendered from its camera ray, (N, 4) f32.
    CUDA: the dense entry of csrc/frame_kernel.cu over a queue of N entries
    at level -1 (from the camera ray), written into a scratch image and
    gathered, with the plain kernel's device code (merged where ``merges``
    says so; counted in DENSE_LAUNCHES or MERGED_DENSE_LAUNCHES); CPU: the
    plain version. The compact mode's dense pass resumes its own queue
    instead (``render_frame_resume``)."""
    check_pack(pack)
    dev = pack.params.device
    for name, q in (("qpx", qpx), ("qpy", qpy)):
        if q.dtype != torch.int32 or q.dim() != 1 or q.shape != qpx.shape or q.device != dev \
                or not q.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous (N,) int32 tensor on {dev}")
    if dev.type == "cpu":
        return render_frame_dense_plain(pack, qpx, qpy, width=width, height=height,
                                        max_depth=max_depth)
    n = qpx.shape[0]
    if n == 0:
        return torch.empty((0, 4), dtype=torch.float32, device=dev)
    pad = qpx < 0
    pix = torch.where(pad, 0, qpy * width + qpx)
    entries = torch.zeros((n, QUEUE_ENTRY_WORDS), dtype=torch.int32, device=dev)
    entries[:, 0] = pix
    entries[:, 1] = -1
    image = torch.empty((height, width, 4), dtype=torch.float32, device=dev)
    _dense_launch(pack, CompactQueue(entries, torch.full((1,), n, dtype=torch.int32, device=dev)),
                  image, width, height, max_depth, lib, ops, row_offset=0, local_height=height)
    return torch.where(pad[:, None], 0.0, image.view(-1, 4)[pix.long()])


def _dense_launch(pack, queue, image, width, height, max_depth, lib, ops, *, row_offset,
                  local_height):
    global DENSE_LAUNCHES, MERGED_DENSE_LAUNCHES
    dev = pack.params.device
    lib = _launch_setup(pack, width, height, max_depth, lib)
    merged = merges(pack)
    _raise_on(lib.gprt_frame_dense(
        *_buffers(pack), _ptr(queue.entries), _ptr(queue.count), _ptr(image),
        queue.entries.shape[0], width, height, row_offset, local_height, max_depth,
        pack.num_geometries, pack.num_materials, int(_shared(pack)), int(merged),
        ops_pointer(ops), *_where(dev)), lib, "dense kernel")
    if merged:
        MERGED_DENSE_LAUNCHES += 1
    else:
        DENSE_LAUNCHES += 1


def render_frame_deferred_plain(pack: FramePack, *, width: int, height: int,
                                max_depth: int = MAX_RAY_RECURSION_DEPTH, shadow_cap,
                                mb_shadow_cap=None, row_offset: int = 0,
                                local_height: int | None = None):
    """Plain version of defer's main pass (``render_frame_deferred_main``):
    the wavefront with a deferring ``trace.MainPass`` on the unpacked
    scene. Returns its ``trace.DeferPlanes`` over the band's (h, W)
    pixels."""
    from gpuraytracer_tpu_torch.render import trace

    main = trace.MainPass(shadow=(shadow_cap, mb_shadow_cap), defer=True)
    return trace.render_wavefront(unpack_frame(pack), width, height, max_depth=max_depth,
                                  plain=True, main=main, row_offset=row_offset,
                                  local_height=local_height)


def render_frame_deferred_main(pack: FramePack, *, width: int, height: int,
                               max_depth: int = MAX_RAY_RECURSION_DEPTH, shadow_cap,
                               mb_shadow_cap=None, lib=None, ops=None, planes=None,
                               row_offset: int = 0, local_height: int | None = None):
    """Defer's main pass, the ``trace.DeferPlanes`` of the band's (h, W)
    pixels: on CUDA the defer entry of csrc/frame_kernel.cu (counted in
    DEFER_LAUNCHES), on the CPU the plain version. Needs max_depth >= 2.
    ``planes``: CUDA only, DeferPlanes of the entry's shapes to write into
    instead of new ones (a timing loop keeps its 34 planes out of the
    allocator)."""
    check_pack(pack)
    if max_depth < 2:
        raise ValueError("the deferred-shadow pass needs a shadowed level (max_depth >= 2)")
    band = dict(row_offset=row_offset, local_height=band_height(height, row_offset, local_height))
    if pack.params.device.type == "cpu":
        return render_frame_deferred_plain(pack, width=width, height=height,
                                           max_depth=max_depth, shadow_cap=shadow_cap,
                                           mb_shadow_cap=mb_shadow_cap, **band)
    return _defer_launch(pack, width, height, max_depth, shadow_cap, mb_shadow_cap, None, lib,
                         ops, planes, **band)[0]


def _defer_launch(pack, width, height, max_depth, shadow_cap, mb_shadow_cap, cap, lib, ops,
                  planes=None, *, row_offset, local_height):
    """One launch of the defer entry over a band: (DeferPlanes, None)
    without a queue capacity ``cap``, else (DeferPlanes, DeferQueue)."""
    global DEFER_LAUNCHES
    from gpuraytracer_tpu_torch.render import trace

    dev = pack.params.device
    lib = _launch_setup(pack, width, height, max_depth, lib)
    nsl, lh = max_depth - 1, local_height
    want = trace.DeferPlanes(
        lit=((max_depth, lh, width, 4), torch.float32),
        shadowed=((nsl, lh, width, 4), torch.float32),
        sinfo=((nsl, lh, width), torch.int32),
        rays=((nsl, lh, width, 6), torch.float32))
    if planes is None:
        planes = trace.DeferPlanes(*(torch.empty(s, dtype=t, device=dev) for s, t in want))
    elif any(tuple(p.shape) != s or p.dtype != t or p.device != dev or not p.is_contiguous()
             for p, (s, t) in zip(planes, want)):
        raise ValueError("planes must be contiguous DeferPlanes of the entry's shapes on its device")
    null = ctypes.c_void_p(None)
    queue = None
    if cap is None:
        q_args = (null, null, null, 0)
    else:
        words = _queue_words(nsl, defer_bins(width * lh), dev)
        queue = DeferQueue(torch.empty((nsl, cap), dtype=torch.int32, device=dev), words[:nsl],
                           torch.empty((nsl, lh, width, MARCH_RECORD_WORDS), dtype=torch.int32,
                                       device=dev), words[nsl:])
        q_args = (_ptr(queue.rec), _ptr(queue.idx), _ptr(queue.count), cap)
    _raise_on(lib.gprt_frame_defer(
        *_buffers(pack), *(_ptr(p) for p in planes), *q_args, width, height, row_offset, lh,
        max_depth,
        pack.num_geometries, pack.num_materials, int(_shared(pack)),
        *_kernel_caps((None, shadow_cap), (None, mb_shadow_cap), 1), ops_pointer(ops),
        *_where(dev)), lib, "defer kernel")
    DEFER_LAUNCHES += 1
    return planes, queue


def _cappable(pack: FramePack, sdf_caps, mb_caps) -> bool:
    """Whether a march of the packed scene can run out of a cap below its
    natural budget (SDF) or its 128 steps (metaballs)."""
    for kind, natural in pack.budgets:
        caps = [c for c in (sdf_caps if kind == IntersectorKind.SIGNED_DISTANCE else
                            mb_caps if kind == IntersectorKind.VOLUMETRIC else ())
                if c is not None]
        limit = natural if kind == IntersectorKind.SIGNED_DISTANCE else metaballs.METABALL_MAX_STEPS
        if caps and min(caps) < limit:
            return True
    return False


# ---------------------------------------------------------------------------
# The modes' device queues
# ---------------------------------------------------------------------------

# Words (int32) of one compact queue entry (csrc/frame_kernel.cu QueueEntry,
# 64 bytes): pixel index, level | the lowest set bit of the dirty mask << 8
# (the key of the binned order; -1: the camera ray), then as float32 bits
# the ray origin and direction, the colour and the throughput at the start
# of that level.
QUEUE_ENTRY_WORDS = 16
# Words (int32) of one march record (csrc/frame_math.cuh MarchRecord, 16
# bytes): the geometry whose capped occlusion march left a lane's status
# unknown, the samples it took with its flags, and as float32 bits its t
# and carry.
MARCH_RECORD_WORDS = 4


def defer_bins(npix: int) -> int:
    """Keys of the defer queues' binned order over npix pixels: 32 per
    raster block of 2**15 pixels (``bin_keys``)."""
    return 32 * ((npix + 32767) >> 15)


def _queue_words(nseg: int, nbins: int, dev):
    """A queue's counts (nseg int32) and the words the main entry zeroes with
    them (csrc/frame_kernel.cu queue_words): its keys' histogram, the bin
    entry's cursors and its count of finished blocks."""
    return torch.empty(nseg + 2 * nseg * nbins + 1, dtype=torch.int32, device=dev)


class CompactQueue(NamedTuple):
    """The compact main pass's queue of dirty pixels: ``entries`` (cap, 16)
    int32, one QueueEntry per slot (``queue_entries``), the first
    min(count, cap) of them live; ``count`` (1,) int32, every dirty pixel
    counted, stored or not. ``bins`` (on a GPU): the 2 * 32 + 1 int32 words
    after the count, the histogram of the 32 keys of the binned order that
    the compact entry counted, then the bin entry's cursors and its count of
    finished blocks (None for the plain version's queue)."""

    entries: torch.Tensor
    count: torch.Tensor
    bins: torch.Tensor | None = None


class DeferQueue(NamedTuple):
    """The defer main pass's queues of unknown lanes, one per shadowed
    level: ``idx`` (D-1, cap) int32 raster indices, the first
    min(count[k], cap) of row k live; ``count`` (D-1,) int32. On a GPU also
    ``rec`` (D-1, H, W, 4) int32, the march record (MARCH_RECORD_WORDS) of
    each queued pixel, from which the repair resumes (defined only at the
    unknown lanes), and ``bins``, the 2 * (D-1) * defer_bins(H * W) + 1
    int32 words after the counts (the keys' histograms that the defer entry
    counted, the bin entry's cursors and its count of finished blocks). The
    plain version's queue has neither: its repair runs the whole
    traversal."""

    idx: torch.Tensor
    count: torch.Tensor
    rec: torch.Tensor | None = None
    bins: torch.Tensor | None = None


class QueueCount(int):
    """The lanes a compacted mode queued in a frame (what ``debug_count``
    returns), with ``overflow``: whether a queue held more than its
    capacity, so that the frame is the plain kernel's."""

    overflow: bool

    def __new__(cls, count: int, overflow: bool):
        obj = super().__new__(cls, count)
        obj.overflow = bool(overflow)
        return obj


def _queued_on_device(dev):
    t = _QUEUED_ON_DEVICE.get(dev)
    if t is None:
        t = _QUEUED_ON_DEVICE[dev] = torch.zeros(1, dtype=torch.int64, device=dev)
    return t


def queued_lanes() -> int:
    """Lanes the compacted modes queued since import: QUEUED_LANES (counted
    on the host) plus what the binned device queues counted (read from each
    device: one sync, outside any timed window)."""
    return QUEUED_LANES + sum(int(t.item()) for t in _QUEUED_ON_DEVICE.values())


def lowest_bit(mask):
    """Index of the lowest set bit of each int32 of ``mask`` (-1 for 0)."""
    m = mask.to(torch.int64) & 0xFFFFFFFF
    low = m & -m
    return torch.where(low > 0, torch.log2(low.to(torch.float64)).round().to(torch.int64), -1)


def queue_entries(pix, state, dirty):
    """(N, 16) int32 compact queue entries of the pixels ``pix`` (N,) with
    their ``trace.PixelState`` and dirty masks ``dirty`` (N rows each)."""
    floats = torch.cat([state.o, state.d, state.color, state.throughput], dim=1)
    meta = state.level.to(torch.int64) | (lowest_bit(dirty) << 8)
    return torch.cat([pix.to(torch.int32)[:, None], meta.to(torch.int32)[:, None],
                      floats.to(torch.float32).contiguous().view(torch.int32)], dim=1)


def entry_state(entries):
    """(pixel indices (N,) int64, ``trace.PixelState``) of compact queue
    entries (N, 16) int32."""
    from gpuraytracer_tpu_torch.render import trace

    f = entries[:, 2:].contiguous().view(torch.float32)
    meta = entries[:, 1]
    return entries[:, 0].to(torch.int64), trace.PixelState(
        torch.where(meta >= 0, meta & 255, meta), f[:, 0:3], f[:, 3:6], f[:, 6:10], f[:, 10:14])


def queue_plain(mask, cap: int):
    """The reference's queue build for one flat mask (frame_kernel.py:934,
    :1212): the raster indices of its set lanes as ``jnp.nonzero(mask,
    size=cap, fill_value=-1)`` gives them ((cap,) int64, -1 past the last),
    their count, and whether the count passed ``cap`` (the overflow). The
    count is read on the host: one sync on a GPU, counted in HOST_SYNCS,
    the lanes in QUEUED_LANES."""
    global HOST_SYNCS, QUEUED_LANES
    idx = torch.nonzero(mask.reshape(-1)).squeeze(1)
    count = idx.shape[0]
    HOST_SYNCS += 1
    QUEUED_LANES += count
    out = torch.full((cap,), -1, dtype=torch.int64, device=mask.device)
    out[:min(count, cap)] = idx[:cap]
    return out, count, count > cap


def render_frame_compact_main_plain(pack: FramePack, *, width: int, height: int,
                                    max_depth: int = MAX_RAY_RECURSION_DEPTH, budget_cap,
                                    mb_budget_cap=None, cap: int, row_offset: int = 0,
                                    local_height: int | None = None):
    """Plain version of ``render_frame_compact_main``: the capped wavefront
    keeping each dirty pixel's state (``trace.MainPass(resume=True)``), and
    the queue that ``queue_plain`` builds over its dirty mask, in the band's
    raster order. Returns (image, CompactQueue)."""
    from gpuraytracer_tpu_torch.render import trace

    caps, mb_caps = norm_caps(budget_cap), norm_caps(mb_budget_cap)
    main = trace.MainPass(closest=(caps[0], mb_caps[0]), shadow=(caps[1], mb_caps[1]),
                          resume=True)
    img, dirty, state = trace.render_wavefront(unpack_frame(pack), width, height,
                                               max_depth=max_depth, plain=True, main=main,
                                               row_offset=row_offset, local_height=local_height)
    idx, count, _ = queue_plain(dirty != 0, cap)
    live = idx[:min(count, cap)]
    flat = trace.PixelState(*(x.reshape((dirty.numel(),) + x.shape[2:]) for x in state))
    entries = torch.zeros((cap, QUEUE_ENTRY_WORDS), dtype=torch.int32, device=img.device)
    entries[:live.shape[0]] = queue_entries(live, trace.PixelState(*(x[live] for x in flat)),
                                            dirty.reshape(-1)[live])
    return img, CompactQueue(entries, torch.tensor([count], dtype=torch.int32,
                                                   device=img.device))


def render_frame_compact_main(pack: FramePack, *, width: int, height: int,
                              max_depth: int = MAX_RAY_RECURSION_DEPTH, budget_cap,
                              mb_budget_cap=None, cap: int, lib=None, ops=None,
                              row_offset: int = 0, local_height: int | None = None):
    """Compact's main pass with its queue: (image, CompactQueue). The image
    is the plain frame at every clean pixel; each dirty pixel goes to the
    queue with its state at the start of the level where a cap stopped it.
    CUDA: the compact entry of csrc/frame_kernel.cu appending warp by warp
    to a queue of ``cap`` slots in device memory (append order; counted in
    COMPACT_LAUNCHES; no host sync); CPU: the plain version."""
    check_pack(pack)
    band = dict(row_offset=row_offset, local_height=band_height(height, row_offset, local_height))
    if pack.params.device.type == "cpu":
        return render_frame_compact_main_plain(pack, width=width, height=height,
                                               max_depth=max_depth, budget_cap=budget_cap,
                                               mb_budget_cap=mb_budget_cap, cap=cap, **band)
    out, _, queue = _compact_launch(pack, width, height, max_depth, budget_cap, mb_budget_cap,
                                    cap, lib, ops, **band)
    return out, queue


def bin_keys(queue, sinfo=None):
    """The binned order's key of each slot of a queue (the device's
    bin_key): compact (``sinfo`` None), the lowest set bit of the dirty mask
    ((cap,) int64); defer, the pixel's block of 2**15 raster pixels * 32 +
    the lowest set bit of its level's capped-geometry mask in ``sinfo``
    ((D-1, H, W)), per level ((D-1, cap) int64); a lane whose capped
    geometries are all past 29, which the status word's mask (bits 0-29)
    does not hold, has key 30 in its block. Slots past a segment's count
    hold no entry: their keys are meaningless."""
    if sinfo is None:
        return queue.entries[:, 1].to(torch.int64) >> 8
    live = torch.arange(queue.idx.shape[1], device=queue.idx.device) < queue.count[:, None]
    pix = torch.where(live, queue.idx, 0).to(torch.int64)
    code = torch.gather(sinfo.reshape(sinfo.shape[0], -1), 1, pix) >> 2
    return (pix >> 15) * 32 + torch.where(code != 0, lowest_bit(code), 30)


def bin_queue_plain(queue, sinfo=None):
    """Plain version of ``bin_queue``: each segment's live slots stably
    sorted by key (``bin_keys``): one order the kernels may give, which
    keep the keys' order and not the order within a key."""
    slots = queue.entries if sinfo is None else queue.idx
    segs = slots[None] if sinfo is None else slots
    keys = bin_keys(queue, sinfo)
    keys = keys[None] if sinfo is None else keys
    counts = queue.count.tolist()
    out = segs.clone()
    if max(counts) <= segs.shape[1]:
        for k, n in enumerate(counts):
            out[k, :n] = segs[k, :n][torch.argsort(keys[k, :n], stable=True)]
    field = "entries" if sinfo is None else "idx"
    return queue._replace(**{field: out[0] if sinfo is None else out})


def bin_queue(queue, sinfo=None, lib=None):
    """A mode's queue in the binned order (the reference's ray sorting,
    frame_kernel.py:937-947 and :1214-1230): compact (a CompactQueue,
    ``sinfo`` None) grouped by the lowest set bit of the dirty mask, the
    capped geometry; defer (a DeferQueue and the main pass's (D-1, H, W)
    ``sinfo`` planes) grouped per level by raster block of 2**15 pixels,
    then the capped geometry, so that a warp of the dense pass or the repair
    marches one geometry. The order is a schedule: the frame does not depend
    on it. CUDA: the bin entry of csrc/frame_kernel.cu, one launch (the
    queue's main entry counted its keys into ``queue.bins``; each block
    scans that histogram and scatters its entries; nothing read back;
    counted in BIN_LAUNCHES); CPU: the plain version."""
    global BIN_LAUNCHES
    slots = queue.entries if sinfo is None else queue.idx
    dev = slots.device
    if dev.type == "cpu":
        return bin_queue_plain(queue, sinfo)
    from gpuraytracer_tpu_torch.kernels import build

    lib = lib if lib is not None else build.load("frame_kernel")
    nseg = 1 if sinfo is None else slots.shape[0]
    cap = slots.shape[0] if sinfo is None else slots.shape[1]
    npix = 0 if sinfo is None else sinfo.shape[1] * sinfo.shape[2]
    nbins = 32 if sinfo is None else defer_bins(npix)
    if sinfo is not None and (sinfo.dtype != torch.int32 or sinfo.shape[0] != nseg
                              or sinfo.device != dev or not sinfo.is_contiguous()):
        raise ValueError(f"sinfo: expected contiguous ({nseg}, H, W) int32 planes on {dev}")
    bins = queue.bins
    if bins is None or bins.dtype != torch.int32 or tuple(bins.shape) != (2 * nseg * nbins + 1,) \
            or bins.device != dev or not bins.is_contiguous():
        raise ValueError(f"queue.bins: expected the ({2 * nseg * nbins + 1},) int32 words that "
                         f"the queue's main entry counted its keys into, on {dev}")
    out = torch.empty_like(slots)
    _raise_on(lib.gprt_queue_bin(
        _ptr(slots), _ptr(out), _ptr(queue.count),
        ctypes.c_void_p(None) if sinfo is None else _ptr(sinfo), _ptr(bins),
        _ptr(_queued_on_device(dev)), nseg, cap, npix, nbins, int(sinfo is not None),
        *_where(dev)), lib, "queue bin kernel")
    BIN_LAUNCHES += 1
    return queue._replace(**{"entries" if sinfo is None else "idx": out})


def render_frame_resume_plain(pack: FramePack, queue: CompactQueue, image, *, width: int,
                              height: int, max_depth: int = MAX_RAY_RECURSION_DEPTH,
                              row_offset: int = 0):
    """Plain version of ``render_frame_resume``: the wavefront from each
    live entry's saved state (``trace.trace_radiance(start=...)``) at plain
    budgets, written into ``image`` at the entry's pixel (an index in the
    band's raster order, its global row ``row_offset`` further down);
    nothing where the queue overflowed."""
    from gpuraytracer_tpu_torch.render import trace

    count, cap = int(queue.count[0]), queue.entries.shape[0]
    if count > cap or count == 0:
        return image
    pix, state = entry_state(queue.entries[:count])
    colour = trace.trace_radiance(state.o, state.d, pix % width, pix // width + row_offset,
                                  width, height, unpack_frame(pack), max_depth=max_depth,
                                  start=state)
    image.view(-1, 4)[pix] = colour
    return image


def render_frame_resume(pack: FramePack, queue: CompactQueue, image, *, width: int,
                        height: int, max_depth: int = MAX_RAY_RECURSION_DEPTH, lib=None,
                        ops=None, row_offset: int = 0, local_height: int | None = None):
    """The compact mode's dense pass: each queued pixel continued from the
    level where the cap stopped it, at full budgets, its colour written into
    ``image`` (H, W, 4) in place, which is returned. The pixel is the plain
    kernel's: the levels before were its levels bit for bit, and the level
    is traced again at full budget. Where the queue overflowed nothing is
    written. CUDA: the dense entry of csrc/frame_kernel.cu, launched over
    the queue's capacity, reading the live count on the device (merged where
    ``merges`` says so; counted in DENSE_LAUNCHES or MERGED_DENSE_LAUNCHES);
    CPU: the plain version. A band's queue resumes into the band's image."""
    check_pack(pack)
    dev = pack.params.device
    lh = band_height(height, row_offset, local_height)
    _check_queue(queue.entries, queue.count, dev, (queue.entries.shape[0], QUEUE_ENTRY_WORDS), 1)
    _check_image(image, width, lh, dev)
    if dev.type == "cpu":
        return render_frame_resume_plain(pack, queue, image, width=width, height=height,
                                         max_depth=max_depth, row_offset=row_offset)
    _dense_launch(pack, queue, image, width, height, max_depth, lib, ops, row_offset=row_offset,
                  local_height=lh)
    return image


def render_frame_gated_plain(pack: FramePack, image, count, cap: int, *, width: int,
                             height: int, max_depth: int = MAX_RAY_RECURSION_DEPTH,
                             row_offset: int = 0, local_height: int | None = None):
    """Plain version of ``render_frame_gated``: the counts read on the host,
    and ``image`` overwritten with ``render_frame_plain`` of the band where
    one passed ``cap``."""
    if bool((count > cap).any()):
        image.copy_(render_frame_plain(pack, width=width, height=height, max_depth=max_depth,
                                       row_offset=row_offset, local_height=local_height))
    return image


def render_frame_gated(pack: FramePack, image, count, cap: int, *, width: int, height: int,
                       max_depth: int = MAX_RAY_RECURSION_DEPTH, lib=None, row_offset: int = 0,
                       local_height: int | None = None):
    """The queues' overflow, decided where the counts are: if any of
    ``count`` ((K,) int32) passed ``cap``, ``image`` (H, W, 4) becomes the
    plain kernel's frame, in place (the reference's lax.cond,
    frame_kernel.py:1004, :1311); it is returned. CUDA: the gate of
    csrc/frame_gate.cu (``lib``, default its shipped build), one warp that
    reads the counts and, only where one passed ``cap``, launches the plain
    frame kernel over the band from the device, after which the stream's
    later work runs (merged where ``merges`` says so; counted in
    GATED_FALLBACK_LAUNCHES, one per call, launched every frame); CPU: the
    plain version."""
    global GATED_FALLBACK_LAUNCHES
    check_pack(pack)
    dev = pack.params.device
    lh = band_height(height, row_offset, local_height)
    _check_image(image, width, lh, dev)
    if count.dtype != torch.int32 or count.dim() != 1 or count.device != dev \
            or not count.is_contiguous() or count.numel() == 0:
        raise ValueError(f"count: expected a contiguous (K,) int32 tensor on {dev}")
    if dev.type == "cpu":
        return render_frame_gated_plain(pack, image, count, cap, width=width, height=height,
                                        max_depth=max_depth, row_offset=row_offset,
                                        local_height=lh)
    lib = _launch_setup(pack, width, height, max_depth, lib, "frame_gate")
    _raise_on(lib.gprt_frame_gated(
        *_buffers(pack), _ptr(image), _ptr(count), count.numel(), cap, width, height, row_offset,
        lh, max_depth, pack.num_geometries, pack.num_materials, int(_shared(pack)), int(merges(pack)),
        ctypes.c_void_p(None), *_where(dev)), lib, "gated frame kernel")
    GATED_FALLBACK_LAUNCHES += 1
    return image


def render_frame_deferred_queue_plain(pack: FramePack, *, width: int, height: int,
                                      max_depth: int = MAX_RAY_RECURSION_DEPTH, shadow_cap,
                                      mb_shadow_cap=None, cap: int, row_offset: int = 0,
                                      local_height: int | None = None):
    """Plain version of ``render_frame_deferred_queue``: the plain main
    pass's planes and, per shadowed level, ``queue_plain`` over its unknown
    lanes (the band's raster order)."""
    planes = render_frame_deferred_plain(pack, width=width, height=height, max_depth=max_depth,
                                         shadow_cap=shadow_cap, mb_shadow_cap=mb_shadow_cap,
                                         row_offset=row_offset, local_height=local_height)
    built = [queue_plain((info & 3) == 2, cap) for info in planes.sinfo]
    dev = planes.sinfo.device
    idx = torch.stack([i.to(torch.int32) for i, _, _ in built])
    return planes, DeferQueue(idx, torch.tensor([c for _, c, _ in built], dtype=torch.int32,
                                                device=dev))


def render_frame_deferred_queue(pack: FramePack, *, width: int, height: int,
                                max_depth: int = MAX_RAY_RECURSION_DEPTH, shadow_cap,
                                mb_shadow_cap=None, cap: int, lib=None, ops=None,
                                row_offset: int = 0, local_height: int | None = None):
    """Defer's main pass with its queues: (``trace.DeferPlanes``,
    DeferQueue), the planes those of ``render_frame_deferred_main`` and per
    shadowed level the pixels whose status is unknown. CUDA: the defer entry
    appending warp by warp to per-level queues of ``cap`` slots in device
    memory (append order; counted in DEFER_LAUNCHES; no host sync), with the
    record of the march that the cap stopped at each queued pixel and the
    histogram of the queues' keys; CPU: the plain version. Needs
    max_depth >= 2."""
    check_pack(pack)
    if max_depth < 2:
        raise ValueError("the deferred-shadow pass needs a shadowed level (max_depth >= 2)")
    band = dict(row_offset=row_offset, local_height=band_height(height, row_offset, local_height))
    if pack.params.device.type == "cpu":
        return render_frame_deferred_queue_plain(pack, width=width, height=height,
                                                 max_depth=max_depth, shadow_cap=shadow_cap,
                                                 mb_shadow_cap=mb_shadow_cap, cap=cap, **band)
    return _defer_launch(pack, width, height, max_depth, shadow_cap, mb_shadow_cap, cap, lib, ops,
                         **band)


def frame_compose_plain(planes, occ):
    """Plain version of ``frame_compose``: the recomposition in the defer
    kernel's association order, acc = term_0; acc = acc + term_1; ..."""
    acc = None
    nsl = planes.shadowed.shape[0]
    for k in range(planes.lit.shape[0]):
        term = planes.lit[k]
        if k < nsl:
            stat = planes.sinfo[k] & 3
            shad = (stat == 1) | ((stat == 2) & (occ[k] != 0))
            term = torch.where(shad[..., None], planes.shadowed[k], term)
        acc = term if acc is None else acc + term
    return acc


def frame_compose(planes, occ, lib=None):
    """The deferred frame from its main pass's ``planes`` (trace.DeferPlanes
    of an (H, W) frame) and the occlusion planes ``occ`` (D-1, H, W) int32
    (read only where a level's status is unknown): (H, W, 4) f32, each
    pixel's levels summed in the defer kernel's order, each level shadowed
    where its status is 1 or, at status 2, where occ is set. CUDA: the
    compose entry of csrc/frame_kernel.cu, one thread per pixel (counted in
    COMPOSE_LAUNCHES); CPU: the plain version."""
    global COMPOSE_LAUNCHES
    lit, shadowed, sinfo, _ = planes
    dev = lit.device
    d, h, w = lit.shape[0], lit.shape[1], lit.shape[2]
    for name, t, shape, dtype in (("lit", lit, (d, h, w, 4), torch.float32),
                                  ("shadowed", shadowed, (d - 1, h, w, 4), torch.float32),
                                  ("sinfo", sinfo, (d - 1, h, w), torch.int32),
                                  ("occ", occ, (d - 1, h, w), torch.int32)):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {shape} {dtype} tensor on {dev}")
    if d < 2:
        raise ValueError("the recomposition needs a shadowed level (D >= 2)")
    if dev.type == "cpu":
        return frame_compose_plain(planes, occ)
    if dev.type != "cuda":
        raise ValueError(f"no frame kernel for device {dev}")
    from gpuraytracer_tpu_torch.kernels import build

    lib = lib if lib is not None else build.load("frame_kernel")
    out = torch.empty((h, w, 4), dtype=torch.float32, device=dev)
    _raise_on(lib.gprt_frame_compose(_ptr(lit), _ptr(shadowed), _ptr(sinfo), _ptr(occ), _ptr(out),
                                     h * w, d, *_where(dev)), lib, "compose kernel")
    COMPOSE_LAUNCHES += 1
    return out


def _check_queue(slots, count, dev, shape, n_counts):
    if tuple(slots.shape) != shape or slots.dtype != torch.int32 or slots.device != dev \
            or not slots.is_contiguous():
        raise ValueError(f"queue slots: expected a contiguous {shape} int32 tensor on {dev}")
    if tuple(count.shape) != (n_counts,) or count.dtype != torch.int32 or count.device != dev:
        raise ValueError(f"queue count: expected a ({n_counts},) int32 tensor on {dev}")


def _check_image(image, width, height, dev):
    if tuple(image.shape) != (height, width, 4) or image.dtype != torch.float32 \
            or image.device != dev or not image.is_contiguous():
        raise ValueError(f"image: expected a contiguous ({height}, {width}, 4) float32 tensor "
                         f"on {dev}")


def _debug_count(count, cap):
    """``debug_count``'s QueueCount of a mode's device counts: one sync,
    counted in HOST_SYNCS."""
    global HOST_SYNCS
    counts = count.tolist()
    HOST_SYNCS += 1
    return QueueCount(sum(counts), max(counts) > cap)


def render_frame_compact(pack: FramePack, *, width: int, height: int,
                         max_depth: int = MAX_RAY_RECURSION_DEPTH, budget_cap=None,
                         mb_budget_cap=None, cap_lanes: int | None = None,
                         debug_count: bool = False, row_offset: int = 0,
                         local_height: int | None = None):
    """GPURT_FRAME_MODE=compact, the reference's render_frame_compact
    (frame_kernel.py:803): the frame with every SDF march capped at
    ``budget_cap`` steps (default GPURT_COMPACT_BUDGET, 64; an int or
    (closest, occlusion)) and the metaball marches at ``mb_budget_cap``
    (default uncapped), queueing every pixel that a cap touched with its
    state at the start of that level (``render_frame_compact_main``); the
    queue grouped by capped geometry (``bin_queue``); the dense pass
    continues each queued pixel from there at full budgets and writes it
    into the image (``render_frame_resume``). The image equals the plain
    kernel's: a march that resolves within its cap is a strict prefix of
    the full one, so the levels before were the plain kernel's.

    Where no march can be capped the plain kernel renders the frame
    (frame_kernel.py:860-889); where the queue holds more than
    ``queue_capacity`` pixels the frame is the plain kernel's, as the
    reference's lax.cond decides (frame_kernel.py:1004): on a GPU the gated
    plain kernel (``render_frame_gated``) decides it on the device, and the
    chain of launches reads nothing back; on the CPU the host reads the
    count and renders the plain kernel (``render_frame_tiles``).
    ``debug_count``: also return the number of dirty pixels, a QueueCount
    whose ``overflow`` says whether the queue overflowed (a sync on a
    GPU). A band (``row_offset``, ``local_height``) has a queue of its own,
    of ``queue_capacity`` of its rows, and overflows on its own."""
    if budget_cap is None:
        budget_cap = int(os.environ.get("GPURT_COMPACT_BUDGET", COMPACT_BUDGET))
    lh = band_height(height, row_offset, local_height)
    kw = dict(width=width, height=height, max_depth=max_depth, row_offset=row_offset,
              local_height=lh)
    if not _cappable(pack, norm_caps(budget_cap), norm_caps(mb_budget_cap)):
        img = render_frame_tiles(pack, **kw)
        return (img, QueueCount(0, False)) if debug_count else img
    cap = queue_capacity(width, lh, cap_lanes)
    img, queue = render_frame_compact_main(pack, budget_cap=budget_cap,
                                           mb_budget_cap=mb_budget_cap, cap=cap, **kw)
    cpu = pack.params.device.type == "cpu"
    if cpu:
        count = int(queue.count[0])
        if count > cap:
            img = render_frame_tiles(pack, **kw)
            return (img, QueueCount(count, True)) if debug_count else img
    render_frame_resume(pack, bin_queue(queue), img, **kw)
    if cpu:
        return (img, QueueCount(count, False)) if debug_count else img
    render_frame_gated(pack, img, queue.count, cap, **kw)
    return (img, _debug_count(queue.count, cap)) if debug_count else img


def render_frame_deferred(pack: FramePack, *, width: int, height: int,
                          max_depth: int = MAX_RAY_RECURSION_DEPTH, shadow_cap=None,
                          mb_shadow_cap=None, cap_lanes: int | None = None,
                          debug_count: bool = False, qsort: str = "block-code",
                          row_offset: int = 0, local_height: int | None = None):
    """GPURT_FRAME_MODE=defer, the reference's render_frame_deferred
    (frame_kernel.py:1075): the main pass caps only the occlusion marches
    (at ``shadow_cap`` steps, default GPURT_SHADOW_CAP, 32; metaballs at
    ``mb_shadow_cap``, default uncapped), records per level both shadow
    variants and a status, and queues per shadowed level the lanes whose
    status is unknown (``render_frame_deferred_queue``), grouped by raster
    block and capped geometry (``bin_queue``); the occlusion repair
    (scene_kernel.shadow_queue_planes) finishes their occlusion queries at
    full budgets, each from where the cap stopped it, into per-level
    occlusion planes, and ``frame_compose`` sums the levels
    in the kernel's association order, acc = term_0; acc = acc + term_1;
    ... The occlusion results are the plain kernel's, so the image agrees
    with it to the last bits of the shading.

    Where no occlusion march can be capped the plain kernel renders the
    frame (frame_kernel.py:1136-1157); where a level's queue holds more
    than ``queue_capacity`` lanes the frame is the plain kernel's
    (frame_kernel.py:1311): on a GPU the gated plain kernel decides it on
    the device (a chain of launches that reads nothing back), on the CPU
    the host. ``debug_count``: also return the number of unknown lanes over
    the levels, a QueueCount with ``overflow`` (a sync on a GPU). A band
    (``row_offset``, ``local_height``) has queues of their own, of
    ``queue_capacity`` of its rows, and overflows on its own.

    ``qsort`` is deprecated and has no effect: it chose the queue's order
    ("block-code", "code" or "raster") while the host sorted the queue. The
    queues are now always binned by block and capped geometry on the
    device, and the order is a schedule, not behaviour. The parameter stays
    so that callers written against the host-sorted form still run; any
    value but the default warns (DeprecationWarning)."""
    from gpuraytracer_tpu_torch.kernels import scene_kernel

    if qsort not in ("block-code", "code", "raster"):
        raise ValueError(f"unknown queue order {qsort!r}")
    if qsort != "block-code":
        warnings.warn("render_frame_deferred(qsort=...) has no effect: the queues are always "
                      "binned by block and capped geometry on the device", DeprecationWarning,
                      stacklevel=2)
    if shadow_cap is None:
        shadow_cap = int(os.environ.get("GPURT_SHADOW_CAP", SHADOW_CAP))
    lh = band_height(height, row_offset, local_height)
    kw = dict(width=width, height=height, max_depth=max_depth, row_offset=row_offset,
              local_height=lh)
    if max_depth < 2 or not _cappable(pack, (shadow_cap,), (mb_shadow_cap,)):
        img = render_frame_tiles(pack, **kw)
        return (img, QueueCount(0, False)) if debug_count else img
    cap = queue_capacity(width, lh, cap_lanes)
    planes, queue = render_frame_deferred_queue(pack, shadow_cap=shadow_cap,
                                                mb_shadow_cap=mb_shadow_cap, cap=cap, **kw)
    cpu = pack.params.device.type == "cpu"
    if cpu:
        counts = queue.count.tolist()
        if max(counts) > cap:
            img = render_frame_tiles(pack, **kw)
            return (img, QueueCount(sum(counts), True)) if debug_count else img
    queue = bin_queue(queue, planes.sinfo)
    occ = scene_kernel.shadow_queue_planes(pack, planes.rays, queue.idx, queue.count, queue.rec)
    img = frame_compose(planes, occ)
    if cpu:
        return (img, QueueCount(sum(counts), False)) if debug_count else img
    render_frame_gated(pack, img, queue.count, cap, **kw)
    return (img, _debug_count(queue.count, cap)) if debug_count else img
