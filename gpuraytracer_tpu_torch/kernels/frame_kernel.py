"""The whole frame in one hand-written CUDA kernel (csrc/frame_kernel.cu).

Replaces the reference's fused Pallas frame kernel
(gpuraytracer_tpu/kernels/frame_kernel.py: render_frame_tiles /
_frame_kernel, plain mode) together with the scene-kernel device functions
it inlines. One CUDA thread renders one pixel: raygen, then per level the
plane test, the closest traversal, the material pick, the shadow ray, the
shading and the bounce, and one float4 store.

Parameters reach the kernel as one contiguous f32 buffer and one int32
layout buffer (``pack_frame``), packed from the same blocks as the
reference's ``pack_frame_params``, and the mesh face table
(accel/traverse.pack_tri_rows); the scene kernel (scene_kernel.py) reads
the same buffers. On a CPU tensor the wrapper runs the kernel's
plain version — the wavefront ``render/trace.trace_radiance`` on the
scene unpacked from the same buffers; on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os

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
from gpuraytracer_tpu_torch.geometry import metaballs, sdf, trimesh

# Kernel launches since import (or since a caller reset it); chip runs read
# it to show that a frame went through the kernel.
LAUNCHES = 0

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
# per-block opt-in limit); the buffers are copied there (``shared_bytes``).
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
    count) in it (F = 0 without meshes)."""

    params: torch.Tensor
    layout: torch.Tensor
    num_geometries: int
    num_materials: int
    tri: torch.Tensor
    tri_offsets: tuple = ()


def frame_mode() -> str:
    """GPURT_FRAME_MODE as the reference reads it (default "plain")."""
    m = os.environ.get("GPURT_FRAME_MODE", "")
    if m in ("plain", "compact", "defer"):
        return m
    return "plain"


def merged_shadow_enabled() -> bool:
    return os.environ.get("GPURT_MERGED_SHADOW", "") == "1"


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


def check_kernel_covers(layout: SceneLayout) -> None:
    """Raise, naming the reference kernel that is not ported yet, for a
    CUDA frame that no ported route renders (the frame kernel, the scene
    kernel, the per-geometry route of csrc/megakernel.cu). Never falls
    back."""
    mode = frame_mode()
    if mode == "compact":
        raise NotImplementedError(
            "GPURT_FRAME_MODE=compact: frame_kernel.render_frame_compact is not "
            "ported to CUDA yet")
    if mode == "defer":
        raise NotImplementedError(
            "GPURT_FRAME_MODE=defer: frame_kernel.render_frame_deferred and "
            "_shadow_queue_kernel are not ported to CUDA yet")
    if merged_shadow_enabled():
        raise NotImplementedError(
            "GPURT_MERGED_SHADOW: scene_kernel._march_sdf_multi is not ported "
            "to CUDA yet")
    for kind, code in zip(layout.kinds, layout.prim_types):
        if kind == IntersectorKind.SIGNED_DISTANCE and int(code) not in KERNEL_SDF_CODES:
            raise NotImplementedError(
                f"distance code {int(code)} has no CUDA device function")


def pack_frame_params(scene: Scene):
    """Parameter blocks as the reference's pack_frame_params builds them:
    (b2l_rows (G,12), l2b_rot (G,9), step_scales (G,), aabbs (G,6),
    mb_params (3,4), materials (M,8), p2w (4,4), cvec (8,4)), plus the
    static fields (geoms, plane_gid)."""
    arrays, layout = scene.arrays, scene.layout
    tr = arrays.transforms
    g = tr.blas_to_local.shape[0]
    b2l_rows = tr.blas_to_local[:, :3, :].reshape(g, 12)
    l2b_rot = tr.local_to_blas[:, :3, :3].reshape(g, 9)
    aabbs = torch.cat([arrays.aabb_min, arrays.aabb_max], dim=-1)
    centers, radii = metaballs.animated_metaballs(arrays.constants.elapsed_time)
    mb_params = torch.cat([centers, radii[:, None]], dim=-1)
    step_scales = arrays.materials.step_scale[:g]
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
    blocks = (b2l_rows, l2b_rot, step_scales, aabbs, mb_params, materials, p2w, cvec)
    static = dict(
        geoms=tuple((int(k), int(p)) for k, p in zip(layout.kinds, layout.prim_types)),
        plane_gid=int(layout.plane_geometry_id),
    )
    return blocks, static


def pack_frame(scene: Scene) -> FramePack:
    """One f32 parameter buffer + one int32 layout buffer on the scene's
    device. The march knobs (budgets per level, relaxation, capped-hit
    occlusion) are read here, at call time, as the wavefront reads them."""
    blocks, static = pack_frame_params(scene)
    layout = scene.layout
    tri, tri_offsets = traverse.pack_tri_rows(scene.arrays)
    g = len(static["geoms"])
    m = blocks[5].shape[0]
    dev = blocks[0].device
    relax = []
    for windowed in (False, True):
        relax_r = sdf.march_relax(windowed, occlusion=False)
        relax_s = sdf.march_relax(windowed, occlusion=True)
        relax += [relax_r, relax_s, (1.0 - relax_r) * relax_r, (1.0 - relax_s) * relax_s]
    header = torch.tensor([0.0] + relax + [0.0, 0.0, 0.0], dtype=torch.float32, device=dev)
    header[0] = scene.arrays.constants.elapsed_time
    params = torch.cat([header] + [b.reshape(-1).to(torch.float32) for b in blocks])

    ints = [g, m, static["plane_gid"], int(layout.has_plane), int(layout.material_ids is not None),
            int(layout.step_budgets is not None), 0, 0]
    for i, (kind, code) in enumerate(static["geoms"]):
        natural = layout.step_budgets[i] if layout.step_budgets else SDF_MAX_STEPS
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
    layout_buf = torch.tensor(ints, dtype=torch.int32, device=dev)
    return FramePack(params=params.contiguous(), layout=layout_buf, num_geometries=g,
                     num_materials=m, tri=tri, tri_offsets=tri_offsets)


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


def check_shared(kernel: str, g: int, m: int, *, shading: bool) -> None:
    """Raise, naming the kernel, for a scene whose buffers do not fit in a
    block's shared memory."""
    nbytes = shared_bytes(g, m, shading=shading)
    if nbytes > SHARED_BYTES_MAX:
        raise ValueError(
            f"{kernel}: {g} geometries and {m} materials need {nbytes} bytes of shared "
            f"memory a block, over the {SHARED_BYTES_MAX} a block can take")


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
                       max_depth: int = MAX_RAY_RECURSION_DEPTH):
    """The kernel's plain PyTorch version on the same packed inputs: the
    wavefront (render/trace.render_wavefront) with plain traversal passes
    on the unpacked scene, on the pack's device."""
    from gpuraytracer_tpu_torch.render import trace

    return trace.render_wavefront(unpack_frame(pack), width, height, max_depth=max_depth,
                                  plain=True)


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


def ops_pointer(ops):
    """The device address of an op counter ((1,) int64 CUDA tensor, read
    by a counting build of a kernel) or NULL."""
    if ops is None:
        return ctypes.c_void_p(None)
    if ops.dtype != torch.int64 or ops.numel() != 1 or ops.device.type != "cuda":
        raise ValueError("ops must be a (1,) int64 CUDA tensor")
    return ctypes.c_void_p(ops.data_ptr())


def render_frame_tiles(pack: FramePack, *, width: int, height: int,
                       max_depth: int = MAX_RAY_RECURSION_DEPTH, lib=None, ops=None):
    """(H, W, 4) f32 radiance image of the packed frame.

    CUDA: launches csrc/frame_kernel.cu on the current stream (``lib``: a
    loaded build of it, default the shipped one; ``ops``: the counter a
    counting build adds to) and counts the launch in LAUNCHES. CPU: runs
    ``render_frame_plain``."""
    global LAUNCHES
    check_pack(pack)
    dev = pack.params.device
    if dev.type == "cpu":
        return render_frame_plain(pack, width=width, height=height, max_depth=max_depth)
    if dev.type != "cuda":
        raise ValueError(f"no frame kernel for device {dev}")
    if width <= 0 or height <= 0 or not 1 <= max_depth <= 8:
        raise ValueError(f"bad frame size {width}x{height} or depth {max_depth}")
    if pack.num_materials > MAX_MATERIALS:
        raise ValueError(f"{pack.num_materials} materials: the frame kernel takes at most "
                         f"{MAX_MATERIALS} (render_frame routes such scenes to the wavefront)")
    check_shared("frame kernel", pack.num_geometries, pack.num_materials, shading=True)
    from gpuraytracer_tpu_torch.kernels import build

    lib = lib if lib is not None else build.load("frame_kernel")
    out = torch.empty((height, width, 4), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.gprt_frame_render(
        ctypes.c_void_p(pack.params.data_ptr()), ctypes.c_void_p(pack.layout.data_ptr()),
        ctypes.c_void_p(pack.tri.data_ptr()), ctypes.c_void_p(out.data_ptr()), width, height, max_depth,
        pack.num_geometries, pack.num_materials, ops_pointer(ops), dev.index,
        ctypes.c_void_p(stream),
    )
    if rc != 0:
        raise RuntimeError(f"frame kernel launch failed: CUDA error {rc} "
                           f"({lib.gprt_error_string(rc).decode()})")
    LAUNCHES += 1
    return out
