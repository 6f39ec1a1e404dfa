"""The per-geometry route's kernels (csrc/megakernel.cu).

``route_pass`` is the route's pass entry (``accel/traverse.
per_geometry_route`` on a GPU, for a scene past
``accel/traverse.TRI_FACE_TOTAL_CAP`` mesh faces): one launch per closest
or occlusion pass, one thread per ray running the whole route, every
geometry in definition order at the level-0 budgets, with the mesh faces
staged in shared memory and whole chunks of faces skipped. Its plain
version, ``route_pass_plain``, is the route's loop as the reference's TPU
runs it: one march call per SDF geometry and one mesh call per mesh over
every ray of the pass.

``sphere_trace_tiles`` replaces the reference's per-geometry Pallas march
(gpuraytracer_tpu/kernels/megakernel.py: sphere_trace_tiles /
_tile_march_kernel): one SDF geometry's sphere trace over (N,) local rays
behind a gate, with the call's static march spec, and the tetrahedral
normal at the hit; on the card one thread per ray with the march
specialized on its distance code (``build.load("megakernel",
defines=GENERIC_DEFINES)`` is the generic march, which switches over every
code a sample, for checks). ``trimesh_closest`` is the same library's mesh
entry:
one mesh's closest face for each gated ray (the reference runs it in XLA,
geometry/trimesh.intersect_trimesh), with the pass entry's face loop.
These two keep the reference's one-geometry API; no render path launches
them.

Each wrapper launches its kernel on a CUDA tensor and counts the launch
(PASS_LAUNCHES, LAUNCHES, MESH_LAUNCHES); on a CPU tensor it runs its plain
version (``route_pass_plain``, ``sphere_trace_plain``,
``trimesh_closest_plain``); any other device raises.
"""

from __future__ import annotations

import ctypes

import torch

from gpuraytracer_tpu_torch.core.types import SDF_MAX_STEPS
from gpuraytracer_tpu_torch.geometry import sdf, trimesh
from gpuraytracer_tpu_torch.kernels import frame_kernel

# Kernel launches since import (or since a caller reset it): the pass
# entry, the march kernel and the mesh entry, apart.
PASS_LAUNCHES = 0
LAUNCHES = 0
MESH_LAUNCHES = 0

# The -D macro of the one-geometry march with the generic march (a switch
# over every distance code a sample): a build that checks hold the shipped
# one to.
GENERIC_DEFINES = ("GPRT_SPHERE_MARCH_GENERIC",)

# Faces per chunk of the face loop's skip (csrc/megakernel.cu kChunk).
FACE_CHUNK = 16


def _check(n, **tensors):
    shapes = {"o": (n, 3), "d": (n, 3), "gate": (n,), "t_max": (n,), "t_start": (n,)}
    dev = tensors["o"].device
    for name, x in tensors.items():
        if x is None:
            continue
        dtype = torch.bool if name == "gate" else torch.float32
        if tuple(x.shape) != shapes[name] or x.dtype != dtype:
            raise ValueError(f"{name}: expected {shapes[name]} {dtype}, got {tuple(x.shape)} "
                             f"{x.dtype}")
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, o on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no megakernel for device {dev}")
    return dev


def sphere_trace_plain(o, d, gate, t_max, step_scale, *, prim_code: int,
                       cull_backface: bool = True, max_steps: int = SDF_MAX_STEPS,
                       t_start=None, relax: float = 1.0, capped_hit: bool = False):
    """The kernel's plain PyTorch version: geometry/sdf.march with the same
    static arguments (the escape bound for sdf.ESCAPE_SAFE_CODES only), a
    capped hit at t = 0 as the reference's kernel writes it, and the
    tetrahedral normal at each hit ((0, 0, 0) on a miss).

    Returns (hit (N,), t_hit (N,) with +inf on a miss, normal (N, 3))."""
    return sdf.march(o, d, gate, t_max, step_scale, prim_code=prim_code,
                     cull_backface=cull_backface, max_steps=max_steps, t_start=t_start,
                     relax=relax, capped_hit=capped_hit, capped_t=0.0)


def _ptr(x):
    return ctypes.c_void_p(None if x is None else x.data_ptr())


def _raise_on(rc, lib, what):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({lib.gprt_error_string(rc).decode()})")


def sphere_trace_tiles(o, d, gate, t_max, step_scale, *, prim_code: int,
                       cull_backface: bool = True, max_steps: int = SDF_MAX_STEPS,
                       t_start=None, relax: float = 1.0, capped_hit: bool = False,
                       lib=None, ops=None):
    """(hit, t_hit, normal) of one SDF geometry's march over (N, 3) local
    rays o, d with gate (N,) bool, t_max and t_start (N,) f32 (t_start None:
    march from 0) and a scalar step_scale; see ``sphere_trace_plain``.

    CUDA: launches csrc/megakernel.cu's march on the current stream
    (``lib``: a loaded build, default the shipped one; ``ops``: the
    counters a counting build adds to, -DGPRT_COUNT_SIMT:
    ``MARCH_SIMT_COUNTERS`` of them, read by ``march_simt``) and counts it
    in LAUNCHES. CPU: runs ``sphere_trace_plain``."""
    global LAUNCHES
    n = o.shape[0]
    dev = _check(n, o=o, d=d, gate=gate, t_max=t_max, t_start=t_start)
    kw = dict(prim_code=prim_code, cull_backface=cull_backface, max_steps=max_steps,
              t_start=t_start, relax=relax, capped_hit=capped_hit)
    if dev.type == "cpu":
        return sphere_trace_plain(o, d, gate, t_max, step_scale, **kw)
    code = int(prim_code)
    if code not in sdf.DISTANCE_FUNCTIONS or not 0 <= code <= 8:
        raise ValueError(f"distance code {code} has no device function")
    t_hit = torch.empty(n, dtype=torch.float32, device=dev)
    normal = torch.empty(n, 3, dtype=torch.float32, device=dev)
    if n == 0:
        return torch.isfinite(t_hit), t_hit, normal
    from gpuraytracer_tpu_torch.kernels import build

    lib = lib if lib is not None else build.load("megakernel")
    o, d, gate, t_max = o.contiguous(), d.contiguous(), gate.contiguous(), t_max.contiguous()
    t_start = None if t_start is None else t_start.contiguous()
    relax = float(relax)
    rc = lib.gprt_sphere_trace(
        _ptr(o), _ptr(d), _ptr(gate), _ptr(t_max), _ptr(t_start), _ptr(t_hit), _ptr(normal), n,
        code, float(step_scale), int(max_steps), relax, (1.0 - relax) * relax, int(capped_hit),
        int(cull_backface), int(code in sdf.ESCAPE_SAFE_CODES), frame_kernel.ops_pointer(ops),
        dev.index, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(rc, lib, "megakernel march")
    LAUNCHES += 1
    return torch.isfinite(t_hit), t_hit, normal


# Counters of a -DGPRT_COUNT_SIMT build's march entry: the SIMT counters
# (frame_kernel.SIMT_COUNTERS), then the launch's longest march in samples
# (0 in the generic march's build).
MARCH_SIMT_COUNTERS = frame_kernel.SIMT_COUNTERS + 1


def march_simt(counts) -> dict:
    """From the MARCH_SIMT_COUNTERS counters of a -DGPRT_COUNT_SIMT build's
    march entry: "simt" (the lanes marching at each march sample over 32),
    "samples" (every gated ray's march samples, summed), "warp_samples"
    and "max_samples" (the longest march's)."""
    c = [int(x) for x in counts.tolist()]
    lanes = sum(c[0:2 * frame_kernel.SIMT_BUCKETS:2])
    warps = c[2 * frame_kernel.SIMT_BUCKETS]
    return {"simt": lanes / (32 * warps) if warps else 0.0, "samples": lanes,
            "warp_samples": warps, "max_samples": c[2 * frame_kernel.SIMT_BUCKETS + 1]}


def sphere_residency(device, code: int, *, lib=None) -> tuple:
    """(blocks per SM, blocks in all) of the march kernel for distance code
    ``code`` that the card keeps resident (the loaded build's); launches
    nothing."""
    from gpuraytracer_tpu_torch.kernels import build

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"no megakernel for device {device}")
    lib = lib if lib is not None else build.load("megakernel")
    per_sm, total = ctypes.c_int(0), ctypes.c_int(0)
    index = device.index if device.index is not None else torch.cuda.current_device()
    _raise_on(lib.gprt_sphere_residency(int(code), index, ctypes.byref(per_sm),
                                        ctypes.byref(total)), lib, "megakernel march residency")
    return per_sm.value, total.value


def trimesh_closest_plain(rows, o, d, gate, t_max, *, cull_backface: bool = True):
    """The mesh entry's plain version: geometry/trimesh.intersect_trimesh
    over the gated lanes of (N, 3) local rays against one mesh's (F, 12)
    face rows. Returns (hit, t with +inf on a miss, local normal, zero on a
    miss)."""
    mesh = trimesh.TriangleMesh(v0=rows[:, 0:3], e1=rows[:, 3:6], e2=rows[:, 6:9],
                                n=rows[:, 9:12])
    return trimesh.intersect_trimesh(o, d, mesh, t_min=0.0, t_max=t_max,
                                     cull_backface=cull_backface, active=gate)


def trimesh_closest(rows, o, d, gate, t_max, *, cull_backface: bool = True, lib=None,
                    ops=None):
    """(hit, t, local normal) of one mesh's closest face for each gated ray;
    see ``trimesh_closest_plain``. ``rows``: the mesh's (F, 12) f32 rows of
    the face table. CUDA: launches csrc/megakernel.cu's mesh entry and
    counts it in MESH_LAUNCHES (``lib``: a loaded build, default the shipped
    one; build.load(faces_global=True) is the unculled face loop); CPU: runs
    ``trimesh_closest_plain``."""
    global MESH_LAUNCHES
    n = o.shape[0]
    dev = _check(n, o=o, d=d, gate=gate, t_max=t_max)
    if rows.dim() != 2 or rows.shape[1] != 12 or rows.dtype != torch.float32:
        raise ValueError(f"rows: expected (F, 12) float32, got {tuple(rows.shape)} {rows.dtype}")
    if rows.device != dev:
        raise ValueError(f"rows on {rows.device}, o on {dev}")
    if dev.type == "cpu":
        return trimesh_closest_plain(rows, o, d, gate, t_max, cull_backface=cull_backface)
    t_hit = torch.empty(n, dtype=torch.float32, device=dev)
    normal = torch.empty(n, 3, dtype=torch.float32, device=dev)
    if n == 0:
        return torch.isfinite(t_hit), t_hit, normal
    from gpuraytracer_tpu_torch.kernels import build

    lib = lib if lib is not None else build.load("megakernel")
    rows = _aligned(rows.contiguous())
    o, d, gate, t_max = o.contiguous(), d.contiguous(), gate.contiguous(), t_max.contiguous()
    rc = lib.gprt_trimesh(
        _ptr(rows), rows.shape[0], _ptr(o), _ptr(d), _ptr(gate), _ptr(t_max), _ptr(t_hit),
        _ptr(normal), n, int(cull_backface), frame_kernel.ops_pointer(ops), dev.index,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(rc, lib, "megakernel mesh entry")
    MESH_LAUNCHES += 1
    return torch.isfinite(t_hit), t_hit, normal


def _aligned(rows):
    """rows, or a copy of them where their address is not 16-byte aligned
    (the bulk copy's rule; a slice of the face table may start anywhere)."""
    return rows if rows.data_ptr() % 16 == 0 else rows.clone()


def route_pass_plain(scene, o_blas, d_blas, active, t0, *, level: int = 0,
                     accept_first: bool = False, cull_backface: bool = True):
    """The pass entry's plain version: the per-geometry route as the
    reference's TPU runs it (accel/traverse.py:337-395, 444-479, with
    _dispatch_procedural, :128-175), which is kernels/scene_kernel.
    scene_closest_plain at the level-0 budget for every ``level`` (the route
    has no bounce cap), with ``sphere_trace_plain`` for every SDF march and
    ``trimesh_closest_plain`` for every mesh, each called once per geometry
    over all the pass's rays behind its gate. Returns (best_t, normal, gid)
    as scene_closest_plain does."""
    from gpuraytracer_tpu_torch.kernels import scene_kernel

    return scene_kernel.scene_closest_plain(
        scene, o_blas, d_blas, active, t0, level=level, accept_first=accept_first,
        cull_backface=cull_backface, budget_level=0, march=sphere_trace_plain,
        mesh_closest=trimesh_closest_plain)


def _route_setup(pack, lib):
    """(tables in shared memory, the face table or None, its largest mesh's
    face count, the library) of a pass-entry launch."""
    from gpuraytracer_tpu_torch.kernels import build

    frame_kernel.check_pack(pack)
    shared = frame_kernel.tables_in_shared(pack.num_geometries, pack.num_materials,
                                           shading=False)
    tri = _aligned(pack.tri) if pack.tri.numel() else None
    largest = max((c for _, c in pack.tri_offsets), default=0)
    return int(shared), tri, largest, lib if lib is not None else build.load("megakernel")


def route_pass(scene, o_blas, d_blas, active, t0, *, level: int = 0,
               accept_first: bool = False, cull_backface: bool = True, pack=None, lib=None,
               ops=None):
    """(best_t, normal, gid) of one pass of the per-geometry route over
    (N, 3) BLAS-space rays, as ``route_pass_plain`` gives them (``level``
    changes nothing: the route marches every level at the level-0 budget).

    CUDA: one launch of csrc/megakernel.cu's pass entry on the current
    stream, over the buffers of ``pack`` (default frame_kernel.
    pack_frame(scene); the wavefront passes the frame's), counted in
    PASS_LAUNCHES; ``lib``: a loaded build (default the shipped one;
    build.load(faces_global=True) is the unculled face loop, which stages
    nothing); ``ops``: the counters of a counting build
    (-DGPRT_COUNT_OPS: FLOPs; -DGPRT_COUNT_SIMT: ``route_simt``). No host
    sync. CPU: runs ``route_pass_plain``."""
    global PASS_LAUNCHES
    from gpuraytracer_tpu_torch.kernels import scene_kernel

    scene_kernel._check_rays(o_blas, d_blas, active, t0)
    dev, n = o_blas.device, o_blas.shape[0]
    if dev.type == "cpu":
        return route_pass_plain(scene, o_blas, d_blas, active, t0, level=level,
                                accept_first=accept_first, cull_backface=cull_backface)
    if dev.type != "cuda":
        raise ValueError(f"no megakernel for device {dev}")
    pack = pack if pack is not None else frame_kernel.pack_frame(scene)
    if pack.params.device != dev:
        raise ValueError(f"pack on {pack.params.device}, rays on {dev}")
    best_t = torch.empty(n, dtype=torch.float32, device=dev)
    normal = torch.empty(n, 3, dtype=torch.float32, device=dev)
    gid = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return best_t, normal, gid
    shared, tri, largest, lib = _route_setup(pack, lib)
    o_blas, d_blas = o_blas.contiguous(), d_blas.contiguous()
    active, t0 = active.contiguous(), t0.contiguous()
    rc = lib.gprt_route_pass(
        _ptr(pack.params), _ptr(pack.layout), _ptr(tri), _ptr(o_blas), _ptr(d_blas),
        _ptr(active), _ptr(t0), _ptr(best_t), _ptr(normal), _ptr(gid), n, pack.num_geometries,
        pack.num_materials, largest, shared, int(accept_first), int(cull_backface),
        frame_kernel.ops_pointer(ops), dev.index,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(rc, lib, "megakernel pass entry")
    PASS_LAUNCHES += 1
    return best_t, normal, gid


def route_residency(pack, *, lib=None) -> tuple:
    """(blocks per SM, blocks in all) of the pass entry that the card keeps
    resident for the packed scene, as ``route_pass`` launches it (its
    dynamic shared memory: the tables and the staging area); launches
    nothing."""
    dev = pack.params.device
    if dev.type != "cuda":
        raise ValueError(f"no megakernel for device {dev}")
    shared, _, largest, lib = _route_setup(pack, lib)
    per_sm, total = ctypes.c_int(0), ctypes.c_int(0)
    _raise_on(lib.gprt_route_residency(pack.num_geometries, pack.num_materials, largest, shared,
                                       dev.index, ctypes.byref(per_sm), ctypes.byref(total)),
              lib, "megakernel pass entry residency")
    return per_sm.value, total.value


def route_simt(counts) -> dict:
    """SIMT efficiency from the counters of a -DGPRT_COUNT_SIMT build of the
    pass or mesh entry: "march" (the lanes marching at each march sample
    over 32), "faces" (the lanes testing each face over 32) and "faces
    needed" (of those, the lanes whose ray needs the face's chunk), each
    with its lane-samples and warp-samples."""
    c = [int(x) for x in counts.tolist()]
    lanes = [c[2 * b] for b in range(6)]
    warps = [c[2 * b + 1] / 2 ** frame_kernel.SIMT_SHIFT for b in range(6)]

    def eff(ls, ws):
        return (sum(ls) / (32 * sum(ws)) if sum(ws) else 0.0, sum(ls), sum(ws))

    face_w = warps[2:6]
    return {"march": eff(lanes[0:2], warps[0:2]), "faces": eff(lanes[2:6], face_w),
            "faces needed": eff(lanes[2:4], face_w)}
