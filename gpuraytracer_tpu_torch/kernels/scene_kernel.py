"""One traversal pass over every procedural geometry in one hand-written
CUDA kernel (csrc/scene_kernel.cu).

Replaces the reference's Pallas scene kernel
(gpuraytracer_tpu/kernels/scene_kernel.py: scene_closest_tiles /
_scene_kernel, phase "single"): BLAS-space rays with an initial bound t0
in, the closest procedural hit (best_t, world normal, geometry id) out,
or accept-first occlusion. The plane stays in PyTorch (accel/traverse.py),
which sets t0: the plane's t where it hits, else RAY_TMAX, for a closest
pass; 0 for plane-occluded lanes (which go in inactive) and RAY_TMAX for
the rest, for an occlusion pass.

One CUDA thread traces one ray over flat (N,) rays, with the device code
the frame kernel runs (csrc/traverse.cuh), reading the buffers
``frame_kernel.pack_frame`` builds. On a CPU tensor the wrapper runs the
plain version below, the per-geometry loop of the wavefront; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from gpuraytracer_tpu_torch.accel.instances import Scene, normal_to_world, ray_to_local
from gpuraytracer_tpu_torch.core.types import RAY_TMAX, RAY_TMIN, SDF_MAX_STEPS, IntersectorKind
from gpuraytracer_tpu_torch.geometry import analytic, registry
from gpuraytracer_tpu_torch.kernels import frame_kernel

# Kernel launches since import (or since a caller reset it); PROBE_LAUNCHES
# counts the check-only distance probe (``sdf_distance``) apart, and
# QUEUE_LAUNCHES the occlusion repair queue's kernel (``shadow_queue``).
LAUNCHES = 0
PROBE_LAUNCHES = 0
QUEUE_LAUNCHES = 0


def dirty_bit(g: int) -> int:
    """Geometry -> bit of the dirty mask (scene_kernel._dirty_bit):
    geometries past 31 share bit 31."""
    return 1 << min(g, 31)


def scene_closest_plain(scene: Scene, o_blas, d_blas, active, t0, *, level: int = 0,
                        accept_first: bool = False, cull_backface: bool = True,
                        budget_level: int | None = None, march=None, mesh_closest=None,
                        budget_cap: int | None = None, mb_budget_cap: int | None = None,
                        dirty=None, kill_on_cap: bool = False):
    """The kernel's plain PyTorch version: every procedural geometry in
    definition order, each gated by its BLAS-space slab against the
    running best t, with a strict-< closest reduction. accept_first: a
    lane's first valid hit ends its search (its best_t drops to 0);
    back-face culling stays on.

    The same loop is the per-geometry route (accel/traverse.
    per_geometry_route): ``budget_level`` marches every pass at that
    level's budget instead of ``level``'s; ``march`` and ``mesh_closest``
    run the SDF marches and the meshes (geometry/registry.intersect), one
    call per geometry over all N rays behind its gate.

    The capped traversal of the compacted frame modes' main passes
    (scene_kernel._traverse_tile with budget_cap, dirty_ref, kill_on_cap):
    ``budget_cap`` / ``mb_budget_cap`` cap the SDF / metaball marches
    (sdf.march_budget's ``cap``); ``dirty``, an (N,) int32 mask updated
    in place, takes ``dirty_bit(g)`` for every lane whose march of
    geometry g ran out of a capped budget (sdf.cap_marks_dirty); with
    ``kill_on_cap`` a lane whose mask is not 0 passes no further gate.
    A lane that no cap touched gets what the uncapped pass gives it: a
    capped march that resolves is a strict prefix of the full one.

    Returns (best_t (N,) f32, normal (N, 3) f32 world space, gid (N,)
    int32); gid is -1 where no procedural hit beat t0."""
    layout, arrays = scene.layout, scene.arrays
    n = o_blas.shape[0]
    dev = o_blas.device
    best_t = t0.clone()
    normal = torch.zeros_like(o_blas)
    gid = torch.full((n,), -1, dtype=torch.int32, device=dev)
    tr = arrays.transforms
    step_scales = arrays.materials.step_scale.tolist()
    march_level = level if budget_level is None else budget_level
    caps = {}
    if dirty is not None:
        caps = dict(budget_cap=budget_cap, mb_budget_cap=mb_budget_cap, return_capped=True)
    elif budget_cap is not None or mb_budget_cap is not None:
        raise ValueError("a capped traversal needs a dirty mask")
    for i, (kind, prim_type) in enumerate(zip(layout.kinds, layout.prim_types)):
        gate = analytic.aabb_hit_mask(o_blas, d_blas, arrays.aabb_min[i], arrays.aabb_max[i],
                                      t_min=RAY_TMIN, t_max=best_t) & active
        if accept_first:
            gate = gate & (gid < 0)
        if kill_on_cap and dirty is not None:
            gate = gate & (dirty == 0)
        o_loc, d_loc = ray_to_local(o_blas, d_blas, tr.blas_to_local[i])
        hit, t, n_loc, *capped = registry.intersect(
            kind, prim_type, o_loc, d_loc, t_min=RAY_TMIN, t_max=best_t, active=gate,
            cull_backface=True if accept_first else cull_backface,
            step_scale=step_scales[i], elapsed_time=arrays.constants.elapsed_time,
            natural_budget=layout.step_budgets[i] if layout.step_budgets else SDF_MAX_STEPS,
            occlusion=accept_first, level=march_level, with_normal=not accept_first,
            mesh=arrays.meshes[prim_type] if kind == IntersectorKind.TRIANGLE else None,
            march=march, mesh_closest=mesh_closest, **caps,
        )
        if capped:
            dirty.bitwise_or_(torch.where(capped[0], dirty_bit(i), 0).to(torch.int32))
        if accept_first:
            # Any valid (or capped) hit occludes, whatever its t.
            win = hit
            best_t = torch.where(win, 0.0, best_t)
        else:
            win = hit & (t < best_t)
            best_t = torch.where(win, t, best_t)
            normal = torch.where(win[:, None], normal_to_world(n_loc, tr.local_to_blas[i]),
                                 normal)
        gid = torch.where(win, i, gid)
    return best_t, normal, gid


def _check_rays(o_blas, d_blas, active, t0):
    n = o_blas.shape[0]
    for name, x, shape, dtype in (("o_blas", o_blas, (n, 3), torch.float32),
                                  ("d_blas", d_blas, (n, 3), torch.float32),
                                  ("active", active, (n,), torch.bool),
                                  ("t0", t0, (n,), torch.float32)):
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got {tuple(x.shape)} {x.dtype}")
        if x.device != o_blas.device:
            raise ValueError(f"{name} on {x.device}, o_blas on {o_blas.device}")


def scene_closest_tiles(scene: Scene, o_blas, d_blas, active, t0, *, level: int = 0,
                        accept_first: bool = False, cull_backface: bool = True,
                        pack: frame_kernel.FramePack | None = None, lib=None, ops=None):
    """(best_t, normal, gid) of one traversal pass over (N, 3) BLAS-space
    rays; see ``scene_closest_plain`` for the semantics.

    CUDA: launches csrc/scene_kernel.cu on the current stream over the
    buffers of ``pack`` (default: ``frame_kernel.pack_frame(scene)``; pass
    one to reuse it across the passes of a frame; ``lib``, ``ops`` as for
    frame_kernel.render_frame_tiles) and counts the launch in LAUNCHES.
    CPU: runs ``scene_closest_plain``."""
    global LAUNCHES
    _check_rays(o_blas, d_blas, active, t0)
    dev = o_blas.device
    if dev.type == "cpu":
        return scene_closest_plain(scene, o_blas, d_blas, active, t0, level=level,
                                   accept_first=accept_first, cull_backface=cull_backface)
    if dev.type != "cuda":
        raise ValueError(f"no scene kernel for device {dev}")
    pack = pack if pack is not None else frame_kernel.pack_frame(scene)
    frame_kernel.check_pack(pack)
    if pack.params.device != dev:
        raise ValueError(f"pack on {pack.params.device}, rays on {dev}")
    frame_kernel.check_shared("scene kernel", pack.num_geometries, pack.num_materials,
                              shading=False)
    n = o_blas.shape[0]
    best_t = torch.empty(n, dtype=torch.float32, device=dev)
    normal = torch.empty(n, 3, dtype=torch.float32, device=dev)
    gid = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return best_t, normal, gid
    from gpuraytracer_tpu_torch.kernels import build

    lib = lib if lib is not None else build.load("scene_kernel")
    o_blas, d_blas = o_blas.contiguous(), d_blas.contiguous()
    active, t0 = active.contiguous(), t0.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ptr(x):
        return ctypes.c_void_p(x.data_ptr())

    rc = lib.gprt_scene_closest(
        ptr(pack.params), ptr(pack.layout), ptr(pack.tri), ptr(o_blas), ptr(d_blas), ptr(active), ptr(t0),
        ptr(best_t), ptr(normal), ptr(gid), n, pack.num_geometries, pack.num_materials,
        int(level), int(accept_first), int(cull_backface), frame_kernel.ops_pointer(ops),
        dev.index, ctypes.c_void_p(stream),
    )
    if rc != 0:
        raise RuntimeError(f"scene kernel launch failed: CUDA error {rc} "
                           f"({lib.gprt_error_string(rc).decode()})")
    LAUNCHES += 1
    return best_t, normal, gid


def sdf_distance(code: int, points, lib=None):
    """(N,) distances of SDF code ``code`` at (N, 3) f32 local-space points:
    a check entry (no render path calls it) that holds the device distance
    functions against their plain versions point by point. CUDA: launches
    the probe kernel of csrc/scene_kernel.cu and counts it in
    PROBE_LAUNCHES; CPU: geometry/sdf.DISTANCE_FUNCTIONS[code]."""
    global PROBE_LAUNCHES
    from gpuraytracer_tpu_torch.geometry import sdf

    if points.dim() != 2 or points.shape[1] != 3 or points.dtype != torch.float32:
        raise ValueError(f"points: expected (N, 3) float32, got {tuple(points.shape)} "
                         f"{points.dtype}")
    if int(code) not in frame_kernel.KERNEL_SDF_CODES:
        raise ValueError(f"distance code {code} has no device function")
    dev = points.device
    if dev.type == "cpu":
        return sdf.DISTANCE_FUNCTIONS[int(code)](points)
    if dev.type != "cuda":
        raise ValueError(f"no scene kernel for device {dev}")
    from gpuraytracer_tpu_torch.kernels import build

    lib = lib if lib is not None else build.load("scene_kernel")
    points = points.contiguous()
    out = torch.empty(points.shape[0], dtype=torch.float32, device=dev)
    if points.shape[0] == 0:
        return out
    rc = lib.gprt_sdf_distance(int(code), ctypes.c_void_p(points.data_ptr()),
                               ctypes.c_void_p(out.data_ptr()), points.shape[0], dev.index,
                               ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"distance probe launch failed: CUDA error {rc} "
                           f"({lib.gprt_error_string(rc).decode()})")
    PROBE_LAUNCHES += 1
    return out


def shadow_queue_plain(pack: frame_kernel.FramePack, rays, active, seg: int):
    """Plain version of the occlusion repair (``shadow_queue``): each
    segment of ``seg`` queue entries is one accept-first
    ``scene_closest_plain`` pass at its level's plain budgets, from t = 0
    to RAY_TMAX, on the scene unpacked from the pack."""
    scene = frame_kernel.unpack_frame(pack)
    occ = torch.zeros(rays.shape[0], dtype=torch.int32, device=rays.device)
    t0 = torch.full((seg,), RAY_TMAX, dtype=torch.float32, device=rays.device)
    for k in range(rays.shape[0] // seg):
        part = slice(k * seg, (k + 1) * seg)
        _, _, gid = scene_closest_plain(scene, rays[part, :3], rays[part, 3:], active[part], t0,
                                        level=k, accept_first=True)
        occ[part] = ((gid >= 0) & active[part]).to(torch.int32)
    return occ


def shadow_queue(pack: frame_kernel.FramePack, rays, active, seg: int, lib=None, ops=None):
    """The deferred-shadow mode's occlusion repair (the reference's
    _shadow_queue_kernel, frame_kernel.py:1016): (N,) int32, 1 where the
    queued shadow ray is occluded. ``rays`` (N, 6) f32 (BLAS-space origin,
    direction) and ``active`` (N,) bool hold one segment of ``seg``
    entries per shadowed level, in level order; an entry's level is its
    index // seg, and its occlusion query runs at full budgets with that
    level's knobs. CUDA: the queue entry of csrc/scene_kernel.cu, one
    thread per entry (counted in QUEUE_LAUNCHES); CPU: the plain
    version."""
    global QUEUE_LAUNCHES
    n = rays.shape[0]
    dev = rays.device
    if rays.dtype != torch.float32 or rays.dim() != 2 or rays.shape[1] != 6 \
            or not rays.is_contiguous():
        raise ValueError(f"rays: expected a contiguous (N, 6) float32 tensor, got "
                         f"{tuple(rays.shape)} {rays.dtype}")
    if active.dtype != torch.bool or tuple(active.shape) != (n,) or active.device != dev \
            or not active.is_contiguous():
        raise ValueError(f"active: expected a contiguous ({n},) bool tensor on {dev}")
    if seg <= 0 or n % seg:
        raise ValueError(f"{n} queue entries are not whole segments of {seg}")
    frame_kernel.check_pack(pack)
    if pack.params.device != dev:
        raise ValueError(f"pack on {pack.params.device}, rays on {dev}")
    if dev.type == "cpu":
        return shadow_queue_plain(pack, rays, active, seg)
    if dev.type != "cuda":
        raise ValueError(f"no scene kernel for device {dev}")
    frame_kernel.check_shared("scene kernel", pack.num_geometries, pack.num_materials,
                              shading=False)
    from gpuraytracer_tpu_torch.kernels import build

    lib = lib if lib is not None else build.load("scene_kernel")
    occ = torch.empty(n, dtype=torch.int32, device=dev)
    rc = lib.gprt_shadow_queue(
        ctypes.c_void_p(pack.params.data_ptr()), ctypes.c_void_p(pack.layout.data_ptr()),
        ctypes.c_void_p(pack.tri.data_ptr()), ctypes.c_void_p(rays.data_ptr()),
        ctypes.c_void_p(active.data_ptr()), ctypes.c_void_p(occ.data_ptr()), n, seg,
        pack.num_geometries, pack.num_materials, frame_kernel.ops_pointer(ops), dev.index,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"shadow queue kernel launch failed: CUDA error {rc} "
                           f"({lib.gprt_error_string(rc).decode()})")
    QUEUE_LAUNCHES += 1
    return occ
