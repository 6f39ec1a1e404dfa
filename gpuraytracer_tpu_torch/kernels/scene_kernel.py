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
from gpuraytracer_tpu_torch.core.types import RAY_TMIN, SDF_MAX_STEPS, IntersectorKind
from gpuraytracer_tpu_torch.geometry import analytic, registry
from gpuraytracer_tpu_torch.kernels import frame_kernel

# Kernel launches since import (or since a caller reset it); PROBE_LAUNCHES
# counts the check-only distance probe (``sdf_distance``) apart.
LAUNCHES = 0
PROBE_LAUNCHES = 0


def scene_closest_plain(scene: Scene, o_blas, d_blas, active, t0, *, level: int = 0,
                        accept_first: bool = False, cull_backface: bool = True,
                        budget_level: int | None = None, march=None, mesh_closest=None):
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
    for i, (kind, prim_type) in enumerate(zip(layout.kinds, layout.prim_types)):
        gate = analytic.aabb_hit_mask(o_blas, d_blas, arrays.aabb_min[i], arrays.aabb_max[i],
                                      t_min=RAY_TMIN, t_max=best_t) & active
        if accept_first:
            gate = gate & (gid < 0)
        o_loc, d_loc = ray_to_local(o_blas, d_blas, tr.blas_to_local[i])
        hit, t, n_loc = registry.intersect(
            kind, prim_type, o_loc, d_loc, t_min=RAY_TMIN, t_max=best_t, active=gate,
            cull_backface=True if accept_first else cull_backface,
            step_scale=step_scales[i], elapsed_time=arrays.constants.elapsed_time,
            natural_budget=layout.step_budgets[i] if layout.step_budgets else SDF_MAX_STEPS,
            occlusion=accept_first, level=march_level, with_normal=not accept_first,
            mesh=arrays.meshes[prim_type] if kind == IntersectorKind.TRIANGLE else None,
            march=march, mesh_closest=mesh_closest,
        )
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
