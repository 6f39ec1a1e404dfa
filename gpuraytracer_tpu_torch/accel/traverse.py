"""Scene traversal: closest-hit and any-hit (occlusion) queries.

Port of gpuraytracer_tpu/accel/traverse.py (the XLA wavefront path): the
plane closed form, then every procedural geometry in definition order,
each gated by a slab test of its BLAS-space AABB against the running best
t (the shrinking RayTCurrent), with a strict-< closest reduction. Shadow
rays use accept-first semantics (Raytracing.hlsl:115-147): any valid hit
occludes, and back-face culling stays on.

Rays are (N, 3); every per-geometry intersector runs only on the lanes
its gate admits.
"""

from __future__ import annotations

import torch

from gpuraytracer_tpu_torch.accel.instances import (
    Scene,
    normal_to_world,
    ray_to_blas,
    ray_to_local,
)
from gpuraytracer_tpu_torch.core.types import (
    AnalyticPrimitive,
    HitRecord,
    IntersectorKind,
    RAY_TMAX,
    RAY_TMIN,
    SDF_MAX_STEPS,
)
from gpuraytracer_tpu_torch.geometry import analytic, metaballs, sdf


def intersect_plane(origins, directions, plane_origin, plane_size, *, t_min, t_max):
    """Ground-plane quad y == plane_origin.y, x/z in [origin, origin+size]:
    two back-face-culled triangles tiling the rect exactly
    (Renderer.cpp:539-565, 742-765). Returns (hit, t)."""
    dy = directions[:, 1]
    t = -(origins[:, 1] - plane_origin[1]) / dy
    px = origins[:, 0] + t * directions[:, 0]
    pz = origins[:, 2] + t * directions[:, 2]
    inside = (
        (px >= plane_origin[0]) & (px <= plane_origin[0] + plane_size[0])
        & (pz >= plane_origin[2]) & (pz <= plane_origin[2] + plane_size[1])
    )
    hit = inside & (dy < 0.0) & (t >= t_min) & (t <= t_max)
    return hit, torch.where(hit, t, torch.inf)


def _dispatch_procedural(kind, prim_type, o_loc, d_loc, *, t_min, t_max, cull,
                         step_scale, elapsed_time, gate, occlusion=False, level=0,
                         with_normal=True):
    """Static dispatch to one geometry's intersector (the SBT analog,
    Raytracing.hlsl:289-341). Returns (hit, t, local normal or None)."""
    if kind == IntersectorKind.ANALYTIC:
        if prim_type == AnalyticPrimitive.AABB:
            return analytic.intersect_hollow_aabb(
                o_loc, d_loc, t_min=t_min, t_max=t_max, cull_backface=cull)
        if prim_type == AnalyticPrimitive.SPHERES:
            return analytic.intersect_spheres(
                o_loc, d_loc, t_min=t_min, t_max=t_max, cull_backface=cull)
    elif kind == IntersectorKind.VOLUMETRIC:
        return metaballs.intersect_metaballs(
            o_loc, d_loc, elapsed_time, t_min=t_min, t_max=t_max,
            cull_backface=cull, active=gate)
    elif kind == IntersectorKind.SIGNED_DISTANCE:
        budget, capped_hit = sdf.march_budget(SDF_MAX_STEPS, occlusion=occlusion,
                                              level=level)
        fn = sdf.DISTANCE_FUNCTIONS[int(prim_type)]
        hit, t = sdf.sphere_trace(
            o_loc, d_loc, fn, step_scale=step_scale, t_min=t_min, t_max=t_max,
            cull_backface=cull, active=gate, max_steps=budget,
            escape_bound=int(prim_type) in sdf.ESCAPE_SAFE_CODES,
            relax=sdf.relax_for_code(int(prim_type), occlusion=occlusion),
            capped_hit=capped_hit,
        )
        normal = None
        if with_normal:
            normal = torch.zeros_like(o_loc)
            if bool(hit.any()):
                hi = torch.nonzero(hit).squeeze(1)
                pos = o_loc[hi] + t[hi][:, None] * d_loc[hi]
                normal[hi] = sdf.calculate_normal(pos, fn)
        return hit, t, normal
    elif kind == IntersectorKind.TRIANGLE:
        raise NotImplementedError("triangle meshes are not ported yet")
    raise ValueError(f"no intersector for kind={kind} type={prim_type}")


def closest_hit(origins, directions, scene: Scene, *, t_min=RAY_TMIN, t_max=RAY_TMAX,
                cull_backface=True, active=None, level=0) -> HitRecord:
    """Closest hit over the plane + every procedural geometry; geometry_id
    indexes the material table (procedural 0..P-1, plane == P, miss -1)."""
    layout, arrays = scene.layout, scene.arrays
    n = origins.shape[0]
    dev = origins.device
    best_t = torch.full((n,), torch.inf, dtype=origins.dtype, device=dev)
    best_n = torch.zeros_like(origins)
    best_id = torch.full((n,), -1, dtype=torch.int64, device=dev)
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=dev)

    if layout.has_plane:
        hit_p, t_p = intersect_plane(origins, directions, arrays.plane_origin,
                                     arrays.plane_size, t_min=t_min, t_max=t_max)
        hit_p = hit_p & active
        best_t = torch.where(hit_p, t_p, best_t)
        best_n[hit_p, 1] = 1.0
        best_id[hit_p] = layout.plane_geometry_id

    o_blas, d_blas = ray_to_blas(origins, directions, arrays.blas_offset)
    tr = arrays.transforms
    for i, (kind, prim_type) in enumerate(zip(layout.kinds, layout.prim_types)):
        running = torch.clamp(best_t, max=t_max)
        gate = analytic.aabb_hit_mask(
            o_blas, d_blas, arrays.aabb_min[i], arrays.aabb_max[i],
            t_min=t_min, t_max=running) & active
        lanes = torch.nonzero(gate).squeeze(1)
        if lanes.numel() == 0:
            continue
        o_loc, d_loc = ray_to_local(o_blas[lanes], d_blas[lanes], tr.blas_to_local[i])
        hit_i, t_i, n_loc = _dispatch_procedural(
            kind, prim_type, o_loc, d_loc, t_min=t_min, t_max=running[lanes],
            cull=cull_backface, step_scale=arrays.materials.step_scale[i],
            elapsed_time=arrays.constants.elapsed_time,
            gate=torch.ones(lanes.numel(), dtype=torch.bool, device=dev),
            level=level,
        )
        closer = hit_i & (t_i < best_t[lanes])
        win = lanes[closer]
        best_t[win] = t_i[closer]
        best_n[win] = normal_to_world(n_loc[closer], tr.local_to_blas[i])
        best_id[win] = i

    hit = best_id >= 0
    return HitRecord(t=torch.where(hit, best_t, RAY_TMAX), normal=best_n,
                     geometry_id=best_id, hit=hit)


def any_hit(origins, directions, scene: Scene, *, t_min=RAY_TMIN, t_max=RAY_TMAX,
            active=None, level=0):
    """Occlusion query — TraceRay with ACCEPT_FIRST_HIT | SKIP_CLOSEST_HIT
    (Raytracing.hlsl:115-147); back-face culling stays on, which prevents
    self-shadowing. Returns an (N,) bool occlusion mask."""
    layout, arrays = scene.layout, scene.arrays
    n = origins.shape[0]
    dev = origins.device
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=dev)
    occluded = torch.zeros(n, dtype=torch.bool, device=dev)
    if layout.has_plane:
        hit_p, _ = intersect_plane(origins, directions, arrays.plane_origin,
                                   arrays.plane_size, t_min=t_min, t_max=t_max)
        occluded = hit_p & active

    o_blas, d_blas = ray_to_blas(origins, directions, arrays.blas_offset)
    tr = arrays.transforms
    for i, (kind, prim_type) in enumerate(zip(layout.kinds, layout.prim_types)):
        gate = analytic.aabb_hit_mask(
            o_blas, d_blas, arrays.aabb_min[i], arrays.aabb_max[i],
            t_min=t_min, t_max=t_max) & active & ~occluded
        lanes = torch.nonzero(gate).squeeze(1)
        if lanes.numel() == 0:
            continue
        o_loc, d_loc = ray_to_local(o_blas[lanes], d_blas[lanes], tr.blas_to_local[i])
        hit_i, _, _ = _dispatch_procedural(
            kind, prim_type, o_loc, d_loc, t_min=t_min,
            t_max=torch.full((lanes.numel(),), t_max, dtype=origins.dtype, device=dev),
            cull=True, step_scale=arrays.materials.step_scale[i],
            elapsed_time=arrays.constants.elapsed_time,
            gate=torch.ones(lanes.numel(), dtype=torch.bool, device=dev),
            occlusion=True, level=level, with_normal=False,
        )
        occluded[lanes[hit_i]] = True
    return occluded
