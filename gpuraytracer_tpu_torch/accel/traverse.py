"""Scene traversal: closest-hit and any-hit (occlusion) queries.

Port of gpuraytracer_tpu/accel/traverse.py (the XLA wavefront path): the
plane closed form, then every procedural geometry in definition order,
each gated by a slab test of its BLAS-space AABB against the running best
t (the shrinking RayTCurrent), with a strict-< closest reduction. Shadow
rays use accept-first semantics (Raytracing.hlsl:115-147): any valid hit
occludes, and back-face culling stays on.

Rays are (N, 3). The plane is tested here; the procedural pass is one
call of kernels/scene_kernel.scene_closest_tiles (the CUDA scene kernel
on a GPU, its plain version, the per-geometry loop, on the CPU).
"""

from __future__ import annotations

import functools

import torch

from gpuraytracer_tpu_torch.accel.instances import Scene, ray_to_blas
from gpuraytracer_tpu_torch.core.types import HitRecord, RAY_TMAX, RAY_TMIN


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


def _procedural_pass(plain, pack):
    from gpuraytracer_tpu_torch.kernels import scene_kernel

    if plain:
        return scene_kernel.scene_closest_plain
    return functools.partial(scene_kernel.scene_closest_tiles, pack=pack)


def pass_inputs(origins, directions, scene: Scene, *, t_min=RAY_TMIN, t_max=RAY_TMAX,
                active=None, occlusion=False):
    """The plane test and the procedural pass's inputs for (N, 3) world
    rays: (plane hit, o_blas, d_blas, active, t0). A closest pass starts
    from the plane's t where the plane hits, else t_max; an occlusion pass
    sends plane-occluded lanes in inactive with t0 = 0."""
    layout, arrays = scene.layout, scene.arrays
    n = origins.shape[0]
    dev = origins.device
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=dev)
    t_full = torch.full((n,), t_max, dtype=origins.dtype, device=dev)
    if layout.has_plane:
        hit_p, t_p = intersect_plane(origins, directions, arrays.plane_origin,
                                     arrays.plane_size, t_min=t_min, t_max=t_max)
        hit_p = hit_p & active
    else:
        hit_p = torch.zeros(n, dtype=torch.bool, device=dev)
        t_p = t_full
    o_blas, d_blas = ray_to_blas(origins, directions, arrays.blas_offset)
    if occlusion:
        return hit_p, o_blas, d_blas, active & ~hit_p, torch.where(hit_p, 0.0, t_full)
    return hit_p, o_blas, d_blas, active, torch.where(hit_p, t_p, t_full)


def closest_hit(origins, directions, scene: Scene, *, t_min=RAY_TMIN, t_max=RAY_TMAX,
                cull_backface=True, active=None, level=0, pack=None,
                plain=False) -> HitRecord:
    """Closest hit over the plane + every procedural geometry; geometry_id
    indexes the geometry rows (procedural 0..P-1, plane == P, miss -1).

    The plane is tested here; the procedural pass starts from its t (else
    t_max) in kernels/scene_kernel.scene_closest_tiles: the CUDA scene
    kernel on a GPU (``pack``: the frame's packed buffers, if already
    built), its plain version on the CPU or wherever ``plain`` is set."""
    hit_p, o_blas, d_blas, active, t0 = pass_inputs(
        origins, directions, scene, t_min=t_min, t_max=t_max, active=active)
    best_t, normal, gid = _procedural_pass(plain, pack)(
        scene, o_blas, d_blas, active, t0, level=level, cull_backface=cull_backface)
    hit_proc = gid >= 0
    geometry_id = torch.where(hit_proc, gid.to(torch.int64),
                              torch.where(hit_p, scene.layout.plane_geometry_id, -1))
    hit = geometry_id >= 0
    up = torch.zeros_like(origins)
    up[:, 1] = 1.0
    nrm = torch.where(hit_proc[:, None], normal, torch.where(hit_p[:, None], up, 0.0))
    t = torch.where(hit_proc, best_t, t0)
    return HitRecord(t=torch.where(hit, t, RAY_TMAX), normal=nrm, geometry_id=geometry_id,
                     hit=hit)


def any_hit(origins, directions, scene: Scene, *, t_min=RAY_TMIN, t_max=RAY_TMAX,
            active=None, level=0, pack=None, plain=False):
    """Occlusion query — TraceRay with ACCEPT_FIRST_HIT | SKIP_CLOSEST_HIT
    (Raytracing.hlsl:115-147); back-face culling stays on, which prevents
    self-shadowing. Plane-occluded lanes skip the procedural pass (they go
    in inactive, with t0 = 0). Returns an (N,) bool occlusion mask."""
    if active is None:
        active = torch.ones(origins.shape[0], dtype=torch.bool, device=origins.device)
    hit_p, o_blas, d_blas, remaining, t0 = pass_inputs(
        origins, directions, scene, t_min=t_min, t_max=t_max, active=active, occlusion=True)
    _, _, gid = _procedural_pass(plain, pack)(
        scene, o_blas, d_blas, remaining, t0, level=level, accept_first=True)
    return (hit_p | (gid >= 0)) & active
