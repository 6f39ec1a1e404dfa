"""Scene traversal: closest-hit and any-hit (occlusion) queries.

Port of gpuraytracer_tpu/accel/traverse.py (the XLA wavefront path): the
plane closed form, then every procedural geometry in definition order,
each gated by a slab test of its BLAS-space AABB against the running best
t (the shrinking RayTCurrent), with a strict-< closest reduction. Shadow
rays use accept-first semantics (Raytracing.hlsl:115-147): any valid hit
occludes, and back-face culling stays on.

Rays are (N, 3). The plane is tested here; the procedural pass takes one
of two routes, as the reference's does (``_scene_kernel_eligible``). A
scene of at most TRI_FACE_TOTAL_CAP mesh faces takes one call of
kernels/scene_kernel.scene_closest_tiles: the CUDA scene kernel on a GPU.
A GPU scene past the cap takes ``per_geometry_route``: one launch of
csrc/megakernel.cu's pass entry per pass, the reference's per-geometry loop
on each ray at the level-0 budgets. On the CPU every pass is
scene_closest_plain, the per-geometry loop with the XLA path's per-level
budgets, which rendered every golden.
"""

from __future__ import annotations

import functools

import torch

from gpuraytracer_tpu_torch.accel.instances import Scene, SceneArrays, ray_to_blas
from gpuraytracer_tpu_torch.core.types import HitRecord, RAY_TMAX, RAY_TMIN

# The reference's mesh caps (gpuraytracer_tpu/accel/traverse.py:196-207):
# meshes of at most TRI_FACE_CAP faces unroll in the TPU kernels, larger
# ones stream; a scene of more than TRI_FACE_TOTAL_CAP faces in all takes
# neither the frame nor the scene kernel but the per-geometry route. The
# port keeps the faces in global memory, where no such ceiling exists, and
# keeps the rule so that every scene takes the reference's route (the
# per-geometry route marches at other budgets, so the route shows in the
# image).
TRI_FACE_CAP = 64
TRI_FACE_TOTAL_CAP = 512


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


def _total_mesh_faces(scene: Scene) -> int:
    """Faces over every mesh of the scene, counted raw as the reference
    counts them. (The reference's note that padded rows are what fill the
    TPU's scalar memory is about that memory; the port keeps faces in
    global memory and counts raw faces, so that it routes every scene as
    the reference does.)"""
    return sum(m.num_faces for m in scene.arrays.meshes)


def _scene_kernel_eligible(scene: Scene) -> bool:
    """Whether a GPU pass takes the scene kernel (the reference's rule,
    traverse.py:214-232, in which only the face cap decides on the card:
    the kernel covers every kind); else it takes ``per_geometry_route``."""
    return scene.layout.num_procedural > 0 and _total_mesh_faces(scene) <= TRI_FACE_TOTAL_CAP


def pack_tri_rows(arrays: SceneArrays):
    """Every mesh's faces in one (F, 12) f32 table [v0 | e1 | e2 | n] on the
    arrays' device, and each mesh slot's (start, count) in it. The
    reference's padding of large meshes to its stream chunk is a TPU
    schedule and is dropped (its all-zero faces cannot hit)."""
    rows, offsets, start = [], [], 0
    for m in arrays.meshes:
        rows.append(m.rows())
        offsets.append((start, m.num_faces))
        start += m.num_faces
    if not rows:
        return torch.zeros((0, 12), dtype=torch.float32, device=arrays.aabb_min.device), ()
    return torch.cat(rows, dim=0).contiguous(), tuple(offsets)


def per_geometry_route(plain: bool = False, pack=None):
    """The pass function of a GPU scene past TRI_FACE_TOTAL_CAP faces: the
    reference's closest_hit / any_hit loop (traverse.py:337-395, 444-479) as
    its TPU runs it, every level marched at the level-0 budget (its
    _dispatch_procedural, traverse.py:128-175, has no bounce cap on this
    route). On a GPU that is kernels/megakernel.route_pass, one launch per
    pass (``pack``: the frame's packed buffers, if already built).
    ``plain``: its plain version, megakernel.route_pass_plain (one march
    call per SDF geometry and one mesh call per mesh over all the pass's
    rays; analytic shapes and metaballs in their plain forms, as the
    reference runs them in XLA)."""
    from gpuraytracer_tpu_torch.kernels import megakernel

    if plain:
        return megakernel.route_pass_plain
    return functools.partial(megakernel.route_pass, pack=pack)


def _procedural_pass(scene: Scene, plain, pack):
    """The pass function of the scene's route (see the module docstring);
    ``plain`` picks the route's plain version on a GPU."""
    from gpuraytracer_tpu_torch.kernels import scene_kernel

    if scene.arrays.aabb_min.device.type != "cuda":
        return scene_kernel.scene_closest_plain
    if not _scene_kernel_eligible(scene):
        return per_geometry_route(plain, pack)
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


def _capped_pass(scene: Scene, plain, pack, caps):
    """The pass function, or with ``caps`` (the keyword arguments of a
    capped traversal, scene_kernel.scene_closest_plain's budget_cap,
    mb_budget_cap, dirty and kill_on_cap) the capped plain pass, which
    only the plain forms of the compacted frame modes run."""
    from gpuraytracer_tpu_torch.kernels import scene_kernel

    if not caps:
        return _procedural_pass(scene, plain, pack)
    if not plain and scene.arrays.aabb_min.device.type != "cpu":
        raise ValueError("a capped pass runs only as the scene kernel's plain version")
    return functools.partial(scene_kernel.scene_closest_plain, **caps)


def closest_hit(origins, directions, scene: Scene, *, t_min=RAY_TMIN, t_max=RAY_TMAX,
                cull_backface=True, active=None, level=0, pack=None,
                plain=False, caps=None) -> HitRecord:
    """Closest hit over the plane + every procedural geometry; geometry_id
    indexes the geometry rows (procedural 0..P-1, plane == P, miss -1).

    The plane is tested here; the procedural pass starts from its t (else
    t_max) on the scene's route (``_procedural_pass``): on a GPU the scene
    kernel or the per-geometry route (``pack``: the frame's packed buffers,
    if already built; ``plain``: the route's plain version), on the CPU
    the scene kernel's plain version. ``caps``: a capped pass
    (``_capped_pass``)."""
    hit_p, o_blas, d_blas, active, t0 = pass_inputs(
        origins, directions, scene, t_min=t_min, t_max=t_max, active=active)
    best_t, normal, gid = _capped_pass(scene, plain, pack, caps)(
        scene, o_blas, d_blas, active, t0, level=level, cull_backface=cull_backface)
    return merge_hit(scene, hit_p, t0, best_t, normal, gid)


def merge_hit(scene: Scene, hit_p, t0, best_t, normal, gid) -> HitRecord:
    """The closest hit from the plane test (hit_p, t0: ``pass_inputs``) and
    the procedural pass's answer (best_t, normal, gid): the procedural hit
    where one beat t0, else the plane's where it hits, else a miss (t
    RAY_TMAX)."""
    hit_proc = gid >= 0
    geometry_id = torch.where(hit_proc, gid.to(torch.int64),
                              torch.where(hit_p, scene.layout.plane_geometry_id, -1))
    hit = geometry_id >= 0
    up = torch.zeros_like(normal)
    up[:, 1] = 1.0
    nrm = torch.where(hit_proc[:, None], normal, torch.where(hit_p[:, None], up, 0.0))
    t = torch.where(hit_proc, best_t, t0)
    return HitRecord(t=torch.where(hit, t, RAY_TMAX), normal=nrm, geometry_id=geometry_id,
                     hit=hit)


def any_hit(origins, directions, scene: Scene, *, t_min=RAY_TMIN, t_max=RAY_TMAX,
            active=None, level=0, pack=None, plain=False, caps=None):
    """Occlusion query — TraceRay with ACCEPT_FIRST_HIT | SKIP_CLOSEST_HIT
    (Raytracing.hlsl:115-147); back-face culling stays on, which prevents
    self-shadowing. Plane-occluded lanes skip the procedural pass (they go
    in inactive, with t0 = 0). Returns an (N,) bool occlusion mask.
    ``caps``: a capped pass (``_capped_pass``)."""
    if active is None:
        active = torch.ones(origins.shape[0], dtype=torch.bool, device=origins.device)
    hit_p, o_blas, d_blas, remaining, t0 = pass_inputs(
        origins, directions, scene, t_min=t_min, t_max=t_max, active=active, occlusion=True)
    _, _, gid = _capped_pass(scene, plain, pack, caps)(
        scene, o_blas, d_blas, remaining, t0, level=level, accept_first=True)
    return (hit_p | (gid >= 0)) & active
