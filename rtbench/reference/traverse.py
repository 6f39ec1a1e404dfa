"""Scene traversal of the plain reference: the plane closed form, then every
procedural geometry in definition order behind its BLAS-space slab.

Frozen copy of the port's plain passes: ``accel/traverse.py`` (the plane,
``pass_inputs``, ``closest_hit``, ``merge_hit``, ``any_hit``),
``kernels/scene_kernel.scene_closest_plain`` (the per-geometry loop) and
``kernels/megakernel.route_pass_plain`` (the same loop at the level-0
budget on every level, with the march and mesh test in the pass entry's
plain form). The route is the configuration's, never the device's:

- ``"frame"``: the frame kernel's plain version, each level's marches at
  that level's budgets;
- ``"per_geometry"``: a scene past the 512-face cap, every level at the
  level-0 budgets, as the per-geometry route marches on the card.
"""

from __future__ import annotations

import functools

import torch

from rtbench.reference import analytic, registry, sdf, trimesh
from rtbench.reference.instances import Scene, normal_to_world, ray_to_blas, ray_to_local
from rtbench.reference.types import RAY_TMAX, RAY_TMIN, SDF_MAX_STEPS, HitRecord, IntersectorKind

ROUTES = ("frame", "per_geometry")


def intersect_plane(origins, directions, plane_origin, plane_size, *, t_min, t_max):
    """Ground-plane quad y == plane_origin.y, x/z in [origin, origin+size]:
    two back-face-culled triangles tiling the rect exactly. Returns (hit, t)."""
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


def _geometry_args(scene: Scene, i: int, o_blas, d_blas, gate, step_scales):
    layout, arrays = scene.layout, scene.arrays
    kind, code = layout.kinds[i], layout.prim_types[i]
    o_loc, d_loc = ray_to_local(o_blas, d_blas, arrays.transforms.blas_to_local[i])
    kw = dict(active=gate, step_scale=step_scales[i],
              elapsed_time=arrays.constants.elapsed_time,
              natural_budget=layout.step_budgets[i] if layout.step_budgets else SDF_MAX_STEPS,
              mesh=arrays.meshes[code] if kind == IntersectorKind.TRIANGLE else None)
    return kind, code, o_loc, d_loc, kw


def scene_closest_plain(scene: Scene, o_blas, d_blas, active, t0, *, level: int = 0,
                        accept_first: bool = False, cull_backface: bool = True,
                        budget_level: int | None = None, march=None, mesh_closest=None):
    """Every procedural geometry in definition order, each gated by its
    BLAS-space slab against the running best t, with a strict-< closest
    reduction; accept_first: a lane's first valid hit ends its search.
    ``budget_level`` marches at that level's budgets instead of ``level``'s;
    ``march`` and ``mesh_closest`` replace the plain march and mesh test.
    Returns (best_t, world normal, gid; -1 where nothing beat t0)."""
    layout, arrays = scene.layout, scene.arrays
    n = o_blas.shape[0]
    best_t = t0.clone()
    normal = torch.zeros_like(o_blas)
    gid = torch.full((n,), -1, dtype=torch.int32, device=o_blas.device)
    tr = arrays.transforms
    step_scales = arrays.materials.step_scale.tolist()
    march_level = level if budget_level is None else budget_level
    for i in range(len(layout.kinds)):
        gate = analytic.aabb_hit_mask(o_blas, d_blas, arrays.aabb_min[i], arrays.aabb_max[i],
                                      t_min=RAY_TMIN, t_max=best_t) & active
        if accept_first:
            gate = gate & (gid < 0)
        kind, prim_type, o_loc, d_loc, kw = _geometry_args(scene, i, o_blas, d_blas, gate,
                                                           step_scales)
        hit, t, n_loc = registry.intersect(
            kind, prim_type, o_loc, d_loc, t_min=RAY_TMIN, t_max=best_t,
            cull_backface=True if accept_first else cull_backface,
            occlusion=accept_first, level=march_level, with_normal=not accept_first,
            march=march, mesh_closest=mesh_closest, **kw)
        if accept_first:
            win = hit
            best_t = torch.where(win, 0.0, best_t)
        else:
            win = hit & (t < best_t)
            best_t = torch.where(win, t, best_t)
            normal = torch.where(win[:, None], normal_to_world(n_loc, tr.local_to_blas[i]),
                                 normal)
        gid = torch.where(win, i, gid)
    return best_t, normal, gid


def sphere_trace_plain(o, d, gate, t_max, step_scale, *, prim_code: int,
                       cull_backface: bool = True, max_steps: int = SDF_MAX_STEPS,
                       t_start=None, relax: float = 1.0, capped_hit: bool = False):
    """The per-geometry route's march: sdf.march with a capped hit at t = 0."""
    return sdf.march(o, d, gate, t_max, step_scale, prim_code=prim_code,
                     cull_backface=cull_backface, max_steps=max_steps, t_start=t_start,
                     relax=relax, capped_hit=capped_hit, capped_t=0.0)


def trimesh_closest_plain(rows, o, d, gate, t_max, *, cull_backface: bool = True):
    """The per-geometry route's mesh test over one mesh's (F, 12) face rows."""
    mesh = trimesh.TriangleMesh(v0=rows[:, 0:3], e1=rows[:, 3:6], e2=rows[:, 6:9],
                                n=rows[:, 9:12])
    return trimesh.intersect_trimesh(o, d, mesh, t_min=0.0, t_max=t_max,
                                     cull_backface=cull_backface, active=gate)


def procedural_pass(route: str):
    """The pass function of ``route`` (see the module docstring)."""
    if route == "frame":
        return scene_closest_plain
    if route == "per_geometry":
        return functools.partial(scene_closest_plain, budget_level=0, march=sphere_trace_plain,
                                 mesh_closest=trimesh_closest_plain)
    raise ValueError(f"unknown route {route!r}; expected one of {ROUTES}")


def pass_inputs(origins, directions, scene: Scene, *, t_min=RAY_TMIN, t_max=RAY_TMAX,
                active=None, occlusion=False):
    """(plane hit, o_blas, d_blas, active, t0) of (N, 3) world rays: a
    closest pass starts from the plane's t where the plane hits; an
    occlusion pass sends plane-occluded lanes in inactive with t0 = 0."""
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


def merge_hit(scene: Scene, hit_p, t0, best_t, normal, gid) -> HitRecord:
    """The procedural hit where one beat t0, else the plane's, else a miss."""
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


def closest_hit(origins, directions, scene: Scene, route: str, *, level=0) -> HitRecord:
    """Closest hit over the plane and every procedural geometry."""
    hit_p, o_blas, d_blas, active, t0 = pass_inputs(origins, directions, scene)
    best_t, normal, gid = procedural_pass(route)(scene, o_blas, d_blas, active, t0,
                                                 level=level, cull_backface=True)
    return merge_hit(scene, hit_p, t0, best_t, normal, gid)


def any_hit(origins, directions, scene: Scene, route: str, *, active, level=0):
    """Occlusion (accept first hit, back faces culled): (N,) bool."""
    hit_p, o_blas, d_blas, remaining, t0 = pass_inputs(origins, directions, scene,
                                                       active=active, occlusion=True)
    _, _, gid = procedural_pass(route)(scene, o_blas, d_blas, remaining, t0, level=level,
                                       accept_first=True)
    return (hit_p | (gid >= 0)) & active
