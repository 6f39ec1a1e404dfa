"""Intersector registry — the shader-binding-table analog.

Port of gpuraytracer_tpu/geometry/registry.py: (IntersectorKind, primitive
type) -> intersection routine over (N, 3) local-space rays. It is the
port's one dispatch table: every entry also does what the JAX package's
per-geometry dispatch (accel/traverse._dispatch_procedural) adds around the
intersector, so the traversal's plain version (kernels/scene_kernel.py)
calls ``intersect`` and nothing else. Sphere traces take the geometry's
natural budget capped by the level's knobs (sdf.march_budget); an
AABB-windowed code (sdf.AABB_WINDOWED_CODES) skips the back-face cull and
marches only inside its local unit box. Every triangle mesh shares one
entry (its prim_type is the scene's mesh slot; the caller hands the mesh
in). ``intersect`` is a plain dispatch on the code, where the JAX package
compiles a switch over every branch. The CUDA kernels hold the same table
in csrc/traverse.cuh.

The SDF and mesh entries take the march and the mesh test as optional
callables in the form of kernels/megakernel.py's wrappers, which is how the
per-geometry route (accel/traverse.per_geometry_route) runs them in
csrc/megakernel.cu; by default they run the plain forms (sdf.march,
trimesh.intersect_trimesh).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from rtbench.reference.types import (
    AnalyticPrimitive,
    IntersectorKind,
    METABALL_MAX_STEPS,
    SDF_MAX_STEPS,
    VolumetricPrimitive,
)
from rtbench.reference import analytic, metaballs, sdf, trimesh

# (kind, prim_type) -> fn(o, d, *, t_min, t_max, cull_backface, active,
#                         step_scale, elapsed_time, natural_budget, occlusion,
#                         level, with_normal, mesh, march, mesh_closest,
#                         budget_cap, mb_budget_cap)
#                      -> (hit, t, local normal or None, dirty lanes or None)
_REGISTRY: Dict[Tuple[IntersectorKind, int], Callable] = {}


def _key(kind, prim_type) -> Tuple[IntersectorKind, int]:
    """Every mesh slot shares the TRIANGLE entry (slot 0)."""
    kind = IntersectorKind(kind)
    return kind, 0 if kind == IntersectorKind.TRIANGLE else int(prim_type)


def register(kind: IntersectorKind, prim_type: int):
    def deco(fn):
        _REGISTRY[_key(kind, prim_type)] = fn
        return fn

    return deco


def lookup(kind: IntersectorKind, prim_type: int) -> Callable:
    return _REGISTRY[_key(kind, prim_type)]


def registered() -> Tuple[Tuple[IntersectorKind, int], ...]:
    return tuple(sorted(_REGISTRY))


def dense_code(kind: IntersectorKind, prim_type: int) -> int:
    """Index of (kind, prim_type) in ``registered()`` order: the branch
    that ``intersect_switch`` takes. It is the reference's index for every
    key that both packages register; the port's one more key, the shared
    TRIANGLE entry, sorts last."""
    return registered().index(_key(kind, prim_type))


def intersect_switch(code, o, d, *, t_min, t_max, cull_backface, step_scale, elapsed_time,
                     active, **kwargs):
    """``intersect`` of the entry whose dense code (``dense_code``) is
    ``code``, a Python int or a 0-d integer tensor; out of range it is
    clamped to the first or last entry, as the reference's lax.switch
    clamps its index. The host picks the branch, since it has no
    lax.switch: a 0-d tensor on a CUDA device is read on the host, one
    host sync; a Python int or a CPU tensor makes none. ``kwargs`` go to
    ``intersect`` (a TRIANGLE entry's ``mesh``, the march's knobs)."""
    entries = registered()
    kind, prim_type = entries[min(max(int(code), 0), len(entries) - 1)]
    return intersect(kind, prim_type, o, d, t_min=t_min, t_max=t_max,
                     cull_backface=cull_backface, step_scale=step_scale,
                     elapsed_time=elapsed_time, active=active, **kwargs)


def intersect(kind, prim_type, o, d, *, t_min, t_max, cull_backface, step_scale,
              elapsed_time, natural_budget=SDF_MAX_STEPS, occlusion=False, level=0,
              with_normal=True, mesh=None, active=None, march=None, mesh_closest=None,
              budget_cap=None, mb_budget_cap=None, return_capped=False):
    """One geometry's intersector over (N, 3) local rays (t_max (N,)):
    (hit, t, local normal or None), hit False outside ``active`` (N,) bool
    (default: every lane), whose lanes marches and meshes skip.
    ``occlusion`` and ``level`` select the march's budget and relaxation;
    ``with_normal=False`` skips a plain march's normal; ``mesh``: a
    TRIANGLE geometry's TriangleMesh; ``march``, ``mesh_closest``: the
    SDF march and the mesh test in the form of
    kernels/megakernel.sphere_trace_tiles and trimesh_closest (default:
    the plain forms).

    ``budget_cap`` / ``mb_budget_cap``: the step caps of an SDF / metaball
    march in a compacted frame mode's main pass (sdf.march_budget's
    ``cap``). ``return_capped`` adds a fourth output, the lanes whose
    march ran out of a capped budget and so set the geometry's dirty bit
    (all False for a closed form, or where the cap cannot bind:
    sdf.cap_marks_dirty)."""
    try:
        fn = lookup(kind, prim_type)
    except KeyError:
        raise ValueError(f"no intersector for kind={kind} type={prim_type}") from None
    if active is None:
        active = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    hit, t, normal, capped = fn(o, d, t_min=t_min, t_max=t_max, cull_backface=cull_backface,
                                active=active, step_scale=step_scale,
                                elapsed_time=elapsed_time, natural_budget=natural_budget,
                                occlusion=occlusion, level=level, with_normal=with_normal,
                                mesh=mesh, march=march, mesh_closest=mesh_closest,
                                budget_cap=budget_cap, mb_budget_cap=mb_budget_cap,
                                return_capped=return_capped)
    if not return_capped:
        return hit & active, t, normal
    if capped is None:
        capped = torch.zeros_like(active)
    return hit & active, t, normal, capped & active


@register(IntersectorKind.ANALYTIC, AnalyticPrimitive.AABB)
def _aabb(o, d, *, t_min, t_max, cull_backface, **_):
    return analytic.intersect_hollow_aabb(o, d, t_min=t_min, t_max=t_max,
                                          cull_backface=cull_backface) + (None,)


@register(IntersectorKind.ANALYTIC, AnalyticPrimitive.SPHERES)
def _spheres(o, d, *, t_min, t_max, cull_backface, **_):
    return analytic.intersect_spheres(o, d, t_min=t_min, t_max=t_max,
                                      cull_backface=cull_backface) + (None,)


@register(IntersectorKind.TRIANGLE, 0)
def _trimesh(o, d, *, t_min, t_max, cull_backface, active, mesh, mesh_closest, **_):
    if mesh_closest is None:
        return trimesh.intersect_trimesh(o, d, mesh, t_min=t_min, t_max=t_max,
                                         cull_backface=cull_backface, active=active) + (None,)
    # The mesh entry's hit test is t >= 0: t_min is RAY_TMIN = 0 on every pass.
    return mesh_closest(mesh.rows(), o, d, active, t_max, cull_backface=cull_backface) + (None,)


@register(IntersectorKind.VOLUMETRIC, VolumetricPrimitive.METABALLS)
def _metaballs(o, d, *, t_min, t_max, cull_backface, active, elapsed_time, mb_budget_cap,
               return_capped, **_):
    # A metaball march sets its dirty bit only under a cap below its 128
    # steps (scene_kernel.py:1526-1529).
    if not return_capped or mb_budget_cap is None or mb_budget_cap >= METABALL_MAX_STEPS:
        return metaballs.intersect_metaballs(
            o, d, elapsed_time, t_min=t_min, t_max=t_max, cull_backface=cull_backface,
            active=active) + (None,)
    return metaballs.intersect_metaballs(
        o, d, elapsed_time, t_min=t_min, t_max=t_max, cull_backface=cull_backface,
        active=active, max_steps=int(mb_budget_cap), return_capped=True)


_UNIT_LO = torch.tensor([-1.0, -1.0, -1.0])
_UNIT_HI = torch.tensor([1.0, 1.0, 1.0])


def sdf_march_args(code: int, o, d, *, t_min, t_max, cull_backface, active, natural_budget,
                   occlusion, level, budget_cap=None):
    """(gate, t_max, keyword arguments of sdf.march) of SDF code ``code``'s
    march over (N, 3) local rays, as its registry entry sets it up: the
    window of an AABB-windowed code, the level's budget and capped-hit rule,
    the relaxation."""
    windowed = int(code) in sdf.AABB_WINDOWED_CODES
    cull, gate, t_hi = cull_backface, active, t_max
    t_start = None if t_min == 0.0 else torch.full_like(t_max, t_min)
    if windowed:
        # [max(entry, t_min), min(exit, t_max)] of the local unit box;
        # lanes whose window is empty are not marched.
        cull = False
        w_lo, w_hi = analytic.aabb_interval(o, d, _UNIT_LO.to(o.device), _UNIT_HI.to(o.device))
        t_start = torch.clamp(w_lo, min=t_min)
        t_hi = torch.minimum(t_max, w_hi)
        gate = gate & (w_hi > w_lo) & (t_hi > t_start)
    budget, capped_hit = sdf.march_budget(natural_budget, occlusion=occlusion, level=level,
                                          cap=budget_cap)
    kw = dict(prim_code=int(code), cull_backface=cull, max_steps=budget, t_start=t_start,
              relax=sdf.relax_for_code(code, occlusion=occlusion), capped_hit=capped_hit)
    return gate, t_hi, kw


def _make_sdf(code: int):
    def _fn(o, d, *, t_min, t_max, cull_backface, active, step_scale, natural_budget,
            occlusion, level, with_normal, march, budget_cap, return_capped, **_):
        gate, t_hi, kw = sdf_march_args(code, o, d, t_min=t_min, t_max=t_max,
                                        cull_backface=cull_backface, active=active,
                                        natural_budget=natural_budget, occlusion=occlusion,
                                        level=level, budget_cap=budget_cap)
        if return_capped:
            if march is not None:
                raise ValueError("a capped march runs in its plain form only")
            hit, t, normal, capped = sdf.march(o, d, gate, t_hi, step_scale,
                                               with_normal=with_normal, return_capped=True, **kw)
            if not sdf.cap_marks_dirty(natural_budget, occlusion=occlusion, cap=budget_cap):
                capped = None
            return hit, t, normal, capped
        if march is None:
            return sdf.march(o, d, gate, t_hi, step_scale, with_normal=with_normal, **kw) + (None,)
        return march(o, d, gate, t_hi, step_scale, **kw) + (None,)

    return _fn


for _code in sorted(sdf.DISTANCE_FUNCTIONS):
    register(IntersectorKind.SIGNED_DISTANCE, _code)(_make_sdf(_code))
