"""Intersector registry — the shader-binding-table analog.

Port of gpuraytracer_tpu/geometry/registry.py: (IntersectorKind, primitive
type) -> intersection routine over (N, 3) local-space rays. It is the
port's one dispatch table: every entry also does what the JAX package's
per-geometry dispatch (accel/traverse._dispatch_procedural) adds around the
intersector, so the traversal's plain version (kernels/scene_kernel.py)
calls ``intersect`` and nothing else. Sphere traces take the geometry's
natural budget capped by the level's knobs (sdf.march_budget); an
AABB-windowed code (sdf.AABB_WINDOWED_CODES) skips the back-face cull and
marches only inside its local unit box. ``intersect`` is a plain dispatch
on the code, where the JAX package compiles a switch over every branch.
The CUDA kernels hold the same table in csrc/traverse.cuh.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from gpuraytracer_tpu_torch.core.types import (
    AnalyticPrimitive,
    IntersectorKind,
    SDF_MAX_STEPS,
    VolumetricPrimitive,
)
from gpuraytracer_tpu_torch.geometry import analytic, metaballs, sdf

# (kind, prim_type) -> fn(o, d, *, t_min, t_max, cull_backface, step_scale,
#                         elapsed_time, natural_budget, occlusion, level,
#                         with_normal) -> (hit, t, local normal or None)
_REGISTRY: Dict[Tuple[IntersectorKind, int], Callable] = {}


def register(kind: IntersectorKind, prim_type: int):
    def deco(fn):
        _REGISTRY[(IntersectorKind(kind), int(prim_type))] = fn
        return fn

    return deco


def lookup(kind: IntersectorKind, prim_type: int) -> Callable:
    return _REGISTRY[(IntersectorKind(kind), int(prim_type))]


def registered() -> Tuple[Tuple[IntersectorKind, int], ...]:
    return tuple(sorted(_REGISTRY))


def intersect(kind, prim_type, o, d, *, t_min, t_max, cull_backface, step_scale,
              elapsed_time, natural_budget=SDF_MAX_STEPS, occlusion=False, level=0,
              with_normal=True):
    """One geometry's intersector over the lanes it is given (t_max per
    lane): (hit, t, local normal or None). ``occlusion`` and ``level``
    select the march's budget and relaxation; ``with_normal=False`` skips
    a march's normal."""
    if IntersectorKind(kind) == IntersectorKind.TRIANGLE:
        raise NotImplementedError("triangle meshes: geometry/trimesh.py is not ported yet")
    try:
        fn = lookup(kind, prim_type)
    except KeyError:
        raise ValueError(f"no intersector for kind={kind} type={prim_type}") from None
    return fn(o, d, t_min=t_min, t_max=t_max, cull_backface=cull_backface,
              step_scale=step_scale, elapsed_time=elapsed_time, natural_budget=natural_budget,
              occlusion=occlusion, level=level, with_normal=with_normal)


@register(IntersectorKind.ANALYTIC, AnalyticPrimitive.AABB)
def _aabb(o, d, *, t_min, t_max, cull_backface, **_):
    return analytic.intersect_hollow_aabb(o, d, t_min=t_min, t_max=t_max,
                                          cull_backface=cull_backface)


@register(IntersectorKind.ANALYTIC, AnalyticPrimitive.SPHERES)
def _spheres(o, d, *, t_min, t_max, cull_backface, **_):
    return analytic.intersect_spheres(o, d, t_min=t_min, t_max=t_max,
                                      cull_backface=cull_backface)


@register(IntersectorKind.VOLUMETRIC, VolumetricPrimitive.METABALLS)
def _metaballs(o, d, *, t_min, t_max, cull_backface, elapsed_time, **_):
    return metaballs.intersect_metaballs(
        o, d, elapsed_time, t_min=t_min, t_max=t_max, cull_backface=cull_backface,
        active=torch.ones(o.shape[0], dtype=torch.bool, device=o.device))


_UNIT_LO = torch.tensor([-1.0, -1.0, -1.0])
_UNIT_HI = torch.tensor([1.0, 1.0, 1.0])


def _make_sdf(code: int):
    distance_fn = sdf.DISTANCE_FUNCTIONS[code]
    windowed = code in sdf.AABB_WINDOWED_CODES

    def _fn(o, d, *, t_min, t_max, cull_backface, step_scale, natural_budget, occlusion,
            level, with_normal, **_):
        t_lo, t_hi, cull = t_min, t_max, cull_backface
        gate = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
        if windowed:
            # [max(entry, t_min), min(exit, t_max)] of the local unit box;
            # lanes whose window is empty are not marched.
            cull = False
            w_lo, w_hi = analytic.aabb_interval(o, d, _UNIT_LO.to(o.device),
                                                _UNIT_HI.to(o.device))
            t_lo = torch.clamp(w_lo, min=t_min)
            t_hi = torch.minimum(t_max, w_hi)
            gate = (w_hi > w_lo) & (t_hi > t_lo)
        budget, capped_hit = sdf.march_budget(natural_budget, occlusion=occlusion, level=level)
        hit, t = sdf.sphere_trace(
            o, d, distance_fn, step_scale=step_scale, t_min=t_lo, t_max=t_hi,
            cull_backface=cull, active=gate, max_steps=budget,
            escape_bound=code in sdf.ESCAPE_SAFE_CODES,
            relax=sdf.relax_for_code(code, occlusion=occlusion), capped_hit=capped_hit)
        normal = None
        if with_normal:
            normal = torch.zeros_like(o)
            if bool(hit.any()):
                hi = torch.nonzero(hit).squeeze(1)
                normal[hi] = sdf.calculate_normal(o[hi] + t[hi][:, None] * d[hi], distance_fn)
        return hit, t, normal

    return _fn


for _code in sorted(sdf.DISTANCE_FUNCTIONS):
    register(IntersectorKind.SIGNED_DISTANCE, _code)(_make_sdf(_code))
