"""Analytic primitives: hollow unit AABB and the 3-sphere cluster.

Port of gpuraytracer_tpu/geometry/analytic.py (src/AnalyticPrimitives.hlsli).
Every test takes local-space rays shaped (N, 3) and returns
(hit, t, normal) with t = +inf on a miss. t_min/t_max may be scalars or
per-ray tensors.
"""

from __future__ import annotations

import torch

from rtbench.reference import hlsl
from rtbench.reference.upload import constant

# The 3 hard-coded spheres (AnalyticPrimitives.hlsli:121-128).
SPHERE_CENTERS = ((-0.3, -0.3, -0.3), (0.1, 0.1, 0.4), (0.35, 0.35, 0.0))
SPHERE_RADII = (0.6, 0.3, 0.15)

AABB_EPS = 0.0001  # face-pick epsilon (hlsli:208)


def _vec(v, like):
    """A constant vector (or scalar) of ``like``'s type on its device,
    uploaded once per device (core/upload.constant): read it, never write
    it."""
    v = tuple(map(float, v)) if isinstance(v, (tuple, list)) else float(v)
    return constant(v, like.device, like.dtype)


def solve_ray_sphere(origins, directions, center, radius):
    """Stable quadratic; (has_roots, t0, t1) with t0 <= t1 (hlsli:28-60).
    center: (3,) tensor; radius: a float or a 0-d tensor (r*r is then
    rounded as the caller's reference rounds it)."""
    L = origins - center
    a = hlsl.dot(directions, directions)
    b = 2.0 * hlsl.dot(directions, L)
    c = hlsl.dot(L, L) - radius * radius
    discr = b * b - 4.0 * a * c
    has = discr >= 0.0
    sq = hlsl.sqrt(torch.clamp(discr, min=0.0))
    q = torch.where(b > 0, -0.5 * (b + sq), -0.5 * (b - sq))
    x0 = q / a
    x1 = c / q
    t0 = torch.minimum(x0, x1)
    t1 = torch.maximum(x0, x1)
    mid = -0.5 * b / a
    t0 = torch.where(discr == 0.0, mid, t0)
    t1 = torch.where(discr == 0.0, mid, t1)
    return has, t0, t1


def intersect_hollow_sphere(origins, directions, center, radius, *, t_min, t_max,
                            cull_backface):
    """RaySphereIntersectionTest (hlsli:64-100): prefer t0; if t0 < t_min
    or invalid, fall through to t1."""
    c = _vec(center, origins)
    has, t0, t1 = solve_ray_sphere(origins, directions, c, radius)

    def normal_at(t):
        return hlsl.normalize(origins + t[:, None] * directions - c)

    def valid(t, normal):
        ok = (t >= t_min) & (t <= t_max)
        if cull_backface:
            ok = ok & (hlsl.dot(directions, normal) <= 0.0)
        return ok

    n0 = normal_at(t0)
    n1 = normal_at(t1)
    use_a = t0 < t_min
    hit_a = ~(t1 < t_min) & valid(t1, n1)
    hit_b0 = valid(t0, n0)
    hit_b1 = ~hit_b0 & valid(t1, n1)
    hit = has & torch.where(use_a, hit_a, hit_b0 | hit_b1)
    use_t1 = use_a | (~use_a & hit_b1 & ~hit_b0)
    t = torch.where(use_t1, t1, t0)
    normal = torch.where((use_a | hit_b1)[:, None], n1, n0)
    return hit, torch.where(hit, t, torch.inf), normal


def intersect_spheres(origins, directions, *, t_min, t_max, cull_backface):
    """RaySpheresIntersectionTest (hlsli:119-153): three hollow spheres,
    closest valid hit wins (thit starts at RayTCurrent)."""
    n = origins.shape[0]
    best_t = (t_max.to(origins.dtype).expand(n) if isinstance(t_max, torch.Tensor)
              else torch.full((n,), t_max, dtype=origins.dtype, device=origins.device))
    best_n = torch.zeros_like(origins)
    found = torch.zeros(n, dtype=torch.bool, device=origins.device)
    for center, radius in zip(SPHERE_CENTERS, SPHERE_RADII):
        hit, t, nrm = intersect_hollow_sphere(
            origins, directions, center, radius,
            t_min=t_min, t_max=t_max, cull_backface=cull_backface,
        )
        closer = hit & (t < best_t)
        best_t = torch.where(closer, t, best_t)
        best_n = torch.where(closer[:, None], nrm, best_n)
        found = found | closer
    return found, torch.where(found, best_t, torch.inf), best_n


def aabb_interval(origins, directions, aabb_min, aabb_max):
    """Slab interval (hlsli:158-188) with the reference's inf handling for
    axis-parallel rays. Returns (tmin, tmax)."""
    d = directions
    inv = torch.where(d != 0.0, 1.0 / d,
                      torch.where(d > 0.0, torch.inf, -torch.inf))
    near = torch.where(d > 0.0, aabb_min, aabb_max)
    far = torch.where(d > 0.0, aabb_max, aabb_min)
    tmin3 = (near - origins) * inv
    tmax3 = (far - origins) * inv
    tmin = torch.maximum(torch.maximum(tmin3[:, 0], tmin3[:, 1]), tmin3[:, 2])
    tmax = torch.minimum(torch.minimum(tmax3[:, 0], tmax3[:, 1]), tmax3[:, 2])
    return tmin, tmax


def aabb_hit_mask(origins, directions, aabb_min, aabb_max, *, t_min, t_max):
    """tmax > tmin && tmax >= t_min && tmin <= t_max (hlsli:187): the
    traversal gate for procedural geometry."""
    tmin, tmax = aabb_interval(origins, directions, aabb_min, aabb_max)
    return (tmax > tmin) & (tmax >= t_min) & (tmin <= t_max)


_FACES = (
    (0, 0, (-1.0, 0.0, 0.0)),
    (0, 1, (0.0, -1.0, 0.0)),
    (0, 2, (0.0, 0.0, -1.0)),
    (1, 0, (1.0, 0.0, 0.0)),
    (1, 1, (0.0, 1.0, 0.0)),
    (1, 2, (0.0, 0.0, 1.0)),
)


def intersect_hollow_aabb(origins, directions, *, t_min, t_max, cull_backface):
    """Hollow unit AABB with priority-ordered face normals (hlsli:191-219);
    only entry crossings (tmin within the ray extents) count."""
    lo = _vec((-1.0, -1.0, -1.0), origins)
    hi = _vec((1.0, 1.0, 1.0), origins)
    tmin, tmax = aabb_interval(origins, directions, lo, hi)
    interval_ok = (tmax > tmin) & (tmax >= t_min) & (tmin <= t_max)
    entry_ok = (tmin >= t_min) & (tmin <= t_max)
    t = tmin
    pos = origins + t[:, None] * directions
    dist = (torch.abs(lo - pos), torch.abs(hi - pos))
    normal = torch.zeros_like(pos)
    picked = torch.zeros(t.shape, dtype=torch.bool, device=t.device)
    for side, axis, n in _FACES:
        take = ~picked & (dist[side][:, axis] < AABB_EPS)
        normal = torch.where(take[:, None], _vec(n, origins), normal)
        picked = picked | take
    hit = interval_ok & entry_ok
    if cull_backface:
        hit = hit & (hlsl.dot(directions, normal) <= 0.0)
    return hit, torch.where(hit, t, torch.inf), normal
