"""Animated metaballs — volumetric isosurface ray march.

Port of gpuraytracer_tpu/geometry/metaballs.py (src/VolumetricPrimitives
.hlsli). The march keeps the reference's per-lane semantics: a fixed
128-step march over the union of the balls' bounding-sphere intervals,
clipped to [t_min, t_max]; a crossing of the 0.25 isosurface ends the
march only if it passes the validity check, and the step is taken after
an invalid crossing as after any other sample (hlsli:165-199).

The wavefront loop works on the compacted set of still-marching lanes, so
its cost follows the lanes that need it.
"""

from __future__ import annotations

import torch

from rtbench.reference import hlsl
from rtbench.reference.types import (
    METABALL_CYCLE_DURATION,
    METABALL_ISO_THRESHOLD,
    METABALL_MAX_STEPS,
    METABALLS_COUNT,
)
from rtbench.reference.upload import constant
from rtbench.reference import analytic

# Keyframe centers at t0/t1 and field radii (VolumetricPrimitives.hlsli:103-110).
KEYFRAME_CENTERS = (
    ((-0.3, -0.3, -0.4), (0.3, -0.3, -0.0)),
    ((0.0, -0.2, 0.5), (0.0, 0.4, 0.5)),
    ((0.4, 0.4, 0.4), (-0.4, 0.2, -0.4)),
)
RADII = (0.45, 0.55, 0.45)
NORMAL_EPS = 0.5773 * 0.00001


def animated_metaballs(elapsed_time, cycle_duration=METABALL_CYCLE_DURATION):
    """(centers (3, 3), radii (3,)) lerped by the smoothstepped triangle-wave
    interpolant (hlsli:88-120), on the device of ``elapsed_time``."""
    elapsed_time = torch.as_tensor(elapsed_time, dtype=torch.float32)
    dev = elapsed_time.device
    t = hlsl.calculate_animation_interpolant(elapsed_time, cycle_duration)
    # The keyframes and radii: uploaded once per device, no host sync.
    c0 = constant(tuple(tuple(k[0]) for k in KEYFRAME_CENTERS), dev)
    c1 = constant(tuple(tuple(k[1]) for k in KEYFRAME_CENTERS), dev)
    return hlsl.lerp(c0, c1, t), constant(tuple(RADII), dev)


def _pow_3_4_5(x):
    """x^3, x^4, x^5 by the reference's binary exponentiation
    (x^3 = x*x^2, x^4 = (x^2)^2, x^5 = x*x^4)."""
    x2 = x * x
    x4 = x2 * x2
    return x * x2, x4, x * x4


def metaball_potential(position, center, radius):
    """Quintic falloff 6d^5 - 15d^4 + 10d^3 over d = (r - dist)/r, zero
    outside the radius (hlsli:36-57)."""
    distance = hlsl.length(position - center)
    dr = (radius - distance) / radius
    d3, d4, d5 = _pow_3_4_5(dr)
    val = 6.0 * d5 - 15.0 * d4 + 10.0 * d3
    return torch.where(distance <= radius, val, 0.0)


def metaballs_potential(position, centers, radii):
    """Sum of the METABALLS_COUNT potentials (hlsli:60-73)."""
    total = metaball_potential(position, centers[0], radii[0])
    for j in range(1, METABALLS_COUNT):
        total = total + metaball_potential(position, centers[j], radii[j])
    return total


def metaballs_normal(position, centers, radii):
    """Central differences of the summed potential, f(p-e) - f(p+e)
    (hlsli:76-86), normalized."""
    e = NORMAL_EPS
    comps = []
    for axis in range(3):
        off = torch.zeros(3, dtype=position.dtype, device=position.device)
        off[axis] = e
        comps.append(metaballs_potential(position - off, centers, radii)
                     - metaballs_potential(position + off, centers, radii))
    return hlsl.normalize(torch.stack(comps, dim=-1))


def find_intersecting_metaballs(origins, directions, centers, radii, t_min, t_max):
    """Union of the bounding spheres' [entry, exit], each clipped to
    [t_min, t_max] before the union (hlsli:124-147)."""
    n = origins.shape[0]
    tmin = torch.full((n,), torch.inf, dtype=origins.dtype, device=origins.device)
    tmax = torch.full((n,), -torch.inf, dtype=origins.dtype, device=origins.device)
    for j in range(METABALLS_COUNT):
        has, t0, t1 = analytic.solve_ray_sphere(origins, directions, centers[j], radii[j])
        tmin = torch.where(has, torch.minimum(torch.clamp(t0, min=t_min), tmin), tmin)
        tmax = torch.where(has, torch.maximum(torch.minimum(t1, t_max), tmax), tmax)
    return torch.clamp(tmin, min=t_min), torch.minimum(tmax, t_max)


def intersect_metaballs(origins, directions, elapsed_time, *, t_min=0.0, t_max,
                        cull_backface, active, max_steps: int = METABALL_MAX_STEPS,
                        return_capped: bool = False):
    """RayMetaballsIntersectionTest (hlsli:151-202).

    origins/directions: (N, 3) local-space rays; t_max: (N,) per-ray bound
    (the shrinking RayTCurrent); active: (N,) gate. ``max_steps`` below
    128 caps the march (a compacted frame mode's main pass); the step stays
    the interval over 128, so a capped march is a strict prefix of the
    full one (scene_kernel._march_metaballs_part's step_div). Returns
    (hit, t_hit, normal) with t_hit = inf on a miss, and with
    ``return_capped`` the capped lanes: marched (a non-empty interval),
    the budget spent, no valid crossing. (The reference's kernel also
    leaves out lanes its potential bound proves empty, which the port
    does not compute; such lanes can only add to the repaired set.)"""
    n = origins.shape[0]
    dev = origins.device
    centers, radii = animated_metaballs(elapsed_time.to(dev))
    t_hit = torch.full((n,), torch.inf, dtype=origins.dtype, device=dev)
    normal = torch.zeros_like(origins)
    capped = torch.zeros(n, dtype=torch.bool, device=dev)

    tmin, tmax = find_intersecting_metaballs(origins, directions, centers, radii,
                                             t_min, t_max)
    # A lane that misses every bounding sphere cannot cross the isosurface.
    lanes = torch.nonzero(active & (tmax >= tmin)).squeeze(1)
    if lanes.numel():
        o, d, tm = origins[lanes], directions[lanes], t_max[lanes]
        step = (tmax[lanes] - tmin[lanes]) / float(METABALL_MAX_STEPS)
        t = tmin[lanes]
        steps = torch.zeros_like(lanes)
        found = torch.full_like(t, torch.inf)
        cur = torch.arange(lanes.numel(), device=dev)
        while cur.numel():
            tc = t[cur]
            oc, dc = o[cur], d[cur]
            sc = steps[cur]
            live = sc < max_steps
            pos = oc + tc[:, None] * dc
            crossed = live & (metaballs_potential(pos, centers, radii)
                              >= METABALL_ISO_THRESHOLD)
            valid = torch.zeros_like(crossed)
            if bool(crossed.any()):
                ci = torch.nonzero(crossed).squeeze(1)
                ok = (tc[ci] >= t_min) & (tc[ci] <= tm[cur[ci]])
                if cull_backface:
                    nrm = metaballs_normal(pos[ci], centers, radii)
                    ok = ok & (hlsl.dot(dc[ci], nrm) <= 0.0)
                valid[ci] = ok
            found[cur[valid]] = tc[valid]
            # Every counted sample that did not end the march steps on,
            # including invalid crossings (hlsli:199 steps unconditionally).
            go = live & ~valid
            steps[cur] = sc + live.to(sc.dtype)
            t[cur] = torch.where(go, tc + step[cur], tc)
            cur = cur[go]
        t_hit[lanes] = found
        capped[lanes] = (steps >= max_steps) & ~torch.isfinite(found)
    hit = torch.isfinite(t_hit)
    if bool(hit.any()):
        hi = torch.nonzero(hit).squeeze(1)
        pos = origins[hi] + t_hit[hi][:, None] * directions[hi]
        normal[hi] = metaballs_normal(pos, centers, radii)
    return (hit, t_hit, normal) + ((capped,) if return_capped else ())
