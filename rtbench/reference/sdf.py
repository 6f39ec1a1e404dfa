"""Signed-distance-field library + sphere-trace intersector.

Port of gpuraytracer_tpu/geometry/sdf.py (iq's distance functions as the
reference composes them: SignedDistancePrimitives.hlsli:55-319,
ProceduralPrimitivesLibrary.hlsli:63-98, SignedDistanceFractals.hlsli).

Distance functions take (N, 3) positions and return (N,) distances, with
the reference's association and HLSL fmod. ``sphere_trace`` keeps the
reference march's per-lane semantics (march from t_min in steps of
step_scale * distance until distance <= 1e-4 * t; an invalid crossing
keeps marching) on the compacted set of still-marching lanes.

The march knobs are frozen at the port's defaults (no ``GPURT_*``
environment variable is read).
"""

from __future__ import annotations

import torch

from rtbench.reference import hlsl
from rtbench.reference.upload import constant
from rtbench.reference.types import (
    FRACTAL_ITERATIONS_COUNT,
    SDF_HIT_THRESHOLD,
    SDF_MAX_STEPS,
    SignedDistancePrimitive,
)


def _vec(v, like):
    """A constant vector (or scalar) of ``like``'s type on its device,
    uploaded once per device (core/upload.constant): read it, never write
    it."""
    v = tuple(map(float, v)) if isinstance(v, (tuple, list)) else float(v)
    return constant(v, like.device, like.dtype)


# ---------------------------------------------------------------------------
# CSG operators and primitives (hlsli:55-273)
# ---------------------------------------------------------------------------

def op_subtract(d1, d2):
    return torch.maximum(d1, -d2)


def op_intersect(d1, d2):
    return torch.maximum(d1, d2)


def op_rep(p, c):
    """Domain repetition fmod(p, c) - 0.5*c with HLSL (truncating) fmod."""
    c = _vec(c, p)
    return hlsl.fmod(p, c) - 0.5 * c


def op_twist(p):
    """Rotate xz by angle 3*y (hlsli:108-114)."""
    c = torch.cos(3.0 * p[:, 1])
    s = torch.sin(3.0 * p[:, 1])
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    return torch.stack([c * x - s * z, s * x + c * z, y], dim=-1)


def sd_sphere(p, s):
    return hlsl.length(p) - s


def sd_box(p, b):
    d = torch.abs(p) - _vec(b, p)
    dmax = torch.maximum(torch.maximum(d[:, 0], d[:, 1]), d[:, 2])
    return torch.clamp(dmax, max=0.0) + hlsl.length(torch.clamp(d, min=0.0))


def ud_round_box(p, b, r):
    return hlsl.length(torch.clamp(torch.abs(p) - _vec(b, p), min=0.0)) - r


def _length_xz(p):
    return hlsl.sqrt(p[:, 0] * p[:, 0] + p[:, 2] * p[:, 2])


def _length2(a, b):
    return hlsl.sqrt(a * a + b * b)


def sd_torus(p, t):
    return _length2(_length_xz(p) - t[0], p[:, 1]) - t[1]


def sd_cylinder(p, h):
    d_x = torch.abs(_length_xz(p)) - h[0]
    d_y = torch.abs(p[:, 1]) - h[1]
    return (torch.clamp(torch.maximum(d_x, d_y), max=0.0)
            + _length2(torch.clamp(d_x, min=0.0), torch.clamp(d_y, min=0.0)))


def length_to_pow_negative8(a, b):
    """(a^8 + b^8)^(1/8) (hlsli:252-256), with pow(., 1/8) as the
    reference's XLA path evaluates it."""
    qa = a * a
    qa = qa * qa
    qa = qa * qa
    qb = b * b
    qb = qb * qb
    qb = qb * qb
    return torch.pow(qa + qb, 1.0 / 8.0)


def sd_torus82(p, t):
    """Square-profile torus: L2 ring distance, L8 tube norm (hlsli:258-262)."""
    return length_to_pow_negative8(_length_xz(p) - t[0], p[:, 1]) - t[1]


def sd_octahedron(p, h):
    d = (torch.maximum(torch.abs(p[:, 0]), torch.abs(p[:, 2])) * h[0]
         + torch.abs(p[:, 1]) * h[1])
    return d - h[1] * h[2]


def sd_pyramid(p, h):
    return op_subtract(sd_octahedron(p, h), p[:, 1])


def sd_fractal_pyramid(p, h, scale=2.0, iterations=FRACTAL_ITERATIONS_COUNT):
    """Sierpinski pyramid (SignedDistanceFractals.hlsli:34-63): fold toward
    the closest of 5 vertices (strict <, ties keep the earlier vertex),
    p <- scale*p - v*(scale-1), then sdPyramid rescaled by scale^-n."""
    a = h[2] * h[1] / h[0]
    vertices = [
        _vec((0.0, h[2], 0.0), p),
        _vec((-a, 0.0, a), p),
        _vec((a, 0.0, -a), p),
        _vec((a, 0.0, a), p),
        _vec((-a, 0.0, -a), p),
    ]
    for _ in range(iterations):
        best_v = vertices[0].expand_as(p)
        best_d = hlsl.length_sq(p - vertices[0])
        for v in vertices[1:]:
            dv = hlsl.length_sq(p - v)
            closer = dv < best_d
            best_v = torch.where(closer[:, None], v, best_v)
            best_d = torch.where(closer, dv, best_d)
        p = scale * p - best_v * (scale - 1.0)
    return sd_pyramid(p, h) * (scale ** (-float(iterations)))


# ---------------------------------------------------------------------------
# The seven composed scene objects (ProceduralPrimitivesLibrary.hlsli:63-98)
# ---------------------------------------------------------------------------

def distance_mini_spheres(p):
    return op_intersect(
        sd_sphere(op_rep(p + 1.0, (2.0 / 4.0, 2.0 / 4.0, 2.0 / 4.0)), 0.65 / 4.0),
        sd_box(p, (1.0, 1.0, 1.0)),
    )


def distance_intersected_round_cube(p):
    return op_subtract(
        op_subtract(ud_round_box(p, (0.75, 0.75, 0.75), 0.2), sd_sphere(p, 1.20)),
        -sd_sphere(p, 1.32),
    )


def distance_square_torus(p):
    return sd_torus82(p, (0.75, 0.15))


def distance_twisted_torus(p):
    return sd_torus(op_twist(p), (0.6, 0.2))


def distance_cog(p):
    """Torus82 ring minus angularly repeated cylinders; the polar angle is
    atan2 as in the reference's XLA path (not a polynomial)."""
    polar = torch.stack([
        torch.atan2(p[:, 2], p[:, 0]) / 6.2831,
        torch.ones_like(p[:, 0]),
        0.015 + 0.25 * hlsl.length(p),
    ], dim=-1)
    teeth = sd_cylinder(op_rep(polar + 1.0, (0.05, 1.0, 0.075)), (0.02, 0.8))
    return op_subtract(sd_torus82(p, (0.60, 0.3)), teeth)


def distance_cylinder(p):
    return op_intersect(
        sd_cylinder(op_rep(p + 1.0, (1.0, 2.0, 1.0)), (0.3, 2.0)),
        sd_box(p + 1.0, (2.0, 2.0, 2.0)),
    )


def distance_fractal_pyramid(p):
    """Base at y == -1 of the unit AABB; 63.435deg base angle, height 2."""
    return sd_fractal_pyramid(p + _vec((0.0, 1.0, 0.0), p), (0.894, 0.447, 2.0), 2.0)


DISTANCE_FUNCTIONS = {
    int(SignedDistancePrimitive.MINI_SPHERES): distance_mini_spheres,
    int(SignedDistancePrimitive.INTERSECTED_ROUND_CUBE): distance_intersected_round_cube,
    int(SignedDistancePrimitive.SQUARE_TORUS): distance_square_torus,
    int(SignedDistancePrimitive.TWISTED_TORUS): distance_twisted_torus,
    int(SignedDistancePrimitive.COG): distance_cog,
    int(SignedDistancePrimitive.CYLINDER): distance_cylinder,
    int(SignedDistancePrimitive.FRACTAL_PYRAMID): distance_fractal_pyramid,
}

# Codes inside the march_escape_t envelope (slope >= 0.4, support radius
# <= 2.5 local units): every reference primitive.
ESCAPE_SAFE_CODES = frozenset(DISTANCE_FUNCTIONS)
# Extension codes registered as AABB-windowed (geometry/fractal.py adds 7
# and 8 when the geometry package is imported). Their marches skip the
# back-face cull, run only inside the local unit box and take the
# extension relaxation (geometry/registry.py, csrc/traverse.cuh).
AABB_WINDOWED_CODES = frozenset()


def register_distance_function(code, fn, *, aabb_windowed=False):
    """Register an extension distance function (codes past 0..6). It makes
    no escape-envelope claim, so the caller must declare AABB-windowed
    marches, which stop at the local unit box's exit."""
    global AABB_WINDOWED_CODES
    code = int(code)
    if not aabb_windowed:
        raise ValueError(
            f"distance function code {code}: extension codes are marched "
            "inside their unit box only; declare aabb_windowed=True")
    DISTANCE_FUNCTIONS[code] = fn
    AABB_WINDOWED_CODES = AABB_WINDOWED_CODES | {code}


def calculate_normal(pos, distance_fn):
    """Tetrahedral-offset gradient estimate, e = 0.5773e-4 (hlsli:275-283)."""
    e = 0.5773 * 0.0001
    offsets = [_vec(o, pos) for o in ((e, -e, -e), (-e, -e, e), (-e, e, -e), (e, e, e))]
    n = offsets[0] * distance_fn(pos + offsets[0])[:, None]
    for off in offsets[1:]:
        n = n + off * distance_fn(pos + off)[:, None]
    return hlsl.normalize(n)


# ---------------------------------------------------------------------------
# March knobs (read at call time; same variables and defaults as the
# reference package, geometry/sdf.py:407-585)
# ---------------------------------------------------------------------------

ESCAPE_ALPHA_INV = 2.5
ESCAPE_RADIUS = 12.0  # already multiplied by ESCAPE_ALPHA_INV (2x margin)


def march_escape_t(o_norm, d_norm):
    """Upper bound on any crossing t for a local ray with |origin| = o_norm,
    |direction| = d_norm: no crossing exists once
    t * (|d| - ESCAPE_ALPHA_INV * threshold) > |o| + ESCAPE_RADIUS."""
    denom = torch.clamp(d_norm - ESCAPE_ALPHA_INV * SDF_HIT_THRESHOLD, min=1e-6)
    return (o_norm + ESCAPE_RADIUS) / denom


def _env_relax(name: str, default: float) -> float:
    """The knob's default: the reference never reads the environment."""
    return default


def _env_budget(name: str, default: int) -> int:
    """The knob's default: the reference never reads the environment."""
    return default


def reference_relax() -> float:
    """GPURT_RELAX_REF: opt-in over-relaxation of radiance marches (default
    1.0, off)."""
    return _env_relax("GPURT_RELAX_REF", 1.0)


def occlusion_relax() -> float:
    """GPURT_RELAX_SHADOW: over-relaxation of occlusion marches (default 1.6)."""
    return _env_relax("GPURT_RELAX_SHADOW", 1.6)


RELAX_OMEGA = 1.6


def extension_relax() -> float:
    """GPURT_RELAX: over-relaxation of the AABB-windowed extension
    fractals' marches (default 1.6)."""
    return _env_relax("GPURT_RELAX", RELAX_OMEGA)


def march_relax(windowed: bool, occlusion: bool = False) -> float:
    """Relaxation of a march of an AABB-windowed code or a reference code."""
    base = extension_relax() if windowed else reference_relax()
    return max(base, occlusion_relax()) if occlusion else base


def relax_for_code(code: int, occlusion: bool = False) -> float:
    """Relaxation of a march of SDF code ``code``."""
    return march_relax(int(code) in AABB_WINDOWED_CODES, occlusion)


def shadow_budget_cap() -> int:
    """GPURT_SHADOW_BUDGET: occlusion march budget cap (default 96; 0 off)."""
    return _env_budget("GPURT_SHADOW_BUDGET", 96)


def bounce_shadow_budget_cap() -> int:
    """GPURT_SHADOW_BUDGET_B: extra cap at bounce levels (default 64)."""
    return _env_budget("GPURT_SHADOW_BUDGET_B", 64)


def radiance_budget_cap() -> int:
    """GPURT_MARCH_BUDGET: radiance march budget cap (default 160; 0 off)."""
    return _env_budget("GPURT_MARCH_BUDGET", 160)


def bounce_radiance_budget_cap() -> int:
    """GPURT_MARCH_BUDGET_B: extra cap at bounce levels (default 128)."""
    return _env_budget("GPURT_MARCH_BUDGET_B", 128)


def cap_occlusion_budget(budget: int, bounce: bool = False) -> int:
    cap = shadow_budget_cap()
    budget = min(int(budget), cap) if cap else int(budget)
    if bounce:
        bcap = bounce_shadow_budget_cap()
        if bcap:
            budget = min(budget, bcap)
    return budget


def cap_radiance_budget(budget: int, bounce: bool = False) -> int:
    cap = radiance_budget_cap()
    budget = min(int(budget), cap) if cap else int(budget)
    if bounce:
        bcap = bounce_radiance_budget_cap()
        if bcap:
            budget = min(budget, bcap)
    return budget


def march_budget(natural: int, *, occlusion: bool, level: int, cap: int | None = None):
    """(budget, capped_hit) of one march at recursion ``level``: bounce
    levels (>= 1) take the harsher bounce cap, and an occlusion march whose
    budget sits below the geometry's natural one reports OCCLUDED when it
    runs out (reference: accel/traverse._dispatch_procedural).

    ``cap``: the step cap of a compacted frame mode's main pass
    (scene_kernel._traverse_tile's budget_cap), applied to the natural
    budget before the level's knobs. The occluded-on-cap rule binds only
    where the capped budget is the plain one (scene_kernel.py:1479-1505):
    a march capped below it reports a miss, and its lane goes to the
    repair pass."""
    if occlusion:
        steps = cap_occlusion_budget(natural if cap is None else min(cap, natural))
        steps_b = cap_occlusion_budget(steps, bounce=True)
    else:
        steps = cap_radiance_budget(natural if cap is None else min(cap, natural))
        steps_b = cap_radiance_budget(steps, bounce=True)
    budget = steps_b if (level > 0 and steps_b < steps) else steps
    plain = budget if cap is None else march_budget(natural, occlusion=occlusion, level=level)[0]
    return budget, bool(occlusion and budget == plain and plain < natural)


def cap_marks_dirty(natural: int, *, occlusion: bool, cap: int | None) -> bool:
    """Whether a march capped by ``cap`` sets its geometry's dirty bit: only
    where the smaller of its capped budgets at the two kinds of level sits
    below the natural budget (scene_kernel.py:1506-1510)."""
    return march_budget(natural, occlusion=occlusion, level=1, cap=cap)[0] < natural


# ---------------------------------------------------------------------------
# Sphere tracer (hlsli:287-319)
# ---------------------------------------------------------------------------

def sphere_trace(origins, directions, distance_fn, *, step_scale, t_min=0.0, t_max,
                 cull_backface, active, max_steps: int = SDF_MAX_STEPS,
                 escape_bound: bool = True, relax: float = 1.0, capped_hit: bool = False,
                 capped_t=None, return_capped: bool = False):
    """RaySignedDistancePrimitiveTest over (N, 3) local-space rays.

    Per lane: sample d = f(o + t*dir); a sample is counted against
    ``max_steps``; d <= 1e-4*t is a crossing, which ends the march if the
    hit is valid (t in [t_min, t_max], and facing the ray when culling) and
    otherwise steps on by step_scale*d like any other sample. Lanes retire
    past the escape bound (``march_escape_t``, result-identical).

    relax > 1: Keinert over-relaxation with overshoot back-step, as the
    reference (cruise steps relax*step_scale*d; consecutive safety spheres
    disjoint -> step back (1-relax)*relax*step_scale*d_prev and march
    plainly from then on; an invalid crossing also ends relaxation).

    Non-relaxed marches retire cycles: an advance that leaves t unchanged
    or returns to the previous t repeats forever, so the lane is marked as
    having spent its budget at once — the same result as the reference
    burning its remaining steps, including under ``capped_hit``.

    capped_hit: lanes that spend the budget without a valid hit report a
    hit at their final t (occlusion semantics under reduced budgets), or
    at ``capped_t`` where one is given (the per-geometry kernel writes 0).

    t_min is a float or a per-lane (N,) tensor (the window entry of an
    AABB-windowed march); the march starts there and a crossing before it
    is invalid.

    Returns (hit, t_hit) with t_hit = inf on a miss; with
    ``return_capped`` also the capped lanes, as the reference defines
    them (scene_kernel.py:459-463): active, the budget spent, no valid
    crossing (whatever ``capped_hit`` then reports).
    """
    march = SphereTrace(origins, directions, distance_fn, step_scale=step_scale, t_min=t_min,
                        t_max=t_max, cull_backface=cull_backface, active=active,
                        max_steps=max_steps, escape_bound=escape_bound, relax=relax)
    while march.marching:
        march.step()
    return march.result(capped_hit=capped_hit, capped_t=capped_t, return_capped=return_capped)


class SphereTrace:
    """``sphere_trace``'s march, resumable: ``step`` takes one sample on
    every lane still marching (one pass of sphere_trace's loop), ``kill``
    retires lanes, ``result`` answers as sphere_trace does. The merged
    occlusion march (kernels/scene_kernel.occluded_merged_plain) advances
    one per geometry in turns."""

    def __init__(self, origins, directions, distance_fn, *, step_scale, t_min=0.0, t_max,
                 cull_backface, active, max_steps: int = SDF_MAX_STEPS,
                 escape_bound: bool = True, relax: float = 1.0):
        n = origins.shape[0]
        dev = origins.device
        self.n, self.fn, self.step_scale = n, distance_fn, step_scale
        self.cull, self.max_steps, self.relax = cull_backface, max_steps, relax
        self.lanes = torch.nonzero(active).squeeze(1)
        lanes = self.lanes
        self.o, self.d, self.tm = origins[lanes], directions[lanes], t_max[lanes]
        if escape_bound:
            self.t_esc = torch.minimum(self.tm, march_escape_t(hlsl.length(self.o),
                                                               hlsl.length(self.d)))
        else:
            self.t_esc = self.tm
        m = lanes.numel()
        if torch.is_tensor(t_min):
            self.t_lo = t_min[lanes]
        else:
            self.t_lo = torch.full((m,), float(t_min), dtype=origins.dtype, device=dev)
        self.t = self.t_lo.clone()
        self.steps = torch.zeros(m, dtype=torch.int32, device=dev)
        self.found = torch.full_like(self.t, torch.inf)
        if relax > 1.0:
            self.rprev = torch.zeros_like(self.t)
            self.oon = torch.ones(m, dtype=torch.bool, device=dev)
        else:
            self.t_prev = torch.full_like(self.t, -1.0)
        self.cur = torch.arange(m, device=dev)

    @property
    def marching(self) -> bool:
        return self.cur.numel() > 0

    def step(self):
        """One sample on every marching lane."""
        cur, relax, step_scale, max_steps = self.cur, self.relax, self.step_scale, self.max_steps
        tc, oc, dc, sc = self.t[cur], self.o[cur], self.d[cur], self.steps[cur]
        live = sc < max_steps
        pos = oc + tc[:, None] * dc
        dist = self.fn(pos)
        relaxed = relax > 1.0
        if relaxed:
            rp, on = self.rprev[cur], self.oon[cur]
            fail = live & on & (dist + rp < relax * rp)
            crossed = live & (dist <= SDF_HIT_THRESHOLD * tc) & ~fail
        else:
            crossed = live & (dist <= SDF_HIT_THRESHOLD * tc)
        valid = torch.zeros_like(crossed)
        if bool(crossed.any()):
            ci = torch.nonzero(crossed).squeeze(1)
            ok = (tc[ci] >= self.t_lo[cur[ci]]) & (tc[ci] <= self.tm[cur[ci]])
            if self.cull:
                nrm = calculate_normal(pos[ci], self.fn)
                ok = ok & (hlsl.dot(dc[ci], nrm) <= 0.0)
            valid[ci] = ok
        self.found[cur[valid]] = tc[valid]
        moved = live & ~valid
        plain = step_scale * dist
        if relaxed:
            resumed = crossed & ~valid
            stepv = torch.where(
                fail, (1.0 - relax) * relax * (step_scale * rp),
                torch.where(on & ~resumed, relax * plain, plain))
            escaped = moved & ~fail & (tc + plain > self.t_esc[cur])
            t_new = tc + stepv
            self.oon[cur] = on & ~fail & ~resumed
            self.rprev[cur] = torch.where(moved, dist, rp)
            go = moved & ~escaped
            self.steps[cur] = sc + live.to(sc.dtype)
        else:
            t_new = tc + plain
            tp = self.t_prev[cur]
            stuck = moved & ((t_new == tc) | (t_new == tp))
            self.t_prev[cur] = torch.where(moved, tc, tp)
            go = moved & ~(t_new > self.t_esc[cur]) & ~stuck
            self.steps[cur] = torch.where(stuck, max_steps, sc + live.to(sc.dtype))
        self.t[cur] = torch.where(moved, t_new, tc)
        self.cur = cur[go]

    def hits(self):
        """The (N,) lanes that have met a valid crossing so far."""
        out = torch.zeros(self.n, dtype=torch.bool, device=self.o.device)
        out[self.lanes[torch.isfinite(self.found)]] = True
        return out

    def kill(self, mask):
        """Retire the marching lanes set in the (N,) bool ``mask``."""
        self.cur = self.cur[~mask[self.lanes[self.cur]]]

    def result(self, *, capped_hit: bool = False, capped_t=None, return_capped: bool = False):
        """(hit, t_hit[, capped]) as ``sphere_trace`` returns them."""
        dev = self.o.device
        t_hit = torch.full((self.n,), torch.inf, dtype=self.o.dtype, device=dev)
        capped_all = torch.zeros(self.n, dtype=torch.bool, device=dev)
        capped = (self.steps >= self.max_steps) & ~torch.isfinite(self.found)
        found = self.found
        if capped_hit:
            found = torch.where(capped, self.t if capped_t is None
                                else torch.full_like(self.t, capped_t), found)
        t_hit[self.lanes] = found
        if return_capped:
            capped_all[self.lanes] = capped
            return torch.isfinite(t_hit), t_hit, capped_all
        return torch.isfinite(t_hit), t_hit


def march(o, d, gate, t_max, step_scale, *, prim_code: int, cull_backface: bool = True,
          max_steps: int = SDF_MAX_STEPS, t_start=None, relax: float = 1.0,
          capped_hit: bool = False, capped_t=None, with_normal: bool = True,
          return_capped: bool = False):
    """One SDF geometry's march over the gated lanes of (N, 3) local rays, in
    the form of the march kernel's wrapper (kernels/megakernel.py): from
    t_start ((N,), None: 0) to t_max, the escape bound for ESCAPE_SAFE_CODES
    only, then the tetrahedral normal at each hit ((0, 0, 0) elsewhere;
    None when not ``with_normal``). Returns (hit, t_hit, normal), and the
    capped lanes (``sphere_trace``) after them with ``return_capped``."""
    code = int(prim_code)
    fn = DISTANCE_FUNCTIONS[code]
    hit, t, *capped = sphere_trace(
        o, d, fn, step_scale=step_scale, t_min=0.0 if t_start is None else t_start,
        t_max=t_max, cull_backface=cull_backface, active=gate, max_steps=int(max_steps),
        escape_bound=code in ESCAPE_SAFE_CODES, relax=float(relax),
        capped_hit=bool(capped_hit), capped_t=capped_t, return_capped=return_capped)
    normal = None
    if with_normal:
        normal = torch.zeros_like(o)
        if bool(hit.any()):
            hi = torch.nonzero(hit).squeeze(1)
            normal[hi] = calculate_normal(o[hi] + t[hi][:, None] * d[hi], fn)
    return (hit, t, normal, *capped)


