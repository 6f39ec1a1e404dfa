"""Wavefront integrator — the TraceRay recursion unrolled to depth 3.

Port of gpuraytracer_tpu/render/trace.py. Every closest-hit colour is
affine in the colour its reflection child returns,

    c_d = base_d + M_d * c_{d+1}
    base_d = (1 - fog_d) * checkers_d * phong_d + fog_d * BACKGROUND
    M_d    = (1 - fog_d) * checkers_d * reflectance * float4(fresnel, 1)

so c_0 = sum_d (prod_{j<d} M_j) * base_d, accumulated with a running
throughput. Shadow rays are traced at levels 0 and 1 only (the recursion
cap, Raytracing.hlsl:117-120).

``trace_radiance`` is the plain PyTorch version of the CUDA frame kernel
(kernels/frame_kernel.py): each level over the lanes still alive, which a
``torch.nonzero`` compacts. ``render_frame`` sends a CUDA scene to the
frame kernel when it is fused-eligible, and every other CUDA scene to this
wavefront, whose traversal passes take the scene's route
(accel/traverse.py): the CUDA scene kernel (kernels/scene_kernel.py)
within the mesh face cap, the per-geometry route with the march kernel of
kernels/megakernel.py past it. On a GPU the wavefront runs as
``render_lanes``, one stream-ordered chain of launches with no host sync:
every lane under an active mask for the whole frame, the passes over every
lane, the level's work between them in the lane kernels of
kernels/wavefront.py, whose plain versions are ``_surface``,
``_shadow_ray`` and ``_shading`` over the active lanes, the code
``trace_radiance`` runs. A CPU scene renders through ``trace_radiance``
with the scene kernel's plain version.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from gpuraytracer_tpu_torch.accel import traverse
from gpuraytracer_tpu_torch.accel.instances import Scene, ray_to_blas
from gpuraytracer_tpu_torch.accel.traverse import any_hit, closest_hit
from gpuraytracer_tpu_torch.core import camera as cam
from gpuraytracer_tpu_torch.core import hlsl
from gpuraytracer_tpu_torch.core.upload import constant
from gpuraytracer_tpu_torch.core.types import (
    MAX_RAY_RECURSION_DEPTH,
    RAY_TMAX,
    RAY_TMIN,
    REFLECTANCE_EPS,
    HitRecord,
)
from gpuraytracer_tpu_torch.render import checkers as checkers_mod
from gpuraytracer_tpu_torch.render import shade
from gpuraytracer_tpu_torch.utils import debug


def _material_rows(scene: Scene, geometry_id):
    """Material-table row of each lane's geometry: geometry ids map through
    layout.material_ids when the table is deduplicated; miss lanes (-1)
    take row 0 and are masked by the callers."""
    gid = geometry_id.clamp(min=0)
    ids = scene.layout.material_ids
    if ids is None:
        return gid
    table = constant(tuple(ids), gid.device, torch.int64)
    return torch.where(geometry_id >= 0, table[gid], 0)


class Surface(NamedTuple):
    """What a level's closest hit leaves for the shading over B lanes: the
    hit, its position and its material row's fields (the plane and misses
    through ``_material_rows``); csrc/wavefront.cu's Surface, whose Phong
    geometry terms ``_shadow_ray`` and shade.phong_lighting compute here."""

    hit: HitRecord
    hit_pos: torch.Tensor
    albedo: torch.Tensor
    refl_coef: torch.Tensor
    diff_coef: torch.Tensor
    spec_coef: torch.Tensor
    spec_pow: torch.Tensor


def _surface(scene: Scene, oa, da, hit: HitRecord) -> Surface:
    mats = scene.arrays.materials
    gid = _material_rows(scene, hit.geometry_id)
    return Surface(hit, oa + hit.t[:, None] * da, mats.albedo[gid],
                   mats.reflectance_coefficient[gid], mats.diffuse_coefficient[gid],
                   mats.specular_coefficient[gid], mats.specular_power[gid])


def _shadow_ray(scene: Scene, surf: Surface, da):
    """(needed, shadow direction) of the lanes' shadow rays: a shadow ray
    is traced only where it can change the image. The shadow factor scales
    the diffuse term (zero when kd == 0) and zeroes the specular term (zero
    when spec * ks == 0), so lanes where both vanish render identically lit
    or shadowed."""
    light_pos = scene.arrays.constants.light_position[:3]
    nrm, hit_pos = surf.hit.normal, surf.hit_pos
    incident = hlsl.normalize(hit_pos - light_pos)
    kd = hlsl.saturate(hlsl.dot(-incident, nrm))
    refl_l = hlsl.normalize(hlsl.reflect(incident, nrm))
    ks = torch.pow(hlsl.saturate(hlsl.dot(refl_l, hlsl.normalize(-da))), surf.spec_pow)
    needed = surf.hit.hit & ((kd > 0.0) | (surf.spec_coef * ks > 0.0))
    return needed, hlsl.normalize(light_pos - hit_pos)


class Shading(NamedTuple):
    """A level's shading over B lanes: ``base(in_shadow)`` the (B, 4)
    colour before the throughput (Phong under that shadow flag), ``mult``
    the (B, 4) reflection multiplier, ``reflective`` (B,) bool."""

    base: Callable
    mult: torch.Tensor
    reflective: torch.Tensor


def _shading(scene: Scene, surf: Surface, da, px, py, width: int, height: int) -> Shading:
    """Phong with fake AO, the checkerboard on plane hits (px, py: the
    lanes' pixels, whose neighbours' camera rays give its differentials),
    the Fresnel-weighted reflection multiplier and the fog of the lanes'
    surfaces (csrc/wavefront.cu shading, phong, base, mult)."""
    constants = scene.arrays.constants
    light_pos = constants.light_position[:3]
    hit, hit_pos = surf.hit, surf.hit_pos
    nrm = hit.normal
    bg = shade.background_color(hit_pos.device)

    def phong_for(shadowed):
        return shade.phong_lighting(
            surf.albedo, nrm, shadowed, hit_pos, da, light_pos,
            constants.light_ambient_color, constants.light_diffuse_color,
            surf.diff_coef, surf.spec_coef, surf.spec_pow,
        )

    # Checkerboard modulation on plane hits only (Raytracing.hlsl:195,211).
    k = torch.ones_like(hit.t)
    on_plane = torch.nonzero(hit.geometry_id == scene.layout.plane_geometry_id).squeeze(1)
    if on_plane.numel():
        k[on_plane] = checkers_mod.analytical_checkers(
            hit_pos[on_plane], nrm[on_plane], px[on_plane], py[on_plane], width, height,
            constants.camera_position, constants.projection_to_world,
        )
    k = k[:, None]

    # Reflection multiplier reflectance * float4(fresnel(albedo.rgb), 1),
    # gated on reflectance > 0.001 (Raytracing.hlsl:198-207, 233-242).
    fresnel = shade.fresnel_reflectance_schlick(da, nrm, surf.albedo[:, :3])
    refl_mult = surf.refl_coef[:, None] * torch.cat([fresnel, torch.ones_like(fresnel[:, :1])],
                                                    dim=-1)
    reflective = hit.hit & (surf.refl_coef > REFLECTANCE_EPS)
    refl_mult = torch.where(reflective[:, None], refl_mult, 0.0)

    fog = shade.fog_factor(hit.t)[:, None]
    hit4 = hit.hit[:, None]

    def base(in_shadow):
        return torch.where(hit4, (1.0 - fog) * (k * phong_for(in_shadow)) + fog * bg, bg)

    return Shading(base, torch.where(hit4, (1.0 - fog) * k * refl_mult, 0.0), reflective)


@dataclasses.dataclass(frozen=True)
class MainPass:
    """The main pass of a compacted frame mode: what the level loop of the
    reference's _frame_kernel carries besides the plain frame
    (gpuraytracer_tpu/kernels/frame_kernel.py:270-294, 330-333, 382-418,
    502-549). ``closest`` and ``shadow`` are the (SDF, metaball) step caps
    of the closest and the occlusion passes (None: uncapped).

    compact (``defer`` False): one dirty mask per lane, sticky across
    levels and both kinds of ray; every capped traversal kills (a dirty
    lane passes no further gate), and a lane that is dirty after its
    closest pass is dropped. With ``resume``, a dirty lane's state at the
    start of the level where it became dirty is kept (``PixelState``; the
    CUDA compact entry's queue entry). defer: the closest passes are never
    capped; each level's occlusion pass has a dirty mask of its own, and
    the level's contributions under both shadow variants, its shadow status
    and its shadow ray are recorded (``DeferPlanes``)."""

    closest: tuple = (None, None)
    shadow: tuple = (None, None)
    defer: bool = False
    resume: bool = False


class PixelState(NamedTuple):
    """Lanes' state at the start of a level (B lanes): ``level`` (B,)
    int32, the ray ``o``, ``d`` (B, 3), the colour so far and the
    throughput (B, 4). The compact main pass keeps it for its dirty lanes
    (``MainPass.resume``), and ``trace_radiance(start=...)`` continues
    from it."""

    level: torch.Tensor
    o: torch.Tensor
    d: torch.Tensor
    color: torch.Tensor
    throughput: torch.Tensor


class DeferPlanes(NamedTuple):
    """The deferred-shadow main pass's outputs over a batch B of pixels
    (the reference's plane set, frame_kernel.py:1174-1179), with D levels:
    ``lit`` (D, *B, 4) f32, each level's colour contribution with the
    light visible; ``shadowed`` (D-1, *B, 4) f32, the same in shadow;
    ``sinfo`` (D-1, *B) int32, status (0 lit, 1 shadowed, 2 unknown: a
    capped occlusion march found nothing) | dirty bits << 2; ``rays``
    (D-1, *B, 6) f32, the shadow ray (BLAS-space origin, direction).
    Levels a lane never reaches hold zeros."""

    lit: torch.Tensor
    shadowed: torch.Tensor
    sinfo: torch.Tensor
    rays: torch.Tensor


def trace_radiance(origins, directions, pixel_x, pixel_y, width, height, scene: Scene,
                   *, max_depth: int = MAX_RAY_RECURSION_DEPTH, main: MainPass | None = None,
                   start: PixelState | None = None):
    """Trace radiance rays (..., 3) and return float4 colours (..., 4).

    pixel_x/pixel_y are the launch indices (DispatchRaysIndex), which the
    checkerboard's ray differentials need at every bounce. Each level works
    on the lanes still alive; a lane retires when its reflection is off or
    its outgoing throughput is exactly zero on every channel (it would add
    +0.0 at every later level, so retiring it is result-exact).

    Every pass is its route's plain version (on a GPU too: the device form
    of the wavefront is ``render_lanes``).

    ``main``: the plain version of a compacted frame mode's main pass
    (``MainPass``; the passes run as the scene kernel's plain version).
    Compact returns (colours, dirty mask (...) int32), and with
    ``main.resume`` also the dirty lanes' ``PixelState`` (valid where the
    mask is set); a dirty lane's colour is not the frame's (the dense pass
    renders it again). Defer returns the ``DeferPlanes``.

    ``start``: each lane's ``PixelState`` (origins and directions are its
    ``o`` and ``d``): a lane starts at its level with its colour and
    throughput, as the resumed dense pass does.
    """
    arrays = scene.arrays
    batch = origins.shape[:-1]
    dev = origins.device
    o = origins.reshape(-1, 3).clone()
    d = directions.reshape(-1, 3).clone()
    px_all = pixel_x.reshape(-1)
    py_all = pixel_y.reshape(-1)
    n = o.shape[0]

    color = torch.zeros(n, 4, dtype=torch.float32, device=dev)
    throughput = torch.ones(n, 4, dtype=torch.float32, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    first = None
    if start is not None:
        color, throughput = start.color.reshape(-1, 4).clone(), start.throughput.reshape(-1, 4).clone()
        first = start.level.reshape(-1)
    defer = main is not None and main.defer
    dirty = saved = None
    if main is not None and not defer:
        dirty = torch.zeros(n, dtype=torch.int32, device=dev)
        if main.resume:
            saved = PixelState(torch.zeros(n, dtype=torch.int32, device=dev), o.clone(), d.clone(),
                               color.clone(), throughput.clone())

    def save(at, level, oa, da):
        # at: indices into lanes of the lanes that a cap stopped at this level
        if saved is not None and at.numel():
            ln = lanes[at]
            saved.level[ln] = level
            saved.o[ln], saved.d[ln] = oa[at], da[at]
            saved.color[ln], saved.throughput[ln] = color[ln], throughput[ln]
    if defer:
        nsl = max_depth - 1
        planes = DeferPlanes(
            lit=torch.zeros(max_depth, n, 4, dtype=torch.float32, device=dev),
            shadowed=torch.zeros(nsl, n, 4, dtype=torch.float32, device=dev),
            sinfo=torch.zeros(nsl, n, dtype=torch.int32, device=dev),
            rays=torch.zeros(nsl, n, 6, dtype=torch.float32, device=dev))

    def capped(caps, mask):
        return dict(budget_cap=caps[0], mb_budget_cap=caps[1], dirty=mask, kill_on_cap=True)

    for level in range(max_depth):
        lanes = torch.nonzero(active if first is None else active & (first <= level)).squeeze(1)
        if lanes.numel() == 0:
            if first is not None and bool((active & (first > level)).any()):
                continue
            break
        oa, da = o[lanes], d[lanes]
        mask = None if dirty is None else dirty[lanes]
        clean = None if mask is None else mask == 0
        hit = closest_hit(oa, da, scene, t_min=RAY_TMIN, t_max=RAY_TMAX,
                          cull_backface=True, level=level, plain=True,
                          caps=None if mask is None else capped(main.closest, mask))
        if mask is not None:
            # A lane capped in its closest pass is dropped here: the dense
            # pass renders it again from this level. (A dropped lane stays
            # active; its mask kills it at every later gate.)
            dirty[lanes] = mask
            save(torch.nonzero(clean & (mask != 0)).squeeze(1), level, oa, da)
            keep = torch.nonzero(mask == 0).squeeze(1)
            lanes, oa, da = lanes[keep], oa[keep], da[keep]
            hit = HitRecord(t=hit.t[keep], normal=hit.normal[keep],
                            geometry_id=hit.geometry_id[keep], hit=hit.hit[keep])
        if debug.nan_checks_enabled():  # the NaN trap (utils/debug.debug_layer)
            debug.trap(f"level {level} closest pass", hit.t[hit.hit], hit.normal[hit.hit])
        surf = _surface(scene, oa, da, hit)
        hit_pos = surf.hit_pos

        # Shadow ray, only where it can change the image (``_shadow_ray``).
        in_shadow = torch.zeros_like(hit.hit)
        if level + 1 < max_depth:
            needed, shadow_dir = _shadow_ray(scene, surf, da)
            if main is not None:
                # compact: the lane's sticky mask (0 here); defer: the level's own.
                mask = (dirty[lanes] if dirty is not None
                        else torch.zeros(lanes.shape[0], dtype=torch.int32, device=dev))
            in_shadow = any_hit(hit_pos, shadow_dir, scene, t_min=RAY_TMIN,
                                t_max=RAY_TMAX, active=needed, level=level, plain=True,
                                caps=None if main is None else capped(main.shadow, mask))
            if debug.nan_checks_enabled():
                debug.trap(f"level {level} shadow pass", hit_pos[needed], shadow_dir[needed])
            if dirty is not None:
                dirty[lanes] = mask
                save(torch.nonzero(mask != 0).squeeze(1), level, oa, da)
            elif defer:
                unknown = ~in_shadow & (mask != 0)
                status = torch.where(in_shadow, 1, torch.where(unknown, 2, 0)).to(torch.int32)
                planes.sinfo[level, lanes] = status | (mask << 2)
                ob, _ = ray_to_blas(hit_pos, shadow_dir, arrays.blas_offset)
                planes.rays[level, lanes] = torch.cat([ob, shadow_dir], dim=-1)

        shading = _shading(scene, surf, da, px_all[lanes], py_all[lanes], width, height)
        base = shading.base(in_shadow)
        mult, reflective = shading.mult, shading.reflective

        tw = throughput[lanes]
        if defer:
            # Both variants, in the association of the plain recurrence.
            planes.lit[level, lanes] = tw * shading.base(torch.zeros_like(hit.hit))
            if level + 1 < max_depth:
                planes.shadowed[level, lanes] = tw * shading.base(torch.ones_like(hit.hit))
        color[lanes] = color[lanes] + tw * base
        tw_out = tw * mult
        throughput[lanes] = tw_out
        live = reflective & (tw_out != 0.0).any(dim=-1)
        active[lanes] = live if dirty is None else live & (dirty[lanes] == 0)
        o[lanes] = hit_pos
        d[lanes] = hlsl.reflect(da, hit.normal)
        if debug.nan_checks_enabled():
            debug.trap(f"level {level} shading", color[lanes], throughput[lanes])
    if defer:
        return DeferPlanes(*(p.reshape(p.shape[:1] + batch + p.shape[2:]) for p in planes))
    color = color.reshape(batch + (4,))
    if saved is not None:
        return color, dirty.reshape(batch), PixelState(
            *(x.reshape(batch + x.shape[1:]) for x in saved))
    return color if dirty is None else (color, dirty.reshape(batch))


def render_frame(scene: Scene, width: int, height: int, *,
                 max_depth: int = MAX_RAY_RECURSION_DEPTH, row_offset: int = 0,
                 local_height: int | None = None, pack=None):
    """Full frame, the DispatchRays(W, H, 1) analog; returns an (H, W, 4)
    float32 radiance image on the scene's device. With ``row_offset`` and
    ``local_height`` (kernels/frame_kernel.band_height), the band of those
    rows of the W x H frame, (local_height, W, 4), on every route and in
    every mode: its pixels are the whole frame's.

    A CUDA scene renders as the reference routes it: through the
    hand-written frame kernel when it is fused-eligible
    (frame_kernel.fused_eligible_layout: at most 16 materials and 512 mesh
    faces), else through the wavefront, whose passes run in the scene
    kernel for a scene of at most 512 mesh faces and on the per-geometry
    route (the march kernel and the mesh entry of csrc/megakernel.cu)
    past that; what no route covers raises (frame_kernel.
    check_kernel_covers). As in the reference (render/trace.py:226-247),
    GPURT_FRAME_MODE is read only for a fused-eligible scene: "compact"
    and "defer" render it through frame_kernel.render_frame_compact and
    render_frame_deferred, "plain" (the default) through the frame kernel
    alone; every other scene takes its wavefront route in any mode.

    A CPU scene renders through the wavefront with plain passes, or in
    "compact" or "defer" mode (fused-eligible only) through those modes'
    host code with their kernels' plain versions.

    ``pack``: the frame's packed buffers (frame_kernel.FramePack), built
    from the scene (frame_kernel.pack_frame) if None; a frame program
    (render/program.py) passes the pack it keeps and writes in place. The
    CPU's plain mode renders the scene's arrays and reads no pack."""
    from gpuraytracer_tpu_torch.kernels import frame_kernel

    route, mode = frame_route(scene)
    band = dict(row_offset=row_offset, local_height=local_height)
    if scene.arrays.aabb_min.device.type == "cuda":
        frame_kernel.check_kernel_covers(scene.layout, route)
    elif mode == "plain":
        return render_wavefront(scene, width, height, max_depth=max_depth, **band)
    pack = pack if pack is not None else frame_kernel.pack_frame(scene)
    kw = dict(width=width, height=height, max_depth=max_depth, **band)
    if mode == "compact":
        return frame_kernel.render_frame_compact(pack, **kw)
    if mode == "defer":
        return frame_kernel.render_frame_deferred(pack, **kw)
    if route == "frame":
        return frame_kernel.render_frame_tiles(pack, **kw)
    return render_wavefront(scene, width, height, max_depth=max_depth, pack=pack, **band)


def make_renderer(layout, width: int, height: int, *,
                  max_depth: int = MAX_RAY_RECURSION_DEPTH):
    """The frame function over a scene's arrays, ``render(arrays)`` -> the
    (H, W, 4) image, with the layout, size and depth bound (the reference's
    make_renderer, render/trace.py:260-267 there: a jit-compiled frame
    function, the compiled RTPSO analog).

    On a GPU each call copies ``arrays`` device to device into a program's
    static inputs and replays its captured graph (render/program.py): the
    whole pack of the arrays (frame_kernel.repack, torch ops in the graph)
    and ``render_frame`` on the scene's route and in its mode. A program is
    built at the first call for its key (the device, the arrays' shapes,
    the route, the frame mode and the GPURT_* knobs); a failed capture or
    replay raises. On the CPU, which has no graphs, each call renders the
    arrays eagerly through ``render_frame``.

    Spans (utils/profile.py): each call is a ``render.frame``; inside it,
    ``render.key`` (the program's key and the arrays' shapes) and
    ``render.copy_inputs`` (the copy into the static inputs), then the
    program's own."""
    from gpuraytracer_tpu_torch.kernels import frame_kernel
    from gpuraytracer_tpu_torch.render import program
    from gpuraytracer_tpu_torch.utils import profile

    programs = {}

    def build(arrays):
        static = program.static_copy(arrays)
        scene = Scene(layout, static)
        pack = frame_kernel.pack_static(scene)

        def frame():
            frame_kernel.repack(pack, scene)
            return render_frame(scene, width, height, max_depth=max_depth, pack=pack)

        route, mode = frame_route(scene)
        return static, program.FrameProgram(
            frame, static.aabb_min.device,
            label=f"make_renderer {width}x{height} depth {max_depth} (route {route}, mode {mode})")

    def render(arrays):
        with profile.span("render.frame"):
            dev = arrays.aabb_min.device
            if dev.type != "cuda":
                return render_frame(Scene(layout, arrays), width, height, max_depth=max_depth)
            with profile.span("render.key"):
                shapes = tuple(tuple(t.shape) for t in program.tensor_leaves(arrays))
                k = program.key(Scene(layout, arrays), str(dev), shapes)
            if k not in programs:
                programs[k] = build(arrays)
            static, prog = programs[k]
            with profile.span("render.copy_inputs"):
                program.copy_arrays(static, arrays)
            return prog()

    render.programs = programs
    return render


def frame_route(scene: Scene):
    """(route, mode) of a frame on a GPU: route "frame" for a fused-eligible
    scene (frame_kernel.fused_eligible), else "scene" within the
    mesh face cap and "per_geometry" past it; mode GPURT_FRAME_MODE
    (frame_kernel.frame_mode) for the "frame" route, "plain" for the
    others, which the reference never sends to a compacted mode."""
    from gpuraytracer_tpu_torch.accel.traverse import _scene_kernel_eligible
    from gpuraytracer_tpu_torch.kernels import frame_kernel

    if frame_kernel.fused_eligible(scene):
        return "frame", frame_kernel.frame_mode()
    return ("scene" if _scene_kernel_eligible(scene) else "per_geometry"), "plain"


def render_wavefront(scene: Scene, width: int, height: int, *,
                     max_depth: int = MAX_RAY_RECURSION_DEPTH, pack=None,
                     plain: bool = False, main: MainPass | None = None,
                     row_offset: int = 0, local_height: int | None = None):
    """Raygen + trace_radiance over the whole frame on the scene's device,
    or over the band of ``local_height`` rows from ``row_offset``
    (kernels/frame_kernel.band_height): the W x H frame's pixels at those
    rows, (local_height, W, ...).
    On a GPU the frame is ``render_lanes``, the device form, whose passes
    take the scene's route: the scene kernel, or the per-geometry route past
    the mesh face cap (``pack``: the frame's packed buffers, built if None);
    with ``plain`` (or ``main``) it is ``trace_radiance``, the plain version
    with each route's plain passes. On the CPU it is ``trace_radiance`` with
    the scene kernel's plain passes, the frame kernel's plain version.
    ``main``: see ``trace_radiance``."""
    from gpuraytracer_tpu_torch.kernels import frame_kernel

    lh = frame_kernel.band_height(height, row_offset, local_height)
    dev = scene.arrays.aabb_min.device
    if dev.type == "cuda" and not plain and main is None:
        return render_lanes(scene, width, height, max_depth=max_depth, pack=pack,
                            row_offset=row_offset, local_height=lh)
    px, py = cam.pixel_grid(width, lh, dev)
    py = py + row_offset
    c = scene.arrays.constants
    origins, directions = cam.generate_camera_rays(
        px, py, width, height, c.camera_position, c.projection_to_world)
    return trace_radiance(origins, directions, px, py, width, height, scene,
                          max_depth=max_depth, main=main)


def render_lanes(scene: Scene, width: int, height: int, *,
                 max_depth: int = MAX_RAY_RECURSION_DEPTH, pack=None, row_offset: int = 0,
                 local_height: int | None = None):
    """The wavefront's device form: the band's (local_height, W, 4) image
    (the whole (H, W, 4) frame by default) as one stream-ordered chain of
    launches, with no host sync.

    The reference's trace_radiance runs its level body over every lane
    under an ``active`` mask, at fixed shapes (lax.scan, render/trace.py:
    95-210 there). So does this: every lane of the band stays in the
    ``kernels/wavefront.Lanes`` buffers for the whole frame, and the host
    loops over the levels. Per level: the closest pass over every lane,
    then (below the last level) the hit kernel, the occlusion pass and the
    shade kernel; at the last level the shade kernel alone. The passes take
    the active mask, and an inactive lane's thread in them and in the lane
    kernels returns at once: 5 pass launches and 1 start, 2 hit and 3 shade
    launches a frame at depth 3.

    The passes take the scene's route (traverse._procedural_pass; ``pack``:
    the frame's packed buffers, built if None on a GPU). On a GPU every
    wrapper launches its kernel or raises; on the CPU each runs its plain
    version (the route's plain passes, the lane kernels' plain versions),
    which is how the CPU checks this loop: it equals ``trace_radiance``'s
    compacted frame on the same passes bit for bit."""
    from gpuraytracer_tpu_torch.kernels import frame_kernel, wavefront

    lh = frame_kernel.band_height(height, row_offset, local_height)
    if pack is None and scene.arrays.aabb_min.device.type == "cuda":
        pack = frame_kernel.pack_frame(scene)
    traverse_pass = traverse._procedural_pass(scene, False, pack)
    lanes = wavefront.start(scene, pack, width=width, height=height, row_offset=row_offset,
                            local_height=lh)
    for level in range(max_depth):
        answer = traverse_pass(scene, lanes.ob, lanes.d, lanes.active, lanes.t0, level=level,
                               cull_backface=True)
        shadow = shadow_gid = None
        if level + 1 < max_depth:
            shadow = wavefront.hit(scene, pack, lanes, answer)
            _, _, shadow_gid = traverse_pass(scene, shadow.ob, shadow.d, shadow.active,
                                             shadow.t0, level=level, accept_first=True)
        wavefront.shade(scene, pack, lanes, answer, shadow, shadow_gid, level=level,
                        max_depth=max_depth, width=width, height=height, row_offset=row_offset)
        if debug.nan_checks_enabled():  # the NaN trap (utils/debug.debug_layer): host reads
            debug.trap(f"level {level} shading", lanes.color, lanes.tw)
    return lanes.color.reshape(lh, width, 4)


def to_rgba8(image_f32):
    """R8G8B8A8_UNORM conversion: saturate, then round half to even."""
    return torch.round(torch.clamp(image_f32, 0.0, 1.0) * 255.0).to(torch.uint8)
