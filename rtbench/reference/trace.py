"""The plain reference's integrator: the TraceRay recursion unrolled to the
configuration's depth, over the lanes still alive at each level.

Frozen copy of the port's ``render/trace.trace_radiance`` (plain passes,
no compacted modes): every closest-hit colour is affine in its reflection
child's, c_d = base_d + M_d * c_{d+1}, accumulated with a running
throughput; shadow rays at every level but the last. ``render`` runs it
over a frame in blocks of rows, so that a 1080p frame fits beside
whatever the device already holds.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from rtbench.reference import camera as cam
from rtbench.reference import checkers as checkers_mod
from rtbench.reference import hlsl, shade
from rtbench.reference.instances import Scene
from rtbench.reference.traverse import any_hit, closest_hit
from rtbench.reference.types import REFLECTANCE_EPS, HitRecord


def _material_rows(scene: Scene, geometry_id):
    gid = geometry_id.clamp(min=0)
    ids = scene.layout.material_ids
    if ids is None:
        return gid
    table = torch.tensor(ids, dtype=torch.int64, device=gid.device)
    return torch.where(geometry_id >= 0, table[gid], 0)


class Surface(NamedTuple):
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
    """(needed, direction) of the lanes' shadow rays: traced only where the
    shadow factor can change the image (kd > 0 or spec * ks > 0)."""
    light_pos = scene.arrays.constants.light_position[:3]
    nrm, hit_pos = surf.hit.normal, surf.hit_pos
    incident = hlsl.normalize(hit_pos - light_pos)
    kd = hlsl.saturate(hlsl.dot(-incident, nrm))
    refl_l = hlsl.normalize(hlsl.reflect(incident, nrm))
    ks = torch.pow(hlsl.saturate(hlsl.dot(refl_l, hlsl.normalize(-da))), surf.spec_pow)
    needed = surf.hit.hit & ((kd > 0.0) | (surf.spec_coef * ks > 0.0))
    return needed, hlsl.normalize(light_pos - hit_pos)


class Shading(NamedTuple):
    base: Callable
    mult: torch.Tensor
    reflective: torch.Tensor


def _shading(scene: Scene, surf: Surface, da, px, py, width: int, height: int) -> Shading:
    """Phong with fake AO, the checkerboard on plane hits, the
    Fresnel-weighted reflection multiplier and the fog."""
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

    k = torch.ones_like(hit.t)
    on_plane = torch.nonzero(hit.geometry_id == scene.layout.plane_geometry_id).squeeze(1)
    if on_plane.numel():
        k[on_plane] = checkers_mod.analytical_checkers(
            hit_pos[on_plane], nrm[on_plane], px[on_plane], py[on_plane], width, height,
            constants.camera_position, constants.projection_to_world,
        )
    k = k[:, None]

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


def trace_radiance(origins, directions, pixel_x, pixel_y, width, height, scene: Scene,
                   route: str, *, max_depth: int):
    """Colours (..., 4) of radiance rays (..., 3); pixel_x/pixel_y are the
    launch indices the checkerboard's differentials need. A lane retires
    when its reflection is off or its throughput is exactly zero."""
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
    for level in range(max_depth):
        lanes = torch.nonzero(active).squeeze(1)
        if lanes.numel() == 0:
            break
        oa, da = o[lanes], d[lanes]
        hit = closest_hit(oa, da, scene, route, level=level)
        surf = _surface(scene, oa, da, hit)
        hit_pos = surf.hit_pos
        in_shadow = torch.zeros_like(hit.hit)
        if level + 1 < max_depth:
            needed, shadow_dir = _shadow_ray(scene, surf, da)
            in_shadow = any_hit(hit_pos, shadow_dir, scene, route, active=needed, level=level)
        shading = _shading(scene, surf, da, px_all[lanes], py_all[lanes], width, height)
        tw = throughput[lanes]
        color[lanes] = color[lanes] + tw * shading.base(in_shadow)
        tw_out = tw * shading.mult
        throughput[lanes] = tw_out
        active[lanes] = shading.reflective & (tw_out != 0.0).any(dim=-1)
        o[lanes] = hit_pos
        d[lanes] = hlsl.reflect(da, hit.normal)
    return color.reshape(batch + (4,))


def render(scene: Scene, route: str, width: int, height: int, *, max_depth: int,
           rows: int | None = None, pixels=None):
    """The (H, W, 4) f32 radiance image of the W x H frame, in blocks of
    ``rows`` rows (default: the whole frame at once); with ``pixels``
    ((y, x) int tensors), only those pixels' (N, 4) colours."""
    dev = scene.arrays.aabb_min.device
    c = scene.arrays.constants
    if pixels is not None:
        py, px = (p.to(device=dev, dtype=torch.int32) for p in pixels)
        o, d = cam.generate_camera_rays(px, py, width, height, c.camera_position,
                                        c.projection_to_world)
        return trace_radiance(o, d, px, py, width, height, scene, route, max_depth=max_depth)
    rows = rows or height
    out = torch.empty((height, width, 4), dtype=torch.float32, device=dev)
    for y0 in range(0, height, rows):
        h = min(rows, height - y0)
        px, py = cam.pixel_grid(width, h, dev)
        py = py + y0
        o, d = cam.generate_camera_rays(px, py, width, height, c.camera_position,
                                        c.projection_to_world)
        out[y0:y0 + h] = trace_radiance(o, d, px, py, width, height, scene, route,
                                        max_depth=max_depth)
    return out


def to_rgba8(image_f32):
    """R8G8B8A8_UNORM: saturate, scale by 255, round half to even; alpha 255."""
    out = torch.round(torch.clamp(image_f32, 0.0, 1.0) * 255.0).to(torch.uint8)
    out[..., 3] = 255
    return out
