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
(kernels/frame_kernel.py). ``render_frame`` sends a CUDA scene to the
frame kernel when it is fused-eligible, and every other CUDA scene to this
wavefront, whose traversal passes take the scene's route
(accel/traverse.py): the CUDA scene kernel (kernels/scene_kernel.py)
within the mesh face cap, the per-geometry route with the march kernel of
kernels/megakernel.py past it. A CPU scene renders through the wavefront
with the scene kernel's plain version.
"""

from __future__ import annotations

import torch

from gpuraytracer_tpu_torch.accel.instances import Scene
from gpuraytracer_tpu_torch.accel.traverse import _total_mesh_faces, any_hit, closest_hit
from gpuraytracer_tpu_torch.core import camera as cam
from gpuraytracer_tpu_torch.core import hlsl
from gpuraytracer_tpu_torch.core.types import (
    MAX_RAY_RECURSION_DEPTH,
    RAY_TMAX,
    RAY_TMIN,
    REFLECTANCE_EPS,
)
from gpuraytracer_tpu_torch.render import checkers as checkers_mod
from gpuraytracer_tpu_torch.render import shade


def _material_rows(scene: Scene, geometry_id):
    """Material-table row of each lane's geometry: geometry ids map through
    layout.material_ids when the table is deduplicated; miss lanes (-1)
    take row 0 and are masked by the callers."""
    gid = geometry_id.clamp(min=0)
    ids = scene.layout.material_ids
    if ids is None:
        return gid
    table = torch.tensor(ids, dtype=torch.int64, device=gid.device)
    return torch.where(geometry_id >= 0, table[gid], 0)


def trace_radiance(origins, directions, pixel_x, pixel_y, width, height, scene: Scene,
                   *, max_depth: int = MAX_RAY_RECURSION_DEPTH, pack=None,
                   plain: bool = False):
    """Trace radiance rays (..., 3) and return float4 colours (..., 4).

    pixel_x/pixel_y are the launch indices (DispatchRaysIndex), which the
    checkerboard's ray differentials need at every bounce. Each level works
    on the lanes still alive; a lane retires when its reflection is off or
    its outgoing throughput is exactly zero on every channel (it would add
    +0.0 at every later level, so retiring it is result-exact).

    ``pack``: the frame's packed kernel buffers (frame_kernel.pack_frame),
    built once by the caller for the scene kernel's passes on a GPU;
    ``plain``: the route's plain version of every pass on a GPU.
    """
    arrays = scene.arrays
    constants = arrays.constants
    mats = arrays.materials
    batch = origins.shape[:-1]
    dev = origins.device
    o = origins.reshape(-1, 3).clone()
    d = directions.reshape(-1, 3).clone()
    px_all = pixel_x.reshape(-1)
    py_all = pixel_y.reshape(-1)
    n = o.shape[0]

    bg = shade.background_color(dev)
    light_pos = constants.light_position[:3]
    plane_id = scene.layout.plane_geometry_id
    color = torch.zeros(n, 4, dtype=torch.float32, device=dev)
    throughput = torch.ones(n, 4, dtype=torch.float32, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)

    for level in range(max_depth):
        lanes = torch.nonzero(active).squeeze(1)
        if lanes.numel() == 0:
            break
        oa, da = o[lanes], d[lanes]
        hit = closest_hit(oa, da, scene, t_min=RAY_TMIN, t_max=RAY_TMAX,
                          cull_backface=True, level=level, pack=pack, plain=plain)
        nrm = hit.normal
        hit_pos = oa + hit.t[:, None] * da
        gid = _material_rows(scene, hit.geometry_id)
        albedo = mats.albedo[gid]
        refl_coef = mats.reflectance_coefficient[gid]
        diff_coef = mats.diffuse_coefficient[gid]
        spec_coef = mats.specular_coefficient[gid]
        spec_pow = mats.specular_power[gid]

        # Shadow ray, only where it can change the image: the shadow factor
        # scales the diffuse term (zero when kd == 0) and zeroes the
        # specular term (zero when spec * ks == 0), so lanes where both
        # vanish render identically lit or shadowed.
        in_shadow = torch.zeros_like(hit.hit)
        if level + 1 < max_depth:
            incident = hlsl.normalize(hit_pos - light_pos)
            kd = hlsl.saturate(hlsl.dot(-incident, nrm))
            refl_l = hlsl.normalize(hlsl.reflect(incident, nrm))
            ks = torch.pow(hlsl.saturate(hlsl.dot(refl_l, hlsl.normalize(-da))), spec_pow)
            needed = hit.hit & ((kd > 0.0) | (spec_coef * ks > 0.0))
            shadow_dir = hlsl.normalize(light_pos - hit_pos)
            in_shadow = any_hit(hit_pos, shadow_dir, scene, t_min=RAY_TMIN,
                                t_max=RAY_TMAX, active=needed, level=level, pack=pack,
                                plain=plain)

        phong = shade.phong_lighting(
            albedo, nrm, in_shadow, hit_pos, da, light_pos,
            constants.light_ambient_color, constants.light_diffuse_color,
            diff_coef, spec_coef, spec_pow,
        )

        # Checkerboard modulation on plane hits only (Raytracing.hlsl:195,211).
        k = torch.ones_like(hit.t)
        on_plane = torch.nonzero(hit.geometry_id == plane_id).squeeze(1)
        if on_plane.numel():
            k[on_plane] = checkers_mod.analytical_checkers(
                hit_pos[on_plane], nrm[on_plane], px_all[lanes[on_plane]],
                py_all[lanes[on_plane]], width, height,
                constants.camera_position, constants.projection_to_world,
            )
        k = k[:, None]

        # Reflection multiplier reflectance * float4(fresnel(albedo.rgb), 1),
        # gated on reflectance > 0.001 (Raytracing.hlsl:198-207, 233-242).
        fresnel = shade.fresnel_reflectance_schlick(da, nrm, albedo[:, :3])
        refl_mult = refl_coef[:, None] * torch.cat([fresnel, torch.ones_like(fresnel[:, :1])], dim=-1)
        reflective = hit.hit & (refl_coef > REFLECTANCE_EPS)
        refl_mult = torch.where(reflective[:, None], refl_mult, 0.0)

        fog = shade.fog_factor(hit.t)[:, None]
        hit4 = hit.hit[:, None]
        base = torch.where(hit4, (1.0 - fog) * (k * phong) + fog * bg, bg)
        mult = torch.where(hit4, (1.0 - fog) * k * refl_mult, 0.0)

        tw = throughput[lanes]
        color[lanes] = color[lanes] + tw * base
        tw_out = tw * mult
        throughput[lanes] = tw_out
        active[lanes] = reflective & (tw_out != 0.0).any(dim=-1)
        o[lanes] = hit_pos
        d[lanes] = hlsl.reflect(da, nrm)
    return color.reshape(batch + (4,))


def render_frame(scene: Scene, width: int, height: int, *,
                 max_depth: int = MAX_RAY_RECURSION_DEPTH):
    """Full frame, the DispatchRays(W, H, 1) analog; returns an (H, W, 4)
    float32 radiance image on the scene's device.

    A CUDA scene renders as the reference routes it: through the
    hand-written frame kernel when it is fused-eligible
    (frame_kernel.fused_eligible_layout: at most 16 materials and 512 mesh
    faces), else through the wavefront, whose passes run in the scene
    kernel for a scene of at most 512 mesh faces and on the per-geometry
    route (the march kernel and the mesh entry of csrc/megakernel.cu)
    past that; what no route covers raises. A CPU scene renders through
    the wavefront with plain passes."""
    from gpuraytracer_tpu_torch.kernels import frame_kernel

    dev = scene.arrays.aabb_min.device
    if dev.type != "cuda":
        return render_wavefront(scene, width, height, max_depth=max_depth)
    frame_kernel.check_kernel_covers(scene.layout)
    pack = frame_kernel.pack_frame(scene)
    if frame_kernel.fused_eligible_layout(scene.layout, scene.arrays.materials.albedo.shape[0],
                                          _total_mesh_faces(scene)):
        return frame_kernel.render_frame_tiles(pack, width=width, height=height,
                                               max_depth=max_depth)
    return render_wavefront(scene, width, height, max_depth=max_depth, pack=pack)


def render_wavefront(scene: Scene, width: int, height: int, *,
                     max_depth: int = MAX_RAY_RECURSION_DEPTH, pack=None,
                     plain: bool = False):
    """Raygen + trace_radiance over the whole frame on the scene's device.
    On a GPU the traversal passes take the scene's route: the scene kernel,
    or the per-geometry route past the mesh face cap (``pack``: the frame's
    packed buffers, built here if None); with ``plain`` each route's plain
    version. On the CPU every pass is the scene kernel's plain version, the
    frame kernel's plain version."""
    from gpuraytracer_tpu_torch.kernels import frame_kernel

    dev = scene.arrays.aabb_min.device
    if dev.type == "cuda" and pack is None and not plain:
        pack = frame_kernel.pack_frame(scene)
    px, py = cam.pixel_grid(width, height, dev)
    c = scene.arrays.constants
    origins, directions = cam.generate_camera_rays(
        px, py, width, height, c.camera_position, c.projection_to_world)
    return trace_radiance(origins, directions, px, py, width, height, scene,
                          max_depth=max_depth, pack=pack, plain=plain)


def to_rgba8(image_f32):
    """R8G8B8A8_UNORM conversion: saturate, then round half to even."""
    return torch.round(torch.clamp(image_f32, 0.0, 1.0) * 255.0).to(torch.uint8)
