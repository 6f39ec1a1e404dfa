"""The wavefront's lane kernels (csrc/wavefront.cu).

Replace the XLA-fused level body of the reference's trace_radiance
(gpuraytracer_tpu/render/trace.py:127-199, level_body under lax.scan),
which has no Pallas kernel: the work between the traversal passes of the
wavefront routes. With the passes (kernels/scene_kernel.
scene_closest_tiles, kernels/megakernel.route_pass, which take an active
mask) they make a frame of render/trace.render_lanes one stream-ordered
chain of launches with no host sync: every lane of the band stays in the
batch for the whole frame under an active mask, and the host loops over
the levels.

- ``start``: raygen for the band's lanes, then the plane test and the
  level-0 closest pass's inputs (``Lanes``);
- ``hit``: after a closest pass, the merged hit, the surface, the shadow
  gate and the occlusion pass's inputs (``ShadowRays``);
- ``shade``: after the occlusion pass, the shading, the colour and
  throughput recurrence, the exact kill, the reflected ray and the next
  level's closest-pass inputs, in place.

Each wrapper launches its kernel on the current stream when the tensors it
is given lie on a CUDA device (reading the material table and slots, the
camera, the light and the plane from the frame's ``pack``, so any number of
materials and tables of any size), counts the launch (START_LAUNCHES,
HIT_LAUNCHES, SHADE_LAUNCHES), and raises if the launch fails; on CPU
tensors it runs its plain version, the PyTorch code of render/trace.
trace_radiance's level body over the active lanes (``start_plain``,
``hit_plain``, ``shade_plain``). A lane's state lives in the ``Lanes``
buffers, in the band's raster order.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from gpuraytracer_tpu_torch.accel import traverse
from gpuraytracer_tpu_torch.core import camera as cam
from gpuraytracer_tpu_torch.core import hlsl
from gpuraytracer_tpu_torch.core.types import RAY_TMAX
from gpuraytracer_tpu_torch.kernels import frame_kernel

# Kernel launches since import (or since a caller reset it), per kernel.
START_LAUNCHES = 0
HIT_LAUNCHES = 0
SHADE_LAUNCHES = 0


def launches() -> dict:
    """The lane kernels' launch counters by kernel name."""
    return {"wavefront_start": START_LAUNCHES, "wavefront_hit": HIT_LAUNCHES,
            "wavefront_shade": SHADE_LAUNCHES}


def reset_launches() -> None:
    global START_LAUNCHES, HIT_LAUNCHES, SHADE_LAUNCHES
    START_LAUNCHES = HIT_LAUNCHES = SHADE_LAUNCHES = 0


class Lanes(NamedTuple):
    """The n lanes of a band in its raster order between the passes: the
    ray ``o``, ``d`` (n, 3) (``d`` is also the closest pass's direction),
    ``color`` and ``tw`` (throughput) (n, 4), ``active`` (n,) bool (the
    closest pass's mask), and the closest pass's BLAS-space origin ``ob``
    (n, 3) and ``t0`` (n,) (the plane's t where the plane hits, else
    RAY_TMAX). All float32 but ``active``; ``color`` is the band's image at
    the end of the frame."""

    o: torch.Tensor
    d: torch.Tensor
    color: torch.Tensor
    tw: torch.Tensor
    active: torch.Tensor
    ob: torch.Tensor
    t0: torch.Tensor


class ShadowRays(NamedTuple):
    """The occlusion pass's inputs over the n lanes: BLAS-space origin
    ``ob`` and direction ``d`` (n, 3), ``active`` (n,) bool (a shadow ray
    that can change the pixel and that the plane does not occlude), ``t0``
    (n,) (0 where the plane occludes a needed shadow ray, else
    RAY_TMAX)."""

    ob: torch.Tensor
    d: torch.Tensor
    active: torch.Tensor
    t0: torch.Tensor


def start_plain(scene, *, width: int, height: int, row_offset: int = 0,
                local_height: int | None = None) -> Lanes:
    """Plain version of ``start``: the band's camera rays as render/trace.
    render_wavefront generates them, colour 0, throughput 1, every lane
    active, and the level-0 closest pass's inputs (traverse.pass_inputs)."""
    lh = frame_kernel.band_height(height, row_offset, local_height)
    dev = scene.arrays.aabb_min.device
    px, py = cam.pixel_grid(width, lh, dev)
    c = scene.arrays.constants
    o, d = cam.generate_camera_rays(px, py + row_offset, width, height, c.camera_position,
                                    c.projection_to_world)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    n = o.shape[0]
    _, ob, _, _, t0 = traverse.pass_inputs(o, d, scene)
    return Lanes(o, d, torch.zeros(n, 4, dtype=torch.float32, device=dev),
                 torch.ones(n, 4, dtype=torch.float32, device=dev),
                 torch.ones(n, dtype=torch.bool, device=dev), ob, t0)


def _active_hits(scene, lanes: Lanes, answer):
    """(active lane indices, their o, d, merged HitRecord) after a closest
    pass (answer: its (best_t, normal, gid))."""
    idx = torch.nonzero(lanes.active).squeeze(1)
    oa, da = lanes.o[idx], lanes.d[idx]
    hit_p, _, _, _, t0 = traverse.pass_inputs(oa, da, scene)
    best_t, normal, gid = (x[idx] for x in answer)
    return idx, oa, da, traverse.merge_hit(scene, hit_p, t0, best_t, normal, gid)


def hit_plain(scene, lanes: Lanes, answer) -> ShadowRays:
    """Plain version of ``hit``: trace_radiance's shadow rays
    (trace._surface, trace._shadow_ray, the occlusion pass's
    traverse.pass_inputs) at the active lanes; the other lanes' shadow rays
    are off (inactive, t0 RAY_TMAX, zero rays)."""
    from gpuraytracer_tpu_torch.render import trace

    n, dev = lanes.o.shape[0], lanes.o.device
    idx, oa, da, hit = _active_hits(scene, lanes, answer)
    surf = trace._surface(scene, oa, da, hit)
    needed, shadow_dir = trace._shadow_ray(scene, surf, da)
    _, ob, db, act, t0 = traverse.pass_inputs(surf.hit_pos, shadow_dir, scene, active=needed,
                                              occlusion=True)
    out = ShadowRays(torch.zeros(n, 3, dtype=torch.float32, device=dev),
                     torch.zeros(n, 3, dtype=torch.float32, device=dev),
                     torch.zeros(n, dtype=torch.bool, device=dev),
                     torch.full((n,), RAY_TMAX, dtype=torch.float32, device=dev))
    out.ob[idx], out.d[idx], out.active[idx], out.t0[idx] = ob, db, act, t0
    return out


def shade_plain(scene, lanes: Lanes, answer, shadow: ShadowRays | None, shadow_gid, *,
                level: int, max_depth: int, width: int, height: int,
                row_offset: int = 0) -> Lanes:
    """Plain version of ``shade``, in place on ``lanes``: trace_radiance's
    shading and recurrence at the active lanes (trace._surface,
    trace._shading), the shadow flag from the occlusion pass (``shadow``
    and its answer's gid ``shadow_gid``; None at the last level), the exact
    kill, the reflected ray and the next level's closest-pass inputs."""
    from gpuraytracer_tpu_torch.render import trace

    idx, oa, da, hit = _active_hits(scene, lanes, answer)
    surf = trace._surface(scene, oa, da, hit)
    if shadow_gid is None:
        in_shadow = torch.zeros_like(hit.hit)
    else:
        in_shadow = (shadow.t0[idx] == 0.0) | (shadow.active[idx] & (shadow_gid[idx] >= 0))
    # The lanes' pixels (int32, as cam.pixel_grid gives them to trace_radiance).
    px, py = (idx % width).to(torch.int32), (idx // width + row_offset).to(torch.int32)
    shading = trace._shading(scene, surf, da, px, py, width, height)
    tw = lanes.tw[idx]
    lanes.color[idx] = lanes.color[idx] + tw * shading.base(in_shadow)
    tw_out = tw * shading.mult
    lanes.tw[idx] = tw_out
    lanes.active[idx] = shading.reflective & (tw_out != 0.0).any(dim=-1)
    lanes.o[idx] = surf.hit_pos
    lanes.d[idx] = hlsl.reflect(da, hit.normal)
    _, ob, _, _, t0 = traverse.pass_inputs(lanes.o[idx], lanes.d[idx], scene)
    lanes.ob[idx], lanes.t0[idx] = ob, t0
    return lanes


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def _raise_on(rc, lib, what):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({lib.gprt_error_string(rc).decode()})")


def _setup(scene, pack, dev, lib):
    """(pack, library) of a launch on CUDA device ``dev``: ``pack`` (default
    frame_kernel.pack_frame(scene)) checked and on ``dev``; ``lib`` default
    the shipped build of csrc/wavefront.cu."""
    if dev.type != "cuda":
        raise ValueError(f"no wavefront kernel for device {dev}")
    pack = pack if pack is not None else frame_kernel.pack_frame(scene)
    frame_kernel.check_pack(pack)
    if pack.params.device != dev:
        raise ValueError(f"pack on {pack.params.device}, lanes on {dev}")
    from gpuraytracer_tpu_torch.kernels import build

    return pack, lib if lib is not None else build.load("wavefront")


def _where(dev):
    return dev.index, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _check(name, x, shape, dtype, dev):
    if tuple(x.shape) != shape or x.dtype != dtype or x.device != dev or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {shape} {dtype} tensor on {dev}, got "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")


def _check_lanes(lanes: Lanes, answer, shadow=None, shadow_gid=None):
    n, dev = lanes.o.shape[0], lanes.o.device
    f32, b = torch.float32, torch.bool
    for name, x, shape, dtype in (
            ("o", lanes.o, (n, 3), f32), ("d", lanes.d, (n, 3), f32),
            ("color", lanes.color, (n, 4), f32), ("tw", lanes.tw, (n, 4), f32),
            ("active", lanes.active, (n,), b), ("ob", lanes.ob, (n, 3), f32),
            ("t0", lanes.t0, (n,), f32), ("best_t", answer[0], (n,), f32),
            ("normal", answer[1], (n, 3), f32), ("gid", answer[2], (n,), torch.int32)):
        _check(name, x, shape, dtype, dev)
    if shadow is not None:
        for name, x, shape, dtype in (("shadow ob", shadow.ob, (n, 3), f32),
                                      ("shadow d", shadow.d, (n, 3), f32),
                                      ("shadow active", shadow.active, (n,), b),
                                      ("shadow t0", shadow.t0, (n,), f32)):
            _check(name, x, shape, dtype, dev)
    if shadow_gid is not None:
        _check("shadow gid", shadow_gid, (n,), torch.int32, dev)
    return n, dev


def start(scene, pack=None, *, width: int, height: int, row_offset: int = 0,
          local_height: int | None = None, lib=None) -> Lanes:
    """The lanes of the band of ``local_height`` rows from ``row_offset``
    of a width x height frame (the whole frame by default) at the start of
    level 0, as ``start_plain`` gives them. CUDA (``pack``: the frame's
    packed buffers on a CUDA device, default frame_kernel.pack_frame(scene)
    of a CUDA scene): one launch of the start kernel, counted in
    START_LAUNCHES. CPU: ``start_plain``."""
    global START_LAUNCHES
    lh = frame_kernel.band_height(height, row_offset, local_height)
    dev = pack.params.device if pack is not None else scene.arrays.aabb_min.device
    if dev.type == "cpu":
        return start_plain(scene, width=width, height=height, row_offset=row_offset,
                           local_height=lh)
    pack, lib = _setup(scene, pack, dev, lib)
    n = width * lh
    f32 = dict(dtype=torch.float32, device=dev)
    lanes = Lanes(torch.empty(n, 3, **f32), torch.empty(n, 3, **f32), torch.empty(n, 4, **f32),
                  torch.empty(n, 4, **f32), torch.empty(n, dtype=torch.bool, device=dev),
                  torch.empty(n, 3, **f32), torch.empty(n, **f32))
    _raise_on(lib.gprt_wavefront_start(_ptr(pack.params), _ptr(pack.layout),
                                       *(_ptr(x) for x in lanes), width, height, row_offset, lh,
                                       pack.num_geometries, pack.num_materials, *_where(dev)),
              lib, "wavefront start kernel")
    START_LAUNCHES += 1
    return lanes


def hit(scene, pack, lanes: Lanes, answer, *, lib=None) -> ShadowRays:
    """The occlusion pass's inputs after a closest pass (``answer``: its
    (best_t, normal, gid) over the lanes), as ``hit_plain`` gives them.
    CUDA: one launch of the hit kernel, counted in HIT_LAUNCHES. CPU:
    ``hit_plain``."""
    global HIT_LAUNCHES
    if lanes.o.device.type == "cpu":
        return hit_plain(scene, lanes, answer)
    n, dev = _check_lanes(lanes, answer)
    pack, lib = _setup(scene, pack, dev, lib)
    f32 = dict(dtype=torch.float32, device=dev)
    out = ShadowRays(torch.empty(n, 3, **f32), torch.empty(n, 3, **f32),
                     torch.empty(n, dtype=torch.bool, device=dev), torch.empty(n, **f32))
    _raise_on(lib.gprt_wavefront_hit(_ptr(pack.params), _ptr(pack.layout), _ptr(lanes.o),
                                     _ptr(lanes.d), _ptr(lanes.active),
                                     *(_ptr(x) for x in answer), *(_ptr(x) for x in out), n,
                                     pack.num_geometries, pack.num_materials, *_where(dev)),
              lib, "wavefront hit kernel")
    HIT_LAUNCHES += 1
    return out


def shade(scene, pack, lanes: Lanes, answer, shadow: ShadowRays | None, shadow_gid, *,
          level: int, max_depth: int, width: int, height: int, row_offset: int = 0,
          lib=None) -> Lanes:
    """The level's shading and recurrence, in place on ``lanes``, as
    ``shade_plain`` gives them (``shadow`` and ``shadow_gid``: the occlusion
    pass's inputs and its answer's gid; None at the last level). CUDA: one
    launch of the shade kernel, counted in SHADE_LAUNCHES. CPU:
    ``shade_plain``."""
    global SHADE_LAUNCHES
    kw = dict(level=level, max_depth=max_depth, width=width, height=height,
              row_offset=row_offset)
    if lanes.o.device.type == "cpu":
        return shade_plain(scene, lanes, answer, shadow, shadow_gid, **kw)
    if (shadow_gid is None) != (level + 1 >= max_depth) or (shadow is None) != (shadow_gid is None):
        raise ValueError("an occlusion answer is given exactly at the levels below max_depth - 1")
    n, dev = _check_lanes(lanes, answer, shadow, shadow_gid)
    if n % width:
        raise ValueError(f"{n} lanes are not whole rows of {width}")
    pack, lib = _setup(scene, pack, dev, lib)
    null = ctypes.c_void_p(None)
    s_args = ((_ptr(shadow.active), _ptr(shadow.t0), _ptr(shadow_gid)) if shadow is not None
              else (null, null, null))
    _raise_on(lib.gprt_wavefront_shade(_ptr(pack.params), _ptr(pack.layout),
                                       *(_ptr(x) for x in lanes), *(_ptr(x) for x in answer),
                                       *s_args, width, height, row_offset, n // width, level,
                                       max_depth, pack.num_geometries, pack.num_materials,
                                       *_where(dev)),
              lib, "wavefront shade kernel")
    SHADE_LAUNCHES += 1
    return lanes
