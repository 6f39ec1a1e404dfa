"""One geometry at a time: the SDF march kernel and the mesh entry
(csrc/megakernel.cu).

``sphere_trace_tiles`` replaces the reference's per-geometry Pallas march
(gpuraytracer_tpu/kernels/megakernel.py: sphere_trace_tiles /
_tile_march_kernel): one SDF geometry's sphere trace over (N,) local rays
behind a gate, with the call's static march spec, and the tetrahedral
normal at the hit. ``trimesh_closest`` is the same library's mesh entry:
one mesh's closest face for each gated ray (the reference runs it in XLA,
geometry/trimesh.intersect_trimesh). Both serve the per-geometry route of
a scene past ``accel/traverse.TRI_FACE_TOTAL_CAP`` faces
(``traverse.per_geometry_route``), one launch per geometry and pass.

Each wrapper launches its kernel on a CUDA tensor and counts the launch
(LAUNCHES, MESH_LAUNCHES); on a CPU tensor it runs its plain version
(``sphere_trace_plain``, ``trimesh_closest_plain``); any other device
raises.
"""

from __future__ import annotations

import ctypes

import torch

from gpuraytracer_tpu_torch.core.types import SDF_MAX_STEPS
from gpuraytracer_tpu_torch.geometry import sdf, trimesh

# Kernel launches since import (or since a caller reset it): the march
# kernel and the mesh entry, apart.
LAUNCHES = 0
MESH_LAUNCHES = 0


def _check(n, **tensors):
    shapes = {"o": (n, 3), "d": (n, 3), "gate": (n,), "t_max": (n,), "t_start": (n,)}
    dev = tensors["o"].device
    for name, x in tensors.items():
        if x is None:
            continue
        dtype = torch.bool if name == "gate" else torch.float32
        if tuple(x.shape) != shapes[name] or x.dtype != dtype:
            raise ValueError(f"{name}: expected {shapes[name]} {dtype}, got {tuple(x.shape)} "
                             f"{x.dtype}")
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, o on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no megakernel for device {dev}")
    return dev


def sphere_trace_plain(o, d, gate, t_max, step_scale, *, prim_code: int,
                       cull_backface: bool = True, max_steps: int = SDF_MAX_STEPS,
                       t_start=None, relax: float = 1.0, capped_hit: bool = False):
    """The kernel's plain PyTorch version: geometry/sdf.march with the same
    static arguments (the escape bound for sdf.ESCAPE_SAFE_CODES only), a
    capped hit at t = 0 as the reference's kernel writes it, and the
    tetrahedral normal at each hit ((0, 0, 0) on a miss).

    Returns (hit (N,), t_hit (N,) with +inf on a miss, normal (N, 3))."""
    return sdf.march(o, d, gate, t_max, step_scale, prim_code=prim_code,
                     cull_backface=cull_backface, max_steps=max_steps, t_start=t_start,
                     relax=relax, capped_hit=capped_hit, capped_t=0.0)


def _ptr(x):
    return ctypes.c_void_p(None if x is None else x.data_ptr())


def _raise_on(rc, lib, what):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({lib.gprt_error_string(rc).decode()})")


def sphere_trace_tiles(o, d, gate, t_max, step_scale, *, prim_code: int,
                       cull_backface: bool = True, max_steps: int = SDF_MAX_STEPS,
                       t_start=None, relax: float = 1.0, capped_hit: bool = False,
                       lib=None, ops=None):
    """(hit, t_hit, normal) of one SDF geometry's march over (N, 3) local
    rays o, d with gate (N,) bool, t_max and t_start (N,) f32 (t_start None:
    march from 0) and a scalar step_scale; see ``sphere_trace_plain``.

    CUDA: launches csrc/megakernel.cu's march on the current stream
    (``lib``: a loaded build, default the shipped one; ``ops``: the counter
    a counting build adds to) and counts it in LAUNCHES. CPU: runs
    ``sphere_trace_plain``."""
    global LAUNCHES
    n = o.shape[0]
    dev = _check(n, o=o, d=d, gate=gate, t_max=t_max, t_start=t_start)
    kw = dict(prim_code=prim_code, cull_backface=cull_backface, max_steps=max_steps,
              t_start=t_start, relax=relax, capped_hit=capped_hit)
    if dev.type == "cpu":
        return sphere_trace_plain(o, d, gate, t_max, step_scale, **kw)
    code = int(prim_code)
    if code not in sdf.DISTANCE_FUNCTIONS or not 0 <= code <= 8:
        raise ValueError(f"distance code {code} has no device function")
    t_hit = torch.empty(n, dtype=torch.float32, device=dev)
    normal = torch.empty(n, 3, dtype=torch.float32, device=dev)
    if n == 0:
        return torch.isfinite(t_hit), t_hit, normal
    from gpuraytracer_tpu_torch.kernels import build, frame_kernel

    lib = lib if lib is not None else build.load("megakernel")
    o, d, gate, t_max = o.contiguous(), d.contiguous(), gate.contiguous(), t_max.contiguous()
    t_start = None if t_start is None else t_start.contiguous()
    relax = float(relax)
    rc = lib.gprt_sphere_trace(
        _ptr(o), _ptr(d), _ptr(gate), _ptr(t_max), _ptr(t_start), _ptr(t_hit), _ptr(normal), n,
        code, float(step_scale), int(max_steps), relax, (1.0 - relax) * relax, int(capped_hit),
        int(cull_backface), int(code in sdf.ESCAPE_SAFE_CODES), frame_kernel.ops_pointer(ops),
        dev.index, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(rc, lib, "megakernel march")
    LAUNCHES += 1
    return torch.isfinite(t_hit), t_hit, normal


def trimesh_closest_plain(rows, o, d, gate, t_max, *, cull_backface: bool = True):
    """The mesh entry's plain version: geometry/trimesh.intersect_trimesh
    over the gated lanes of (N, 3) local rays against one mesh's (F, 12)
    face rows. Returns (hit, t with +inf on a miss, local normal, zero on a
    miss)."""
    mesh = trimesh.TriangleMesh(v0=rows[:, 0:3], e1=rows[:, 3:6], e2=rows[:, 6:9],
                                n=rows[:, 9:12])
    return trimesh.intersect_trimesh(o, d, mesh, t_min=0.0, t_max=t_max,
                                     cull_backface=cull_backface, active=gate)


def trimesh_closest(rows, o, d, gate, t_max, *, cull_backface: bool = True, lib=None,
                    ops=None):
    """(hit, t, local normal) of one mesh's closest face for each gated ray;
    see ``trimesh_closest_plain``. ``rows``: the mesh's (F, 12) f32 rows of
    the face table. CUDA: launches csrc/megakernel.cu's mesh entry and
    counts it in MESH_LAUNCHES; CPU: runs ``trimesh_closest_plain``."""
    global MESH_LAUNCHES
    n = o.shape[0]
    dev = _check(n, o=o, d=d, gate=gate, t_max=t_max)
    if rows.dim() != 2 or rows.shape[1] != 12 or rows.dtype != torch.float32:
        raise ValueError(f"rows: expected (F, 12) float32, got {tuple(rows.shape)} {rows.dtype}")
    if rows.device != dev:
        raise ValueError(f"rows on {rows.device}, o on {dev}")
    if dev.type == "cpu":
        return trimesh_closest_plain(rows, o, d, gate, t_max, cull_backface=cull_backface)
    t_hit = torch.empty(n, dtype=torch.float32, device=dev)
    normal = torch.empty(n, 3, dtype=torch.float32, device=dev)
    if n == 0:
        return torch.isfinite(t_hit), t_hit, normal
    from gpuraytracer_tpu_torch.kernels import build, frame_kernel

    lib = lib if lib is not None else build.load("megakernel")
    rows = rows.contiguous()
    o, d, gate, t_max = o.contiguous(), d.contiguous(), gate.contiguous(), t_max.contiguous()
    rc = lib.gprt_trimesh(
        _ptr(rows), rows.shape[0], _ptr(o), _ptr(d), _ptr(gate), _ptr(t_max), _ptr(t_hit),
        _ptr(normal), n, int(cull_backface), frame_kernel.ops_pointer(ops), dev.index,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(rc, lib, "megakernel mesh entry")
    MESH_LAUNCHES += 1
    return torch.isfinite(t_hit), t_hit, normal
