"""Pipeline introspection: the print_state_object_desc / shader-table
DebugPrint analog (RendererRaytracingHelper.h:551-660, 472-489).

Port of gpuraytracer_tpu/utils/introspect.py. ``describe_scene`` gives the
reference's text for the same scene (geometry table: kind, primitive,
material); ``describe_backend`` names torch, CUDA, the card and the route
that render/trace.frame_route picks for the scene.
"""

from __future__ import annotations

import torch

from gpuraytracer_tpu_torch.accel.instances import Scene
from gpuraytracer_tpu_torch.core.types import (
    AnalyticPrimitive,
    IntersectorKind,
    SignedDistancePrimitive,
    VolumetricPrimitive,
)


def _prim_name(kind: IntersectorKind, code: int) -> str:
    try:
        if kind == IntersectorKind.ANALYTIC:
            return AnalyticPrimitive(code).name
        if kind == IntersectorKind.VOLUMETRIC:
            return VolumetricPrimitive(code).name
        if kind == IntersectorKind.SIGNED_DISTANCE:
            if code <= int(SignedDistancePrimitive.FRACTAL_PYRAMID):
                return SignedDistancePrimitive(code).name
            from gpuraytracer_tpu_torch.geometry.fractal import ExtendedSignedDistancePrimitive

            return ExtendedSignedDistancePrimitive(code).name
    except ValueError:
        pass
    return f"type_{code}"


def describe_scene(scene: Scene) -> str:
    """Human-readable dump of the dispatch structure (the SBT listing).
    Reads the material table back to the host (once, before a run)."""
    layout = scene.layout
    mats = scene.arrays.materials
    albedo = mats.albedo.cpu().numpy()
    refl = mats.reflectance_coefficient.cpu().numpy()
    step = mats.step_scale.cpu().numpy()

    lines = [
        f"scene: {layout.num_procedural} procedural geometr"
        f"{'y' if layout.num_procedural == 1 else 'ies'}"
        f"{' + ground plane' if layout.has_plane else ''}",
        f"{'id':>3} {'kind':<16} {'primitive':<24} {'albedo':<26} "
        f"{'refl':>5} {'step':>5}",
    ]
    rows = [(i, IntersectorKind(kind).name, _prim_name(kind, code))
            for i, (kind, code) in enumerate(zip(layout.kinds, layout.prim_types))]
    if layout.has_plane:
        rows.append((layout.plane_geometry_id, "TRIANGLE", "GROUND_PLANE"))
    for i, kind, prim in rows:
        a = albedo[i]
        lines.append(f"{i:>3} {kind:<16} {prim:<24} "
                     f"({a[0]:.3f}, {a[1]:.3f}, {a[2]:.3f}, {a[3]:.3f}) "
                     f"{refl[i]:>5.2f} {step[i]:>5.2f}")
    return "\n".join(lines)


def describe_backend(scene: Scene) -> str:
    """torch and CUDA versions, the device, and the compute path the scene
    takes on it."""
    from gpuraytracer_tpu_torch.render import trace

    dev = scene.arrays.aabb_min.device
    head = f"torch {torch.__version__}; cuda {torch.version.cuda}"
    route, mode = trace.frame_route(scene)
    if dev.type != "cuda":
        # The CPU renders the wavefront, or a compacted mode's host code,
        # with the kernels' plain versions.
        return f"{head}; device cpu; route=wavefront (plain versions) mode={mode}"
    return (f"{head}; device {torch.cuda.get_device_name(dev)} ({dev}); "
            f"route={route} mode={mode}")
