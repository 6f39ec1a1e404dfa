"""Scene/constants ABI as frozen dataclasses of tensors.

Mirrors gpuraytracer_tpu/core/types.py (which mirrors the reference's
ConstantBuffers.h / RaytracingSceneDefines.h field for field). Each
dataclass holds tensors and moves to a device with ``.to(device)``.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from rtbench.reference.upload import to_device

# ---------------------------------------------------------------------------
# Global compile-time constants (ConstantBuffers.h:12-31, 135-138)
# ---------------------------------------------------------------------------

METABALLS_COUNT = 3
FRACTAL_ITERATIONS_COUNT = 4
MAX_RAY_RECURSION_DEPTH = 3  # primary + reflection + shadows from reflected geometry

CHROMIUM_REFLECTANCE = (0.549, 0.556, 0.554, 1.0)
BACKGROUND_COLOR = (0.8, 0.9, 1.0, 1.0)
IN_SHADOW_RADIANCE = 0.35

# Radiance-ray extents (Raytracing.hlsl:100-101).
RAY_TMIN = 0.0
RAY_TMAX = 10000.0

# SDF sphere-trace parameters (SignedDistancePrimitives.hlsli:289-291).
SDF_HIT_THRESHOLD = 0.0001  # relative: hit when distance <= threshold * t
SDF_MAX_STEPS = 512

# Metaball march parameters (VolumetricPrimitives.hlsli:160-185).
METABALL_MAX_STEPS = 128
METABALL_ISO_THRESHOLD = 0.25
METABALL_CYCLE_DURATION = 12.0

# Reflection contribution cutoff (Raytracing.hlsl:199,234).
REFLECTANCE_EPS = 0.001


class AnalyticPrimitive(enum.IntEnum):
    AABB = 0
    SPHERES = 1


class VolumetricPrimitive(enum.IntEnum):
    METABALLS = 0


class SignedDistancePrimitive(enum.IntEnum):
    MINI_SPHERES = 0
    INTERSECTED_ROUND_CUBE = 1
    SQUARE_TORUS = 2
    TWISTED_TORUS = 3
    COG = 4
    CYLINDER = 5
    FRACTAL_PYRAMID = 6


class IntersectorKind(enum.IntEnum):
    """Which intersection routine a geometry dispatches to (the three DXR
    intersection shaders, plus triangle meshes)."""

    ANALYTIC = 0
    VOLUMETRIC = 1
    SIGNED_DISTANCE = 2
    TRIANGLE = 3


ANALYTIC_PRIMITIVE_COUNT = len(AnalyticPrimitive)
VOLUMETRIC_PRIMITIVE_COUNT = len(VolumetricPrimitive)
SDF_PRIMITIVE_COUNT = len(SignedDistancePrimitive)
TOTAL_PRIMITIVE_COUNT = (
    ANALYTIC_PRIMITIVE_COUNT + VOLUMETRIC_PRIMITIVE_COUNT + SDF_PRIMITIVE_COUNT
)


def tensors_to(obj, device, move=None):
    """Return a copy of a frozen dataclass with every tensor field (and
    nested dataclass field, alone or in a tuple) moved to ``device``, by
    ``move(tensor, device)`` (default ``tensor.to(device)``)."""
    move = move or (lambda t, d: t.to(d))
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = move(v, device)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = tensors_to(v, device, move)
        elif isinstance(v, tuple) and all(dataclasses.is_dataclass(x) for x in v):
            changes[f.name] = tuple(tensors_to(x, device, move) for x in v)
    return dataclasses.replace(obj, **changes)


@dataclasses.dataclass(frozen=True)
class SceneConstants:
    """SceneConstantBuffer (ConstantBuffers.h:49-58). projection_to_world
    is row-vector convention: world = [sx, sy, 0, 1] @ projection_to_world."""

    projection_to_world: torch.Tensor  # (4, 4) f32
    camera_position: torch.Tensor  # (4,) f32
    light_position: torch.Tensor  # (4,) f32
    light_ambient_color: torch.Tensor  # (4,) f32
    light_diffuse_color: torch.Tensor  # (4,) f32
    reflectance: torch.Tensor  # () f32
    elapsed_time: torch.Tensor  # () f32

    def to(self, device) -> "SceneConstants":
        return tensors_to(self, device)


@dataclasses.dataclass(frozen=True)
class MaterialTable:
    """Struct-of-arrays PrimitiveConstantBuffer (ConstantBuffers.h:61-71),
    one row per geometry; the plane material is the last row."""

    albedo: torch.Tensor  # (G, 4)
    reflectance_coefficient: torch.Tensor  # (G,)
    diffuse_coefficient: torch.Tensor  # (G,)
    specular_coefficient: torch.Tensor  # (G,)
    specular_power: torch.Tensor  # (G,)
    step_scale: torch.Tensor  # (G,)

    def to(self, device) -> "MaterialTable":
        return tensors_to(self, device)

    def row(self, g) -> "MaterialTable":
        """Geometry ``g``'s material: each field indexed by ``g`` (an int or
        a tensor of geometry ids)."""
        return MaterialTable(*(getattr(self, f.name)[g] for f in dataclasses.fields(self)))


@dataclasses.dataclass(frozen=True)
class InstanceTransforms:
    """PrimitiveInstancePerFrameBuffer (ConstantBuffers.h:81-85) as
    column-convention (P, 4, 4) matrices: p_blas = local_to_blas @ [p, 1]."""

    local_to_blas: torch.Tensor  # (P, 4, 4)
    blas_to_local: torch.Tensor  # (P, 4, 4)

    def to(self, device) -> "InstanceTransforms":
        return tensors_to(self, device)


@dataclasses.dataclass(frozen=True)
class HitRecord:
    """Closest-hit result over the scene (RayPayload analog)."""

    t: torch.Tensor  # (N,) world-space hit distance (RAY_TMAX on miss)
    normal: torch.Tensor  # (N, 3) world-space normal
    geometry_id: torch.Tensor  # (N,) int64; -1 on miss
    hit: torch.Tensor  # (N,) bool


def make_scene_constants(
    projection_to_world,
    camera_position,
    light_position,
    light_ambient_color,
    light_diffuse_color,
    reflectance=0.0,
    elapsed_time=0.0,
    *,
    device,
) -> SceneConstants:
    """The constants from host values, in one upload that never waits for
    the stream (core/upload.to_device); each field is a view of it. An
    ``elapsed_time`` that is already a tensor stays on the device."""
    fields = [projection_to_world, camera_position, light_position, light_ambient_color,
              light_diffuse_color, reflectance]
    on_device = isinstance(elapsed_time, torch.Tensor)
    if not on_device:
        fields.append(elapsed_time)
    host = [np.asarray(x, dtype=np.float32) for x in fields]
    flat = to_device(np.concatenate([x.reshape(-1) for x in host]), device)
    parts = [p.reshape(x.shape) for p, x in zip(flat.split([x.size for x in host]), host)]
    if on_device:
        parts.append(elapsed_time.to(device=device, dtype=torch.float32))
    return SceneConstants(*parts)
