"""THE built-in scene: checkerboard ground plane + 4x1x4 grid of procedural
primitives, with every material/placement constant from the reference.

Port of gpuraytracer_tpu/models/builtin.py (reference anchors there:
Renderer.cpp:201-356, 478-835). The layout keeps only the fields that
decide the image; the reference's TPU tile-order and cluster fields are
cost choices of its kernels and are left unset.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from gpuraytracer_tpu_torch.accel.instances import Scene, SceneArrays, SceneLayout
from gpuraytracer_tpu_torch.core.camera import Camera
from gpuraytracer_tpu_torch.core.types import (
    AnalyticPrimitive,
    CHROMIUM_REFLECTANCE,
    InstanceTransforms,
    IntersectorKind,
    MaterialTable,
    SceneConstants,
    SignedDistancePrimitive,
    TOTAL_PRIMITIVE_COUNT,
    VolumetricPrimitive,
    make_scene_constants,
)
from gpuraytracer_tpu_torch.core.upload import constant, to_device
from gpuraytracer_tpu_torch.utils import profile

# Grid constants (Renderer.h:95-96, Renderer.cpp:490-497)
AABB_WIDTH = 2.0
AABB_DISTANCE = 2.0
_GRID = (4, 1, 4)
_STRIDE = AABB_WIDTH + AABB_DISTANCE  # 4.0
_BASE = tuple(
    -(n * AABB_WIDTH + (n - 1) * AABB_DISTANCE) / 2.0 for n in _GRID
)  # (-7, -1, -7)


def _aabb(offset_index, size):
    """initialize_aabb (Renderer.cpp:498-504)."""
    mn = tuple(_BASE[k] + offset_index[k] * _STRIDE for k in range(3))
    mx = tuple(mn[k] + size[k] for k in range(3))
    return mn, mx


# Geometry order == shader-record order: Analytic(2), Volumetric(1), SDF(7).
LAYOUT = SceneLayout(
    kinds=(
        IntersectorKind.ANALYTIC,
        IntersectorKind.ANALYTIC,
        IntersectorKind.VOLUMETRIC,
    ) + (IntersectorKind.SIGNED_DISTANCE,) * 7,
    prim_types=(
        int(AnalyticPrimitive.AABB),
        int(AnalyticPrimitive.SPHERES),
        int(VolumetricPrimitive.METABALLS),
        int(SignedDistancePrimitive.MINI_SPHERES),
        int(SignedDistancePrimitive.INTERSECTED_ROUND_CUBE),
        int(SignedDistancePrimitive.SQUARE_TORUS),
        int(SignedDistancePrimitive.TWISTED_TORUS),
        int(SignedDistancePrimitive.COG),
        int(SignedDistancePrimitive.CYLINDER),
        int(SignedDistancePrimitive.FRACTAL_PYRAMID),
    ),
    has_plane=True,
)

# AABB placements (Renderer.cpp:508-533), in geometry order.
_AABBS = (
    _aabb((3, 0, 0), (2, 3, 2)),  # AnalyticPrimitive::AABB
    _aabb((2.25, 0, 0.75), (3, 3, 3)),  # AnalyticPrimitive::Spheres
    _aabb((0, 0, 0), (3, 3, 3)),  # VolumetricPrimitive::Metaballs
    _aabb((2, 0, 0), (2, 2, 2)),  # MiniSpheres
    _aabb((0, 0, 2), (2, 2, 2)),  # IntersectedRoundCube
    _aabb((0.75, -0.1, 2.25), (3, 3, 3)),  # SquareTorus
    _aabb((0, 0, 1), (2, 2, 2)),  # TwistedTorus
    _aabb((1, 0, 0), (2, 2, 2)),  # Cog
    _aabb((0, 0, 3), (2, 3, 2)),  # Cylinder
    _aabb((2, 0, 2), (6, 6, 6)),  # FractalPyramid
)

AABB_MIN = np.asarray([a[0] for a in _AABBS], dtype=np.float32)
AABB_MAX = np.asarray([a[1] for a in _AABBS], dtype=np.float32)

# Procedural BLAS instance translation: +aabb_width/2 in Y (Renderer.cpp:778-781).
BLAS_OFFSET = (0.0, AABB_WIDTH / 2.0, 0.0)

# Per-frame transform specs (Renderer.cpp:302-356): (scale xyz, rotates?).
TRANSFORM_SPECS: Tuple[Tuple[Tuple[float, float, float], bool], ...] = (
    ((1.0, 1.5, 1.0), False),  # AABB
    ((1.5, 1.5, 1.5), True),  # Spheres
    ((1.5, 1.5, 1.5), True),  # Metaballs
    ((1.0, 1.0, 1.0), False),  # MiniSpheres
    ((1.0, 1.0, 1.0), False),  # IntersectedRoundCube
    ((1.5, 1.5, 1.5), False),  # SquareTorus
    ((1.0, 1.0, 1.0), True),  # TwistedTorus
    ((1.0, 1.0, 1.0), True),  # Cog
    ((1.0, 1.5, 1.0), False),  # Cylinder
    ((3.0, 3.0, 3.0), False),  # FractalPyramid
)

ROTATION_RATE = -2.0  # radians per second (Renderer.cpp:311)

_GREEN = (0.1, 1.0, 0.5, 1.0)
_RED = (1.0, 0.5, 0.5, 1.0)
_YELLOW = (1.0, 1.0, 0.5, 1.0)


def _mat(albedo, reflectance=0.0, diffuse=0.9, specular=0.7, power=50.0, step_scale=1.0):
    return (albedo, reflectance, diffuse, specular, power, step_scale)


# Materials (Renderer.cpp:201-250); the plane material is the last row.
_MATERIALS = (
    _mat(_RED),  # AnalyticPrimitive::AABB
    _mat(CHROMIUM_REFLECTANCE, 1.0),  # Spheres
    _mat(CHROMIUM_REFLECTANCE, 1.0),  # Metaballs
    _mat(_GREEN),  # MiniSpheres
    _mat(_GREEN),  # IntersectedRoundCube
    _mat(CHROMIUM_REFLECTANCE, 1.0),  # SquareTorus
    _mat(_YELLOW, 0.0, 1.0, 0.7, 50.0, 0.5),  # TwistedTorus
    _mat(_YELLOW, 0.0, 1.0, 0.1, 2.0),  # Cog
    _mat(_RED),  # Cylinder
    _mat(_GREEN, 0.0, 1.0, 0.1, 4.0, 0.8),  # FractalPyramid
    ((0.9, 0.9, 0.9, 1.0), 0.25, 1.0, 0.4, 50.0, 1.0),  # Plane (Renderer.cpp:215)
)

PLANE_GEOMETRY_ID = TOTAL_PRIMITIVE_COUNT  # 10

# Plane instance (Renderer.cpp:742-765): 700x1x700 AABB-widths scaled quad.
_PLANE_N = (700, 1, 700)
PLANE_WIDTH = tuple(n * AABB_WIDTH + (n - 1) * AABB_DISTANCE for n in _PLANE_N)
PLANE_ORIGIN = (PLANE_WIDTH[0] * -0.35, 0.0, PLANE_WIDTH[2] * -0.35)
PLANE_SIZE = (PLANE_WIDTH[0], PLANE_WIDTH[2])

# Lights (Renderer.cpp:270-286)
LIGHT_POSITION = (0.0, 18.0, -20.0, 0.0)
LIGHT_AMBIENT = (0.25, 0.25, 0.25, 1.0)
LIGHT_DIFFUSE = (0.6, 0.6, 0.6, 1.0)


def default_camera() -> Camera:
    return Camera(eye=(0.0, 5.3, -17.0), at=(0.0, 0.0, 0.0), initial_y_rotation_deg=45.0)


def _rows(a) -> tuple:
    """A float32 array as the nested tuple that upload.constant keys on."""
    return tuple(map(tuple, np.asarray(a, dtype=np.float32).tolist()))


def material_table(device) -> MaterialTable:
    """The material table, uploaded once per device (upload.constant)."""
    def col(i):
        return constant(tuple(m[i] for m in _MATERIALS), device)

    return MaterialTable(
        albedo=col(0),
        reflectance_coefficient=col(1),
        diffuse_coefficient=col(2),
        specular_coefficient=col(3),
        specular_power=col(4),
        step_scale=col(5),
    )


def _time_on(elapsed_time, device) -> torch.Tensor:
    """The animation time as an f32 scalar on ``device``: a tensor stays on
    the device, a host number goes up without a host sync
    (upload.to_device)."""
    if isinstance(elapsed_time, torch.Tensor):
        return elapsed_time.to(device=device, dtype=torch.float32)
    return to_device(elapsed_time, device)


def build_instance_transforms(elapsed_time, device) -> InstanceTransforms:
    """update_aabb_primitive_attributes (Renderer.cpp:302-356) as a pure
    function of the animation time, for all instances at once. Column
    convention; the inverse is analytic (S^-1 R^-1 T^-1), with the
    translation column as explicit multiply-adds."""
    f32 = torch.float32
    t = _time_on(elapsed_time, device)
    theta = ROTATION_RATE * t
    c, s = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    # Column-convention XMMatrixRotationY: x' = c x + s z, z' = -s x + c z.
    rot_y = torch.stack([
        torch.stack([c, zero, s]),
        torch.stack([zero, one, zero]),
        torch.stack([-s, zero, c]),
    ])
    eye3 = torch.eye(3, dtype=f32, device=device)
    # The rotate and scale columns, the centres and the bottom row do not
    # change between frames: uploaded once per device.
    rotates = constant(tuple(r for _, r in TRANSFORM_SPECS), device, torch.bool)
    rot = torch.where(rotates[:, None, None], rot_y, eye3)  # (P, 3, 3)
    rot_inv = rot.transpose(1, 2)
    scale = constant(tuple(sc for sc, _ in TRANSFORM_SPECS), device)
    a = rot * scale[:, None, :]  # R @ diag(scale)
    a_inv = rot_inv / scale[:, :, None]  # diag(1/scale) @ R^T
    center = constant(_rows((AABB_MIN + AABB_MAX) * 0.5), device)
    tcol = -(a_inv[:, :, 0] * center[:, 0:1] + a_inv[:, :, 1] * center[:, 1:2]
             + a_inv[:, :, 2] * center[:, 2:3])
    p = len(TRANSFORM_SPECS)
    bottom = constant((0.0, 0.0, 0.0, 1.0), device).expand(p, 1, 4)
    l2b = torch.cat([torch.cat([a, center[:, :, None]], dim=2), bottom], dim=1)
    b2l = torch.cat([torch.cat([a_inv, tcol[:, :, None]], dim=2), bottom], dim=1)
    return InstanceTransforms(local_to_blas=l2b.contiguous(), blas_to_local=b2l.contiguous())


def build_scene_constants(camera: Camera, aspect: float, elapsed_time=0.0,
                          light_position=LIGHT_POSITION, *, device) -> SceneConstants:
    return make_scene_constants(
        projection_to_world=camera.projection_to_world(aspect).astype(np.float32),
        camera_position=tuple(camera.eye) + (1.0,),
        light_position=light_position,
        light_ambient_color=LIGHT_AMBIENT,
        light_diffuse_color=LIGHT_DIFFUSE,
        reflectance=0.0,
        elapsed_time=elapsed_time,
        device=device,
    )


def animate_arrays(arrays: SceneArrays, elapsed_time) -> SceneArrays:
    """Advance the per-frame state to ``elapsed_time`` on the arrays' own
    device (the on_update work, Renderer.cpp:112-119): the animation time
    feeds the instance transforms and the metaball keyframes."""
    device = arrays.aabb_min.device
    t = _time_on(elapsed_time, device)
    constants = dataclasses.replace(arrays.constants, elapsed_time=t)
    return dataclasses.replace(
        arrays, constants=constants, transforms=build_instance_transforms(t, device)
    )


# Row 10's per-instance inputs (kernels/frame_state.py): (rotation rate,
# rotates, scale xyz, centre xyz) per instance, the values
# build_instance_transforms reads.
ANIMATION_TABLE = tuple(
    (ROTATION_RATE, float(rotates), *map(float, scale), *map(float, centre))
    for (scale, rotates), centre in zip(TRANSFORM_SPECS, (AABB_MIN + AABB_MAX) * np.float32(0.5)))
animate_arrays.table = ANIMATION_TABLE


def build_scene(aspect: float, elapsed_time=0.0, camera: Camera | None = None,
                light_position=LIGHT_POSITION, *, device) -> Scene:
    """Assemble the full reference scene at a given animation time, in
    three spans (utils/profile.py): ``models.constants`` (the camera
    matrices and the constants' upload), ``models.transforms`` and
    ``models.tables`` (the material table and the other constant tables)."""
    camera = camera or default_camera()

    def f32(x):
        return constant(_rows(x) if np.ndim(x) == 2 else tuple(x), device)

    with profile.span("models.constants"):
        constants = build_scene_constants(camera, aspect, elapsed_time, light_position,
                                          device=device)
    with profile.span("models.transforms"):
        transforms = build_instance_transforms(constants.elapsed_time, device)
    with profile.span("models.tables"):
        arrays = SceneArrays(
            constants=constants,
            materials=material_table(device),
            transforms=transforms,
            aabb_min=f32(AABB_MIN),
            aabb_max=f32(AABB_MAX),
            blas_offset=f32(BLAS_OFFSET),
            plane_origin=f32(PLANE_ORIGIN),
            plane_size=f32(PLANE_SIZE),
        )
    return Scene(layout=LAYOUT, arrays=arrays)
