"""Generic scene builder — compose procedural scenes from instance specs.

Port of gpuraytracer_tpu/models/builder.py. A scene is a list of instances
(kind, primitive type, BLAS-space AABB placement, material, scale and an
optional rotation about +Y), the builtin camera, light and ground plane.
A triangle-mesh instance's primitive type is its slot in the scene's
meshes (``add_mesh_instance``).
``build`` produces the Scene the renderer consumes, with:

- a layout carrying clusters (accel/bvh.py), per-instance step budgets, a
  near-to-far traversal order and the geometry -> material-slot map;
- a material table deduplicated over the shading fields, with the
  per-geometry step_scale kept per geometry row (instances, then plane);
- per-frame transforms as explicit row math (never ``@``).

``animator()`` advances the transforms and the elapsed time of a built
scene's arrays on their own device, as builtin.animate_arrays does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from gpuraytracer_tpu_torch.accel import bvh
from gpuraytracer_tpu_torch.accel.instances import Scene, SceneArrays, SceneLayout
from gpuraytracer_tpu_torch.core.camera import Camera
from gpuraytracer_tpu_torch.core.upload import constant
from gpuraytracer_tpu_torch.core.types import (
    SDF_MAX_STEPS,
    InstanceTransforms,
    IntersectorKind,
    MaterialTable,
    make_scene_constants,
)
from gpuraytracer_tpu_torch.geometry import trimesh
from gpuraytracer_tpu_torch.models import builtin


@dataclasses.dataclass(frozen=True)
class Material:
    """PrimitiveConstantBuffer fields with the reference's defaults."""

    albedo: Tuple[float, float, float, float]
    reflectance: float = 0.0
    diffuse: float = 0.9
    specular: float = 0.7
    specular_power: float = 50.0
    step_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class InstanceSpec:
    kind: IntersectorKind
    prim_type: int
    aabb_min: Tuple[float, float, float]
    aabb_max: Tuple[float, float, float]
    material: Material
    scale: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    rotates: bool = False
    rotation_rate: float = builtin.ROTATION_RATE  # rad/s about +Y
    # Sphere-trace budget; None = the reference's 512.
    step_budget: int | None = None


class SceneBuilder:
    def __init__(self):
        self._instances: List[InstanceSpec] = []
        self._meshes: List[trimesh.TriangleMesh] = []
        self.camera: Camera = builtin.default_camera()
        self.light_position = builtin.LIGHT_POSITION
        self.light_ambient = builtin.LIGHT_AMBIENT
        self.light_diffuse = builtin.LIGHT_DIFFUSE
        self.plane_material: Optional[Material] = Material(
            (0.9, 0.9, 0.9, 1.0), 0.25, 1.0, 0.4, 50.0, 1.0)
        self.plane_origin = builtin.PLANE_ORIGIN
        self.plane_size = builtin.PLANE_SIZE
        self.blas_offset = builtin.BLAS_OFFSET

    def add_instance(self, spec: InstanceSpec) -> "SceneBuilder":
        self._instances.append(spec)
        return self

    def add_mesh_instance(self, positions, indices, material: Material, *, normals=None,
                          aabb_min: Tuple[float, float, float],
                          aabb_max: Tuple[float, float, float],
                          scale: Tuple[float, float, float] = (1.0, 1.0, 1.0),
                          rotates: bool = False,
                          rotation_rate: float = builtin.ROTATION_RATE) -> "SceneBuilder":
        """Add an indexed-triangle-mesh instance (the triangle BLAS analog,
        Renderer.cpp:575-592). Vertices live in the instance's local space,
        as the procedural primitives do; the mesh's slot becomes the
        instance's prim_type."""
        self._instances.append(InstanceSpec(
            kind=IntersectorKind.TRIANGLE, prim_type=len(self._meshes), aabb_min=aabb_min,
            aabb_max=aabb_max, material=material, scale=scale, rotates=rotates,
            rotation_rate=rotation_rate))
        self._meshes.append(trimesh.from_indexed(positions, indices, normals))
        return self

    def without_plane(self) -> "SceneBuilder":
        self.plane_material = None
        return self

    @property
    def layout(self) -> SceneLayout:
        specs = self._instances
        clusters = None
        march = sum(1 for s in specs
                    if s.kind in (IntersectorKind.SIGNED_DISTANCE, IntersectorKind.VOLUMETRIC))
        if bvh.should_cluster(len(specs), march_kinds=march):
            clusters = bvh.build_clusters(np.asarray([s.aabb_min for s in specs]),
                                          np.asarray([s.aabb_max for s in specs]),
                                          leaf_size=bvh.leaf_size_for(len(specs)))
        budgets = None
        if any(s.step_budget is not None for s in specs):
            budgets = tuple(SDF_MAX_STEPS if s.step_budget is None else int(s.step_budget)
                            for s in specs)
        order = None
        if len(specs) > 1:
            # Closed-form tests first, then marches near to far from the
            # eye in BLAS space (a cost choice of the reference's tile
            # kernels; the port traverses in definition order).
            eye = (np.asarray(self.camera.eye, dtype=np.float64)
                   - np.asarray(self.blas_offset, dtype=np.float64))
            centers = np.asarray([(np.asarray(s.aabb_min, dtype=np.float64)
                                   + np.asarray(s.aabb_max, dtype=np.float64)) * 0.5
                                  for s in specs])
            d2 = ((centers - eye) ** 2).sum(axis=1)
            order = tuple(sorted(range(len(specs)),
                                 key=lambda i: (specs[i].kind != IntersectorKind.ANALYTIC,
                                                float(d2[i]))))
        return SceneLayout(
            kinds=tuple(s.kind for s in specs),
            prim_types=tuple(int(s.prim_type) for s in specs),
            has_plane=self.plane_material is not None,
            clusters=clusters,
            step_budgets=budgets,
            traversal_order=order,
            material_ids=self._material_mapping()[1],
        )

    def _geometry_materials(self) -> List[Material]:
        mats = [s.material for s in self._instances]
        return mats + [self.plane_material] if self.plane_material is not None else mats

    def _material_mapping(self):
        """(unique materials, material_ids): identical shading fields share
        one slot; step_scale is a per-geometry march parameter, keyed out."""
        uniq, ids, index = [], [], {}
        for m in self._geometry_materials():
            key = (tuple(m.albedo), float(m.reflectance), float(m.diffuse),
                   float(m.specular), float(m.specular_power))
            slot = index.setdefault(key, len(uniq))
            if slot == len(uniq):
                uniq.append(m)
            ids.append(slot)
        return uniq, tuple(ids)

    def _material_table(self, device) -> MaterialTable:
        uniq, _ = self._material_mapping()

        def col(values):
            return torch.tensor(values, dtype=torch.float32, device=device)

        return MaterialTable(
            albedo=col([m.albedo for m in uniq]),
            reflectance_coefficient=col([m.reflectance for m in uniq]),
            diffuse_coefficient=col([m.diffuse for m in uniq]),
            specular_coefficient=col([m.specular for m in uniq]),
            specular_power=col([m.specular_power for m in uniq]),
            step_scale=col([m.step_scale for m in self._geometry_materials()]),
        )

    def _transforms(self, elapsed_time, device) -> InstanceTransforms:
        """Per-instance local <-> BLAS matrices at ``elapsed_time``:
        A = R_y(rate * t) @ diag(scale), A^-1 = diag(1/scale) @ R^T, and the
        translation column -(A^-1 center) as explicit multiply-adds."""
        specs = self._instances
        f32 = torch.float32
        t = builtin._time_on(elapsed_time, device)
        # The per-instance tables do not change between frames: uploaded once
        # per device (core/upload.constant), so a frame makes no host sync.
        rates = constant(tuple(float(s.rotation_rate) for s in specs), device)
        theta = rates * t
        c, s = torch.cos(theta), torch.sin(theta)
        zero, one = torch.zeros_like(c), torch.ones_like(c)
        rot_y = torch.stack([
            torch.stack([c, zero, s], dim=-1),
            torch.stack([zero, one, zero], dim=-1),
            torch.stack([-s, zero, c], dim=-1),
        ], dim=1)  # (P, 3, 3)
        rotates = constant(tuple(bool(sp.rotates) for sp in specs), device, torch.bool)
        rot = torch.where(rotates[:, None, None], rot_y, torch.eye(3, dtype=f32, device=device))
        rot_inv = rot.transpose(1, 2)
        scale = constant(tuple(tuple(map(float, sp.scale)) for sp in specs), device)
        a = rot * scale[:, None, :]
        a_inv = rot_inv / scale[:, :, None]
        mn = constant(tuple(tuple(map(float, sp.aabb_min)) for sp in specs), device)
        mx = constant(tuple(tuple(map(float, sp.aabb_max)) for sp in specs), device)
        center = (mn + mx) * 0.5
        tcol = -(a_inv[:, :, 0] * center[:, 0:1] + a_inv[:, :, 1] * center[:, 1:2]
                 + a_inv[:, :, 2] * center[:, 2:3])
        bottom = constant((0.0, 0.0, 0.0, 1.0), device).expand(
            len(specs), 1, 4)
        l2b = torch.cat([torch.cat([a, center[:, :, None]], dim=2), bottom], dim=1)
        b2l = torch.cat([torch.cat([a_inv, tcol[:, :, None]], dim=2), bottom], dim=1)
        return InstanceTransforms(local_to_blas=l2b.contiguous(), blas_to_local=b2l.contiguous())

    def animation_table(self) -> tuple:
        """Row 10's per-instance inputs (kernels/frame_state.py): (rotation
        rate, rotates, scale xyz, centre xyz) per instance, the values
        ``_transforms`` reads (the centre rounded as it rounds it, in f32)."""
        f32 = np.float32
        return tuple(
            (float(s.rotation_rate), float(s.rotates), *map(float, s.scale),
             *(float((f32(lo) + f32(hi)) * f32(0.5)) for lo, hi in zip(s.aabb_min, s.aabb_max)))
            for s in self._instances)

    def animator(self):
        """fn(arrays, elapsed_time) -> arrays with the transforms and the
        elapsed time advanced, on the arrays' device; its ``table`` is
        ``animation_table()``, which row 10 reads in a frame program."""

        def animate(arrays: SceneArrays, elapsed_time) -> SceneArrays:
            device = arrays.aabb_min.device
            t = builtin._time_on(elapsed_time, device)
            constants = dataclasses.replace(arrays.constants, elapsed_time=t)
            return dataclasses.replace(arrays, constants=constants,
                                       transforms=self._transforms(t, device))

        animate.table = self.animation_table()
        return animate

    def build(self, aspect: float, elapsed_time=0.0, *, device="cuda") -> Scene:
        if not self._instances:
            raise ValueError("scene has no instances")
        device = torch.device(device)
        constants = make_scene_constants(
            projection_to_world=self.camera.projection_to_world(aspect).astype(np.float32),
            camera_position=tuple(self.camera.eye) + (1.0,),
            light_position=self.light_position,
            light_ambient_color=self.light_ambient,
            light_diffuse_color=self.light_diffuse,
            elapsed_time=elapsed_time,
            device=device,
        )

        def f32(x):
            return torch.tensor(np.asarray(x, dtype=np.float32), device=device)

        arrays = SceneArrays(
            constants=constants,
            materials=self._material_table(device),
            transforms=self._transforms(elapsed_time, device),
            aabb_min=f32([s.aabb_min for s in self._instances]),
            aabb_max=f32([s.aabb_max for s in self._instances]),
            blas_offset=f32(self.blas_offset),
            plane_origin=f32(self.plane_origin),
            plane_size=f32(self.plane_size),
            meshes=tuple(m.to(device) for m in self._meshes),
        )
        return Scene(layout=self.layout, arrays=arrays)


def grid_cell_aabb(ix: int, iz: int, size=(2.0, 2.0, 2.0), grid=(4, 1, 4)):
    """AABB placement on the reference's 4x1x4 grid (Renderer.cpp:490-504)."""
    base = tuple(-(n * builtin.AABB_WIDTH + (n - 1) * builtin.AABB_DISTANCE) / 2.0 for n in grid)
    stride = builtin.AABB_WIDTH + builtin.AABB_DISTANCE
    mn = (base[0] + ix * stride, base[1], base[2] + iz * stride)
    mx = tuple(mn[k] + size[k] for k in range(3))
    return mn, mx
