"""The plain reference's scenes, built from a configuration's description.

A configuration's ``scene`` is data (``rtbench/configs/*.json``): the
camera, the light, the ground plane and a list of instances, each with its
kind, primitive type, BLAS-space AABB, material, scale and rotation about
+Y; a triangle-mesh instance names its mesh (a sine heightfield). This
module builds the reference's SceneLayout and SceneArrays from it at an
animation time, as the port's ``models/builder.SceneBuilder`` builds its
own (frozen copy): materials deduplicated over the shading fields, step
scales per geometry row, per-instance transforms A = R_y(rate t) diag(s)
written out as row math. ``mesh_data`` is also what the harness hands the
port, so both sides start from the same vertices.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rtbench.reference import trimesh
from rtbench.reference.camera import Camera, rotation_y, transform_point_row
from rtbench.reference.instances import Scene, SceneArrays, SceneLayout
from rtbench.reference.types import (
    InstanceTransforms,
    IntersectorKind,
    MaterialTable,
    make_scene_constants,
)

CAMERA_SECONDS_PER_REV = 48.0
LIGHT_SECONDS_PER_REV = 8.0


def heightfield(nx: int, nz: int, amp: float):
    """(positions, indices) of an nx x nz sine heightfield over local
    [-1, 1]^2: 2 nx nz faces, wound counter-clockwise seen from +y."""
    positions = []
    for iz in range(nz + 1):
        for ix in range(nx + 1):
            x = 2.0 * ix / nx - 1.0
            z = 2.0 * iz / nz - 1.0
            positions.append((x, amp * np.sin(2.5 * x) * np.cos(2.5 * z), z))
    indices = []
    for iz in range(nz):
        for ix in range(nx):
            a = iz * (nx + 1) + ix
            c = a + (nx + 1)
            indices.append([a, c + 1, a + 1])
            indices.append([a, c, c + 1])
    return positions, indices


def mesh_data(spec: dict):
    """(positions, indices) of an instance's ``mesh`` description."""
    if "heightfield" in spec:
        h = spec["heightfield"]
        return heightfield(int(h["nx"]), int(h["nz"]), float(h["amp"]))
    raise ValueError(f"unknown mesh description {sorted(spec)}")


def kind_of(instance: dict) -> IntersectorKind:
    return IntersectorKind[instance["kind"]]


def material_key(m: dict) -> tuple:
    return (tuple(map(float, m["albedo"])), float(m["reflectance"]), float(m["diffuse"]),
            float(m["specular"]), float(m["specular_power"]))


class SceneDescription:
    """A configuration's ``scene``; ``layout`` and ``arrays(...)`` build the
    reference's SceneLayout and SceneArrays from it."""

    def __init__(self, scene: dict):
        self.raw = scene
        self.instances = list(scene["instances"])
        self.plane = scene.get("plane")
        cam = scene["camera"]
        self.camera = Camera(eye=tuple(cam["eye"]), at=tuple(cam["at"]),
                             initial_y_rotation_deg=float(cam["initial_y_rotation_deg"]))
        light = scene["light"]
        self.light_position = tuple(map(float, light["position"]))
        self.light_ambient = tuple(map(float, light["ambient"]))
        self.light_diffuse = tuple(map(float, light["diffuse"]))
        self.blas_offset = tuple(map(float, scene["blas_offset"]))
        self.meshes = []
        self.prim_types = []
        for inst in self.instances:
            if kind_of(inst) == IntersectorKind.TRIANGLE:
                self.prim_types.append(len(self.meshes))
                self.meshes.append(trimesh.from_indexed(*mesh_data(inst["mesh"])))
            else:
                self.prim_types.append(int(inst["prim_type"]))

    def _geometry_materials(self) -> list:
        mats = [inst["material"] for inst in self.instances]
        return mats + [self.plane["material"]] if self.plane is not None else mats

    def _material_mapping(self):
        uniq, ids, index = [], [], {}
        for m in self._geometry_materials():
            slot = index.setdefault(material_key(m), len(uniq))
            if slot == len(uniq):
                uniq.append(m)
            ids.append(slot)
        return uniq, tuple(ids)

    @property
    def layout(self) -> SceneLayout:
        return SceneLayout(kinds=tuple(kind_of(i) for i in self.instances),
                           prim_types=tuple(self.prim_types), has_plane=self.plane is not None,
                           material_ids=self._material_mapping()[1])

    def _materials(self, device) -> MaterialTable:
        uniq, _ = self._material_mapping()

        def col(values):
            return torch.tensor(values, dtype=torch.float32, device=device)

        return MaterialTable(
            albedo=col([list(map(float, m["albedo"])) for m in uniq]),
            reflectance_coefficient=col([float(m["reflectance"]) for m in uniq]),
            diffuse_coefficient=col([float(m["diffuse"]) for m in uniq]),
            specular_coefficient=col([float(m["specular"]) for m in uniq]),
            specular_power=col([float(m["specular_power"]) for m in uniq]),
            step_scale=col([float(m["step_scale"]) for m in self._geometry_materials()]),
        )

    def _transforms(self, t, device) -> InstanceTransforms:
        """Local <-> BLAS matrices at time ``t`` (an f32 scalar tensor)."""
        specs = self.instances
        f32 = torch.float32
        rates = torch.tensor([float(s["rotation_rate"]) for s in specs], dtype=f32,
                             device=device)
        theta = rates * t
        c, s = torch.cos(theta), torch.sin(theta)
        zero, one = torch.zeros_like(c), torch.ones_like(c)
        rot_y = torch.stack([
            torch.stack([c, zero, s], dim=-1),
            torch.stack([zero, one, zero], dim=-1),
            torch.stack([-s, zero, c], dim=-1),
        ], dim=1)
        rotates = torch.tensor([bool(sp["rotates"]) for sp in specs], device=device)
        rot = torch.where(rotates[:, None, None], rot_y, torch.eye(3, dtype=f32, device=device))
        rot_inv = rot.transpose(1, 2)
        scale = torch.tensor([list(map(float, sp["scale"])) for sp in specs], dtype=f32,
                             device=device)
        a = rot * scale[:, None, :]
        a_inv = rot_inv / scale[:, :, None]
        mn = torch.tensor([list(map(float, sp["aabb_min"])) for sp in specs], dtype=f32,
                          device=device)
        mx = torch.tensor([list(map(float, sp["aabb_max"])) for sp in specs], dtype=f32,
                          device=device)
        center = (mn + mx) * 0.5
        tcol = -(a_inv[:, :, 0] * center[:, 0:1] + a_inv[:, :, 1] * center[:, 1:2]
                 + a_inv[:, :, 2] * center[:, 2:3])
        bottom = torch.tensor((0.0, 0.0, 0.0, 1.0), dtype=f32, device=device).expand(
            len(specs), 1, 4)
        l2b = torch.cat([torch.cat([a, center[:, :, None]], dim=2), bottom], dim=1)
        b2l = torch.cat([torch.cat([a_inv, tcol[:, :, None]], dim=2), bottom], dim=1)
        return InstanceTransforms(local_to_blas=l2b.contiguous(), blas_to_local=b2l.contiguous())

    def scene(self, aspect: float, elapsed_time: float, *, camera: Camera | None = None,
              light_position=None, device) -> Scene:
        """The reference's Scene at ``elapsed_time`` (seconds), seen by
        ``camera`` (default the description's) under ``light_position``."""
        camera = camera or self.camera
        light = self.light_position if light_position is None else tuple(light_position)
        constants = make_scene_constants(
            projection_to_world=camera.projection_to_world(aspect).astype(np.float32),
            camera_position=tuple(camera.eye) + (1.0,),
            light_position=light,
            light_ambient_color=self.light_ambient,
            light_diffuse_color=self.light_diffuse,
            elapsed_time=elapsed_time,
            device=device,
        )

        def f32(x):
            return torch.tensor(np.asarray(x, dtype=np.float32), device=device)

        plane = self.plane or {"origin": (0.0, 0.0, 0.0), "size": (0.0, 0.0)}
        arrays = SceneArrays(
            constants=constants,
            materials=self._materials(device),
            transforms=self._transforms(constants.elapsed_time, device),
            aabb_min=f32([s["aabb_min"] for s in self.instances]),
            aabb_max=f32([s["aabb_max"] for s in self.instances]),
            blas_offset=f32(self.blas_offset),
            plane_origin=f32(plane["origin"]),
            plane_size=f32(plane["size"]),
            meshes=tuple(m.to(device) for m in self.meshes),
        )
        return Scene(layout=self.layout, arrays=arrays)


class ViewerState:
    """The viewer's per-frame state (the Renderer::on_update analog): the
    camera orbit (48 s a turn), the light orbit (-360 degrees in 8 s) and
    the geometry time, each advanced by every tick's delta in float64, as
    the viewer accumulates them."""

    def __init__(self, desc: SceneDescription, geometry_time: float):
        self.camera = desc.camera
        self.light = np.asarray(desc.light_position, dtype=np.float64)
        self.geometry_time = float(geometry_time)

    def tick(self, dt: float, *, camera: bool, light: bool, geometry: bool) -> "ViewerState":
        if camera:
            self.camera = self.camera.rotate_y(2.0 * math.pi * (dt / CAMERA_SECONDS_PER_REV))
        if light:
            xyz = transform_point_row(self.light[:3],
                                      rotation_y(-2.0 * math.pi * (dt / LIGHT_SECONDS_PER_REV)))
            self.light = np.asarray([xyz[0], xyz[1], xyz[2], self.light[3]])
        if geometry:
            self.geometry_time = self.geometry_time + dt
        return self
