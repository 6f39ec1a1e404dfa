"""Three triangle-mesh scenes, one for each route a mesh scene takes.

1. mesh_octahedra: the ground plane and 8 octahedron instances (64 faces,
   9 materials), the JAX package's own mesh bench scene
   (tools/profile_mesh.py build_mesh_scene). Fused-eligible: the frame
   kernel renders it; with GPURT_DISABLE_FUSED=1 the wavefront and the
   scene kernel do.
2. mesh_heightfield_512: a plane-less 16x16 sine heightfield of 512 faces
   (the reference's tests/test_trimesh.py big_mesh_scene, scaled 10x about
   its centre: at the test's size it covers 0.4% of the builtin camera's
   frame, at 10x half of it), exactly TRI_FACE_TOTAL_CAP faces: the frame
   kernel renders it.
3. mesh_heightfield_sdf: the plane, a 17x16 heightfield (544 faces, just
   past the cap), a FRACTAL_PYRAMID (code 6, a reference SDF with the
   escape bound) and a MANDELBULB (code 7, AABB-windowed, relaxed), each in
   its own grid cell. Past the cap, so the per-geometry route renders it and
   every SDF march runs in csrc/megakernel.cu.

Each builder function takes the builder module to build with (default the
port's); the tests hand it the JAX package's, so both sides build the same
scene from one definition. All three render at 1920x1080, depth 3.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from gpuraytracer_tpu_torch.models import builder as port_builder
from gpuraytracer_tpu_torch.models.scenes import GREEN, BenchConfig

BLUE = (0.2, 0.3, 1.0, 1.0)


def octahedron(radius=1.0):
    """(positions, indices) of an octahedron: 6 vertices, 8 faces."""
    positions = [(0.0, radius, 0.0), (0.0, -radius, 0.0), (radius, 0.0, 0.0),
                 (-radius, 0.0, 0.0), (0.0, 0.0, radius), (0.0, 0.0, -radius)]
    indices = [[0, 4, 2], [0, 2, 5], [0, 5, 3], [0, 3, 4],
               [1, 2, 4], [1, 5, 2], [1, 3, 5], [1, 4, 3]]
    return positions, indices


def heightfield(nx=16, nz=16, amp=0.3):
    """(positions, indices) of an nx x nz sine heightfield over local
    [-1, 1]^2: 2 * nx * nz faces, wound counter-clockwise seen from +y."""
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


def octahedra_builder(builder=port_builder):
    b = builder.SceneBuilder()
    positions, indices = octahedron()
    for k in range(8):
        gx, gz = divmod(k, 2)
        x, z = -6.0 + gx * 4.0, -4.0 + gz * 6.0
        b.add_mesh_instance(positions, indices,
                            builder.Material((0.9, 0.2 + 0.1 * k, 0.2, 1.0), reflectance=0.3),
                            aabb_min=(x - 1.2, -1.2, z - 1.2), aabb_max=(x + 1.2, 1.2, z + 1.2))
    return b


def heightfield_512_builder(builder=port_builder):
    b = builder.SceneBuilder().without_plane()
    positions, indices = heightfield(16, 16)
    b.add_mesh_instance(positions, indices, builder.Material(BLUE),
                        aabb_min=(-12.0, -6.0, -12.0), aabb_max=(12.0, 6.0, 12.0),
                        scale=(10.0, 10.0, 10.0))
    return b


def heightfield_sdf_builder(builder=port_builder, nx=17, nz=16):
    """mesh_heightfield_sdf's scene; ``nx``, ``nz``: its heightfield's grid
    (a larger one measures the route with a larger mesh)."""
    b = builder.SceneBuilder()
    kind = builder.IntersectorKind
    positions, indices = heightfield(nx, nz)
    mn, mx = builder.grid_cell_aabb(0, 1, (3.0, 3.0, 3.0))
    b.add_mesh_instance(positions, indices, builder.Material(BLUE, reflectance=0.3),
                        aabb_min=mn, aabb_max=mx, scale=(1.5, 1.5, 1.5))
    mn, mx = builder.grid_cell_aabb(2, 1, (3.0, 3.0, 3.0))
    b.add_instance(builder.InstanceSpec(
        kind=kind.SIGNED_DISTANCE, prim_type=6, aabb_min=mn, aabb_max=mx,
        material=builder.Material(GREEN, 0.0, 1.0, 0.1, 4.0, 0.8), scale=(1.5, 1.5, 1.5)))
    mn, mx = builder.grid_cell_aabb(1, 3, (4.0, 4.0, 4.0))
    b.add_instance(builder.InstanceSpec(
        kind=kind.SIGNED_DISTANCE, prim_type=7, aabb_min=mn, aabb_max=mx,
        material=builder.Material((1.0, 1.0, 0.5, 1.0), 0.0, 1.0, 0.4, 10.0, 0.6),
        scale=(2.0, 2.0, 2.0)))
    return b


MESH_CONFIGS: Tuple[BenchConfig, ...] = (
    BenchConfig("mesh_octahedra", octahedra_builder, 1920, 1080, 3),
    BenchConfig("mesh_heightfield_512", heightfield_512_builder, 1920, 1080, 3),
    BenchConfig("mesh_heightfield_sdf", heightfield_sdf_builder, 1920, 1080, 3),
)


def get_config(name: str) -> BenchConfig:
    for c in MESH_CONFIGS:
        if c.name == name:
            return c
    raise KeyError(name)
