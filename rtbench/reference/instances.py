"""Flattened two-level scene structure and the ray space transforms.

Port of gpuraytracer_tpu/accel/instances.py. Spaces as in the reference:
world --(instance translation)--> BLAS space --(per-frame matrix)-->
unit-AABB local space. The ray parameter t is shared by all three.

The transforms are explicit per-row multiply-adds in the association of
the reference (``m[r,0]*x + m[r,1]*y + m[r,2]*z (+ m[r,3])``), never ``@``:
a matrix product may run in reduced precision (TF32 on the GPU) or sum in
another order, and march crossings are ulp-sensitive.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from rtbench.reference import hlsl
from rtbench.reference.types import (
    InstanceTransforms,
    IntersectorKind,
    MaterialTable,
    SceneConstants,
    tensors_to,
)
from rtbench.reference.trimesh import TriangleMesh


@dataclasses.dataclass(frozen=True)
class SceneLayout:
    """Static scene structure (the shader-binding-table analog); same
    fields as the reference's SceneLayout."""

    kinds: Tuple[IntersectorKind, ...]  # per procedural instance
    prim_types: Tuple[int, ...]  # enum value within its kind
    has_plane: bool = True
    # Spatial clusters of instance indices; a pruning structure only —
    # results never depend on it.
    clusters: Tuple[Tuple[int, ...], ...] | None = None
    # Per-instance sphere-trace budgets; None = the reference's 512.
    step_budgets: Tuple[int, ...] | None = None
    # Processing order for the TPU tile kernels; a cost choice only.
    traversal_order: Tuple[int, ...] | None = None
    # Geometry -> material-slot map; None = identity.
    material_ids: Tuple[int, ...] | None = None


    @property
    def plane_geometry_id(self) -> int:
        return len(self.kinds)


@dataclasses.dataclass(frozen=True)
class SceneArrays:
    """Per-frame scene state (the constant-buffer contents)."""

    constants: SceneConstants
    # (M, ...) shading rows: one per geometry row (plane last), or the
    # unique rows that layout.material_ids maps geometry rows to;
    # step_scale always has one entry per geometry row.
    materials: MaterialTable
    transforms: InstanceTransforms  # (P, 4, 4) pairs, rebuilt per frame
    aabb_min: torch.Tensor  # (P, 3) BLAS-space geometry AABBs
    aabb_max: torch.Tensor  # (P, 3)
    blas_offset: torch.Tensor  # (3,) BLAS -> world translation
    plane_origin: torch.Tensor  # (3,) world-space corner of the ground quad
    plane_size: torch.Tensor  # (2,) world-space x/z extents of the quad
    # Triangle meshes, indexed by a TRIANGLE geometry's prim_type (its slot).
    meshes: Tuple[TriangleMesh, ...] = ()

    def to(self, device) -> "SceneArrays":
        return tensors_to(self, device)


@dataclasses.dataclass(frozen=True)
class Scene:
    """layout (static) + arrays (per frame)."""

    layout: SceneLayout
    arrays: SceneArrays


def ray_to_blas(origins_world, directions_world, blas_offset):
    """World -> BLAS space: subtract the instance translation
    (Renderer.cpp:778-781). Directions and t unchanged."""
    return origins_world - blas_offset, directions_world


def _row(m, r, v):
    return m[r, 0] * v[..., 0] + m[r, 1] * v[..., 1] + m[r, 2] * v[..., 2]


def ray_to_local(origins_blas, directions_blas, blas_to_local):
    """BLAS -> unit-AABB local space through the per-frame inverse matrix
    (Raytracing.hlsl:277-287); t is preserved."""
    m = blas_to_local
    o = torch.stack([_row(m, r, origins_blas) + m[r, 3] for r in range(3)], dim=-1)
    d = torch.stack([_row(m, r, directions_blas) for r in range(3)], dim=-1)
    return o, d


def normal_to_world(normal_local, local_to_blas):
    """Local -> BLAS -> world normal as the intersection shaders do it
    (Raytracing.hlsl:298-301): straight matrix (not inverse transpose),
    then normalize by division. A zero normal stays zero, as in the
    reference's Pallas kernels (the squared length is floored at 1e-30,
    which changes no other normal): a march that lands inside a quaternion
    Julia set, where the distance is constant, has a zero gradient."""
    m = local_to_blas
    n = torch.stack([_row(m, r, normal_local) for r in range(3)], dim=-1)
    return n / hlsl.sqrt(torch.clamp(
        n[..., 0] * n[..., 0] + n[..., 1] * n[..., 1] + n[..., 2] * n[..., 2], min=1e-30
    )).unsqueeze(-1)
