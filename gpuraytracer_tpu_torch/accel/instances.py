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
from typing import Mapping, Tuple

import numpy as np
import torch

from gpuraytracer_tpu_torch.core import hlsl
from gpuraytracer_tpu_torch.core.types import (
    InstanceTransforms,
    IntersectorKind,
    MaterialTable,
    SceneConstants,
    tensors_to,
)
from gpuraytracer_tpu_torch.geometry.trimesh import TriangleMesh


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

    @classmethod
    def from_fields(cls, fields: Mapping) -> "SceneLayout":
        """Build from plain fields keyed by name (ints and tuples of ints,
        as the reference package's SceneLayout holds them)."""

        def ints(v):
            return None if v is None else tuple(int(x) for x in v)

        clusters = fields.get("clusters")
        return cls(
            kinds=tuple(IntersectorKind(int(k)) for k in fields["kinds"]),
            prim_types=ints(fields["prim_types"]),
            has_plane=bool(fields.get("has_plane", True)),
            clusters=None if clusters is None else tuple(ints(c) for c in clusters),
            step_budgets=ints(fields.get("step_budgets")),
            traversal_order=ints(fields.get("traversal_order")),
            material_ids=ints(fields.get("material_ids")),
        )

    @property
    def num_procedural(self) -> int:
        return len(self.kinds)

    @property
    def plane_geometry_id(self) -> int:
        return len(self.kinds)

    @property
    def num_geometries(self) -> int:
        return len(self.kinds) + (1 if self.has_plane else 0)


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

    def to_numpy(self) -> dict:
        """Flatten to {"constants.elapsed_time": ndarray, ...}; mesh k's
        rows go to "meshes.k.v0", "meshes.k.e1", ..."""
        return _flatten(self)

    @classmethod
    def from_numpy(cls, flat: Mapping[str, np.ndarray], device) -> "SceneArrays":
        """Build from a flat dict of numpy arrays keyed by dotted field
        path, as ``to_numpy`` writes it. This is how the reference
        package's SceneArrays (flattened to numpy by its field names)
        carries over into the port."""
        return _unflatten(cls, flat, "", device)


def _flatten(obj, prefix="") -> dict:
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        key = prefix + f.name
        if dataclasses.is_dataclass(v):
            out.update(_flatten(v, key + "."))
        elif isinstance(v, torch.Tensor):
            out[key] = v.detach().cpu().numpy()
        elif isinstance(v, tuple):
            for k, item in enumerate(v):
                out.update(_flatten(item, f"{key}.{k}."))
    return out


def _unflatten(cls, flat, prefix, device):
    kw = {}
    for f in dataclasses.fields(cls):
        key = prefix + f.name
        sub = _DATACLASS_FIELDS.get(f.name)
        if f.name == "meshes":
            kw[f.name] = tuple(_unflatten(TriangleMesh, flat, f"{key}.{k}.", device)
                               for k in range(_count_items(flat, key + ".")))
        elif sub is not None:
            kw[f.name] = _unflatten(sub, flat, key + ".", device)
        else:
            kw[f.name] = torch.tensor(np.asarray(flat[key], dtype=np.float32),
                                      device=device)
    return cls(**kw)


def _count_items(flat, prefix) -> int:
    """Number of tuple items under ``prefix`` ("meshes." -> 0, 1, ...)."""
    idx = {int(k[len(prefix):].split(".", 1)[0]) for k in flat if k.startswith(prefix)}
    if idx != set(range(len(idx))):
        raise ValueError(f"{prefix}: items {sorted(idx)} are not 0..n-1")
    return len(idx)


_DATACLASS_FIELDS = {
    "constants": SceneConstants,
    "materials": MaterialTable,
    "transforms": InstanceTransforms,
}


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
