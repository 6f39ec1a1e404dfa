"""Indexed triangle meshes — the triangle BLAS path.

Port of gpuraytracer_tpu/geometry/trimesh.py. The index gather runs once
on the host (``from_indexed``, in numpy exactly as the reference does it):
faces become (v0, e1, e2, n) rows, n being the first vertex's normal when
vertex normals are given (the flat-normal rule, Raytracing.hlsl:184-187),
else the geometric (winding) normal. Intersection is Möller–Trumbore with
the DXR back-face cull (det > eps), closest over faces with a strict <.

``intersect_trimesh`` is the plain version of the mesh body of the CUDA
kernels (csrc/traverse.cuh ``intersect_trimesh``). It reduces over faces
in chunks, each chunk as one (N, C) block: the reference's face loop
(unrolled below 8 faces, ``lax.scan`` above) is a schedule, and the first
face at the minimal t wins either way.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rtbench.reference.types import tensors_to

DET_EPS = 1e-12
# Faces per (N, C) block of the plain reduction (bounds its memory).
_FACE_CHUNK = 64


@dataclasses.dataclass(frozen=True)
class TriangleMesh:
    """Face rows: (F, 3) f32 each."""

    v0: torch.Tensor  # first vertex
    e1: torch.Tensor  # v1 - v0
    e2: torch.Tensor  # v2 - v0
    n: torch.Tensor  # unit shading normal

    @property
    def num_faces(self) -> int:
        return int(self.v0.shape[0])

    def to(self, device) -> "TriangleMesh":
        return tensors_to(self, device)

    def rows(self) -> torch.Tensor:
        """(F, 12) f32 [v0 | e1 | e2 | n]."""
        return torch.cat([self.v0, self.e1, self.e2, self.n], dim=-1)


def from_indexed(positions, indices, normals=None, *, device="cpu") -> TriangleMesh:
    """Mesh from vertex/index buffers (the BLAS-build analog,
    Renderer.cpp:575-592). indices: (F, 3) integers, u16 or u32 (both widen
    losslessly); positions / normals: (V, 3)."""
    positions = np.asarray(positions, dtype=np.float32)
    indices = np.asarray(indices, dtype=np.int64).reshape(-1, 3)
    p0 = positions[indices[:, 0]]
    p1 = positions[indices[:, 1]]
    p2 = positions[indices[:, 2]]
    e1 = p1 - p0
    e2 = p2 - p0
    if normals is not None:
        n = np.asarray(normals, dtype=np.float32)[indices[:, 0]]
    else:
        n = np.cross(e1, e2)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)

    def f32(a):
        return torch.tensor(np.ascontiguousarray(a, dtype=np.float32), device=device)

    return TriangleMesh(v0=f32(p0), e1=f32(e1), e2=f32(e2), n=f32(n))


def _cross(a, b):
    """a x b in jnp.cross's component order; a, b broadcast over (..., 3)."""
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def _dot(a, b):
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return ax * bx + ay * by + az * bz


def mt_face(origins, directions, v0, e1, e2, *, t_min, t_max, cull_backface):
    """Möller–Trumbore of rays (..., 3) against faces broadcast with them.
    det = dot(e1, d x e2) > 0 is a front face, so the cull keeps det > eps,
    and no cull keeps |det| > eps. t_max broadcasts with the result.
    Returns (hit, t) with t = +inf on a miss."""
    pv = _cross(directions, e2)
    det = _dot(e1, pv)
    det_ok = det > DET_EPS if cull_backface else torch.abs(det) > DET_EPS
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    tv = origins - v0
    u = _dot(tv, pv) * inv_det
    qv = _cross(tv, e1)
    v = _dot(directions, qv) * inv_det
    t = _dot(e2, qv) * inv_det
    hit = det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= t_min) & (t <= t_max)
    return hit, torch.where(hit, t, torch.inf)


def intersect_trimesh(origins, directions, mesh: TriangleMesh, *, t_min, t_max,
                      cull_backface=True, active=None):
    """Closest hit over every face for (N, 3) local rays; t_max is a float
    or (N,); ``active`` (N,) bool: only those lanes are tested, the rest
    miss. Returns (hit (N,), t (N,) with +inf on a miss, normal (N, 3):
    the winning face's n, zero on a miss)."""
    n = origins.shape[0]
    if active is not None:
        t = torch.full((n,), torch.inf, dtype=origins.dtype, device=origins.device)
        normal = torch.zeros_like(origins)
        lanes = torch.nonzero(active).squeeze(1)
        if lanes.numel():
            tm = t_max[lanes] if torch.is_tensor(t_max) and t_max.dim() == 1 else t_max
            _, t[lanes], normal[lanes] = intersect_trimesh(
                origins[lanes], directions[lanes], mesh, t_min=t_min, t_max=tm,
                cull_backface=cull_backface)
        return torch.isfinite(t), t, normal
    best_t = torch.full((n,), torch.inf, dtype=origins.dtype, device=origins.device)
    best_f = torch.full((n,), -1, dtype=torch.int64, device=origins.device)
    tm = t_max[:, None] if torch.is_tensor(t_max) and t_max.dim() == 1 else t_max
    o, d = origins[:, None, :], directions[:, None, :]
    for s in range(0, mesh.num_faces, _FACE_CHUNK):
        sl = slice(s, s + _FACE_CHUNK)
        _, t = mt_face(o, d, mesh.v0[sl], mesh.e1[sl], mesh.e2[sl], t_min=t_min, t_max=tm,
                       cull_backface=cull_backface)
        t_c, f_c = torch.min(t, dim=1)  # first face at the minimum
        closer = t_c < best_t
        best_t = torch.where(closer, t_c, best_t)
        best_f = torch.where(closer, f_c + s, best_f)
    hit = best_f >= 0
    normal = torch.where(hit[:, None], mesh.n[best_f.clamp(min=0)],
                         torch.zeros_like(origins)) if mesh.num_faces else torch.zeros_like(origins)
    return hit, best_t, normal
