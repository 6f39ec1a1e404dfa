"""The five benchmark scenes (BASELINE.json configs #1-#5).

Port of gpuraytracer_tpu/models/scenes.py, with the same names, sizes,
depths and instance specs:

1. single_sphere_plane_256: one analytic sphere cluster + plane, 256x256,
   primary + shadow rays (depth 2)
2. analytic_grid_720p: 8 chrome sphere clusters + 8 boxes, 1280x720, one
   reflection bounce (depth 2)
3. sdf_primitives_720p: the seven sphere-traced objects, 1280x720, depth 3
4. metaballs_1080p: three animated metaball instances, 1920x1080, depth 3
5. fractal_mandelbulb_julia_1080p: Mandelbulb + quaternion Julia (the
   extension fractals, DE budget 96) and a chrome sphere cluster,
   1920x1080, depth 3
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

from gpuraytracer_tpu_torch.core.types import (
    CHROMIUM_REFLECTANCE,
    AnalyticPrimitive,
    IntersectorKind,
    SignedDistancePrimitive,
    VolumetricPrimitive,
)
from gpuraytracer_tpu_torch.geometry.fractal import ExtendedSignedDistancePrimitive
from gpuraytracer_tpu_torch.models.builder import (
    InstanceSpec,
    Material,
    SceneBuilder,
    grid_cell_aabb,
)

GREEN = (0.1, 1.0, 0.5, 1.0)
RED = (1.0, 0.5, 0.5, 1.0)
YELLOW = (1.0, 1.0, 0.5, 1.0)
CHROME = Material(CHROMIUM_REFLECTANCE, reflectance=1.0)


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    name: str
    builder: Callable[[], SceneBuilder]  # a fresh SceneBuilder
    width: int
    height: int
    max_depth: int
    animated: bool = False

    def build(self, aspect: float, elapsed_time: float = 0.0, *, device="cuda"):
        return self.builder().build(aspect, elapsed_time, device=device)


def _single_sphere_builder() -> SceneBuilder:
    b = SceneBuilder()
    mn, mx = grid_cell_aabb(1, 1, size=(3.0, 3.0, 3.0))
    b.add_instance(InstanceSpec(
        kind=IntersectorKind.ANALYTIC, prim_type=int(AnalyticPrimitive.SPHERES),
        aabb_min=mn, aabb_max=mx, material=Material(RED), scale=(1.5, 1.5, 1.5)))
    return b


def _analytic_grid_builder() -> SceneBuilder:
    b = SceneBuilder()
    for ix in range(4):
        for iz in range(4):
            if (ix + iz) % 2 == 0:
                mn, mx = grid_cell_aabb(ix, iz, (3, 3, 3))
                b.add_instance(InstanceSpec(
                    kind=IntersectorKind.ANALYTIC, prim_type=int(AnalyticPrimitive.SPHERES),
                    aabb_min=mn, aabb_max=mx, material=CHROME, scale=(1.5, 1.5, 1.5),
                    rotates=True))
            else:
                mn, mx = grid_cell_aabb(ix, iz, (2, 3, 2))
                b.add_instance(InstanceSpec(
                    kind=IntersectorKind.ANALYTIC, prim_type=int(AnalyticPrimitive.AABB),
                    aabb_min=mn, aabb_max=mx, material=Material(RED if iz % 2 else YELLOW),
                    scale=(1.0, 1.5, 1.0)))
    return b


_SDF_OBJECTS = (
    (SignedDistancePrimitive.MINI_SPHERES, Material(GREEN), (1, 1, 1), False),
    (SignedDistancePrimitive.INTERSECTED_ROUND_CUBE, Material(GREEN), (1, 1, 1), False),
    (SignedDistancePrimitive.SQUARE_TORUS, CHROME, (1.5, 1.5, 1.5), False),
    (SignedDistancePrimitive.TWISTED_TORUS, Material(YELLOW, 0, 1.0, 0.7, 50, 0.5), (1, 1, 1),
     True),
    (SignedDistancePrimitive.COG, Material(YELLOW, 0, 1.0, 0.1, 2), (1, 1, 1), True),
    (SignedDistancePrimitive.CYLINDER, Material(RED), (1, 1.5, 1), False),
    (SignedDistancePrimitive.FRACTAL_PYRAMID, Material(GREEN, 0, 1, 0.1, 4, 0.8), (3, 3, 3),
     False),
)


def _sdf_showcase_builder(b: SceneBuilder | None = None) -> SceneBuilder:
    b = SceneBuilder() if b is None else b
    cells = [(0, 0), (1, 0), (2, 0), (0, 2), (1, 2), (2, 2), (3, 1)]
    for (prim, mat, scale, rotates), (ix, iz) in zip(_SDF_OBJECTS, cells):
        size = ((6.0, 6.0, 6.0) if prim == SignedDistancePrimitive.FRACTAL_PYRAMID
                else (2.0 * scale[0], 2.0 * scale[1], 2.0 * scale[2]))
        mn, mx = grid_cell_aabb(ix, iz, size)
        b.add_instance(InstanceSpec(
            kind=IntersectorKind.SIGNED_DISTANCE, prim_type=int(prim), aabb_min=mn,
            aabb_max=mx, material=mat, scale=scale, rotates=rotates))
    return b


def _metaballs_builder() -> SceneBuilder:
    b = SceneBuilder()
    for ix, iz in ((0, 1), (2, 1), (1, 3)):
        mn, mx = grid_cell_aabb(ix, iz, (3, 3, 3))
        b.add_instance(InstanceSpec(
            kind=IntersectorKind.VOLUMETRIC, prim_type=int(VolumetricPrimitive.METABALLS),
            aabb_min=mn, aabb_max=mx, material=CHROME, scale=(1.5, 1.5, 1.5), rotates=True))
    return b


def _fractal_builder() -> SceneBuilder:
    b = SceneBuilder()
    for code, cell, albedo in (
        (ExtendedSignedDistancePrimitive.MANDELBULB, (1, 1), GREEN),
        (ExtendedSignedDistancePrimitive.JULIA_QUATERNION, (3, 2), YELLOW),
    ):
        mn, mx = grid_cell_aabb(*cell, (4, 4, 4))
        b.add_instance(InstanceSpec(
            kind=IntersectorKind.SIGNED_DISTANCE, prim_type=int(code), aabb_min=mn,
            aabb_max=mx, material=Material(albedo, 0.0, 1.0, 0.4, 10.0, 0.6),
            scale=(2.0, 2.0, 2.0), rotates=True,
            step_budget=96))  # the DE fractals' own budget (reference, round 5)
    mn, mx = grid_cell_aabb(0, 3, (3, 3, 3))
    b.add_instance(InstanceSpec(
        kind=IntersectorKind.ANALYTIC, prim_type=int(AnalyticPrimitive.SPHERES),
        aabb_min=mn, aabb_max=mx, material=CHROME, scale=(1.5, 1.5, 1.5)))
    return b


BENCH_CONFIGS: Tuple[BenchConfig, ...] = (
    BenchConfig("single_sphere_plane_256", _single_sphere_builder, 256, 256, 2),
    BenchConfig("analytic_grid_720p", _analytic_grid_builder, 1280, 720, 2),
    BenchConfig("sdf_primitives_720p", _sdf_showcase_builder, 1280, 720, 3),
    BenchConfig("metaballs_1080p", _metaballs_builder, 1920, 1080, 3, animated=True),
    BenchConfig("fractal_mandelbulb_julia_1080p", _fractal_builder, 1920, 1080, 3),
)


def instance_grid(nx: int, nz: int, n_materials: int) -> SceneBuilder:
    """A check scene, not a bench config: nx * nz closed-form instances
    (spheres and hollow boxes, alternating) over the builtin grid's
    footprint, cycling through n_materials albedos. Many instances test
    the kernels' scene tables past what a block's shared memory holds
    (40 x 40), many materials the frame kernel's material cap."""
    b = SceneBuilder()
    for k in range(nx * nz):
        ix, iz = divmod(k, nz)
        mn = (-7.0 + 14.0 * ix / nx, -1.0, -7.0 + 14.0 * iz / nz)
        mx = (mn[0] + 7.0 / nx, mn[1] + 14.0 / nx, mn[2] + 7.0 / nz)
        kind = AnalyticPrimitive.SPHERES if (ix + iz) % 2 else AnalyticPrimitive.AABB
        albedo = (0.2 + 0.8 * (k % n_materials) / n_materials, 0.5, 0.5, 1.0)
        b.add_instance(InstanceSpec(
            kind=IntersectorKind.ANALYTIC, prim_type=int(kind), aabb_min=mn, aabb_max=mx,
            material=Material(albedo)))
    return b


def padded_sdf_showcase(n_pad: int) -> SceneBuilder:
    """A check scene, not a bench config: n_pad small closed-form spheres
    along the back of the grid (geometries 0 to n_pad - 1) before the
    sdf_primitives scene's seven marches, which so take the geometry ids
    from n_pad on. Past 29 they test the deferred mode's queue keys, whose
    capped-geometry mask keeps geometries 0-29 only."""
    b = SceneBuilder()
    for k in range(n_pad):
        x = -7.0 + 14.0 * k / n_pad
        b.add_instance(InstanceSpec(
            kind=IntersectorKind.ANALYTIC, prim_type=int(AnalyticPrimitive.SPHERES),
            aabb_min=(x, -1.0, 6.0), aabb_max=(x + 0.4, -0.6, 6.4), material=Material(RED),
            scale=(0.2, 0.2, 0.2)))
    return _sdf_showcase_builder(b)


def get_config(name: str) -> BenchConfig:
    for c in BENCH_CONFIGS:
        if c.name == name:
            return c
    raise KeyError(name)
