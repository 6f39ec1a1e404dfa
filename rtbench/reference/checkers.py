"""Analytically box-filtered checkerboard with ray differentials.

Port of gpuraytracer_tpu/render/checkers.py (CheckersTextureBoxFilter,
SignedDistancePrimitives.hlsli:324-334; CalculateRayDifferentials and
AnalyticalCheckersTexture, RaytracingShaderHelper.hlsli:148-175). The
differentials come from the camera rays of the neighbouring pixels even
for reflection rays, as in the reference.
"""

from __future__ import annotations

import torch

from rtbench.reference import camera as cam
from rtbench.reference import hlsl

CHECKERS_RATIO = 50  # center-fill to border ratio (hlsli call site :174)


def checkers_box_filter(uv, dpdx, dpdy, ratio=CHECKERS_RATIO):
    w = torch.maximum(torch.abs(dpdx), torch.abs(dpdy))
    a = uv + 0.5 * w
    b = uv - 0.5 * w
    i = (
        torch.floor(a) + torch.clamp(hlsl.frac(a) * ratio, max=1.0)
        - torch.floor(b) - torch.clamp(hlsl.frac(b) * ratio, max=1.0)
    ) / (ratio * w)
    return (1.0 - i[:, 0]) * (1.0 - i[:, 1])


def analytical_checkers(hit_position, surface_normal, pixel_x, pixel_y, width, height,
                        camera_position, projection_to_world):
    """uv = hit.xz, with differentials from the neighbour pixels' camera
    rays intersected with the hit's tangent plane."""
    uv = torch.stack([hit_position[:, 0], hit_position[:, 2]], dim=-1)
    ox, dx_dir = cam.generate_camera_rays(pixel_x + 1, pixel_y, width, height,
                                          camera_position, projection_to_world)
    oy, dy_dir = cam.generate_camera_rays(pixel_x, pixel_y + 1, width, height,
                                          camera_position, projection_to_world)

    def plane_project(o, d):
        num = hlsl.dot(o - hit_position, surface_normal, keepdim=True)
        den = hlsl.dot(d, surface_normal, keepdim=True)
        return o - d * (num / den)

    px_pos = plane_project(ox, dx_dir)
    py_pos = plane_project(oy, dy_dir)
    ddx_uv = torch.stack([px_pos[:, 0], px_pos[:, 2]], dim=-1) - uv
    ddy_uv = torch.stack([py_pos[:, 0], py_pos[:, 2]], dim=-1) - uv
    return checkers_box_filter(uv, ddx_uv, ddy_uv, CHECKERS_RATIO)
