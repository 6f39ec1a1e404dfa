"""Shading: Phong + fake AO, Fresnel-Schlick, distance fog.

Port of gpuraytracer_tpu/render/shade.py (src/Raytracing.hlsl:35-80,
213-215; RaytracingShaderHelper.hlsli:178-182). Colors are float4.
"""

from __future__ import annotations

import torch

from rtbench.reference import hlsl
from rtbench.reference.types import BACKGROUND_COLOR, IN_SHADOW_RADIANCE
from rtbench.reference.upload import constant


def phong_lighting(albedo, normal, in_shadow, hit_position, ray_direction,
                   light_position, light_ambient_color, light_diffuse_color,
                   diffuse_coef, specular_coef, specular_power):
    """CalculatePhongLighting (Raytracing.hlsl:50-80) over (N, ...) lanes."""
    shadow_factor = torch.where(in_shadow, IN_SHADOW_RADIANCE, 1.0)
    incident = hlsl.normalize(hit_position - light_position)

    kd = hlsl.saturate(hlsl.dot(-incident, normal))
    diffuse = (shadow_factor * diffuse_coef * kd)[:, None] * light_diffuse_color * albedo

    reflected_light = hlsl.normalize(hlsl.reflect(incident, normal))
    ks = torch.pow(
        hlsl.saturate(hlsl.dot(reflected_light, hlsl.normalize(-ray_direction))),
        specular_power,
    )
    specular = torch.where(in_shadow, 0.0, specular_coef * ks)[:, None].expand(-1, 4)

    # Fake AO: lerp(ambient - 0.1, ambient, 1 - saturate(dot(N, -Y))).
    down = constant((0.0, -1.0, 0.0), normal.device, normal.dtype)
    a = 1.0 - hlsl.saturate(hlsl.dot(normal, down))
    ambient = albedo * hlsl.lerp(light_ambient_color - 0.1, light_ambient_color, a[:, None])
    return ambient + diffuse + specular


def fresnel_reflectance_schlick(incident, normal, f0):
    """f0 + (1 - f0) * (1 - saturate(dot(-I, N)))^5."""
    cosi = hlsl.saturate(hlsl.dot(-incident, normal, keepdim=True))
    return f0 + (1.0 - f0) * torch.pow(1.0 - cosi, 5.0)


def fog_factor(t):
    """Visibility falloff toward the background: 1 - exp(-0.000002 t^3)."""
    return 1.0 - torch.exp(-0.000002 * t * t * t)


def background_color(device):
    """The background colour on ``device``, uploaded once per device
    (core/upload.constant): read it, never write it."""
    return constant(tuple(map(float, BACKGROUND_COLOR)), device)
