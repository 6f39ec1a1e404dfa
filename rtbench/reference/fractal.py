"""Extended distance-estimated fractals: Mandelbulb and quaternion Julia.

Port of gpuraytracer_tpu/geometry/fractal.py. The reference ships one
fractal (the pyramid); these two extension codes (7, 8) plug into the same
sphere tracer as AABB-windowed primitives: their marches start at the
local unit box's entry, stop at its exit, march over-relaxed and skip the
back-face cull (accel/traverse.py).

Both functions keep the reference's association and its frozen-lane
updates: an escaped lane keeps its last state while the loop runs on.
Square roots go through ``hlsl.sqrt`` (correctly rounded on every device).
"""

from __future__ import annotations

import enum

import torch

from rtbench.reference import hlsl
from rtbench.reference import sdf


class ExtendedSignedDistancePrimitive(enum.IntEnum):
    """Type codes after the reference's SignedDistancePrimitive (0..6)."""

    MANDELBULB = 7
    JULIA_QUATERNION = 8


MANDELBULB_ITERATIONS = 8
MANDELBULB_POWER = 8.0
MANDELBULB_BAILOUT = 2.0
MANDELBULB_SCALE = 1.2

JULIA_ITERATIONS = 11
JULIA_C = (-0.2, 0.6, 0.2, 0.2)  # (w, x, y, z)
JULIA_SCALE = 1.1


def distance_mandelbulb(p):
    """Power-8 triplex Mandelbulb distance estimate in its trig-free
    polynomial form, scaled by 1.2 into the unit AABB:
    DE = 0.25 * log(m) * sqrt(m) / dz with dz <- 8 * m^3.5 * dz + 1."""
    pos = p * MANDELBULB_SCALE
    px, py, pz = pos.unbind(-1)
    wx, wy, wz = px, py, pz
    dz = torch.ones_like(px)
    m = px * px + py * py + pz * pz
    escaped = torch.zeros(px.shape, dtype=torch.bool, device=p.device)
    for _ in range(MANDELBULB_ITERATIONS):
        frozen = escaped | (m > MANDELBULB_BAILOUT * MANDELBULB_BAILOUT)
        m2 = m * m
        m4 = m2 * m2
        dz_new = 8.0 * hlsl.sqrt(m4 * m2 * m) * dz + 1.0
        x, y, z = wx, wy, wz
        x2 = x * x
        x4 = x2 * x2
        y2 = y * y
        y4 = y2 * y2
        z2 = z * z
        z4 = z2 * z2
        k3 = x2 + z2
        k3_7 = k3 * k3 * k3 * k3 * k3 * k3 * k3
        k2 = 1.0 / hlsl.sqrt(torch.clamp(k3_7, min=1e-30))
        k1 = x4 + y4 + z4 - 6.0 * y2 * z2 - 6.0 * x2 * y2 + 2.0 * z2 * x2
        k4 = x2 - y2 + z2
        nx = px + 64.0 * x * y * z * (x2 - z2) * k4 * (x4 - 6.0 * x2 * z2 + z4) * k1 * k2
        ny = py + -16.0 * y2 * k3 * k4 * k4 + k1 * k1
        nz = pz + -8.0 * y * k4 * (
            x4 * x4 - 28.0 * x4 * x2 * z2 + 70.0 * x4 * z4 - 28.0 * x2 * z2 * z4 + z4 * z4
        ) * k1 * k2
        wx = torch.where(frozen, wx, nx)
        wy = torch.where(frozen, wy, ny)
        wz = torch.where(frozen, wz, nz)
        dz = torch.where(frozen, dz, dz_new)
        m = torch.where(frozen, m, wx * wx + wy * wy + wz * wz)
        escaped = frozen
    m = torch.clamp(m, min=1e-18)
    de = 0.25 * torch.log(m) * hlsl.sqrt(m) / dz
    return de / MANDELBULB_SCALE


def _quat_mul(a, b):
    """Hamilton product of (w, x, y, z) quaternion tuples."""
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return (
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    )


def _length4(q):
    # The reference's jnp.sum over the trailing axis, summed in order.
    return hlsl.sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3])


def distance_julia_quaternion(p):
    """Quaternion Julia set z <- z^2 + c on the w = 0 slice, scaled by 1.1:
    DE = 0.5 * |z| * log|z| / |dz| with dz <- 2 z dz; a lane that never
    escapes (|z|^2 > 16, tested before the update) is "just inside" at
    -1e-3."""
    pos = p * JULIA_SCALE
    zero = torch.zeros_like(pos[..., 0])
    z = (pos[..., 0], pos[..., 1], pos[..., 2], zero)
    dz = (torch.ones_like(zero), zero, zero, zero)
    escaped = torch.zeros(zero.shape, dtype=torch.bool, device=p.device)
    for _ in range(JULIA_ITERATIONS):
        m2 = z[0] * z[0] + z[1] * z[1] + z[2] * z[2] + z[3] * z[3]
        escaped = escaped | (m2 > 16.0)
        dz_new = tuple(2.0 * c for c in _quat_mul(z, dz))
        z_new = tuple(c + k for c, k in zip(_quat_mul(z, z), JULIA_C))
        z = tuple(torch.where(escaped, a, b) for a, b in zip(z, z_new))
        dz = tuple(torch.where(escaped, a, b) for a, b in zip(dz, dz_new))
    mz = torch.clamp(_length4(z), min=1e-9)
    mdz = torch.clamp(_length4(dz), min=1e-6)
    de = 0.5 * mz * torch.log(mz) / mdz
    return torch.where(escaped, de, -1e-3) / JULIA_SCALE


def register():
    """Install both fractals in the SDF dispatch table as AABB-windowed
    codes (they make no escape-envelope claim). Runs when the module is
    imported, which importing the geometry package does."""
    sdf.register_distance_function(int(ExtendedSignedDistancePrimitive.MANDELBULB),
                                   distance_mandelbulb, aabb_windowed=True)
    sdf.register_distance_function(int(ExtendedSignedDistancePrimitive.JULIA_QUATERNION),
                                   distance_julia_quaternion, aabb_windowed=True)


register()
