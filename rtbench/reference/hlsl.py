"""HLSL-semantics math helpers over torch tensors.

Port of gpuraytracer_tpu/core/hlsl.py. The semantically loaded ops keep
their HLSL meaning: ``fmod`` truncates (sign follows the dividend, i.e.
``torch.fmod``, never ``%`` or ``torch.remainder``) and ``normalize`` is
the division form with an exact-zero guard. Dot products are written as
explicit multiply-adds in component order so that every device sums in
the same order as the reference.
"""

from __future__ import annotations

import torch


def fmod(x, y):
    """HLSL fmod: x - y * trunc(x / y); the sign follows the dividend."""
    return torch.fmod(x, y)


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def lerp(a, b, t):
    """HLSL lerp in exactly the form a + t*(b-a)."""
    return a + t * (b - a)


def frac(x):
    return x - torch.floor(x)


def smoothstep(edge0, edge1, x):
    t = saturate((x - edge0) / (edge1 - edge0))
    return t * t * (3.0 - 2.0 * t)


def clamp(x, lo, hi):
    return torch.clamp(x, lo, hi)


def sqrt(x):
    """Correctly rounded f32 square root on every device. PyTorch's CPU
    float sqrt may be 1 ulp off; a float64 square root rounded once to
    float32 is exact (53 >= 2*24 + 2 bits, so the double rounding is
    innocuous), as IEEE sqrtf on the GPU and in the reference is."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def dot(a, b, keepdim=False):
    """Dot over the trailing xyz axis, summed as (x + y) + z."""
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    out = ax * bx + ay * by + az * bz
    return out.unsqueeze(-1) if keepdim else out


def length(v, keepdim=False):
    return sqrt(dot(v, v, keepdim=keepdim))


def length_sq(v, keepdim=False):
    return dot(v, v, keepdim=keepdim)


def normalize(v):
    """v / max(|v|, 1e-20): the division form (never a reciprocal
    multiply), so a zero vector normalizes to zero, not NaN."""
    return v / torch.clamp(length(v, keepdim=True), min=1e-20)


def reflect(i, n):
    """HLSL reflect: i - 2 * dot(i, n) * n."""
    return i - 2.0 * dot(i, n, keepdim=True) * n


def cross(a, b):
    """Cross product over the trailing xyz axis (torch.linalg.cross's
    three products-differences, as jnp.cross computes them)."""
    return torch.linalg.cross(a, b, dim=-1)


def _stack(parts):
    """``parts`` (tensors and Python scalars) broadcast to one shape and
    stacked on a new trailing axis; a scalar takes the first tensor's
    dtype and device."""
    like = next((p for p in parts if isinstance(p, torch.Tensor)), None)
    kw = {} if like is None else dict(dtype=like.dtype, device=like.device)
    parts = [p if isinstance(p, torch.Tensor) else torch.as_tensor(p, **kw) for p in parts]
    return torch.stack(torch.broadcast_tensors(*parts), dim=-1)


def calculate_animation_interpolant(elapsed_time, cycle_duration):
    """Cycling 0 -> 1 -> 0 smoothstepped interpolant
    (RaytracingShaderHelper.hlsli:36-41)."""
    t = fmod(elapsed_time, cycle_duration) / cycle_duration
    t = torch.where(t <= 0.5, 2.0 * t, 1.0 - 2.0 * (t - 0.5))
    return smoothstep(0.0, 1.0, t)
