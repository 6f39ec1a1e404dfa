"""Radiance parity metrics: an image against a reference render.

The port's copy of tools/parity.py's comparison (silhouette_mask,
sensitivity_mask, compare), in numpy, with the same keys and the same
rounding, so that the port's parity artifacts read as the reference's:

  pct_within_1e3      share of pixels with max-RGBA |diff| <= 1e-3, in %
  mean_abs, p99_abs   of that per-pixel |diff|
  interior_pct_1e3    the same share over the pixels off the silhouette
                      (3x3 neighbourhood range of the reference < 0.05)
  interior_max_abs
  edge_fraction       the silhouette's share of the image, in %
  sens_fraction       the chaos mask's share, in % (with a mask): pixels
                      whose reference moves by more than 1e-3 under a 1e-6
                      camera move
  stable_pct_1e3      the share within 1e-3 off the chaos mask
  stable_p999_abs, stable_max_abs

pack_mask / unpack_mask store an (H, W) bool mask as np.packbits bytes.
"""

from __future__ import annotations

import numpy as np


def silhouette_mask(ref, thresh=0.05):
    """True where the 3x3 neighbourhood of the reference varies strongly:
    geometry and shading edges, where threshold crossings flip."""
    lum = ref[..., :3].max(axis=-1)
    lo = lum.copy()
    hi = lum.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            shifted = np.roll(np.roll(lum, dy, axis=0), dx, axis=1)
            lo = np.minimum(lo, shifted)
            hi = np.maximum(hi, shifted)
    return (hi - lo) > thresh


def sensitivity_mask(ref, ref_eps, thresh=1e-3):
    """True where the reference itself moves by more than ``thresh`` under
    an ulp-scale camera move (``ref_eps``: the moved render)."""
    return np.abs(ref_eps - ref).max(axis=-1) > thresh


def compare(img, ref, sens=None):
    """The parity metrics of ``img`` against ``ref`` (both (H, W, 4)), with
    the stable-pixel keys where ``sens`` (an (H, W) bool chaos mask) is
    given."""
    diff = np.abs(img - ref).max(axis=-1)
    edge = silhouette_mask(ref)
    interior = ~edge
    out = {
        "pct_within_1e3": round(float((diff <= 1e-3).mean()) * 100, 3),
        "mean_abs": float(f"{diff.mean():.3e}"),
        "p99_abs": float(f"{np.quantile(diff, 0.99):.3e}"),
        "interior_pct_1e3": round(float((diff[interior] <= 1e-3).mean()) * 100, 3),
        "interior_max_abs": float(f"{diff[interior].max():.3e}"),
        "edge_fraction": round(float(edge.mean()) * 100, 2),
    }
    if sens is not None:
        stable = ~sens
        out["sens_fraction"] = round(float(sens.mean()) * 100, 2)
        out["stable_pct_1e3"] = round(float((diff[stable] <= 1e-3).mean()) * 100, 3)
        out["stable_p999_abs"] = float(f"{np.quantile(diff[stable], 0.999):.3e}")
        out["stable_max_abs"] = float(f"{diff[stable].max():.3e}")
    return out


def pack_mask(mask):
    """An (H, W) bool mask as np.packbits bytes (row-major, 8 pixels a byte)."""
    return np.packbits(np.asarray(mask, dtype=bool).reshape(-1))


def unpack_mask(packed, height, width):
    """The (H, W) bool mask that ``pack_mask`` packed."""
    return np.unpackbits(np.asarray(packed, dtype=np.uint8),
                         count=height * width).astype(bool).reshape(height, width)
