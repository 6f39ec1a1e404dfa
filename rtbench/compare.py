"""The comparisons that decide ``correct``: a frame the timed window
produced against the plain reference's frame at the same time, size and
view. Each gives the share of pixels (in %) that differ by more than a
tolerance; ``limits/<cell>.json`` holds the limit of each number."""

from __future__ import annotations

import torch

# A march crossing can flip a pixel between two correct answers; the share
# of such pixels is what the limit allows. A pixel counts as differing
# where any channel of its f32 radiance differs by more than F32_TOL, or
# any byte of its RGBA8 presentation by more than U8_TOL.
F32_TOL = 1e-3
U8_TOL = 1


def f32_gap_pct(image, ref) -> float:
    """% of pixels of an (H, W, 4) f32 frame with a channel more than
    F32_TOL from the reference's (a NaN counts as differing)."""
    diff = (image.to(ref.device, torch.float32) - ref).abs().amax(dim=-1)
    bad = ~(diff <= F32_TOL)
    return 100.0 * float(bad.float().mean())


def u8_gap_pct(image, ref) -> float:
    """% of pixels of an (H, W, 4) RGBA8 frame with a byte more than
    U8_TOL from the reference's."""
    diff = (image.to(ref.device, torch.int16) - ref.to(torch.int16)).abs().amax(dim=-1)
    return 100.0 * float((diff > U8_TOL).float().mean())
