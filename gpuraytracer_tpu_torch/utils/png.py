"""PNG encoding of framebuffers, stdlib zlib only (port of the encoder in
gpuraytracer_tpu/utils/png.py)."""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def encode_png(rgba: np.ndarray, compress_level: int = 6) -> bytes:
    """Encode (H, W, 3|4) uint8 to PNG bytes."""
    rgba = np.ascontiguousarray(rgba)
    if rgba.dtype != np.uint8 or rgba.ndim != 3 or rgba.shape[2] not in (3, 4):
        raise ValueError(f"expected (H, W, 3|4) uint8, got {rgba.shape} {rgba.dtype}")
    h, w, c = rgba.shape
    raw = np.zeros((h, 1 + w * c), dtype=np.uint8)  # filter byte 0 per row
    raw[:, 1:] = rgba.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6 if c == 4 else 2, 0, 0, 0)
    return b"".join([b"\x89PNG\r\n\x1a\n", _chunk(b"IHDR", ihdr),
                     _chunk(b"IDAT", zlib.compress(raw.tobytes(), compress_level)),
                     _chunk(b"IEND", b"")])


def write_png(path: str, rgba: np.ndarray) -> None:
    """Write (H, W, 3|4) uint8 as a PNG file: runtime/hostrt.write_png, the
    native writer where it is available, else ``encode_png``."""
    from gpuraytracer_tpu_torch.runtime import hostrt

    hostrt.write_png(path, rgba)


def image_f32_to_rgba8(image) -> np.ndarray:
    """Radiance -> R8G8B8A8_UNORM (saturate + round), alpha forced opaque
    for viewing (the reference's alpha carries shading, not coverage)."""
    out = np.rint(np.clip(np.asarray(image), 0.0, 1.0) * 255.0).astype(np.uint8)
    if out.shape[-1] == 4:
        out[..., 3] = 255
    return out


def image_to_rgba8(image: torch.Tensor) -> torch.Tensor:
    """``image_f32_to_rgba8`` on the image's own device, so that a frame
    leaves the card as 1 byte a channel: the same f32 clamp, multiply by
    255 and round half to even, alpha 255, hence the same bytes."""
    from gpuraytracer_tpu_torch.render.trace import to_rgba8

    out = to_rgba8(image)
    if out.shape[-1] == 4:
        out[..., 3] = 255
    return out
