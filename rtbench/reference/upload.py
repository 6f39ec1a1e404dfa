"""Host-to-device uploads: ``to_device`` stages host values in pinned memory
and copies them without waiting for the stream (as the port uploads its
per-frame state); ``constant`` uploads a table that never changes once per
(values, device, dtype) and shares it, read-only.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_NP = {torch.float32: np.float32, torch.float64: np.float64, torch.int32: np.int32,
       torch.int64: np.int64, torch.bool: np.bool_}


def to_device(values, device, dtype=torch.float32) -> torch.Tensor:
    """``values`` (array-like) as a new tensor of ``dtype`` on ``device``,
    without a host sync on a CUDA device (see the module docstring)."""
    host = torch.from_numpy(np.array(values, dtype=_NP[dtype]))
    device = torch.device(device)
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


@functools.lru_cache(maxsize=256)
def _constant(raw, shape, device, dtype):
    return to_device(np.frombuffer(raw, dtype=_NP[dtype]).reshape(shape), device, dtype)


def constant(values: tuple, device, dtype=torch.float32) -> torch.Tensor:
    """A constant table on ``device``, uploaded once per (values, device,
    dtype) and shared by every caller: read it, never write it. ``values``
    is a (nested) tuple; tables are told apart by their bits in ``dtype``,
    so -0.0 and 0.0 (equal as Python floats) get tables of their own."""
    host = np.array(values, dtype=_NP[dtype])
    return _constant(host.tobytes(), host.shape, torch.device(device), dtype)


