"""Host-to-device uploads that never wait for the stream.

``torch.tensor(x, device="cuda")`` and ``torch.as_tensor(x, device=...)``
copy from pageable host memory: a blocking copy that waits for every
kernel already queued on the stream, so the host stops queueing the next
frame. The per-frame state goes through ``to_device`` instead: on a CUDA
device the host values are staged in pinned memory from PyTorch's caching
host allocator and copied with ``non_blocking=True``. The allocator records
the copy's event on the staging block and hands the block out again only
after that event has completed, so each frame in flight keeps its own
staging block until its copy has run, and a later frame never overwrites
the values of an earlier one. The values that never change between frames
are uploaded once per device (``constant``) and shared, read-only.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_NP = {torch.float32: np.float32, torch.int32: np.int32, torch.int64: np.int64,
       torch.bool: np.bool_}


def to_device(values, device, dtype=torch.float32) -> torch.Tensor:
    """``values`` (array-like) as a new tensor of ``dtype`` on ``device``,
    without a host sync on a CUDA device (see the module docstring)."""
    host = torch.from_numpy(np.array(values, dtype=_NP[dtype]))
    device = torch.device(device)
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


@functools.lru_cache(maxsize=256)
def _constant(values, device, dtype):
    return to_device(values, device, dtype)


def constant(values: tuple, device, dtype=torch.float32) -> torch.Tensor:
    """A constant table on ``device``, uploaded once per (values, device,
    dtype) and shared by every caller: read it, never write it. ``values``
    is a (nested) tuple."""
    return _constant(values, torch.device(device), dtype)
