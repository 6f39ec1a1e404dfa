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
are uploaded once per device (``constant``) and shared, read-only. A
frame's scene arrays go to another device (a band of a sharded frame,
parallel/sharding.py) through ``arrays_to``, without a host sync either.
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


def tensor_to(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``: itself where it is there already; from the host
    to a CUDA device staged in pinned memory and copied with
    ``non_blocking=True``; between CUDA devices a non-blocking copy, which
    PyTorch orders after the source's stream. Only a copy to the CPU waits
    for the source's stream (the caller asked for the host)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if t.device == device:
        return t
    if device.type != "cuda":
        return t.to(device)
    if t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device, non_blocking=True)


def arrays_to(arrays, device):
    """A frozen dataclass of tensors (SceneArrays) with every tensor on
    ``device`` by ``tensor_to``: no host sync on the way to a CUDA device."""
    from gpuraytracer_tpu_torch.core.types import tensors_to  # types imports this module

    return tensors_to(arrays, device, move=tensor_to)
