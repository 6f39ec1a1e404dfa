"""Debug mode: the D3D12 debug-layer / break-on-error analog.

Port of gpuraytracer_tpu/utils/debug.py. The reference runs the D3D12/DXGI
debug layers with break-on-severity as its runtime sanitizer
(DeviceResources.cpp:67-100, 144-164); its JAX port traps NaNs with
jax_debug_nans and checkify. Here:
  - ``debug_layer``: a NaN trap for the enclosed scope: the plain path
    (render/trace.trace_radiance) checks ``torch.isfinite`` after each
    pass of each level (closest hit, shadow rays, shading) and raises
    FloatingPointError naming the pass. Each check reads the device, so it
    is for debugging only; a CUDA kernel is checked by its outputs.
  - ``checked``: wraps a function so that it runs under the trap and its
    outputs are checked the same way.
  - ``validate_frame``: the renderer's output invariants.
The trap is per thread and per task (a context variable).
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Callable

import torch

_NAN_TRAP = contextvars.ContextVar("gpuraytracer_tpu_torch_nan_trap", default=False)


@contextlib.contextmanager
def debug_layer(nan_checks: bool = True):
    """Enable (or, with False, disable) the NaN trap for the enclosed scope."""
    token = _NAN_TRAP.set(nan_checks)
    try:
        yield
    finally:
        _NAN_TRAP.reset(token)


def nan_checks_enabled() -> bool:
    return _NAN_TRAP.get()


def trap(where: str, *tensors) -> None:
    """Under the NaN trap, raise FloatingPointError if a tensor holds a
    non-finite value, naming ``where`` (the pass); otherwise nothing."""
    if not _NAN_TRAP.get():
        return
    for t in tensors:
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"non-finite value after the {where}")


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for x in out:
            yield from _tensors(x)


def checked(fn: Callable) -> Callable:
    """``fn`` run under the NaN trap, its tensor outputs checked too: the
    wrapper raises FloatingPointError on the first non-finite value instead
    of passing garbage on."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with debug_layer(True):
            out = fn(*args, **kwargs)
            trap(f"output of {getattr(fn, '__name__', 'the function')}", *_tensors(out))
        return out

    return wrapper


def validate_frame(image) -> None:
    """Assert the renderer's output invariants (the live-object report
    analog): shape (H, W, 4), finite values, non-negative radiance."""
    arr = torch.as_tensor(image)
    if arr.dim() != 3 or arr.shape[-1] != 4:
        raise AssertionError(f"framebuffer must be (H, W, 4), got {tuple(arr.shape)}")
    if not bool(torch.isfinite(arr).all()):
        raise AssertionError("framebuffer contains non-finite values")
    if bool((arr < 0).any()):
        raise AssertionError("framebuffer contains negative radiance")
