"""Failure detection and recovery: the device-removed handling analog.

Port of gpuraytracer_tpu/parallel/recovery.py. The reference detects
DXGI_ERROR_DEVICE_REMOVED on Present, tears down its device objects and
recreates them through IDeviceNotify callbacks (DeviceResources.cpp:465-509,
575-585; Renderer.cpp:184-195). Here: a CUDA error raised by a step, or a
step that outlives the watchdog, counts as a device loss; the executor
calls the on_device_lost hook, rebuilds the step (``make_step``: a fresh
Renderer, its scene and its buffers), calls on_device_restored and retries,
a bounded number of times. Programming errors (ValueError, TypeError, and
every exception that is not a CUDA error) stay fatal.

A CUDA error surfaces in one of two ways: the port's wrappers raise
``RuntimeError("<kernel> launch failed: CUDA error N (...)")`` when a launch
is refused (kernels/frame_kernel.py, scene_kernel.py, megakernel.py), and
PyTorch raises ``torch.AcceleratorError`` (a RuntimeError, "CUDA error:
...") when a later CUDA call meets a fault of earlier work. The completion
check after each step waits on an event recorded after the step's work, so
a fault during the step is raised here and not at some later call.

Limit: a sticky CUDA error (an illegal address, a device-side assert)
poisons the process's CUDA context: every later CUDA call in the process
fails, so a retry fails the same way and the executor gives up with
DeviceLostError after ``max_retries``. Recovering from one needs a new
process. What recovers in the same process: a refused launch, an
out-of-memory error, and a step that hangs past the watchdog.
"""

from __future__ import annotations

import concurrent.futures
import time
from typing import Callable, Optional

import torch

from gpuraytracer_tpu_torch.utils.log import get_logger

log = get_logger("recovery")


def is_device_error(e: BaseException) -> bool:
    """A CUDA error (DEVICE_REMOVED), as opposed to a programming error
    (E_INVALIDARG)."""
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(e, accel):
        return True
    return isinstance(e, RuntimeError) and not isinstance(e, NotImplementedError) \
        and "CUDA" in str(e)


class DeviceLostError(RuntimeError):
    pass


class DeviceTimeoutError(RuntimeError):
    """A step exceeded the watchdog deadline: a wedged device or CUDA call.
    Escalated like a device loss: the executor rebuilds and retries."""


class RecoveringExecutor:
    """Runs a step function with device-loss detection and re-create/retry.

    make_step: builds a fresh step (called at init and after every device
    loss: the create_device_dependent_resources analog). device: where the
    step's work runs; on a CUDA device each call waits on an event recorded
    after the step (the Present-time check analog), so an asynchronous
    fault surfaces in the call that caused it. watchdog_seconds: run each
    step on a worker thread with that deadline; a step past it is abandoned
    (a wedged CUDA call cannot be cancelled) and counts as a device loss.
    """

    def __init__(self, make_step: Callable[[], Callable], max_retries: int = 2,
                 retry_delay_seconds: float = 5.0,
                 on_device_lost: Optional[Callable[[], None]] = None,
                 on_device_restored: Optional[Callable[[], None]] = None,
                 watchdog_seconds: Optional[float] = None, device=None):
        self._make_step = make_step
        self._max_retries = max_retries
        self._retry_delay = retry_delay_seconds
        self._on_lost = on_device_lost
        self._on_restored = on_device_restored
        self._watchdog = watchdog_seconds
        self._device = torch.device(device) if device is not None else None
        self._pool = None
        if watchdog_seconds is not None:
            self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._step = make_step()
        self.recoveries = 0

    def _run_once(self, args, kwargs):
        if self._device is None or self._device.type != "cuda":
            return self._step(*args, **kwargs)
        # The worker thread's current device is its own: set it.
        with torch.cuda.device(self._device):
            out = self._step(*args, **kwargs)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self._device))
            done.synchronize()
        return out

    def _call(self, args, kwargs):
        if self._pool is None:
            return self._run_once(args, kwargs)
        fut = self._pool.submit(self._run_once, args, kwargs)
        try:
            return fut.result(timeout=self._watchdog)
        except concurrent.futures.TimeoutError:
            # Abandon the wedged worker (it may never return) so that the
            # retry does not queue behind it.
            self._pool.shutdown(wait=False)
            self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
            raise DeviceTimeoutError(f"step exceeded {self._watchdog}s watchdog") from None

    def __call__(self, *args, **kwargs):
        attempt = 0
        while True:
            try:
                return self._call(args, kwargs)
            except Exception as e:
                if not (isinstance(e, DeviceTimeoutError) or is_device_error(e)):
                    raise
                attempt += 1
                if attempt > self._max_retries:
                    raise DeviceLostError(
                        f"device error persisted after {self._max_retries} retries") from e
                log.warning("device error (%s: %s); recovery attempt %d/%d",
                            type(e).__name__, e, attempt, self._max_retries)
                if self._on_lost:
                    self._on_lost()
                time.sleep(self._retry_delay)
                self._step = self._make_step()
                if self._on_restored:
                    self._on_restored()
                self.recoveries += 1

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
