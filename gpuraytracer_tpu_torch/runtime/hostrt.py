"""ctypes loader for the native host runtime (hostrt.cpp).

Port of gpuraytracer_tpu/runtime/hostrt.py. The shared library is built
with g++ at first use into build/gpuraytracer_tpu_torch/hostrt/ at the
repository root, named after a hash of the source and flags (a changed
source rebuilds, an unchanged one loads the existing build), and loaded
with ctypes. This is host code, not a device kernel, so every entry point
keeps the reference's pure-Python path for a machine without g++:
``time.monotonic`` for the clock, utils/png.encode_png for the encoder, and
synchronous writes for the async writer.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

from gpuraytracer_tpu_torch.utils.log import get_logger

log = get_logger("hostrt")

_SRC = Path(__file__).resolve().parent / "hostrt.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gpuraytracer_tpu_torch" / "hostrt"
_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libhostrt_{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        log.warning("g++ not found: the host runtime falls back to Python")
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([gxx, *_FLAGS, str(_SRC), "-o", tmp], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        os.unlink(tmp)
        log.warning("g++ failed (%d): the host runtime falls back to Python\n%s",
                    proc.returncode, proc.stderr[-2000:])
        return None
    os.replace(tmp, out)  # atomic: concurrent builders publish the same file
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        vp, ci, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.hostrt_now_ns.argtypes = []
        lib.hostrt_now_ns.restype = i64
        lib.hostrt_write_png.argtypes = [ctypes.c_char_p, vp, ci, ci, ci]
        lib.hostrt_write_png.restype = ci
        lib.hostrt_writer_create.argtypes = [ci]
        lib.hostrt_writer_create.restype = vp
        lib.hostrt_writer_submit.argtypes = [vp, ctypes.c_char_p, vp, ci, ci, ci]
        lib.hostrt_writer_submit.restype = None
        lib.hostrt_writer_drain.argtypes = [vp]
        lib.hostrt_writer_drain.restype = None
        for fn in ("hostrt_writer_written", "hostrt_writer_errors", "hostrt_writer_queued"):
            getattr(lib, fn).argtypes = [vp]
            getattr(lib, fn).restype = i64
        lib.hostrt_writer_destroy.argtypes = [vp]
        lib.hostrt_writer_destroy.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library built and loaded."""
    return _load() is not None


def now_seconds() -> float:
    """Monotonic clock in seconds (CLOCK_MONOTONIC; time.monotonic without
    the native library)."""
    lib = _load()
    if lib is None:
        return time.monotonic()
    return lib.hostrt_now_ns() / 1e9


def _check_rgba(rgba) -> np.ndarray:
    rgba = np.ascontiguousarray(rgba)
    if rgba.dtype != np.uint8 or rgba.ndim != 3 or rgba.shape[2] not in (3, 4):
        raise ValueError(f"expected (H, W, 3|4) uint8, got {rgba.shape} {rgba.dtype}")
    return rgba


def write_png(path: str, rgba) -> None:
    """Write (H, W, 3|4) uint8 as a PNG: the native stored-deflate encoder,
    or utils/png.encode_png (zlib) without the native library."""
    rgba = _check_rgba(rgba)
    lib = _load()
    if lib is None:
        from gpuraytracer_tpu_torch.utils.png import encode_png

        with open(path, "wb") as f:
            f.write(encode_png(rgba))
        return
    h, w, c = rgba.shape
    rc = lib.hostrt_write_png(os.fsencode(path), rgba.ctypes.data, w, h, c)
    if rc != 0:
        raise IOError(f"hostrt_write_png failed with rc={rc} for {path}")


class AsyncFrameWriter:
    """Background PNG writer with a bounded queue: at most ``max_depth``
    frames wait, and ``submit`` blocks until one leaves (the present queue
    analog). ``submit`` copies the pixels before it returns. Without the
    native library it writes each frame synchronously."""

    def __init__(self, max_depth: int = 3):
        self._lib = _load()
        self._handle = None
        self._written = self._errors = 0  # counts once the handle is gone
        if self._lib is not None:
            self._handle = self._lib.hostrt_writer_create(max_depth)

    @property
    def native(self) -> bool:
        return self._handle is not None

    def submit(self, path: str, rgba) -> None:
        rgba = _check_rgba(rgba)
        if self._handle is None:
            write_png(path, rgba)
            self._written += 1
            return
        h, w, c = rgba.shape
        self._lib.hostrt_writer_submit(self._handle, os.fsencode(path), rgba.ctypes.data, w, h, c)

    def drain(self) -> None:
        """Block until every submitted frame is written."""
        if self._handle is not None:
            self._lib.hostrt_writer_drain(self._handle)

    @property
    def frames_written(self) -> int:
        if self._handle is None:
            return self._written
        return int(self._lib.hostrt_writer_written(self._handle))

    @property
    def errors(self) -> int:
        """Frames the native writer failed to encode or write (a synchronous
        write raises instead)."""
        if self._handle is None:
            return self._errors
        return int(self._lib.hostrt_writer_errors(self._handle))

    @property
    def queued(self) -> int:
        """Frames waiting or being written now."""
        if self._handle is None:
            return 0
        return int(self._lib.hostrt_writer_queued(self._handle))

    def close(self) -> None:
        """Write what is queued, then stop the writer thread (the counts
        stay readable)."""
        if self._handle is not None:
            self.drain()
            self._written, self._errors = self.frames_written, self.errors
            self._lib.hostrt_writer_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
