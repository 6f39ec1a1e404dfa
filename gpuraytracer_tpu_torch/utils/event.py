"""Resize event and headless viewport (port of gpuraytracer_tpu/utils/event.py,
the AK::Event + Window analogs, src/AK/Event.h:17-122)."""

from __future__ import annotations

import threading
import weakref
from typing import Callable, List


class Event:
    """Listeners are called in attach order; bound methods are held weakly,
    so a collected owner drops out (AK::Event's expired-weak_ptr cleanup)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._listeners: List[object] = []

    def attach(self, fn: Callable) -> None:
        with self._lock:
            self._listeners.append(
                weakref.WeakMethod(fn) if hasattr(fn, "__self__") else fn)

    def __call__(self, *args, **kwargs) -> None:
        with self._lock:
            listeners = list(self._listeners)
        dead = []
        for entry in listeners:
            fn = entry() if isinstance(entry, weakref.WeakMethod) else entry
            if fn is None:
                dead.append(entry)
            else:
                fn(*args, **kwargs)
        if dead:
            with self._lock:
                self._listeners = [e for e in self._listeners if e not in dead]


class Viewport:
    """Headless viewport: image size and a resize event."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.on_size_changed = Event()

    @property
    def aspect_ratio(self) -> float:
        return self.width / self.height

    def resize(self, width: int, height: int) -> None:
        if (width, height) == (self.width, self.height):
            return  # the reference also ignores no-op resizes
        self.width = width
        self.height = height
        self.on_size_changed(width, height)
