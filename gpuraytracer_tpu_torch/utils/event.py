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
        """Hold a bound method weakly; a builtin's bound method (``list.
        append``), which a WeakMethod refuses, and any other callable
        strongly, as the reference does."""
        entry = fn
        if hasattr(fn, "__self__"):
            try:
                entry = weakref.WeakMethod(fn)
            except TypeError:
                pass
        with self._lock:
            self._listeners.append(entry)

    def detach(self, fn: Callable) -> None:
        """Remove every attachment of ``fn`` (held strongly or weakly)."""
        with self._lock:
            self._listeners = [
                e for e in self._listeners
                if not (isinstance(e, weakref.WeakMethod) and e() == fn) and e != fn]

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

    @property
    def listener_count(self) -> int:
        with self._lock:
            return len(self._listeners)


class Viewport:
    """Headless viewport: image size, a title and a resize event."""

    def __init__(self, width: int, height: int, title: str = "gpuraytracer_tpu"):
        self.width = width
        self.height = height
        self.title = title
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

    def set_title(self, text: str) -> None:
        """The set_custom_window_text analog: keeps the frame-stats line."""
        self.title = text
