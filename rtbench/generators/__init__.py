"""The traffic generators: one module a ``generator`` that traffic mixes name,
each with a ``Generator(run)`` that has ``setup()``, ``window()``,
``release()``, ``check() -> {name: value}`` and, after the window,
``result`` (a ``WindowResult``)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class WindowResult:
    """frames: completed in the window; seconds: from the first submission
    to the last completion (the host clock); attempted: frames submitted;
    launches: the port's kernel launches in the window (its counters);
    latencies_s: each frame's latency, where the mix has one; wait_s: the
    host's seconds blocked on frame fences; scene_s: each frame's scene
    build on the host, where the mix builds one."""

    frames: int
    seconds: float
    attempted: int
    launches: int
    latencies_s: list | None = None
    wait_s: float | None = None
    scene_s: list | None = None


def launches(before: dict, after: dict) -> int:
    """Launches between two readings of render/program.counters()."""
    return sum(after[k] - v for k, v in before.items() if k[1].endswith("LAUNCHES"))
