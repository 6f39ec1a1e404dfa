"""The benchmark's metric arithmetic, kept here so that the yardstick does
not move with the program.

Copies: ``mrays_per_second`` is the port's ``utils/stats.
mrays_per_second_from_fps`` (W H fps / 1e6, the reference renderer's
"Million Primary Rays/s"), taken over all the frames of a window and all
its time; ``union_seconds`` is the interval union of ``utils/profile.
device_summary``, here clipped to a window that the harness marks itself;
``by_name`` is the device-time split of ``apps/bench_suite.trace_split``.
"""

from __future__ import annotations

import collections
import math


def mrays_per_second(width: int, height: int, frames: int, seconds: float) -> float:
    """W H frames / seconds / 1e6: every frame completed over the whole
    window."""
    return width * height * frames / seconds / 1e6


def percentile(values, q: float) -> float:
    """The nearest-rank ``q`` quantile (0 < q <= 1) of every value: the
    smallest value that at least q of them do not exceed."""
    s = sorted(values)
    if not s:
        raise ValueError("no values")
    return s[max(0, math.ceil(q * len(s)) - 1)]


def clip(intervals, lo: float, hi: float):
    """The parts of (start, end) intervals that lie inside [lo, hi]."""
    for s, e in intervals:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            yield s, e


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, None
    for s, t in sorted(intervals):
        if end is None or s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    return busy


def gaps(intervals, lo: float, hi: float):
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, cursor = [], lo
    for s, t in sorted(clip(intervals, lo, hi)):
        if s > cursor:
            out.append((cursor, s))
        cursor = max(cursor, t)
    if hi > cursor:
        out.append((cursor, hi))
    return out


def by_name(events, top: int = 10):
    """[(name, seconds)] of the ``top`` names by summed duration, from
    (name, start, end) events."""
    total = collections.defaultdict(float)
    for name, s, e in events:
        total[name] += e - s
    return sorted(total.items(), key=lambda x: -x[1])[:top]


def attribute_gaps(gap_list, spans, top: int = 10):
    """[(host span name, seconds)] of the idle ``gap_list``, each stretch
    given to the innermost host span (latest start) that covers it, or to
    "(no span)"; the ``top`` names by summed seconds."""
    total = collections.defaultdict(float)
    gap_list = sorted(gap_list)
    bounds = sorted({x for g in gap_list for x in g} | {x for _, s, e in spans for x in (s, e)})
    ordered = sorted(spans, key=lambda sp: sp[1])
    active, nxt, g = [], 0, 0
    for a, b in zip(bounds, bounds[1:]):
        while nxt < len(ordered) and ordered[nxt][1] <= a:
            active.append(ordered[nxt])
            nxt += 1
        active = [sp for sp in active if sp[2] > a]
        while g < len(gap_list) and gap_list[g][1] <= a:
            g += 1
        if g < len(gap_list) and gap_list[g][0] <= a:
            total[active[-1][0] if active else "(no span)"] += b - a
    return sorted(total.items(), key=lambda x: -x[1])[:top]
