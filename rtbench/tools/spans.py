"""A traced run of a cell with the port's own spans in its breakdown:

    python3 -m rtbench.tools.spans --workload <cell> --seed <n> \
        --seconds <s> [--out <file.json>]

The benchmark's traced run (``rtbench.run --trace 1``) names the device's
idle gaps by the harness's own spans alone. This tool makes the same run
(``core.execute``, traced) with the port's recorder
(``gpuraytracer_tpu_torch.utils.profile.recording``) open around the
window, as ``tracing.recording`` would once it takes the port's spans in
(PERF.md §7): the port's host spans are appended to the harness's as
(name, start_s, end_s), so that each idle stretch falls on the innermost
program span or on ``gc``, and the port's device marks are kept beside
them on the trace (``Trace.marks``: (frame, enqueue_s, start_s, end_s)),
where the readers of ``PROGRAM_METRICS`` find them.

It prints the run's result line, with ``PROGRAM_METRICS`` and
``setup_s`` among the per-layer metrics, and writes to ``--out`` (a JSON
object) what the window held: each span name's count and its ms and self
ms a frame (over the frames attempted), every idle stretch's seconds by
span, the collector's passes, the span names seen, and the change of the
port's set-up counters across the window. Where the port has no recorder
(before it had one), the run is the harness's alone: the program's
metrics are absent and ``--out`` holds nothing of the program.
"""

import time

T_START = time.perf_counter()  # set-up runs from here, as in rtbench/run.py

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

os.environ.setdefault("OMP_NUM_THREADS", "4")

from rtbench import core, stats, tracing  # noqa: E402

# Per-layer metrics that read the program's spans and marks, in the cells of
# the viewer's traffic; the benchmark's own run cannot report them until it
# takes the program's spans in (PERF.md §7).
PROGRAM_METRICS = (
    {"name": "scene_host_ms_per_frame.viewer", "unit": "ms"},
    {"name": "render_host_ms_per_frame.viewer", "unit": "ms"},
    {"name": "present_host_ms_per_frame.viewer", "unit": "ms"},
    {"name": "queue_wait_ms_p95.viewer", "unit": "ms"},
)
# The set-up counters whose change across the window is reported.
COUNTERS = (("kernels.build", "LOADS"), ("kernels.build", "COMPILES"),
            ("render.program", "CAPTURES"))


def counters() -> dict:
    """{name: value} of the port's set-up counters that it has."""
    out = {}
    for module, name in COUNTERS:
        mod = importlib.import_module(f"gpuraytracer_tpu_torch.{module}")
        if hasattr(mod, name):
            out[name] = getattr(mod, name)
    return out


@dataclasses.dataclass
class Taken:
    """What the window gave: the port's Recording (None without a
    recorder), the set-up counters before and after it, its Trace."""

    recording: object = None
    before: dict = dataclasses.field(default_factory=dict)
    after: dict = dataclasses.field(default_factory=dict)
    trace: object = None

    def marks(self) -> list | None:
        if self.recording is None:
            return None
        return [(m.frame, m.enqueue_ns * 1e-9, m.start_ns * 1e-9, m.end_ns * 1e-9)
                for m in self.recording.marks]

    def summary(self, frames: int) -> dict:
        """The program's part of the window (see the module docstring)."""
        rec = self.recording
        if rec is None:
            return {}
        spans = {name: {"count": n, "ms_per_frame": 1e3 * s / frames,
                        "self_ms_per_frame": 1e3 * own / frames}
                 for name, (n, s, own) in rec.by_name().items()}
        waits = [start - enqueue for _, enqueue, start, _ in self.marks()]
        records = rec.spans
        name = {r.seq: r.name for r in records}
        return {
            "frames": frames, "spans": spans,
            "idle_gaps": self.trace.idle_gaps(top=1000) if self.trace else None,
            "gc": [{"generation": s.attrs["generation"], "collected": s.attrs["collected"],
                    "ms": 1e3 * s.seconds, "in": name.get(s.parent)}
                   for s in records if s.name == "gc"],
            "names": sorted(rec.by_name()),
            "counters_in_window": {k: self.after[k] - v for k, v in self.before.items()},
            "marks": len(waits), "anchor_error_us": None if rec.anchor_error_ns is None
            else rec.anchor_error_ns * 1e-3,
            "queue_wait_ms": None if not waits else {
                q: 1e3 * stats.percentile(waits, p) for q, p in
                (("p50", 0.5), ("p95", 0.95), ("max", 1.0))},
        }


@contextlib.contextmanager
def taking_program_spans(taken: Taken):
    """For the scope: ``tracing.recording`` also runs the port's
    ``profile.recording`` and appends its host spans to the harness's, and
    ``tracing.Trace.from_profiler`` keeps its device marks on the Trace
    (``marks``); where the port has no recorder, the harness's alone."""
    harness_recording = tracing.recording
    harness_from_profiler = tracing.Trace.__dict__["from_profiler"]

    @contextlib.contextmanager
    def recording():
        from gpuraytracer_tpu_torch.utils import profile

        program_recording = getattr(profile, "recording", None)
        with harness_recording() as spans:
            if program_recording is None:
                yield spans
                return
            taken.before = counters()
            with program_recording() as rec:
                yield spans
            taken.after = counters()
            taken.recording = rec
            spans.extend((s.name, s.start_ns * 1e-9, s.end_ns * 1e-9) for s in rec.spans)

    def from_profiler(cls, prof, spans):
        trace = harness_from_profiler.__func__(cls, prof, spans)
        trace.marks = taken.marks()
        taken.trace = trace
        return trace

    tracing.recording = recording
    tracing.Trace.from_profiler = classmethod(from_profiler)
    try:
        yield taken
    finally:
        tracing.recording = harness_recording
        tracing.Trace.from_profiler = harness_from_profiler


def execute(cell: core.Cell, seed: int, seconds: float, *, device, t_start: float,
            size: tuple | None = None) -> tuple:
    """A traced run of ``cell`` (core.execute) with the program's spans
    taken in; returns (its result, the program's summary)."""
    extra = list(PROGRAM_METRICS) if cell.traffic["generator"] == "viewer" else []
    cell = dataclasses.replace(cell, per_layer=cell.per_layer + extra + [
        {"name": "setup_s", "unit": "s", "source": "host_clock"}])
    taken = Taken()
    with taking_program_spans(taken):
        out = core.execute(cell, seed, seconds, True, device=device, t_start=t_start, size=size)
    return out, taken.summary(max(1, out["attempted"]))


def main(argv=None, *, t_start: float) -> int:
    p = argparse.ArgumentParser(prog="python3 -m rtbench.tools.spans",
                                description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True, help="a cell's name, <config>.<traffic>")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="the measured window")
    p.add_argument("--out", default="", help="write the program's summary here (JSON)")
    args = p.parse_args(argv)
    cell = core.Cell.find(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"spans: {args.workload} needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 2
    core._cache_dirs()
    out, program = execute(cell, args.seed, args.seconds, device="cuda:0", t_start=t_start)
    bad = core.forbidden_modules()
    if bad:
        print(f"spans: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(program, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
