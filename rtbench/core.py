"""The harness: one run of one cell of ``BENCHMARK.json``.

A cell ``<config>.<traffic>`` is found by name: the configuration in
``configs/<config>.json`` (the scene as data, its size, depth and route,
and ``port_scene``, the module of ``scenes/`` that builds it in the port),
the traffic mix in ``traffic/<traffic>.json`` (parameters, and ``generator``,
the module of ``generators/`` that generates it), the limits of its output
check in ``limits/<cell>.json``, and each metric's reader in
``metrics/<metric>.py``. A later cell, mix, configuration or metric adds
files and entries; no file here names one.

A run: set-up (imports, the port's kernel libraries loaded from
``build/``, the scene, the cell's program captured and warmed, pinned
buffers), then the measured window of ``--seconds`` (under
``torch.profiler`` with ``--trace 1``), the device's peak memory read, the
program's state freed, then the output check against the plain
reference (``reference/``), and one JSON line. The end-to-end metrics are
read with ``--trace 0``, the per-layer ones with ``--trace 1``.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
# Top-level module names that may not be loaded when the result is printed:
# JAX and the JAX package the port was made from (compared whole, so that
# the port, whose name begins with the JAX package's, passes).
FORBIDDEN = ("jax", "jaxlib", "flax", "gpuraytracer_tpu")


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (default sys.modules)."""
    names = sys.modules if names is None else names
    tops = {n.split(".", 1)[0] for n in names}
    return sorted(t for t in tops if t in FORBIDDEN)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the harness, by file (a metric's name
    may hold dots). A metric split by the end-to-end metric its cells
    report (``<quantity>.<part>``) is read by ``<quantity>.py`` where it
    has no reader of its own."""
    path = ROOT / kind / f"{name}.py"
    if not path.is_file() and kind == "metrics" and "." in name:
        path = ROOT / kind / f"{name.rsplit('.', 1)[0]}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path}")
    spec = importlib.util.spec_from_file_location(
        f"rtbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    limits: dict
    end_to_end: list
    per_layer: list

    @classmethod
    def find(cls, name: str, spec: dict | None = None) -> "Cell":
        spec = spec if spec is not None else load_json(CHECKOUT / "BENCHMARK.json")
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
        w = cells[name]

        def applies(m):
            return "workloads" not in m or name in m["workloads"]

        return cls(name=name, config=load_json(ROOT / "configs" / f"{w['config']}.json"),
                   traffic=load_json(ROOT / "traffic" / f"{w['traffic']}.json"),
                   chips=int(w["chips"]),
                   limits=load_json(ROOT / "limits" / f"{name}.json"),
                   end_to_end=[m for m in spec["end_to_end"] if applies(m)],
                   per_layer=[m for m in spec["per_layer"] if applies(m)])


@dataclasses.dataclass
class Run:
    """What a metric's reader reads: the cell, the run's arguments, the
    set-up time, the generator's window (``generator.result``: frames, seconds
    and what the mix measures besides), the trace (``--trace 1``) and the
    configuration's frozen work count (``work/<config>.json``)."""

    cell: Cell
    seed: int
    seconds: float
    traced: bool
    device: object
    width: int
    height: int
    setup_s: float = 0.0
    generator: object = None
    trace: object = None
    work: dict | None = None


def _cache_dirs() -> None:
    """Every build and kernel cache of the program inside the checkout, at
    fixed paths (the port's nvcc builds already live in build/)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton_cache")


def new_run(cell: Cell, seed: int, seconds: float, traced: bool, *, device,
            size: tuple | None = None) -> Run:
    """A run of ``cell`` with its work count and its traffic's generator,
    not yet set up; ``size`` (W, H) replaces the configuration's (tests on
    the CPU only)."""
    import torch

    cfg = dict(cell.config)
    if size is not None:
        cfg["width"], cfg["height"] = size
    cell = dataclasses.replace(cell, config=cfg)
    run = Run(cell=cell, seed=seed, seconds=seconds, traced=traced,
              device=torch.device(device), width=cfg["width"], height=cfg["height"])
    work_path = ROOT / "work" / f"{cfg['name']}.json"
    run.work = load_json(work_path) if work_path.is_file() else None
    run.generator = load_module("generators", cell.traffic["generator"]).Generator(run)
    return run


def execute(cell: Cell, seed: int, seconds: float, traced: bool, *, device, t_start: float,
            size: tuple | None = None, stand_in=None) -> dict:
    """One run (see the module docstring) on ``device``, of the size
    ``size`` where given (``new_run``). ``stand_in(run)``,
    where given, makes what the check compares in the program's place (the
    control, control.stand_in); the benchmark's own runs give none.
    Returns the result's fields, with ``checks`` last."""
    import torch

    from rtbench import tracing

    run = new_run(cell, seed, seconds, traced, device=device, size=size)
    cuda = run.device.type == "cuda"
    gen = run.generator
    gen.setup()
    if cuda:
        torch.cuda.synchronize(run.device)
    # The objects of set-up (PyTorch's, the port's, the scene's) move out
    # of the collector's reach, so that a collection in the window scans
    # only what the window made and stalls no frame by some 50 ms.
    gc.collect()
    gc.freeze()
    prof = tracing.profiler(run.device) if traced else None
    if prof is not None:
        prof.start()
    run.setup_s = time.perf_counter() - t_start
    with tracing.recording() as spans:
        gen.window()
    gc.unfreeze()
    if prof is not None:
        prof.stop()
        run.trace = tracing.Trace.from_profiler(prof, spans)
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0

    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    gen.release()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    found = gen.check(stand_in=None if stand_in is None else stand_in(run))
    print(f"rtbench: {cell.name} seed {seed}: {gen.result.frames} frames in "
          f"{gen.result.seconds:.3f} s; set-up {run.setup_s:.3f} s; the check "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    checks = {}
    for name, value in found.items():
        if name not in cell.limits["checks"]:
            raise KeyError(f"limits/{cell.name}.json has no limit for {name!r}")
        checks[name] = {"value": value, "limit": cell.limits["checks"][name]["limit"]}
    failed = sum(1 for c in checks.values() if not c["value"] <= c["limit"])
    device_info = {"platform": "gpu" if cuda else run.device.type,
                   "kind": torch.cuda.get_device_name(run.device) if cuda else run.device.type,
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": failed == 0, "attempted": gen.result.attempted,
           "failed": failed, "metrics": metrics, "device": device_info}
    if run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.device_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["checks"] = checks
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m rtbench.run",
                                description="One run of one cell of BENCHMARK.json.")
    p.add_argument("--workload", required=True, help="a cell's name, <config>.<traffic>")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: trace the window and report the per-layer metrics")
    return p.parse_args(argv)


def main(argv=None, *, t_start: float) -> int:
    args = parse_args(argv)
    cell = Cell.find(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"rtbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    _cache_dirs()
    out = execute(cell, args.seed, args.seconds, bool(args.trace), device="cuda:0",
                  t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"rtbench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
