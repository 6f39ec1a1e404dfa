"""Frame programs: the port's counterpart of ``jax.jit`` of a frame.

The reference renders every frame on the chip inside one compiled
program: ``trace.make_renderer`` (render/trace.py:260-267), the
Renderer's jitted step (render/renderer.py:64-69) and bench_suite's chain
of n animated frames (apps/bench_suite.py:90-112). A ``FrameProgram``
records such a frame function into a CUDA graph (``torch.cuda.CUDAGraph``)
at its first call and replays the graph at every later one.

- First call, as a jit's first call compiles: one eager run (``warmup``)
  loads every kernel library and uploads every constant table, then the
  frame function is captured on a side stream that waits for the current
  one (no host sync), its tensors allocated from the graph's private
  memory pool, and the graph instantiated.
- Inputs live in static buffers that the callers fill before a replay,
  stream-ordered and without a host sync: an animation time by ``fill_``
  (a kernel argument), a window's times uploaded once before capture, a
  caller's arrays copied device to device (``copy_arrays``).
- Outputs: each call returns a clone of the graph's outputs, made on the
  stream after the replay, so a returned image is never overwritten by a
  later call (the reference's jit returns a new array each time). One
  graph per program: a clone is 33 MB at 1080p, a few hundredths of a
  millisecond, where a graph per frame in flight would hold a private
  pool each.
- Counters: the wrappers' Python launch counters, HOST_SYNCS and the
  route counters run only while the frame function runs on the host. The
  program records each one's change during its capture, takes it back,
  and adds it again at every replay, so a replayed frame counts as the
  eager frame does.
- Keys (``key``): what the reference's jit keys on (layout, size, depth;
  bound in each caller's program), and the route, the frame mode and every
  GPURT_* knob as the environment holds them now, so a changed knob builds
  a new program instead of replaying a stale one.

Spans and counters (utils/profile.py): a call is ``render.replay`` (the
graph's replay) and ``render.clone`` (the outputs' clone); a capture,
its eager warm-up run, the capture and the instantiation, is
``render.capture``. ``CAPTURES`` counts the graphs captured and
``CAPTURE_SECONDS`` their seconds less those of the kernel libraries
loaded inside them (kernels/build.py ``LOAD_SECONDS`` counts those), so
that no second is counted twice; both are set-up counters, always on.

On a CUDA device a capture or replay that fails raises, naming the
program; nothing renders the frame eagerly instead. Under the NaN trap
(utils/debug.debug_layer), which reads the host once per level, building
a CUDA program raises. On the CPU, which has no graphs, every call runs
the frame function eagerly: the same code, through the wrappers' plain
versions.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import os
import threading
import time

import torch

from gpuraytracer_tpu_torch.accel.instances import Scene
from gpuraytracer_tpu_torch.kernels import build as kernel_build
from gpuraytracer_tpu_torch.utils import debug, profile

# Set-up counters (see the module docstring).
CAPTURES = 0
CAPTURE_SECONDS = 0.0
_COUNT_LOCK = threading.Lock()


def knobs() -> tuple:
    """Every GPURT_* environment variable and its value, sorted."""
    return tuple(sorted((k, v) for k, v in os.environ.items() if k.startswith("GPURT_")))


def key(scene: Scene, *parts) -> tuple:
    """A program's cache key: ``parts`` (what the caller binds: size,
    depth, ...), the scene's route and frame mode (render/trace.frame_route)
    and ``knobs()``."""
    from gpuraytracer_tpu_torch.render import trace

    return parts + (trace.frame_route(scene), knobs())


def _counter_modules():
    from gpuraytracer_tpu_torch.kernels import (
        frame_kernel, frame_state, megakernel, op_probe, scene_kernel, wavefront)

    return (frame_kernel, frame_state, megakernel, op_probe, scene_kernel, wavefront)


def counters() -> dict:
    """{(module, name): value} of every launch counter (``*LAUNCHES``),
    HOST_SYNCS and QUEUED_LANES of the kernel wrappers."""
    out = {}
    for mod in _counter_modules():
        for name, value in vars(mod).items():
            if (name.endswith("LAUNCHES") or name in ("HOST_SYNCS", "QUEUED_LANES")) \
                    and isinstance(value, int):
                out[(mod, name)] = value
    return out


def _add(deltas: dict) -> None:
    for (mod, name), d in deltas.items():
        setattr(mod, name, getattr(mod, name) + d)


def run_counted(fn):
    """(fn(), {counter: change}) with every counter taken back to its value
    before the call: what a capture runs, and what each replay adds."""
    before = counters()
    try:
        out = fn()
    finally:
        after = counters()
        deltas = {k: after[k] - v for k, v in before.items() if after[k] != v}
        _add({k: -d for k, d in deltas.items()})
    return out, deltas


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    return type(out)(_clone(x) for x in out)


def tensor_leaves(obj) -> list:
    """The tensors of a frozen dataclass of tensors (SceneArrays), nested
    dataclasses and tuples of them included, in field order."""
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif dataclasses.is_dataclass(v):
            out += tensor_leaves(v)
        elif isinstance(v, tuple):
            for x in v:
                out += tensor_leaves(x)
    return out


def static_copy(arrays):
    """A copy of ``arrays`` in buffers of its own (a program's static
    inputs: constant tables the arrays share are never written)."""
    from gpuraytracer_tpu_torch.core.types import tensors_to

    return tensors_to(arrays, None, move=lambda t, _: t.clone())


def copy_arrays(dst, src) -> None:
    """Copy every tensor of ``src`` into ``dst``'s (same structure and
    shapes), stream-ordered, device to device."""
    for d, s in zip(tensor_leaves(dst), tensor_leaves(src), strict=True):
        d.copy_(s)


def _graph_nodes(graph) -> int | None:
    """Nodes of a captured graph (cuGraphGetNodes on its cudaGraph_t), or
    None where this PyTorch keeps no cudaGraph_t."""
    try:
        raw = graph.raw_cuda_graph()
    except (AttributeError, RuntimeError):
        return None
    cuda = ctypes.CDLL("libcuda.so.1")
    count = ctypes.c_size_t(0)
    rc = cuda.cuGraphGetNodes(ctypes.c_void_p(raw), None, ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {rc}")
    return count.value


class FrameProgram:
    """A frame function ``fn()`` (reading only static buffers, returning a
    tensor or a tuple of tensors) as a captured CUDA graph on ``device``;
    see the module docstring. ``warmup``: the eager run before capture
    (default ``fn``; a window runs its first frame). ``label`` names the
    program, its route and its mode in errors.

    After the capture: ``graph``, ``nodes`` (the graph's nodes, or None),
    ``pool_peak_bytes`` (the most bytes the capture held at once from the
    private pool, over what was allocated before; the device's peak
    statistics are reset for it) and ``deltas`` (each counter's change per
    replay)."""

    def __init__(self, fn, device, *, label: str, warmup=None):
        self.fn, self.warmup, self.label = fn, warmup or fn, label
        self.device = torch.device(device)
        self.graph = self.output = None
        self.nodes = self.pool_peak_bytes = None
        self.deltas = {}

    def build(self) -> "FrameProgram":
        """Capture the graph now, if not yet (on a GPU; the CPU has none)."""
        if self.device.type == "cuda" and self.graph is None:
            self._capture()
        return self

    def __call__(self):
        if self.device.type != "cuda":
            return self.fn()
        self.build()
        with profile.span("render.replay"):
            try:
                self.graph.replay()
            except RuntimeError as e:
                raise RuntimeError(f"{self.label}: graph replay failed: {e}") from e
        _add(self.deltas)
        with profile.span("render.clone"):
            return _clone(self.output)

    def _capture(self) -> None:
        global CAPTURES, CAPTURE_SECONDS
        t0, loads0 = time.perf_counter(), kernel_build.LOAD_SECONDS
        with profile.span("render.capture"):
            self._capture_graph()
        with _COUNT_LOCK:
            CAPTURES += 1
            CAPTURE_SECONDS += time.perf_counter() - t0 - (kernel_build.LOAD_SECONDS - loads0)

    def _capture_graph(self) -> None:
        if debug.nan_checks_enabled():
            raise RuntimeError(f"{self.label}: the NaN trap (utils/debug.debug_layer) reads "
                               f"the host in every level; a frame program cannot capture it")
        dev = self.device
        self.warmup()
        allocated = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            graph = torch.cuda.CUDAGraph(keep_graph=True)
        except TypeError:  # a PyTorch without keep_graph: no node count
            graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.device(dev), torch.cuda.stream(side):
            # thread_local: other threads may use the card meanwhile (the
            # preview server's, the recovery executor's).
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out, deltas = run_counted(self.fn)
            except BaseException as e:
                with contextlib.suppress(RuntimeError):  # the capture is invalid already
                    graph.capture_end()
                if isinstance(e, Exception):
                    raise RuntimeError(f"{self.label}: capture failed: {e}") from e
                raise
            try:
                graph.capture_end()
            except RuntimeError as e:
                raise RuntimeError(f"{self.label}: capture failed: {e}") from e
        torch.cuda.current_stream(dev).wait_stream(side)
        self.deltas = deltas
        self.pool_peak_bytes = torch.cuda.max_memory_allocated(dev) - allocated
        if hasattr(graph, "instantiate"):
            graph.instantiate()
        self.nodes = _graph_nodes(graph)
        self.graph, self.output = graph, out

    def close(self) -> None:
        """Drop the graph and its outputs (its private pool goes back to
        the allocator)."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.output = None


def animated_frames(scene: Scene, animate, times: torch.Tensor, *, width: int, height: int,
                    max_depth: int, checksum: bool = False, keep=(), label: str = "frames"):
    """A FrameProgram of the ``len(times)`` animated frames of ``scene`` at
    ``times`` (an (n,) f32 buffer on the scene's device, read when the
    program runs, so a caller may refill it between calls).

    Each frame: the per-frame state at its time, then render/trace.
    render_frame over the pack that frame_kernel.pack_static built once.
    With an animator that has a table (builtin.animate_arrays,
    SceneBuilder.animator()) the state is row 10, kernels/frame_state.
    advance; another animator runs as its own torch ops, and frame_kernel.
    repack packs its arrays; ``animate`` False renders the scene as it is.

    Output: the image of the one frame; with ``checksum`` (the bench's
    window, apps/bench_suite.py) the f32 sum of every frame's image instead,
    accumulated in order on the device, and with ``keep`` (frame indices)
    also the (n,) per-frame sums and the kept frames' images:
    (acc, sums, *images). The eager run before capture renders the first
    frame only."""
    from gpuraytracer_tpu_torch.kernels import frame_kernel, frame_state
    from gpuraytracer_tpu_torch.render import trace

    layout, arrays = scene.layout, scene.arrays
    dev = arrays.aabb_min.device
    n = times.shape[0]
    if not checksum and (n != 1 or keep):
        raise ValueError("a program without a checksum renders one frame")
    table = getattr(animate, "table", None)
    pack = (frame_kernel.pack_frame(scene) if animate is False
            else frame_kernel.pack_static(scene))

    def frame(i):
        if animate is False:
            a = arrays
        elif table is not None:
            a = frame_state.advance(pack, animate, arrays, times, i)
        else:
            a = animate(arrays, times[i])
            frame_kernel.repack(pack, Scene(layout, a))
        return trace.render_frame(Scene(layout, a), width, height, max_depth=max_depth, pack=pack)

    def run(count):
        if not checksum:
            return frame(0)
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        sums, images = [], []
        for i in range(count):
            img = frame(i)
            s = torch.sum(img)
            acc = acc + s
            sums.append(s)
            if i in keep:
                images.append(img)
        return (acc, torch.stack(sums), *images) if keep else acc

    route, mode = trace.frame_route(scene)
    return FrameProgram(lambda: run(n), dev, label=f"{label} (route {route}, mode {mode})",
                        warmup=lambda: run(1))
