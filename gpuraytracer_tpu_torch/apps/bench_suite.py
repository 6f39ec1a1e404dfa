"""Benchmark suite over the five bench scenes (models/scenes.BENCH_CONFIGS).

Port of gpuraytracer_tpu/apps/bench_suite.py: its command line, its report
(every key of its JSON lines, under the same names and rounding) and its
windows, with the reference's two Mrays/s variants: fps-derived
(W*H*fps/1e6, Renderer.cpp:391) and dispatch-time-derived (W*H/(ms*1e3),
RendererRaytracingHelper.h:673-678).

A window of n frames is one frame program of n animated frames
(render/program.animated_frames, the counterpart of the reference's
``make_chain(n)``, one jitted program a window): on a GPU one captured
CUDA graph a window, replayed at each call, in which each frame's
animation is row 10 (kernels/frame_state.py) reading the frame's time from
the window's time buffer (frame_t(i) rounded to f32 once, uploaded before
capture), and each image feeds a ``torch.sum`` checksum that accumulates
on the device, so no frame is dead work. The host reads the checksum (and
fails on a non-finite one) after every window of the timed batch has been
issued. The programs for one frame, ``--chain`` and ``--wall-chain``
frames are built before any timing, as the reference compiles its wall and
chain programs untimed; each scene's programs are closed before the next
scene. Launches are counted per replayed frame (render/program.py adds
each replay's launches to the wrappers' counters).

- ``compile_s``: the first one-frame window by the host clock: the builds
  and the capture of the one-frame program (on a GPU it includes the
  first use's nvcc build and load of the kernels); then ``--warmup`` - 1
  more untimed windows.
- Wall throughput, ``frame_ms``: each of ``--reps`` repetitions issues
  ``--frames`` windows of ``--wall-chain`` frames (default 64, the
  reference's window, bench.py) while the earlier ones still run, then
  reads their checksums; ms/frame is the host clock from the first issue
  to the last read over the frames, median over the repetitions (with
  ``frame_ms_min``, ``frame_ms_max``). ``frame_ms_events`` is the same
  repetitions by CUDA events recorded before the first issue and after
  the last (the card's timeline, on which a gap while the card waits for
  the host's next launch still counts), median; null on the CPU.
- ``frame_ms_1dispatch``: windows of one frame each, by the host clock,
  the least of ``--reps`` repetitions (the fixed cost of a window, its
  read of the checksum, not amortized).
- ``device_frame_ms`` (unless ``--no-device-time`` or ``--chain`` 1): the
  slope between one-frame windows and windows of ``--chain`` frames on the
  same clock, (t_chain - t_1) / (chain - 1), at least 1e-3 ms, so that
  the fixed cost cancels; ``mrays_dispatch`` is computed from it, or null
  with ``device_frame_ms_below_resolution`` below 0.05 ms, where the slope
  is inside the jitter of the two windows.

Each frame animates the scene (SceneBuilder.animator) and renders it
through render/trace.render_frame: the CUDA frame kernel for fused-eligible
scenes, else the wavefront with the CUDA scene kernel
(GPURT_DISABLE_FUSED=1 forces the latter). GPURT_FRAME_MODE=compact|defer
renders the fused-eligible scenes in that mode. The JSON also records the
device, the mode, which kernels ran and how many launches each frame made,
and the modes' host syncs and queued (dirty or unknown) lanes per frame,
all counted over the first wall repetition.

``--ab-roots A,B,B,A`` instead times two checkouts' kernels in turns, on
one card inside one call: for each root (a checkout of this repository,
for example the parent commit unpacked with ``git archive`` into a
directory that .gitignore lists), a fresh process imports that checkout's
package, builds its kernels and times with CUDA events (one warm-up
launch, then ``--reps`` launches) on the builtin 1920x1080 frame at
t = 0.2664: the frame kernel, the same under GPURT_MERGED_SHADOW=1, the
scene kernel's level-0 closest pass over that frame's camera rays, the
defer entry (GPURT_FRAME_MODE=defer's main pass at shadow cap 32), the
fractal_mandelbulb_julia_1080p frame kernel; the compacted modes' kernels
alone, each checkout's own form (``compact_main_ms``, ``dense_ms`` at its
queue, ``defer_main_queue_ms``, ``queue_ms``; with device queues also the
binning, ``bin_compact_ms`` and ``bin_defer_ms``, the dense pass and the
repair at the queues in append order, ``compose_ms``, ``gated_ms`` and the
level histogram of the compact queue; the dense pass and the repair under
GPURT_MERGED_SHADOW=1 at the same queues, ``dense_merged_ms`` and
``queue_merged_ms``; and the four again at the binned queues with the
pixels of a key in raster order, the same in every process, where the
device's order within a key varies between processes, ``*_canonical_ms``;
where the checkout's repair resumes from the defer entry's march records,
the whole traversal of its -DGPRT_REPAIR_FULL build at the same queues,
``queue_full_ms`` and ``queue_full_canonical_ms``; and each mode's chain of
kernels alone, ``compact_chain_ms`` (compact entry, bin, dense pass, gated
frame) and ``defer_chain_ms`` (defer entry, bin, repair, compose, gated);
``gated_overflow_ms``, the gated frame with a count past the capacity)
beside the calls both forms have (``compact_capped_ms``,
``dense_camera_ms``, ``queue_compacted_ms``, ``compose_torch_ms``: the host
recomposition of torch ops); and 64-frame animated windows through
Renderer.render (ms/frame) in each GPURT_FRAME_MODE, with the modes' host
syncs and queued lanes per frame (on a device queue read once after the
window); the two-phase finish step on the builtin 1080p level-0 closest and
shadow passes, each checkout's ``scene_finish`` on fresh copies of its main
pass's outputs (``finish_closest_ms``, ``finish_shadow_ms``), and where the
checkout compacts the dirty rays first, the compaction alone
(``finish_queue_closest_ms``, ``finish_queue_shadow_ms``); and the
per-geometry route of mesh_heightfield_sdf (544 faces):
each checkout's pass function on the 1080p level-0 closest and shadow
passes, whole (``mesh_route_*_pass_ms``: the parent's launches per
geometry and its torch ops between them, or one pass-entry launch), and a
64-frame 1080p window with the route's launches; and the CLI's per-frame
path over a 64-frame builtin 1080p window (tick the animation state by
1/60 s, build its scene, render; ``cli_window_ms_per_frame`` by the host
clock, ``cli_window_host_syncs_per_frame`` counted in a second window under
torch.cuda.set_sync_debug_mode("warn") from frame 2 on; where the checkout
has parallel/pipeline.py, the same through FramePipeline at 1 and 3 frames
in flight, ``cli_window_fif1_*`` and ``cli_window_fif3_*``, with
``*_bit_equal`` against the loop without it). Where the checkout has the SIMT
counting build (build.load(count_simt=True)), it reports the SIMT
efficiency of the builtin and fractal 1080p frame kernels per level and
ray kind and of the level-0 closest and shadow passes, and with device
queues of the merged builtin frame and of the dense pass and the repair
with and without the knob. Each process also saves its outputs, made with
the ``--fmad`` build (default: the shipped one): the builtin 1080p frame
(plain, compact and defer), the five bench scenes and mesh_octahedra at
320x180, the 1080p level-0 closest and shadow passes of the builtin scene
(single and two-phase) and of mesh_heightfield_sdf (shadow rays from the plain closest pass, so
that every root gets the same rays), the CLI window's 64 frames (the sum of
each frame's bits), and the merged entries' outputs
beside their sequential twins: the builtin 1080p frame in each mode, the
dense pass and the repair at the binned queues, and builtin,
sdf_primitives_720p, the fractal scene and padded_sdf_showcase(28) at
320x180 plain, compact at cap 8 and defer at cap 8 (``merged_bit_equal``:
whether each merged output is its twin bit for bit). One JSON line per
root, then one per root after the first with the share of bit-equal pixels
and rays against the first root, the rays (and geometry ids) that differ,
and the largest difference.

``--ab-roots ... --wavefront`` times, in each root's process instead, the
two wavefront routes at 1920x1080, depth 3: the scene-kernel route
(builtin under GPURT_DISABLE_FUSED=1) and the per-geometry route
(mesh_heightfield_sdf). Per route: a 64-frame animated window through
Renderer.render (``<route>_window_64_ms_per_frame``, CUDA events, every
frame consumed by a checksum) with the pass and lane kernels' launches per
frame; the host syncs per frame over 8 frames under
torch.cuda.set_sync_debug_mode("warn"); and a torch.profiler trace of 4
frames (utils/profile.trace) split per frame into the device's busy share,
the pass kernels', the lane kernels' and the other device operations' ms
and counts, and the host's ms outside its blocking runtime calls
(``<route>_trace_per_frame``). Also row 1, the builtin 1080p frame kernel
(``frame_kernel_ms``), and each route's frame at t = 0.2664 for the
comparison against the first root.

Usage (on a GPU; ``--device cpu`` runs the wavefront on the CPU, timed by
the host clock, for tiny smoke runs only):
  python -m gpuraytracer_tpu_torch.apps.bench_suite [--configs a,b] [--frames 4]
         [--warmup 1] [--reps 3] [--chain 3] [--wall-chain 64] [--scale 1.0]
         [--no-device-time] [--json out.json] [--device cuda]
  python -m gpuraytracer_tpu_torch.apps.bench_suite --ab-roots PARENT,.,.,PARENT
         [--reps 20] [--fmad false] [--wavefront]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

# Animated frames per timed window: the reference's 64 (bench.py,
# gpuraytracer_tpu/apps/bench_suite.py).
WALL_CHAIN = 64
# The keys the reference's bench_config always writes, and those of its
# device-time slope (written where device_time and chain > 1).
REFERENCE_KEYS = ("config", "width", "height", "max_depth", "frame_ms", "frame_ms_min",
                  "frame_ms_max", "reps", "frames_per_window", "wall_chain",
                  "frame_ms_1dispatch", "fps", "mrays_fps", "compile_s")
DEVICE_TIME_KEYS = ("device_frame_ms", "mrays_dispatch")
# A slope below this (ms) lies inside the jitter of the two windows it is
# taken from: the reference then writes device_frame_ms_below_resolution
# and no mrays_dispatch.
RESOLUTION_MS = 0.05


def _timed_window(window, n: int, frames: int, events: bool = False):
    """``frames`` windows of ``n`` frames issued back to back, then each
    window's checksum read (the reference's _timed_window): (host-clock ms,
    CUDA-event ms or None) per window. The events are recorded before the
    first issue and after the last, so their span lies inside the host's."""
    t0 = time.perf_counter()
    if events:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    checksums = [window(n) for _ in range(frames)]
    if events:
        end.record()
    for acc in checksums:
        if not torch.isfinite(acc).item():  # waits for the window
            raise AssertionError("non-finite frame checksum")
    host_ms = (time.perf_counter() - t0) * 1e3 / frames
    if not events:
        return host_ms, None
    end.synchronize()
    return host_ms, start.elapsed_time(end) / frames


def _launch_counts():
    """Launches of each kernel entry, and the compacted frame modes' host
    syncs and queued (dirty or unknown) lanes (read from the device: call
    it outside a timed window)."""
    from gpuraytracer_tpu_torch.kernels import frame_kernel, scene_kernel

    return {"frame_kernel": frame_kernel.LAUNCHES, "scene_kernel": scene_kernel.LAUNCHES,
            "frame_compact": frame_kernel.COMPACT_LAUNCHES,
            "frame_dense": frame_kernel.DENSE_LAUNCHES,
            "frame_defer": frame_kernel.DEFER_LAUNCHES, "shadow_queue": scene_kernel.QUEUE_LAUNCHES,
            "frame_compose": frame_kernel.COMPOSE_LAUNCHES,
            "frame_gated": frame_kernel.GATED_FALLBACK_LAUNCHES,
            "host_syncs": frame_kernel.HOST_SYNCS, "queued_lanes": frame_kernel.queued_lanes()}


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def bench_config(cfg, frames: int = 4, warmup: int = 1, scale: float = 1.0, reps: int = 3,
                 chain: int = 3, device_time: bool = True, wall_chain: int = WALL_CHAIN,
                 device="cuda") -> dict:
    """One JSON line of the bench for ``cfg`` (see the module docstring):
    the reference's parameters and defaults, and the torch ``device``."""
    from gpuraytracer_tpu_torch.kernels import frame_kernel
    from gpuraytracer_tpu_torch.utils import stats

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    width = max(8, int(cfg.width * scale))
    height = max(8, int(cfg.height * scale))
    builder = cfg.builder()
    scene0 = builder.build(width / height, 0.0, device=dev)
    animate = builder.animator()

    programs = {}

    def program(n):
        if n not in programs:
            programs[n] = window_program(scene0, animate, n, animated=cfg.animated,
                                         width=width, height=height, max_depth=cfg.max_depth)
        return programs[n]

    def window(n):
        """The window of n animated frames (its program, built at its first
        call): every image feeds the checksum, which stays on the device."""
        return program(n)()

    t0 = time.perf_counter()
    _timed_window(window, 1, 1)
    t_compile = time.perf_counter() - t0
    for _ in range(max(0, warmup - 1)):
        _timed_window(window, 1, 1)
    # The wall and chain programs, captured untimed.
    for n in (wall_chain, chain if device_time and chain > 1 else 1):
        program(n).build()

    # Launches are counted over the first repetition (reading the queued
    # lanes syncs, so between repetitions).
    before = _launch_counts()
    wall = [_timed_window(window, wall_chain, frames, events=cuda)]
    after = _launch_counts()
    wall += [_timed_window(window, wall_chain, frames, events=cuda) for _ in range(reps - 1)]
    n_frames = wall_chain * frames
    wall_ms = [host / wall_chain for host, _ in wall]
    frame_ms = statistics.median(wall_ms)
    fps = 1e3 / frame_ms
    ms_1dispatch = min(_timed_window(window, 1, frames)[0] for _ in range(reps))
    out = {
        "config": cfg.name,
        "width": width,
        "height": height,
        "max_depth": cfg.max_depth,
        "frame_ms": round(frame_ms, 3),
        "frame_ms_min": round(min(wall_ms), 3),
        "frame_ms_max": round(max(wall_ms), 3),
        "reps": reps,
        "frames_per_window": frames,
        "wall_chain": wall_chain,
        "frame_ms_1dispatch": round(ms_1dispatch, 3),
        "fps": round(fps, 3),
        "mrays_fps": round(stats.mrays_per_second_from_fps(width, height, fps), 3),
        "compile_s": round(t_compile, 1),
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "frame_mode": frame_kernel.frame_mode(),
        "launches_per_frame": {k: (after[k] - before[k]) / n_frames for k in after
                               if k not in ("host_syncs", "queued_lanes")},
        "host_syncs_per_frame": (after["host_syncs"] - before["host_syncs"]) / n_frames,
        "queued_lanes_per_frame": (after["queued_lanes"] - before["queued_lanes"]) / n_frames,
        "frame_ms_events": (round(statistics.median(ev / wall_chain for _, ev in wall), 3)
                            if cuda else None),
    }
    if device_time and chain > 1:
        t_chain = min(_timed_window(window, chain, frames)[0] for _ in range(reps))
        device_ms = max((t_chain - ms_1dispatch) / (chain - 1), 1e-3)
        out["device_frame_ms"] = round(device_ms, 3)
        if device_ms < RESOLUTION_MS:
            out["device_frame_ms_below_resolution"] = True
            out["mrays_dispatch"] = None
        else:
            out["mrays_dispatch"] = round(
                stats.mrays_per_second_from_dispatch_ms(width, height, device_ms), 3)
    for prog in programs.values():
        prog.close()
    return out


def frame_times(n: int, animated: bool = True) -> list:
    """The animation times of a window's n frames, as the reference's
    frame_t(i) computes them in double (1e-5 i for a scene that does not
    animate): rounded to f32 once where they reach the device."""
    return [0.033 * i if animated else 1e-5 * i for i in range(n)]


def window_program(scene, animate, n: int, *, animated: bool, width: int, height: int,
                   max_depth: int, keep=()):
    """The frame program of a window of n animated frames of ``scene``
    (render/program.animated_frames with a checksum): each frame's time is
    entry i of a time buffer uploaded once, here, before the capture."""
    from gpuraytracer_tpu_torch.core.upload import to_device
    from gpuraytracer_tpu_torch.render import program

    times = to_device(frame_times(n, animated), scene.arrays.aabb_min.device)
    return program.animated_frames(scene, animate, times, width=width, height=height,
                                   max_depth=max_depth, checksum=True, keep=keep,
                                   label=f"bench window of {n} frames {width}x{height}")


_KERNEL_TIMING = r"""
import inspect, json, os, sys, torch
sys.path.insert(0, ROOT)
from gpuraytracer_tpu_torch.accel import traverse
from gpuraytracer_tpu_torch.accel.instances import Scene
from gpuraytracer_tpu_torch.core import camera as cam
from gpuraytracer_tpu_torch.core import hlsl
from gpuraytracer_tpu_torch.kernels import build, frame_kernel, megakernel, scene_kernel
from gpuraytracer_tpu_torch.models import builtin, meshes, scenes
from gpuraytracer_tpu_torch.render.renderer import Renderer

assert frame_kernel.__file__.startswith(ROOT), frame_kernel.__file__
dev = torch.device("cuda:0")
simt = "count_simt" in inspect.signature(build.load).parameters
# The megakernel's unculled face loop (-DGPRT_FACE_LOOP_GLOBAL), where the
# checkout has it.
unculled = "faces_global" in inspect.signature(build.load).parameters
# The repair's whole traversal (-DGPRT_REPAIR_FULL), where the checkout's
# repair resumes from the defer entry's march records.
resumes = "repair_full" in inspect.signature(build.load).parameters
builds = [(k, f, False) for k in ("frame_kernel", "scene_kernel", "megakernel")
          for f in {True, FMAD}]
builds += [(k, True, False, True) for k in ("frame_kernel", "scene_kernel")] if simt else []
builds += [("megakernel", True, False, False, True)] if unculled else []
builds += [("scene_kernel", f, False, False, False, True) for f in {True, FMAD}] if resumes else []
build.compile_all(builds)
w, h = 1920, 1080
t_frame = 0.0333 * 8


def frame_pack(name, width, height, t):
    if name == "builtin":
        a = builtin.animate_arrays(builtin.build_scene(aspect=width / height, device=dev).arrays, t)
        return Scene(builtin.LAYOUT, a), 3
    cfg = scenes.get_config(name) if name in [c.name for c in scenes.BENCH_CONFIGS] \
        else meshes.get_config(name)
    return cfg.build(width / height, t, device=dev), cfg.max_depth


scene, _ = frame_pack("builtin", w, h, t_frame)
pack = frame_kernel.pack_frame(scene)
fractal, fractal_depth = frame_pack("fractal_mandelbulb_julia_1080p", w, h, t_frame)
pack_fr = frame_kernel.pack_frame(fractal)
px, py = cam.pixel_grid(w, h, dev)
c = scene.arrays.constants
o, d = cam.generate_camera_rays(px, py, w, h, c.camera_position, c.projection_to_world)
o, d = o.reshape(-1, 3), d.reshape(-1, 3)
hit_p, ob, db, act, t0 = traverse.pass_inputs(o, d, scene)
# Shadow rays off the plain closest pass, the same in every checkout.
st, _, sg = scene_kernel.scene_closest_plain(scene, ob, db, act, t0)
hp = o + torch.where(sg >= 0, st, t0)[:, None] * d
_, obs, dbs, acts, t0s = traverse.pass_inputs(hp, hlsl.normalize(c.light_position[:3] - hp), scene,
                                              active=(sg >= 0) | hit_p, occlusion=True)


def timed(fn):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    # The card waits first (about 0.06 s), so that the host has queued every
    # launch before the first runs: the events then time the card, not the
    # host's launch rate, which bounds the sub-0.1 ms kernels.
    torch.cuda._sleep(10 ** 8)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def frame():
    return frame_kernel.render_frame_tiles(pack, width=w, height=h)


res = {"root": ROOT, "card": torch.cuda.get_device_name(0), "reps": REPS}
res["frame_kernel_ms"] = timed(frame)
os.environ["GPURT_MERGED_SHADOW"] = "1"
res["frame_kernel_merged_ms"] = timed(frame)
del os.environ["GPURT_MERGED_SHADOW"]
res["scene_kernel_pass_ms"] = timed(
    lambda: scene_kernel.scene_closest_tiles(scene, ob, db, act, t0, pack=pack))
# Each call takes its 34 planes from the allocator's cache (the block the
# previous call freed).
res["defer_main_ms"] = timed(lambda: frame_kernel.render_frame_deferred_main(
    pack, width=w, height=h, shadow_cap=32))
res["fractal_frame_kernel_ms"] = timed(lambda: frame_kernel.render_frame_tiles(
    pack_fr, width=w, height=h, max_depth=fractal_depth))

# The compacted modes' kernels alone, each root's own form at its own queue
# (the queues come from each root's main pass, so each dense pass and repair
# takes the same set of lanes), and the calls that both roots have.
device_queue = hasattr(frame_kernel, "render_frame_compact_main")
cap = frame_kernel.queue_capacity(w, h)
kw = dict(width=w, height=h)
res["compact_capped_ms"] = timed(lambda: frame_kernel.render_frame_capped(pack, budget_cap=64, **kw))
c_img, dirty = frame_kernel.render_frame_capped(pack, budget_cap=64, **kw)
q = torch.nonzero(dirty.reshape(-1)).squeeze(1)
q = q[torch.argsort(dirty.reshape(-1)[q], stable=True)].to(torch.int32)
qpx, qpy = (q % w).contiguous(), (q // w).contiguous()
res["dense_camera_ms"] = timed(lambda: frame_kernel.render_frame_dense(pack, qpx, qpy, **kw))
res["compact_queued"] = q.shape[0]
planes = frame_kernel.render_frame_deferred_main(pack, shadow_cap=32, **kw)
idxs = [torch.nonzero((planes.sinfo[k].reshape(-1) & 3) == 2).squeeze(1) for k in range(2)]
seg = max(i.shape[0] for i in idxs)
q_rays = torch.zeros((2, seg, 6), device=dev)
q_act = torch.zeros((2, seg), dtype=torch.bool, device=dev)
for k, i in enumerate(idxs):
    q_rays[k, :i.shape[0]] = planes.rays[k].reshape(-1, 6)[i]
    q_act[k, :i.shape[0]] = True
q_rays, q_act = q_rays.reshape(-1, 6), q_act.reshape(-1)
res["queue_compacted_ms"] = timed(lambda: scene_kernel.shadow_queue(pack, q_rays, q_act, seg))
res["defer_queued"] = [i.shape[0] for i in idxs]
if device_queue:
    res["compact_main_ms"] = timed(lambda: frame_kernel.render_frame_compact_main(
        pack, budget_cap=64, cap=cap, **kw))
    m_img, appended = frame_kernel.render_frame_compact_main(pack, budget_cap=64, cap=cap, **kw)

    def canonical(q, sinfo=None):
        # The binned order with the pixels of a key in raster order, the same
        # in every process: the device's order within a key is its atomics',
        # which moved the dense pass and the repair by up to 12% between
        # processes of one code.
        if sinfo is None:
            n, e = int(q.count[0]), q.entries.clone()
            e[:n] = e[:n][torch.argsort(e[:n, 0])]
            return frame_kernel.bin_queue_plain(q._replace(entries=e))
        idx = q.idx.clone()
        for k, n in enumerate(q.count.tolist()):
            idx[k, :n] = torch.sort(idx[k, :n]).values
        return frame_kernel.bin_queue_plain(q._replace(idx=idx), sinfo)

    def repair(q, **k):
        # The checkout's repair over its defer queues (with their march
        # records where it resumes from them).
        return scene_kernel.shadow_queue_planes(pack, d_planes.rays, q.idx, q.count,
                                                *((q.rec,) if resumes else ()), **k)

    queue = frame_kernel.bin_queue(appended)
    queue_c = canonical(queue)
    res["bin_compact_ms"] = timed(lambda: frame_kernel.bin_queue(appended))
    res["dense_ms"] = timed(lambda: frame_kernel.render_frame_resume(pack, queue, m_img, **kw))
    res["dense_canonical_ms"] = timed(lambda: frame_kernel.render_frame_resume(pack, queue_c, m_img,
                                                                               **kw))
    res["dense_append_order_ms"] = timed(lambda: frame_kernel.render_frame_resume(
        pack, appended, m_img, **kw))
    d_planes, d_appended = frame_kernel.render_frame_deferred_queue(pack, shadow_cap=32, cap=cap,
                                                                    **kw)
    d_queue = frame_kernel.bin_queue(d_appended, d_planes.sinfo)
    d_queue_c = canonical(d_queue, d_planes.sinfo)
    res["defer_main_queue_ms"] = timed(lambda: frame_kernel.render_frame_deferred_queue(
        pack, shadow_cap=32, cap=cap, **kw))
    res["bin_defer_ms"] = timed(lambda: frame_kernel.bin_queue(d_appended, d_planes.sinfo))
    res["queue_ms"] = timed(lambda: repair(d_queue))
    res["queue_canonical_ms"] = timed(lambda: repair(d_queue_c))
    res["queue_append_order_ms"] = timed(lambda: repair(d_appended))
    if resumes:
        # The whole traversal on the same queues and records (the parent's
        # repair, built from this checkout).
        full = build.load("scene_kernel", repair_full=True)
        res["queue_full_ms"] = timed(lambda: repair(d_queue, lib=full))
        res["queue_full_canonical_ms"] = timed(lambda: repair(d_queue_c, lib=full))
    # Rows 2m and 4m: the merged dense pass and repair (GPURT_MERGED_SHADOW=1)
    # at the same queues, beside the sequential ones above.
    os.environ["GPURT_MERGED_SHADOW"] = "1"
    for suffix, q, dq in (("", queue, d_queue), ("_canonical", queue_c, d_queue_c)):
        res[f"dense_merged{suffix}_ms"] = timed(lambda: frame_kernel.render_frame_resume(
            pack, q, m_img, **kw))
        res[f"queue_merged{suffix}_ms"] = timed(lambda: repair(dq))
    del os.environ["GPURT_MERGED_SHADOW"]
    occ = repair(d_queue)
    res["compose_ms"] = timed(lambda: frame_kernel.frame_compose(d_planes, occ))
    res["gated_ms"] = timed(lambda: frame_kernel.render_frame_gated(pack, m_img, queue.count, cap,
                                                                    **kw))
    over = torch.full((1,), cap + 1, dtype=torch.int32, device=dev)
    o_img = torch.empty_like(m_img)
    res["gated_overflow_ms"] = timed(lambda: frame_kernel.render_frame_gated(pack, o_img, over,
                                                                             cap, **kw))
    # Each mode's chain of device time per frame, its kernels timed alone:
    # compact main + bin + resumed dense + gated; defer main + bin + repair +
    # compose + gated.
    res["compact_chain_ms"] = (res["compact_main_ms"] + res["bin_compact_ms"] + res["dense_ms"]
                               + res["gated_ms"])
    res["defer_chain_ms"] = (res["defer_main_queue_ms"] + res["bin_defer_ms"] + res["queue_ms"]
                             + res["compose_ms"] + res["gated_ms"])
    levels = queue.entries[:int(queue.count[0]), 1].long() & 255
    res["compact_queue_levels"] = torch.bincount(levels, minlength=3).tolist()
else:
    res["compact_main_ms"] = res["compact_capped_ms"]
    res["dense_ms"] = res["dense_camera_ms"]
    res["defer_main_queue_ms"] = res["defer_main_ms"]
    res["queue_ms"] = res["queue_compacted_ms"]


def finish_step(args, af):
    # (mean ms, dirty words) of the checkout's two-phase finish step on the
    # pass ``args``: scene_finish on fresh copies of the main pass's outputs,
    # the copies outside the events.
    *main, dirty = scene_kernel.scene_main_pass(scene, *args, accept_first=af, pack=pack)
    work = [x.clone() for x in main]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    total = 0.0
    for r in range(REPS + 1):
        # the card waits first, as in timed()
        torch.cuda._sleep(10 ** 6)
        for w_, m_ in zip(work, main):
            w_.copy_(m_)
        start.record()
        scene_kernel.scene_finish(scene, args[0], args[1], dirty, *work, accept_first=af,
                                  pack=pack)
        end.record()
        torch.cuda.synchronize()
        if r:
            total += start.elapsed_time(end)
    return total / REPS, dirty


passes = (("closest", (ob, db, act, t0), False), ("shadow", (obs, dbs, acts, t0s), True))
for label, args, af in passes:
    res[f"finish_{label}_ms"], f_dirty = finish_step(args, af)
    if hasattr(scene_kernel, "scene_finish_queue"):
        res[f"finish_queue_{label}_ms"] = timed(lambda: scene_kernel.scene_finish_queue(f_dirty))


def recompose():
    # The host recomposition of the parent's render_frame_deferred.
    occ = [torch.zeros(h * w, dtype=torch.int32, device=dev) for _ in range(2)]
    acc = None
    for k in range(3):
        term = planes.lit[k]
        if k < 2:
            stat = planes.sinfo[k] & 3
            shad = (stat == 1) | ((stat == 2) & (occ[k].reshape(h, w) != 0))
            term = torch.where(shad[..., None], planes.shadowed[k], term)
        acc = term if acc is None else acc + term
    return acc


res["compose_torch_ms"] = timed(recompose)


def queued_lanes():
    return frame_kernel.queued_lanes() if device_queue else frame_kernel.QUEUED_LANES


for mode in ("plain", "compact", "defer"):
    os.environ["GPURT_FRAME_MODE"] = mode
    renderer = Renderer(w, h, device=dev)
    renderer.render(0.0)
    torch.cuda.synchronize()
    syncs, lanes = frame_kernel.HOST_SYNCS, queued_lanes()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    acc = torch.zeros((), device=dev)
    for k in range(64):
        acc = acc + renderer.render(0.0333 * k).sum()
    end.record()
    torch.cuda.synchronize()
    assert torch.isfinite(acc), "non-finite window"
    key = "window_64_ms_per_frame" if mode == "plain" else f"window_{mode}_64_ms_per_frame"
    res[key] = start.elapsed_time(end) / 64
    if mode != "plain":
        # read once after the window, outside the timing
        res[f"{mode}_host_syncs_per_frame"] = (frame_kernel.HOST_SYNCS - syncs) / 64
        res[f"{mode}_queued_lanes_per_frame"] = (queued_lanes() - lanes) / 64
del os.environ["GPURT_FRAME_MODE"]

# The per-geometry route (mesh_heightfield_sdf, 544 faces): each root's
# pass function on the 1080p level-0 closest pass and the shadow pass off
# the plain closest hits (the same rays in every root), whole, torch ops
# included; then a 64-frame 1080p window with the route's launches per
# frame.
m_cfg = meshes.get_config("mesh_heightfield_sdf")
m_scene = m_cfg.build(w / h, t_frame, device=dev)
m_pack = frame_kernel.pack_frame(m_scene)
m_route = traverse._procedural_pass(m_scene, False, m_pack)
mc = m_scene.arrays.constants
m_o, m_d = cam.generate_camera_rays(px, py, w, h, mc.camera_position, mc.projection_to_world)
m_o, m_d = m_o.reshape(-1, 3), m_d.reshape(-1, 3)
m_hit_p, m_ob, m_db, m_act, m_t0 = traverse.pass_inputs(m_o, m_d, m_scene)
m_st, _, m_sg = scene_kernel.scene_closest_plain(m_scene, m_ob, m_db, m_act, m_t0)
m_hp = m_o + torch.where(m_sg >= 0, m_st, m_t0)[:, None] * m_d
_, m_obs, m_dbs, m_acts, m_t0s = traverse.pass_inputs(
    m_hp, hlsl.normalize(mc.light_position[:3] - m_hp), m_scene, active=(m_sg >= 0) | m_hit_p,
    occlusion=True)
m_passes = (("closest", (m_ob, m_db, m_act, m_t0), False),
            ("shadow", (m_obs, m_dbs, m_acts, m_t0s), True))
# Where the checkout has the unculled face loop's build, the pass and mesh
# entries in it too.
for label, args, af in m_passes:
    res[f"mesh_route_{label}_pass_ms"] = timed(lambda: m_route(m_scene, *args, level=0,
                                                               accept_first=af))
    if unculled:
        res[f"route_pass_{label}_unculled_ms"] = timed(lambda: megakernel.route_pass(
            m_scene, *args, accept_first=af, pack=m_pack,
            lib=build.load("megakernel", faces_global=True)))
# The mesh entry alone on the closest pass's gated rays (the call the
# parent's route makes): each root's, and its unculled face loop.
from gpuraytracer_tpu_torch.accel.instances import ray_to_local
from gpuraytracer_tpu_torch.geometry import analytic
m_g = [int(k) for k in m_scene.layout.kinds].index(3)
m_gate = analytic.aabb_hit_mask(m_ob, m_db, m_scene.arrays.aabb_min[m_g],
                                m_scene.arrays.aabb_max[m_g], t_min=0.0, t_max=m_t0) & m_act
m_ol, m_dl = ray_to_local(m_ob, m_db, m_scene.arrays.transforms.blas_to_local[m_g])
m_rows = m_scene.arrays.meshes[0].rows()
res["mesh_entry_ms"] = timed(lambda: megakernel.trimesh_closest(m_rows, m_ol, m_dl, m_gate, m_t0))
if unculled:
    res["mesh_entry_unculled_ms"] = timed(lambda: megakernel.trimesh_closest(
        m_rows, m_ol, m_dl, m_gate, m_t0, lib=build.load("megakernel", faces_global=True)))


def route_launches():
    return (megakernel.LAUNCHES, megakernel.MESH_LAUNCHES, getattr(megakernel, "PASS_LAUNCHES", 0))


renderer = Renderer(m_cfg.width, m_cfg.height, device=dev, scene_factory=m_cfg.build,
                    animate=m_cfg.builder().animator(), max_depth=m_cfg.max_depth)
renderer.render(0.0)
torch.cuda.synchronize()
before = route_launches()
start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
start.record()
acc = torch.zeros((), device=dev)
for k in range(64):
    acc = acc + renderer.render(0.0333 * k).sum()
end.record()
torch.cuda.synchronize()
assert torch.isfinite(acc), "non-finite window"
res["mesh_window_64_ms_per_frame"] = start.elapsed_time(end) / 64
res["mesh_window_launches_per_64_frames"] = dict(zip(
    ("march", "mesh", "pass"), (b - a for a, b in zip(before, route_launches()))))


def efficiency(ops):
    eff = frame_kernel.simt_efficiency(ops)
    return {"all" if k == "all" else f"level {k[0]} {k[1]}": v[0] for k, v in eff.items()}


if simt:
    for label, fn in (
            ("builtin", lambda lib, ops: frame_kernel.render_frame_tiles(
                pack, width=w, height=h, lib=lib, ops=ops)),
            ("fractal", lambda lib, ops: frame_kernel.render_frame_tiles(
                pack_fr, width=w, height=h, max_depth=fractal_depth, lib=lib, ops=ops))):
        ops = torch.zeros(33, dtype=torch.int64, device=dev)
        fn(build.load("frame_kernel", count_simt=True), ops)
        res[f"simt_frame_{label}"] = efficiency(ops)
    for label, args, af in (("closest", (ob, db, act, t0), False), ("shadow", (obs, dbs, acts, t0s), True)):
        ops = torch.zeros(33, dtype=torch.int64, device=dev)
        scene_kernel.scene_closest_tiles(scene, *args, accept_first=af, pack=pack, ops=ops,
                                         lib=build.load("scene_kernel", count_simt=True))
        res[f"simt_pass_{label}"] = efficiency(ops)
    # Rows 1m, 2m and 4m (GPURT_MERGED_SHADOW=1) and, for the dense pass and
    # the repair, their sequential twins at the same queues.
    if device_queue:
        for suffix, knob in (("", False), ("_merged", True)):
            if knob:
                os.environ["GPURT_MERGED_SHADOW"] = "1"
                ops = torch.zeros(33, dtype=torch.int64, device=dev)
                frame_kernel.render_frame_tiles(pack, width=w, height=h, ops=ops,
                                                lib=build.load("frame_kernel", count_simt=True))
                res["simt_frame_builtin_merged"] = efficiency(ops)
            ops = torch.zeros(33, dtype=torch.int64, device=dev)
            frame_kernel.render_frame_resume(pack, queue, m_img.clone(), ops=ops,
                                             lib=build.load("frame_kernel", count_simt=True), **kw)
            res[f"simt_dense{suffix}"] = efficiency(ops)
            ops = torch.zeros(33, dtype=torch.int64, device=dev)
            repair(d_queue, ops=ops, lib=build.load("scene_kernel", count_simt=True))
            res[f"simt_queue{suffix}"] = efficiency(ops)
        del os.environ["GPURT_MERGED_SHADOW"]

# The CLI's per-frame path over a 64-frame builtin 1080p window: tick the
# animation state by 1/60 s, build its scene, render it (each root's
# AnimationState.scene and trace.render_frame; every frame consumed by a
# checksum of its bits). Timed by the host clock from the first frame to
# the last frame's completion, with the sync debug mode off; then the same
# window again with torch.cuda.set_sync_debug_mode("warn") from frame 2 on,
# to count the host syncs (each blocking copy, item() or stream sync warns).
# Where the root has parallel/pipeline.py, the same through FramePipeline
# at 1 and 3 frames in flight.
import time
import warnings
from gpuraytracer_tpu_torch.core.config import RenderConfig
from gpuraytracer_tpu_torch.models.animate import AnimationState
from gpuraytracer_tpu_torch.render import trace
try:
    from gpuraytracer_tpu_torch.parallel.pipeline import FramePipeline
except ImportError:
    FramePipeline = None


def cli_window(fif=None, frames=64, count_syncs=False):
    cfg, sums = RenderConfig(width=w, height=h), []

    def render(scene):
        out = trace.render_frame(scene, w, h)
        sums.append(out.view(torch.int32).sum(dtype=torch.int64))
        return out

    pipe = FramePipeline(render, fif, device=dev) if fif else None
    state = AnimationState.initial()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        for k in range(frames):
            if k == 2 and count_syncs:
                torch.cuda.set_sync_debug_mode("warn")
            state = state.tick(1.0 / 60.0, cfg)
            scene = state.scene(cfg.aspect_ratio, device=dev)
            if pipe is None:
                render(scene)
            else:
                pipe.submit(scene)
        torch.cuda.set_sync_debug_mode("default")
        if pipe is not None:
            pipe.drain()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / frames
    syncs = sum("synchroniz" in str(c.message) for c in caught)
    return ms, syncs / (frames - 2), torch.stack(sums)


cli_window(frames=8)  # warm-up
loops = [("cli_window", None)] + ([("cli_window_fif1", 1), ("cli_window_fif3", 3)]
                                  if FramePipeline else [])
for key, fif in loops:
    res[f"{key}_ms_per_frame"], _, sums = cli_window(fif)
    _, res[f"{key}_host_syncs_per_frame"], _ = cli_window(fif, count_syncs=True)
    if fif is None:
        cli_sums = sums
    else:
        res[f"{key}_bit_equal"] = bool(torch.equal(sums, cli_sums))

flib, slib = build.load("frame_kernel", fmad=FMAD), build.load("scene_kernel", fmad=FMAD)
outs = {"builtin 1080p": frame_kernel.render_frame_tiles(pack, width=w, height=h, lib=flib)}
# The CLI window's frames, as the bits' sum of each (64, 1).
outs["cli window 1080p frame bit sums"] = cli_sums[:, None]
# The modes' frames through the --fmad build (their host code takes no library).
real_load = build.load
build.load = lambda name, count_ops=False: real_load(name, fmad=FMAD, count_ops=count_ops)
outs["builtin 1080p compact"] = frame_kernel.render_frame_compact(pack, width=w, height=h)
outs["builtin 1080p defer"] = frame_kernel.render_frame_deferred(pack, width=w, height=h)
build.load = real_load
for name in [cfg.name for cfg in scenes.BENCH_CONFIGS] + ["mesh_octahedra"]:
    sc, depth = frame_pack(name, 320, 180, 0.7)
    outs[f"{name} 320x180"] = frame_kernel.render_frame_tiles(
        frame_kernel.pack_frame(sc), width=320, height=180, max_depth=depth, lib=flib)
for label, args, af in passes:
    bt, nrm, g = scene_kernel.scene_closest_tiles(scene, *args, accept_first=af, pack=pack, lib=slib)
    outs[f"1080p level-0 {label} pass"] = torch.cat([bt[:, None], nrm, g[:, None].float()], dim=1)
# The route's passes and the two-phase passes through the --fmad build.
build.load = lambda name, count_ops=False: real_load(name, fmad=FMAD, count_ops=count_ops)
for label, args, af in passes:
    bt, nrm, g = scene_kernel.scene_closest_tiles(scene, *args, accept_first=af, pack=pack,
                                                  two_phase=True)
    outs[f"1080p level-0 {label} two-phase pass"] = torch.cat(
        [bt[:, None], nrm, g[:, None].float()], dim=1)
for label, args, af in m_passes:
    bt, nrm, g = m_route(m_scene, *args, level=0, accept_first=af)
    outs[f"mesh_heightfield_sdf 1080p level-0 {label} pass"] = torch.cat(
        [bt[:, None], nrm, g[:, None].float()], dim=1)
build.load = real_load


# The merged entries (rows 1m, 2m and 4m) against their sequential twins in
# both contraction builds (``merged_bit_equal``, "<output> fmad=<build>"),
# the --fmad build's outputs saved: the builtin 1080p frame in each mode, the
# dense pass and the repair at the binned queues (the repair's planes at the
# queued pixels), and at 320x180 builtin, sdf_primitives_720p, the fractal
# scene and padded_sdf_showcase(28) (closed forms first, its marches at
# geometries 28-34, so the lanes of a warp hold different sets of SDF
# geometries), each plain, compact at cap 8 and defer at cap 8 with a queue
# that holds every pixel.
twins = [("builtin 1080p", lambda: frame_kernel.render_frame_tiles(pack, width=w, height=h)),
         ("builtin 1080p compact", lambda: frame_kernel.render_frame_compact(pack, width=w,
                                                                             height=h)),
         ("builtin 1080p defer", lambda: frame_kernel.render_frame_deferred(pack, width=w,
                                                                            height=h))]
if device_queue:
    unknown_q = (d_planes.sinfo & 3) == 2
    twins += [("builtin 1080p dense", lambda: frame_kernel.render_frame_resume(
                   pack, queue, m_img.clone(), **kw)),
              ("builtin 1080p repair", lambda: torch.where(unknown_q, repair(d_queue),
                                                           -1)[..., None])]
for name in ("builtin", "sdf_primitives_720p", "fractal_mandelbulb_julia_1080p",
             "padded_sdf_showcase(28)"):
    if name.startswith("padded"):
        sc = scenes.padded_sdf_showcase(28).build(320 / 180, 0.7, device=dev)
        depth = scenes.get_config("sdf_primitives_720p").max_depth
    else:
        sc, depth = frame_pack(name, 320, 180, 0.7)
    pk, kw3 = frame_kernel.pack_frame(sc), dict(width=320, height=180, max_depth=depth)
    twins += [(f"{name} 320x180 plain", lambda pk=pk, kw3=kw3: frame_kernel.render_frame_tiles(
                   pk, **kw3)),
              (f"{name} 320x180 compact", lambda pk=pk, kw3=kw3: frame_kernel.render_frame_compact(
                   pk, budget_cap=8, cap_lanes=320 * 180, **kw3)),
              (f"{name} 320x180 defer", lambda pk=pk, kw3=kw3: frame_kernel.render_frame_deferred(
                   pk, shadow_cap=8, cap_lanes=320 * 180, **kw3))]
res["merged_bit_equal"] = {}
for fmad in (FMAD, not FMAD):
    build.load = lambda name, count_ops=False, fmad=fmad: real_load(name, fmad=fmad,
                                                                     count_ops=count_ops)
    for label, fn in twins:
        seq = fn()
        os.environ["GPURT_MERGED_SHADOW"] = "1"
        merged = fn()
        del os.environ["GPURT_MERGED_SHADOW"]
        res["merged_bit_equal"][f"{label} fmad={fmad}"] = bool(torch.equal(seq, merged))
        if fmad == FMAD:
            outs[label], outs[f"{label} merged"] = seq, merged
build.load = real_load
torch.save({k: v.cpu() for k, v in outs.items()}, OUT)
print(json.dumps(res), flush=True)
"""


_WAVEFRONT_TIMING = r"""
import collections, json, os, sys, time, warnings, torch
sys.path.insert(0, ROOT)
from gpuraytracer_tpu_torch.accel.instances import Scene
from gpuraytracer_tpu_torch.kernels import build, frame_kernel, megakernel, scene_kernel
from gpuraytracer_tpu_torch.models import builtin, meshes
from gpuraytracer_tpu_torch.render.renderer import Renderer
from gpuraytracer_tpu_torch.utils import profile

assert frame_kernel.__file__.startswith(ROOT), frame_kernel.__file__
try:
    from gpuraytracer_tpu_torch.kernels import wavefront
except ImportError:
    wavefront = None
dev = torch.device("cuda:0")
names = ["frame_kernel", "scene_kernel", "megakernel"] + (["wavefront"] if wavefront else [])
reports = build.compile_all([(k, FMAD, False) for k in names])
w, h = 1920, 1080
res = {"root": ROOT, "card": torch.cuda.get_device_name(0), "reps": REPS}
# Row 1's ptxas lines (frame_kernel<false, true>: its stack, spills and
# registers).
lines = reports[("frame_kernel", FMAD, False)].splitlines()
at = [i for i, x in enumerate(lines) if "_ZN4gprt12frame_kernelILb0ELb1EE" in x and "entry" in x]
res["frame_kernel_ptxas"] = " | ".join(x.split(":", 1)[-1].strip() for x in lines[at[0] + 1:at[0] + 3])

# Row 1, the frame kernel, at the builtin 1080p frame (t = 0.2664), timed as
# the full A/B times it: the card waits first, then REPS launches.
a = builtin.animate_arrays(builtin.build_scene(aspect=w / h, device=dev).arrays, 0.0333 * 8)
pack = frame_kernel.pack_frame(Scene(builtin.LAYOUT, a))
frame_kernel.render_frame_tiles(pack, width=w, height=h)
start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
torch.cuda.synchronize()
torch.cuda._sleep(10 ** 8)
start.record()
for _ in range(REPS):
    frame_kernel.render_frame_tiles(pack, width=w, height=h)
end.record()
torch.cuda.synchronize()
res["frame_kernel_ms"] = start.elapsed_time(end) / REPS


def counters():
    c = {"scene_pass": scene_kernel.LAUNCHES, "route_pass": megakernel.PASS_LAUNCHES,
         "frame": frame_kernel.LAUNCHES}
    if wavefront:
        c.update(wavefront.launches())
    return c


# Device work the trace tells apart: the traversal passes, the wavefront's
# lane kernels, and everything else (kernels, copies, sets).
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")


def trace_split(path, frames):
    # Per frame, from a Chrome trace of `frames` frames inside the
    # "wavefront frames" annotation: the device's busy share from the
    # annotation's start to the last device operation's end; the pass
    # kernels' and the lane kernels' ms and launches; the other device
    # operations' ms and count; the host's ms inside the annotation outside
    # the blocking runtime calls (SYNCS), and in them.
    with open(path) as f:
        ev = json.load(f)
    ev = ev.get("traceEvents", []) if isinstance(ev, dict) else ev
    ann = [e for e in ev if e.get("ph") == "X" and e.get("name") == "wavefront frames"]
    w0, w1 = float(ann[0]["ts"]), float(ann[0]["ts"]) + float(ann[0]["dur"])
    spans, groups = [], collections.defaultdict(lambda: [0.0, 0])
    for e in ev:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE or float(e["ts"]) < w0:
            continue
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        spans.append((s, s + d))
        name = e.get("name", "")
        g = ("passes" if ("scene_kernel" in name or "route_pass" in name) else
             "lane_kernels" if "wavefront" in name else "other")
        groups[g][0] += d
        groups[g][1] += 1
    busy, end_ = 0.0, None
    for s, t in sorted(spans):
        if end_ is None or s > end_:
            busy, end_ = busy + t - s, t
        elif t > end_:
            busy, end_ = busy + t - end_, t
    last = max([w1] + [t for _, t in spans])
    blocked = sum(float(e.get("dur", 0.0)) for e in ev
                  if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
                  and e.get("name") in SYNCS and w0 <= float(e["ts"]) <= w1)
    out = {"busy_share": busy / (last - w0), "window_ms": (last - w0) / 1e3 / frames,
           "host_ms_outside_syncs": (w1 - w0 - blocked) / 1e3 / frames,
           "host_ms_in_syncs": blocked / 1e3 / frames}
    for g in ("passes", "lane_kernels", "other"):
        out[f"{g}_ms"] = groups[g][0] / 1e3 / frames
        out[f"{g}_count"] = groups[g][1] / frames
    return out


outs = {}
for route, cfg in (("scene", None), ("per_geometry", meshes.get_config("mesh_heightfield_sdf"))):
    if cfg is None:
        os.environ["GPURT_DISABLE_FUSED"] = "1"
        renderer = Renderer(w, h, device=dev)
    else:
        renderer = Renderer(cfg.width, cfg.height, device=dev, scene_factory=cfg.build,
                            animate=cfg.builder().animator(), max_depth=cfg.max_depth)
    renderer.render(0.0)  # kernel load, first-use allocations
    torch.cuda.synchronize()
    # The 64-frame window, every frame consumed by a checksum.
    before = counters()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    acc = torch.zeros((), device=dev)
    for k in range(64):
        acc = acc + renderer.render(0.0333 * k).sum()
    end.record()
    torch.cuda.synchronize()
    assert torch.isfinite(acc), "non-finite window"
    res[f"{route}_window_64_ms_per_frame"] = start.elapsed_time(end) / 64
    res[f"{route}_launches_per_frame"] = {k: (v - before[k]) / 64 for k, v in counters().items()}
    # Host syncs: every blocking copy, item() or stream sync warns (the
    # mode's own notice that it is a prototype is not one).
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for k in range(8):
                renderer.render(0.0333 * k)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    res[f"{route}_host_syncs_per_frame"] = sum("synchronizing CUDA operation" in str(c.message)
                                               for c in caught) / 8
    # The trace of 4 frames (utils/profile.py).
    log_dir = os.path.join(os.path.dirname(OUT), f"trace_{route}_{os.path.basename(OUT)[:-3]}")
    with profile.trace(log_dir):
        with profile.span("wavefront frames"):
            for k in range(4):
                renderer.render(0.0333 * k)
        torch.cuda.synchronize()
    res[f"{route}_trace_per_frame"] = trace_split(os.path.join(log_dir, profile.TRACE_FILE), 4)
    outs[f"{route} 1080p frame"] = renderer.render(0.0333 * 8)
    os.environ.pop("GPURT_DISABLE_FUSED", None)
torch.save({k: v.cpu() for k, v in outs.items()}, OUT)
print(json.dumps(res), flush=True)
"""


def _compare(a: dict, b: dict) -> dict:
    """Per output: the share of pixels (frames) or rays (passes) whose
    every value is bit-equal, and the largest absolute difference; for a
    pass (its last column the geometry id), the rays whose id differs."""
    out = {}
    for name, x in a.items():
        y = b[name]
        equal = (x == y) | (torch.isnan(x) & torch.isnan(y))
        rows = equal.reshape(-1, x.shape[-1]).all(dim=1)
        diff = (x - y).abs()
        out[name] = {"bit_equal": float(rows.float().mean()),
                     "rays_differ": int((~rows).sum()),
                     "max_abs_diff": float(diff[~torch.isnan(diff)].max()) if diff.numel() else 0.0}
        if name.endswith(" pass"):
            out[name]["gid_differ"] = int((x[:, -1] != y[:, -1]).sum())
    return out


def ab_kernels(roots, reps: int, fmad: bool = True, wavefront: bool = False) -> int:
    """The builtin 1080p kernels of each checkout in ``roots``, in that
    order, each in a fresh process (see the module docstring); prints one
    JSON line per root, then the outputs of each later root against the
    first root's. ``wavefront``: the wavefront routes' windows, host syncs
    and traces instead (``--wavefront``)."""
    out_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "ab")
    os.makedirs(out_dir, exist_ok=True)
    saved = []
    for k, root in enumerate(roots):
        root = os.path.abspath(root)
        path = os.path.join(out_dir, f"root{k}.pt")
        code = (f"ROOT = {root!r}\nREPS = {reps}\nFMAD = {fmad!r}\nOUT = {path!r}\n"
                + (_WAVEFRONT_TIMING if wavefront else _KERNEL_TIMING))
        proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                              text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
        saved.append((root, path))
    first = torch.load(saved[0][1])
    for root, path in saved[1:]:
        print(json.dumps({"root": root, "against": saved[0][0], "fmad": fmad,
                          "outputs": _compare(first, torch.load(path))}), flush=True)
    return 0


def build_parser() -> argparse.ArgumentParser:
    """The command line: the reference's flags with its types and defaults,
    then the port's own (--device, and the A/B mode's)."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--configs", type=str, default="",
                   help="comma-separated names (default: all five)")
    p.add_argument("--frames", type=int, default=4,
                   help="windows issued in flight per timed repetition")
    p.add_argument("--warmup", type=int, default=1,
                   help="untimed one-frame windows, the first timed as compile_s")
    p.add_argument("--reps", type=int, default=3,
                   help="timed windows per metric (median reported)")
    p.add_argument("--chain", type=int, default=3,
                   help="frames per chained window for the device-time slope")
    p.add_argument("--wall-chain", type=int, default=WALL_CHAIN,
                   help="animated frames per wall window (1 = every frame its own window)")
    p.add_argument("--no-device-time", action="store_true",
                   help="skip the chained-window device-time measurement")
    p.add_argument("--scale", type=float, default=1.0, help="resolution scale factor")
    p.add_argument("--json", type=str, default="")
    p.add_argument("--device", default="cuda", help="torch device: cuda, cuda:N or cpu")
    p.add_argument("--ab-roots", type=str, default="",
                   help="comma-separated checkout roots: time their kernels in turns instead")
    p.add_argument("--fmad", choices=("true", "false"), default="true",
                   help="--ab-roots: the contraction mode of the builds whose outputs are compared")
    p.add_argument("--wavefront", action="store_true",
                   help="--ab-roots: time the wavefront routes' windows and trace them instead")
    return p


def main(argv=None) -> int:
    from gpuraytracer_tpu_torch.models.scenes import BENCH_CONFIGS, get_config

    args = build_parser().parse_args(argv)
    if args.ab_roots:
        print(card_line(), flush=True)
        return ab_kernels(args.ab_roots.split(","), args.reps, fmad=args.fmad == "true",
                          wavefront=args.wavefront)

    configs = ([get_config(n) for n in args.configs.split(",") if n] if args.configs
               else list(BENCH_CONFIGS))
    if torch.device(args.device).type == "cuda":
        print(card_line(), flush=True)
    results = []
    for cfg in configs:
        r = bench_config(cfg, args.frames, args.warmup, args.scale, reps=args.reps,
                         chain=args.chain, device_time=not args.no_device_time,
                         wall_chain=args.wall_chain, device=args.device)
        print(json.dumps(r), flush=True)
        results.append(r)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
