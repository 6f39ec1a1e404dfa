#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases (each prints its result and its seconds; any failure raises and
exits non-zero):
  1. device   fail without CUDA; print the card's name and power limit
  2. build    build the kernel libraries from csrc/ with nvcc, all builds
              at once (the frame kernel, scene kernel and megakernel each
              with --fmad true and false, and the op-counting build of
              each; the SIMT-counting builds of the frame and scene
              kernels; the megakernel's unculled face loop and the scene
              kernel's whole-traversal repair (-DGPRT_REPAIR_FULL) for the
              checks; the two-phase finisher, scene_finish.cu, in both
              --fmad modes, its op-counting build and its per-ray build
              (-DGPRT_FINISH_PER_RAY); the overflow gate, frame_gate.cu,
              whose device-side launch is built with -ewp and linked
              against cudadevrt, in both --fmad modes; the wavefront's
              lane kernels, wavefront.cu; row 10, frame_state.cu, always
              --fmad=false; row 7's generic march
              (-DGPRT_SPHERE_MARCH_GENERIC); row 8's parent bf16 probe,
              one element a thread (-DGPRT_PROBE_BF16_SCALAR)); print
              ptxas' registers
  3. probe    the extension fractals' device distance functions against
              their plain versions point by point across the local AABB
  4. plain    frame kernel vs its plain PyTorch version, builtin 320x180
  5. golden   frame kernel vs tests/golden_builtin_96x54_t0p7.npz, both
              fmad modes
  6. main     Renderer(1920, 1080, device="cuda") over a 64-frame animated
              window (each frame one replay of the Renderer's frame
              program, animated by row 10: one frame-state launch a frame
              in every Renderer window of the script): every frame
              through the frame kernel (launch count),
              finite, not background; ms/frame from CUDA events; the kernel
              alone, its op count and bound, its resident blocks, and one
              plain 1080p frame
  7. suite    the five BENCH_CONFIGS through trace.render_frame: 96x54
              t=0.7 against their goldens, 320x180 against the frame
              kernel's plain version, and a 64-frame animated window at
              their published sizes through the frame kernel
  8. scene    GPURT_DISABLE_FUSED=1: the scene kernel against its plain
              version on ray batches (builtin, sdf_primitives_720p, the
              fractal scene; 320x180; closest at levels 0/1, accept-first
              at levels 0/1); a builtin 320x180 frame through the
              wavefront with the scene kernel against the frame kernel and
              the plain version; the builtin 1080p 64-frame window on this
              path (the wavefront's device form, render/trace.render_lanes)
              under torch.cuda.set_sync_debug_mode("error") (no host sync)
              with its exact launch counts (5 passes, and 1 start, 2 hit
              and 3 shade lane kernels a frame), and its 1080p frame
              against the plain wavefront of phase 6; the lane kernels
              (csrc/wavefront.cu) each at the 1080p level-0 inputs against
              its plain version, timed, with its bound, and every pass of
              the frame at the masked lanes beside the compacted lanes
              the plain wavefront gives it; the 1080p level-0 closest
              pass timed; then three builder scenes against the plain
              version, with GPURT_DISABLE_FUSED unset and set: 16
              instances of 16 materials (17 with the plane, past the frame
              kernel's cap, so the scene kernel renders it either way) and
              384 instances, whose buffers take over the 48 KB of shared
              memory a block gets without opting in, at 160x90, and 1,600
              instances at 64x36 and depth 2, whose tables fit no block's
              shared memory (both kernels read them from global memory)
  9. mesh     the march kernel (csrc/megakernel.cu) against its plain version
              on ray batches for every SDF code, closest and occlusion, at
              the level-0 and the bounce budget, and bit for bit against
              the generic march's build; the three mesh scenes of
              models/meshes.py at 96x54 against their goldens and at
              320x180 against their route's plain version (the octahedra
              also with GPURT_DISABLE_FUSED=1, through the scene kernel);
              64-frame 1080p windows of mesh_octahedra and
              mesh_heightfield_512 (frame kernel) and mesh_heightfield_sdf
              (per-geometry route, the wavefront's device form under
              set_sync_debug_mode("error"): exactly 5 pass-entry launches
              and the lane kernels' 6 a frame, no march or mesh entry);
              the lane kernels on its 1080p level-0 inputs as in phase 8;
              the pass entry on the 544-face
              scene's 1080p level-0 closest and shadow passes against the
              route's plain version (gid on >= 99.9% of rays, t within 1e-3
              on >= 99.9% of both-hit rays) and against the one-geometry
              chain the route ran before (march and mesh entries per
              geometry; agreement, max |dt| and, without contraction, every
              ray that differs), its three face loops bit-equal, each timed
              alone with op counts (unculled and with the chunk skip),
              bounds and SIMT; the chain's march and mesh calls against
              their plain versions (ray-batch bar over the gated rays,
              normals, gated-out rays miss) and alone, the mesh entry in
              each face loop; row 7 on the chain's two 1080p march calls
              (its [mesh] "row 7" lines): gated rays and the blocks and
              warps that hold one, march samples (mean, max), SIMT,
              resident blocks, the shipped march bit for bit against the
              generic march's build and under set_sync_debug_mode("error"),
              both timed in one call in turns, and the longest ray marched
              alone (the ray the plain version marches longest; a
              measurement, not a bound); one 1080p mesh_octahedra
              frame-kernel frame against its plain version
 10. modes    GPURT_FRAME_MODE=compact|defer (the compact, dense, defer,
              compose and gated entries of csrc/frame_kernel.cu, the queue
              kernel of csrc/scene_kernel.cu; device-side queues, no host
              read in a frame): builtin 96x54 against the golden and
              320x180 against the plain frame kernel, each at the default
              cap, at cap 8 with a queue that holds every pixel (the dense
              pass and the queue kernel run) and at cap 1 with a one-tile
              queue (the overflow, read from the device flag that
              debug_count returns: the gated plain kernel renders), in both
              fmad builds (bit-equal share, flips, max |diff|, queued
              lanes); the --fmad=false compact frame equals its plain kernel
              bit for bit; the bench scenes and mesh_octahedra at 320x180 in
              both modes against the plain kernel; a 17-material scene under
              compact through the scene kernel; a 1080p frame in each mode
              under torch.cuda.set_sync_debug_mode("error"); a 64-frame 1080p
              builtin window in each mode (launches, host syncs, which must
              stay 0, and queued lanes per frame); each kernel alone at the
              1080p frame's shapes against its plain version, with op counts
              and bounds: the compact entry with its queue (the queue's set
              against the dirty plane, the level histogram), the dense pass
              resumed from that queue in its binned order (bit-equal to the
              plain kernel's pixels in the --fmad=false build; in the
              shipped build every differing pixel counted), the bin entry
              (one launch over the histogram the main entry counted: the
              plain version's key order), the defer entry with its queues
              and march records, the repair over them (resumed from the
              records: bit-equal to the whole traversal of the
              -DGPRT_REPAIR_FULL build in both fmad builds, and timed beside
              it, with both builds' op counts), the compose entry and the
              overflow gate of csrc/frame_gate.cu (without an overflow the
              image keeps every bit; with one, the frame kernel that the gate
              launches from the device gives the plain kernel's frame to a
              clone queued right after it, timed beside the plain frame
              kernel); beside the bin entry on both modes' queues, its
              library call (torch.sort of the live slots' keys, stable)
 11. last     the last three kernel-table items: GPURT_MERGED_SHADOW=1 (the
              merged instantiations of the frame kernel's plain and dense
              entries and of the occlusion queue) against the sequential
              frame of the same build, bit for bit, in both fmad builds:
              builtin, sdf_primitives_720p, the fractal scene and
              padded_sdf_showcase(28) (its marches at geometries 28-34, so
              a warp's lanes hold different sets of SDF geometries) at
              320x180 and builtin at 1080p, each plain, compact at cap 8 and
              defer at cap 8; the merged builtin frame against the plain
              version at 320x180;
              a 17-material scene under the knob through the scene kernel;
              64-frame 1080p windows with and without the knob (plain,
              compact, defer) and each merged kernel alone beside its
              sequential twin in the same call; the two-phase
              scene pass (scene_closest_tiles(two_phase=True): the main
              entry of csrc/scene_kernel.cu, then csrc/scene_finish.cu's
              compaction of the dirty rays into a queue in key order and the
              finisher over the queue's capacity) on the
              builtin 1080p level-0 closest and shadow passes against the
              single pass (every differing ray named by its cause) and its
              plain version, dirty rays per geometry, each entry alone: the
              finish step beside the parent's one thread per ray
              (-DGPRT_FINISH_PER_RAY) in turns, bit for bit, the compaction
              alone against its plain version's set and key order, the warps
              that march in each form; the
              two-phase pass against its plain version on 320x180 ray
              batches (the three scenes' reflection rays at level 1, the
              builtin scene's camera and shadow rays at level 0) in both
              fmad builds; the op probe (csrc/op_probe.cu) against its plain
              version in all ten variants (the bf16 variants, packed pairs,
              element for element against the scalar build and the plain
              version on the reference's array and a seeded one), then
              timed at the reference's 2000 iterations (ns per
              element-iteration, bf16/f32, packed beside scalar) and priced
              by pipe (apps/op_probe.py pipes: the latency chains' cycles
              an instruction by class and pipe; each variant's SASS
              instructions an iteration by pipe, its dependent chain's
              cycles an iteration at those latencies, its bound by pipe
              beside the FLOP-count bound, and what one warp and the full
              card read)
 12. simt     the SIMT-counting builds (-DGPRT_COUNT_SIMT): the share of a
              warp's 32 lanes that march at each march sample, for the frame
              kernel on the builtin and the fractal 1080p frames per level
              and ray kind, for the builtin 1080p level-0 closest and
              shadow passes of the scene kernel, and for rows 1m, 2m and 4m
              beside their sequential twins (the merged builtin 1080p frame;
              the dense pass and the repair at phase 10's queues, with and
              without the knob), and the resumed repair beside the whole
              traversal (-DGPRT_REPAIR_FULL) on the same queues; one [simt]
              line each
 13. host     the host runtime and the two interactive entry points on the
              card: pick_device("cuda") and the native host runtime built
              (hostrt.available()); the CLI (apps/render_cli.py) at
              1920x1080, --dt 1/60, 8 frames, 3 in flight: 8 PNGs from the
              native async writer with no write error, frame 0 byte for
              byte the native encoding of trace.render_frame of the state
              ticked once; 4 frames with --checkpoint then 4 with --resume,
              whose last PNG is the unbroken run's byte for byte; the CLI's
              frame loop (tick, scene, FramePipeline.submit; no PNGs;
              through the CLI's trace.make_renderer, one replay of its
              frame program a frame) over a
              64-frame builtin 1080p window at 1 and 3 frames in flight:
              ms/frame by the wall clock, the host's own ms/frame outside
              the pipeline's event waits, the frame kernel's ms by CUDA
              events and the device's busy share (64 x kernel ms over the
              window's wall ms), the host's ms a frame by step (tick,
              scene, pack_frame, the launch, render_frame, the
              make_renderer replay), frames 2-63 under
              torch.cuda.set_sync_debug_mode("error") (any host sync
              raises), every frame bit-equal to a direct render of the same
              state; a torch.profiler trace of 4 frames (the trace file, its
              top five device operations and busy share); RecoveringExecutor
              over Renderer.render (a CUDA-shaped launch error recovers to a
              direct render's frame, a step past a 1 s watchdog recovers as
              DeviceTimeoutError, a ValueError propagates); the preview
              server (apps/serve.py) on an ephemeral port at 320x180:
              /frame.png a 320x180 PNG, /stats a status line,
              /resize?w=640&h=360 shown on a later frame, /resize?w=4&h=4
              answered 400
 14. bands    row-band sharding (parallel/sharding.py): the builtin 1920x1080
              frame at t=0.2664 on make_mesh(["cuda:0"] * n) for n = 4 (270
              rows a band, not a multiple of the 8-row block) and n = 8 (135
              rows), in plain mode, under GPURT_FRAME_MODE=compact, under
              defer (which the band renderer sends to compact, as the
              reference's compact_enabled() does) and under
              GPURT_MERGED_SHADOW=1: the eager bands (sharding.render_bands,
              each band packing the scene itself) and the band program's
              replay (make_sharded_renderer: one CUDA graph over the n bands
              of cuda:0, built by a first call) each bit for bit the whole
              frame of the same route and knobs in this process, the
              program's mean radiance bit for bit the eager bands' sums
              added in band order and the image's to rel 1e-5, the launch
              counters of the eager bands and of the replay (set to 0 just
              before each, read just after: one frame-kernel launch per band
              in plain mode), the replay under
              torch.cuda.set_sync_debug_mode("error") (no host sync), a
              second replay equal to the first, the graph's nodes and
              private pool; render_frame_deferred over the same bands
              against its whole frame; the wavefront routes at 320x180 in 4
              bands, eager and as a program, against their whole frames
              (GPURT_DISABLE_FUSED=1: the scene kernel; mesh_heightfield_sdf:
              the per-geometry route); a 2-rank gloo world on cuda:0
              (entry.dryrun_multichip(2, "cuda") with a 1920x1080 frame,
              each rank's band a program: the gathered bands bit for bit the
              one-process frame); the frame kernel's ms at row_offset 0 and
              of the frame as 4 band launches, after a device-side wait; a
              64-frame window of animated builtin 1080p frames in 4 bands,
              program against eager bands against the whole frame's
              make_renderer program, by the host clock and CUDA events
 15. parity   the port against the JAX package's CPU reference renders in
              tests/parity_refs/ (tools/torch_make_refs.py): every scene
              (builtin at 320x180, the five bench scenes and the three mesh
              scenes at 160x90, t=0.7) on its default route, and builtin on
              the compact, defer, merged and scene-kernel routes too,
              through tools/torch_parity.py, one [parity] line each
              (pct_within_1e3, interior_pct_1e3, sens_fraction,
              stable_pct_1e3, stable_max_abs, the route's launches); fails
              on a frame that is not finite, a route that launched no
              kernel or an entry below its bars (torch_parity.BARS: each
              entry's first H100 reading less 2 points, builtin's default
              route at least tests/test_parity.py's 89 / 95.5 / 95.5);
              the parity floor (tools/torch_parity_floor.py: builtin
              320x180 as shipped, launched again, in the --fmad=false build,
              compact, defer, merged, scene kernel and the CPU wavefront,
              each against the first; [floor] lines) and the bisect
              (tools/torch_parity_bisect.py: the level-0 hit of the scene
              kernel against the CPU's plain pass, the distance entry of
              csrc/scene_kernel.cu on the 4,096 committed points of every
              SDF code against its plain version, which fails past
              DIST_ULPS, and the JAX values, timed with its op count, and
              the card's frame against the CPU port's; [bisect] lines)
 16. bench    the port's bench suite through its command line, in process:
              apps/bench_suite.main with tools/round_end.sh's line (--json,
              into out/torch/ beside the reference's committed
              out/bench_suite.json: the five BENCH_CONFIGS at their
              published sizes), README.md's (--scale 0.25), then one scene
              with --warmup 2 --chain 4 and one with --no-device-time;
              fails on a JSON line without
              the reference's keys (bench_suite.REFERENCE_KEYS), with the
              device-time keys where the flags say none or without them
              where they say some, a frame_ms that is not finite and
              positive, a frame-kernel scene not rendered by exactly one
              frame-kernel launch a frame (launches_per_frame and the
              wrapper's count over the whole run), or frame_ms_events past
              frame_ms x 1.01; one [bench] line a scene (frame_ms,
              frame_ms_events, frame_ms_1dispatch, device_frame_ms); then
              the reference's ray invariants (tests/test_properties.py,
              tests/test_torch_properties.py) on the CUDA scene kernel's
              closest and occlusion passes over the same 2,048 random
              rays (builtin at t = 1.3, the tests' seed) and the sky ray,
              with the plain passes' answers beside them; [props] lines
 17. programs the frame programs (render/program.py: the Renderer's step,
              trace.make_renderer, the bench's windows as captured CUDA
              graphs) and row 10 (kernels/frame_state.py,
              csrc/frame_state.cu): row 10 against its plain version on
              every field of the parameter buffer, bit for bit, at 64 times
              of builtin and each bench scene, timed with its bound; the
              builtin 1080p 64-frame window as one program, replayed with
              the counts at 0 under set_sync_debug_mode("error") (one
              frame-kernel and one row-10 launch a frame), every frame's
              checksum and frames 0, 31 and 63 bit for bit the eager
              frames' (animate, pack_frame, render_frame), and a replay
              with trace.render_frame and frame_state.advance patched to
              raise; the same for 8-frame 320x180 windows in compact mode,
              compact with GPURT_COMPACT_BUDGET=1 (the queue overflows: the
              gate launches the plain frame kernel from the device inside
              the graph), defer, GPURT_MERGED_SHADOW=1, the scene-kernel
              route (GPURT_DISABLE_FUSED=1) and the per-geometry route
              (mesh_heightfield_sdf); per program one [programs] line:
              graph nodes a frame, the private pool's peak bytes, ms/frame
              by the host clock and CUDA events beside the eager window's,
              the busy share of a torch.profiler trace of one replay (not
              traced where the gate launches from the device: CUPTI then
              stops the card), the launches a frame
Then the kernel JSON line (with each entry's registers and bytes of
spill stores from ptxas, and the resident blocks per SM of rows 1, 1m,
2's dense pass, 2m, 4, 4m and 5 and the two-phase main pass; the lane
kernels' launches over both wavefront windows, their times at builtin's
1080p level-0 inputs, and at mesh_heightfield_sdf's as route_ms), the card
line, and the final JSON status line.

Image bar (as tests/test_frame_kernel.py holds the reference's Pallas
kernel to its XLA path): fewer than 2% of pixels with max-channel |diff| >
1e-3, every other pixel within 1e-3, and more than 75% of those within
1e-5. Ray-batch bar: gid equal on >= 98% of rays, and |best_t| within 1e-3
where gid agrees: on every such ray for the scene kernel built without
contraction (--fmad=false), which repeats the plain arithmetic; on >= 98%
of them for the shipped build, where contraction moves a march crossing by
a step on a few rays. The one-geometry calls of phase 9 are held to the
same bar over the rays their gate admits (hits for gid), and in addition:
normals within 1e-2 on >= 98% of the valid hits whose t agrees, and
every ray outside the gate a miss.

Bounds: the larger of the bytes a call must move (inputs read once,
outputs written once) over 3.35 TB/s and its f32 FLOPs over 67 TFLOP/s,
the H100 SXM's published peaks. The -DGPRT_COUNT_OPS build counts the
FLOPs on the same inputs, in the unit of that peak: a multiply-add is two
(csrc/frame_math.cuh says what else counts).
"""

import contextlib
import functools
import json
import math
import os
import shutil
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
W_MAIN, H_MAIN, FRAMES = 1920, 1080, 64
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# bf16 outside the tensor cores: twice the f32 rate (packed bf16x2 FMAs,
# NVIDIA's H100 SXM data: 133.8 TFLOP/s). The 989 TFLOP/s bf16 peak is the
# tensor cores', which no element-wise chain reaches.
BF16_OPS_PER_S = 133.8e12
# Launches timed for a kernel of well under a millisecond: ten launches of
# the compose kernel (0.054 ms over 50 launches in apps/bench_suite.py) read
# 0.08-0.14 ms here, after the long, host-bound plain versions. At 100 the
# queued launches stay well inside what the host can queue ahead of the
# card.
SHORT_REPS = 100


def bar(img, ref):
    """(passes, flip fraction, within-1e-5 fraction, max abs diff) of the
    image bar."""
    diff = (img.float().cpu() - ref.float().cpu()).abs().amax(dim=-1)
    flipped = diff > 1e-3
    agree = diff[~flipped]
    tight = float((agree < 1e-5).float().mean()) if agree.numel() else 0.0
    frac = float(flipped.float().mean())
    ok = frac < 0.02 and agree.numel() > 0 and tight > 0.75
    return ok, frac, tight, float(diff.max())


def cuda_ms(fn, reps, warmup=True):
    """Mean device-clock ms of fn() over reps launches, and the last output.
    With a warm-up (a kernel's timing) the card waits first (about 0.06 s),
    so that the host has queued every launch before the first runs: the
    events time the card, not the host's launch rate, which bounds the
    sub-0.1 ms kernels. Without one (a plain version's single run) the
    host's time is part of what is timed."""
    if warmup:
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if warmup:
        torch.cuda._sleep(10 ** 8)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def bound(nbytes, ops, ops_per_s=F32_OPS_PER_S):
    """(bound ms, what bounds it); ops at ops_per_s (f32 by default)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def ray_agreement(k_out, p_out, gate):
    """A one-geometry call (hit, t, normal) against its plain version over
    the rays its gate admits: (hit agreement on the gated rays, share of
    both-hit rays with |dt| <= 1e-3, max |dt|, share of the valid both-hit
    rays whose t agrees with normals within 1e-2, max normal |diff| there,
    whether every ray outside the gate misses). A capped hit (t = 0) takes
    its normal at the ray origin, which no caller reads: not compared."""
    (k_hit, k_t, k_n), (p_hit, p_t, p_n) = k_out, p_out
    agree = float((k_hit == p_hit)[gate].float().mean()) if bool(gate.any()) else 1.0
    both = k_hit & p_hit
    dt = (k_t - p_t).abs()
    dtb = dt[both]
    close = float((dtb <= 1e-3).float().mean()) if dtb.numel() else 1.0
    dt_max = float(dtb.max()) if dtb.numel() else 0.0
    dn = (k_n - p_n).abs().amax(dim=-1)[both & (dt <= 1e-3) & (p_t > 0.0)]
    n_close = float((dn <= 1e-2).float().mean()) if dn.numel() else 1.0
    dn_max = float(dn.max()) if dn.numel() else 0.0
    outside = bool(torch.isinf(k_t[~gate]).all())
    return agree, close, dt_max, n_close, dn_max, outside


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        if exc[0] is None:
            print(f"[{self.name}] done in {time.perf_counter() - self.t0:.1f} s", flush=True)


# queued_lanes() at the last reset_counts().
_QUEUED_BASE = [0]


def reset_counts():
    from gpuraytracer_tpu_torch.kernels import (frame_kernel, frame_state, megakernel,
                                                scene_kernel, wavefront)

    wavefront.reset_launches()
    frame_state.LAUNCHES = 0
    frame_kernel.LAUNCHES = 0
    scene_kernel.LAUNCHES = 0
    megakernel.LAUNCHES = 0
    megakernel.MESH_LAUNCHES = 0
    megakernel.PASS_LAUNCHES = 0
    frame_kernel.COMPACT_LAUNCHES = frame_kernel.DENSE_LAUNCHES = 0
    frame_kernel.DEFER_LAUNCHES = scene_kernel.QUEUE_LAUNCHES = 0
    frame_kernel.GATED_FALLBACK_LAUNCHES = frame_kernel.COMPOSE_LAUNCHES = 0
    frame_kernel.BIN_LAUNCHES = 0
    frame_kernel.HOST_SYNCS = 0
    _QUEUED_BASE[0] = frame_kernel.queued_lanes()
    frame_kernel.MERGED_LAUNCHES = frame_kernel.MERGED_DENSE_LAUNCHES = 0
    scene_kernel.MERGED_QUEUE_LAUNCHES = 0
    scene_kernel.MAIN_LAUNCHES = scene_kernel.FINISH_LAUNCHES = 0
    scene_kernel.FINISH_QUEUE_LAUNCHES = 0


def mode_counts():
    """The compacted modes' counters: launches of the plain frame kernel,
    the compact, dense, defer, compose, bin and gated entries and the
    queue kernel; host syncs; queued lanes (read from the device: one
    sync)."""
    from gpuraytracer_tpu_torch.kernels import frame_kernel, scene_kernel

    return dict(plain=frame_kernel.LAUNCHES, compact=frame_kernel.COMPACT_LAUNCHES,
                dense=frame_kernel.DENSE_LAUNCHES, defer=frame_kernel.DEFER_LAUNCHES,
                queue=scene_kernel.QUEUE_LAUNCHES, compose=frame_kernel.COMPOSE_LAUNCHES,
                bin=frame_kernel.BIN_LAUNCHES,
                gated=frame_kernel.GATED_FALLBACK_LAUNCHES, syncs=frame_kernel.HOST_SYNCS,
                queued=frame_kernel.queued_lanes() - _QUEUED_BASE[0],
                merged=frame_kernel.MERGED_LAUNCHES,
                dense_merged=frame_kernel.MERGED_DENSE_LAUNCHES,
                queue_merged=scene_kernel.MERGED_QUEUE_LAUNCHES)


@contextlib.contextmanager
def env(**values):
    """Environment variables set for the block, restored after it."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def ptxas_summary(report):
    """'kernel<instantiation>: registers; stack and spills' per entry of a
    ptxas -v report."""
    import re

    def pretty(mangled):
        m = re.match(r"_ZN4gprt(\d+)(\w+)", mangled) or re.match(r"_Z(\d+)(\w+)", mangled)
        if not m:
            return mangled
        n, rest = int(m.group(1)), m.group(2)
        flags = re.match(r"I((?:L[bi]n?\d+E)+)E", rest[n:])
        if not flags:
            return rest[:n]
        names = [("true" if v == "1" else "false") if kind == "b" else "-" * len(neg) + v
                 for kind, neg, v in re.findall(r"L([bi])(n?)(\d+)E", flags.group(1))]
        return rest[:n] + "<" + ", ".join(names) + ">"

    out, entry, props, stack = [], None, None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry, stack = m.group(1), ""
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            props = m.group(1)
        elif "bytes stack frame" in line and props == entry:
            stack = line.strip()
        elif entry and "Used" in line:
            out.append(f"{pretty(entry)}: {line.split(':')[-1].strip()}; {stack}")
            entry = None
    return " | ".join(out)


def ptxas_registers(report):
    """{entry: registers} of a ptxas -v report, entries named as
    ptxas_summary names them."""
    out = {}
    for item in ptxas_summary(report).split(" | "):
        if ": Used " in item:
            name, rest = item.split(": Used ", 1)
            out[name] = int(rest.split()[0])
    return out


def ptxas_spill_stores(report):
    """{entry: bytes of spill stores} of a ptxas -v report, entries named as
    ptxas_summary names them."""
    import re

    out = {}
    for item in ptxas_summary(report).split(" | "):
        m = re.search(r"(\d+) bytes spill stores", item)
        if ": Used " in item:
            out[item.split(": Used ", 1)[0]] = int(m.group(1)) if m else 0
    return out


def exactness(img, ref):
    """(bit-equal pixel share, flip share, max |diff|) of two images."""
    img, ref = img.float().cpu(), ref.float().cpu()
    diff = (img - ref).abs().amax(dim=-1)
    return (float((img == ref).all(dim=-1).float().mean()), float((diff > 1e-3).float().mean()),
            float(diff.max()))


def counts():
    """(frame kernel, scene kernel, megakernel march, megakernel mesh entry,
    megakernel pass entry) launches."""
    from gpuraytracer_tpu_torch.kernels import frame_kernel, megakernel, scene_kernel

    return (frame_kernel.LAUNCHES, scene_kernel.LAUNCHES, megakernel.LAUNCHES,
            megakernel.MESH_LAUNCHES, megakernel.PASS_LAUNCHES)


def animated_window(renderer, dev, label, w, h, sync_error=False):
    """FRAMES animated frames through renderer.render, timed by CUDA events:
    (ms/frame, counts(), max background share); every frame is checked
    finite and not mostly background, and animated by row 10 (one
    frame-state launch a frame: the Renderer's step is a frame program,
    render/program.py). ``sync_error``: the frames render under
    torch.cuda.set_sync_debug_mode("error"), so a host sync in a frame
    raises."""
    from gpuraytracer_tpu_torch.kernels import frame_state

    renderer.render(0.0)  # warm-up: builds the step's program, not counted
    torch.cuda.synchronize()
    reset_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    if sync_error:
        torch.cuda.set_sync_debug_mode("error")
    try:
        frames = [renderer.render(0.0333 * k) for k in range(FRAMES)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    end.record()
    torch.cuda.synchronize()
    launched = counts()
    if frame_state.LAUNCHES != FRAMES:
        raise AssertionError(f"{label}: {frame_state.LAUNCHES} frame-state launches for "
                             f"{FRAMES} frames")
    bg = torch.tensor([0.8, 0.9, 1.0, 1.0], device=dev)
    bg_frac = []
    for k, f in enumerate(frames):
        if f.shape != (h, w, 4) or not bool(torch.isfinite(f).all()):
            raise AssertionError(f"{label} frame {k}: shape {tuple(f.shape)} or non-finite")
        bg_frac.append(float(((f - bg).abs().amax(dim=-1) <= 1e-3).float().mean()))
    if max(bg_frac) >= 0.70:
        raise AssertionError(f"{label}: a frame is mostly background ({max(bg_frac):.3f})")
    return start.elapsed_time(end) / FRAMES, launched, max(bg_frac)


# The lane kernels' launches in a FRAMES-frame window at depth 3: one start,
# two hit (levels 0 and 1) and three shade launches a frame.
LANE_LAUNCHES = {"wavefront_start": FRAMES, "wavefront_hit": 2 * FRAMES,
                 "wavefront_shade": 3 * FRAMES}
SYNC_ERROR_NOTE = " under set_sync_debug_mode('error'): 0 host syncs"
# FLOPs of one level of one lane, as csrc/frame_kernel.cu's render_pixel
# counts them (its GPRT_OPS: the level's surface, shadow ray, shading and
# bounce), the checkerboard's on a plane hit, and raygen with the plane test
# and the move to BLAS space (start): the lane kernels' operation bounds
# take them per active lane (an upper count: each lane kernel runs a part
# of a level). Their bytes bound them in every case.
LEVEL_FLOPS = 181
CHECKERS_FLOPS = 81
START_FLOPS = 46 + 8 + 3


def lane_kernels(label, scene, pack, route, card, w=W_MAIN, h=H_MAIN, depth=3):
    """The wavefront's lane kernels (csrc/wavefront.cu) on a 1080p frame of
    ``scene`` on its ``route`` ("scene" or "per_geometry"): each kernel at
    the level-0 inputs against its plain version on the same inputs, timed
    alone (the card waits first; shade on fresh copies of its inputs), with
    its bound (bytes: each lane's state read once and written once, counted
    on this run's active lanes; operations: LEVEL_FLOPS per active lane);
    then the frame's loop run step by step through the wrappers (render/
    trace.render_lanes' launches), each pass timed at the masked lanes it
    takes now and at the compacted lanes the parent took (the level's active
    lanes only, the same rays). Returns ({kernel: row of the kernels line},
    {pass: (masked ms, compacted ms, active lanes)}). Raises where a kernel
    disagrees with its plain version."""
    from gpuraytracer_tpu_torch.kernels import build, megakernel, scene_kernel, wavefront

    dev = pack.params.device
    pass_fn = functools.partial(
        scene_kernel.scene_closest_tiles if route == "scene" else megakernel.route_pass,
        pack=pack)

    def copy(lanes):
        return wavefront.Lanes(*(x.clone() for x in lanes))

    def rel_err(got, want, on=None):
        err = (got - want).abs() / want.abs().clamp(min=1.0)
        if on is not None:
            err = err[on]
        return float(err.max()) if err.numel() else 0.0

    lanes = wavefront.start(scene, pack, width=w, height=h)
    n = lanes.o.shape[0]
    want = wavefront.start_plain(scene, width=w, height=h)
    start_err = max(rel_err(getattr(lanes, k), getattr(want, k)) for k in ("o", "d", "ob", "t0"))
    start_abs = max(float((getattr(lanes, k) - getattr(want, k)).abs().max())
                    for k in ("o", "d", "ob", "t0"))
    start_ok = torch.equal(lanes.active, want.active) and torch.equal(lanes.color, want.color) \
        and torch.equal(lanes.tw, want.tw) and start_err <= 1e-3
    answer = pass_fn(scene, lanes.ob, lanes.d, lanes.active, lanes.t0, level=0, cull_backface=True)
    shadow = wavefront.hit(scene, pack, lanes, answer)
    want_s = wavefront.hit_plain(scene, lanes, answer)
    both = shadow.active & want_s.active
    hit_agree = float((shadow.active == want_s.active).float().mean())
    t0_agree = float((shadow.t0 == want_s.t0).float().mean())
    hit_err = max(rel_err(shadow.ob, want_s.ob, both), rel_err(shadow.d, want_s.d, both))
    hit_abs = max(float((shadow.ob - want_s.ob).abs()[both].max()),
                  float((shadow.d - want_s.d).abs()[both].max()))
    _, _, sgid = pass_fn(scene, *shadow, level=0, accept_first=True)
    kw = dict(level=0, max_depth=depth, width=w, height=h)
    want_l = wavefront.shade_plain(scene, copy(lanes), answer, shadow, sgid, **kw)

    def shade_vs_plain(lib=None):
        # (kill agreement, colour bar, throughput bar, share of the lanes
        # live on both sides whose next ray and pass inputs are within 1e-3,
        # max |diff| of colour and throughput)
        got = wavefront.shade(scene, pack, copy(lanes), answer, shadow, sgid, lib=lib, **kw)
        on = got.active & want_l.active
        near = torch.stack([((getattr(got, k) - getattr(want_l, k)).abs()
                             / getattr(want_l, k).abs().clamp(min=1.0)).reshape(n, -1).amax(-1)
                            for k in ("o", "d", "ob", "t0")]).amax(0)[on] <= 1e-3
        return (float((got.active == want_l.active).float().mean()), bar(got.color, want_l.color),
                bar(got.tw, want_l.tw), float(near.float().mean()) if near.numel() else 1.0,
                max(float((got.color - want_l.color).abs().max()),
                    float((got.tw - want_l.tw).abs().max())), got)

    shade_agree, c_bar, t_bar, next_ok, shade_abs, got = shade_vs_plain()
    nf = shade_vs_plain(build.load("wavefront", fmad=not build.DEFAULT_FMAD))
    print(f"[lanes] {label} 1080p level 0 ({n} lanes) vs the plain versions: start max rel "
          f"|diff| {start_err:.3g} (abs {start_abs:.3g}); hit: shadow ray traced agrees on "
          f"{hit_agree:.6f}, t0 on {t0_agree:.6f}, max rel |diff| {hit_err:.3g} (abs "
          f"{hit_abs:.3g}); shade: kill agrees on {shade_agree:.6f}, colour flipped "
          f"{c_bar[1]:.6f} within 1e-5 {c_bar[2]:.6f}, throughput flipped {t_bar[1]:.6f} within "
          f"1e-5 {t_bar[2]:.6f}, max |diff| {shade_abs:.3g}, next rays within 1e-3 on "
          f"{next_ok:.6f}; the --fmad={not build.DEFAULT_FMAD} build's shade: kill agrees on "
          f"{nf[0]:.6f}, colour flipped {nf[1][1]:.6f} within 1e-5 {nf[1][2]:.6f}, max |diff| "
          f"{nf[4]:.3g}", flush=True)
    if not (start_ok and hit_agree >= 0.999 and t0_agree >= 0.999 and hit_err <= 1e-3
            and shade_agree >= 0.99 and c_bar[0] and t_bar[0] and next_ok >= 0.98):
        raise AssertionError(f"{label}: a lane kernel disagrees with its plain version")
    start_err, hit_err, shade_err = start_abs, hit_abs, shade_abs

    # Each kernel alone at these inputs; shade on fresh copies (it works in place).
    torch.cuda.empty_cache()
    copies = [copy(lanes) for _ in range(11)]
    start_ms = cuda_ms(lambda: wavefront.start(scene, pack, width=w, height=h), SHORT_REPS)[0]
    hit_ms = cuda_ms(lambda: wavefront.hit(scene, pack, lanes, answer), SHORT_REPS)[0]
    shade_ms = cuda_ms(lambda: wavefront.shade(scene, pack, copies.pop(), answer, shadow, sgid,
                                               **kw), 10)[0]
    del copies
    start_plain_ms = cuda_ms(lambda: wavefront.start_plain(scene, width=w, height=h), 1,
                             warmup=False)[0]
    hit_plain_ms = cuda_ms(lambda: wavefront.hit_plain(scene, lanes, answer), 1, warmup=False)[0]
    shade_plain_ms = cuda_ms(lambda: wavefront.shade_plain(scene, copy(lanes), answer, shadow,
                                                           sgid, **kw), 1, warmup=False)[0]
    a = int(lanes.active.sum())
    s_on = int(shadow.active.sum())
    live = int(got.active.sum())
    plane = int((wavefront._active_hits(scene, lanes, answer)[3].geometry_id
                 == scene.layout.plane_geometry_id).sum())
    nbytes = {"start": n * 73,
              # active; o, d and the answer read; the shadow ray written
              "hit": n * 1 + a * (24 + 20) + a * 29 + (n - a) * 5,
              # active; o, d, the answer, colour, throughput, the shadow
              # ray's active and t0 read (its gid where it was traced);
              # colour, throughput, active written, and o, d, ob, t0 where
              # the lane lives on
              "shade": n * 1 + a * (24 + 20 + 32 + 5) + s_on * 4 + a * 33 + live * 40}
    flops = {"start": n * START_FLOPS, "hit": a * LEVEL_FLOPS,
             "shade": a * LEVEL_FLOPS + plane * CHECKERS_FLOPS}
    rows = {}
    for name, ms, plain_ms, err in (("start", start_ms, start_plain_ms, start_err),
                                    ("hit", hit_ms, hit_plain_ms, hit_err),
                                    ("shade", shade_ms, shade_plain_ms, shade_err)):
        b_ms, b_by = bound(nbytes[name], flops[name])
        rows[f"wavefront_{name}"] = dict(ms=ms, plain_ms=plain_ms, err=err, bound_ms=b_ms,
                                         bound_by=b_by)
        print(f"[lanes] {label} wavefront_{name} alone at the 1080p level-0 inputs: {ms:.4f} ms "
              f"({nbytes[name]} bytes, {flops[name]} FLOPs: bound {b_ms:.4f} ms by {b_by}, "
              f"{100 * b_ms / ms:.1f}% of bound); plain {plain_ms:.1f} ms; {card}", flush=True)

    # The frame's loop step by step: each pass at the masked lanes and at the
    # level's active lanes compacted.
    passes = {}
    lanes = wavefront.start(scene, pack, width=w, height=h)
    for level in range(depth):
        idx = torch.nonzero(lanes.active).squeeze(1)
        ones = torch.ones(idx.shape[0], dtype=torch.bool, device=dev)
        args = (lanes.ob, lanes.d, lanes.active, lanes.t0)
        packed = (args[0][idx], args[1][idx], ones, args[3][idx])
        answer = pass_fn(scene, *args, level=level, cull_backface=True)
        passes[f"closest {level}"] = (
            cuda_ms(lambda: pass_fn(scene, *args, level=level, cull_backface=True), 10)[0],
            cuda_ms(lambda: pass_fn(scene, *packed, level=level, cull_backface=True), 10)[0],
            idx.shape[0])
        shadow = sgid = None
        if level + 1 < depth:
            shadow = wavefront.hit(scene, pack, lanes, answer)
            sa = tuple(shadow)
            sp = tuple(x[idx] for x in sa)
            _, _, sgid = pass_fn(scene, *sa, level=level, accept_first=True)
            passes[f"occlusion {level}"] = (
                cuda_ms(lambda: pass_fn(scene, *sa, level=level, accept_first=True), 10)[0],
                cuda_ms(lambda: pass_fn(scene, *sp, level=level, accept_first=True), 10)[0],
                idx.shape[0])
        wavefront.shade(scene, pack, lanes, answer, shadow, sgid, level=level, max_depth=depth,
                        width=w, height=h)
    masked = sum(m for m, _, _ in passes.values())
    compacted = sum(c for _, c, _ in passes.values())
    print(f"[lanes] {label} 1080p passes at the masked lanes against the parent's compacted "
          f"lanes (ms, ms, active lanes): " + "; ".join(
              f"{k} {m:.4f} / {c:.4f} ({a_})" for k, (m, c, a_) in passes.items())
          + f"; a frame's five {masked:.4f} / {compacted:.4f} ms ({masked - compacted:+.4f}); "
          f"{card}", flush=True)
    return rows, passes


def march_designs(calls, dev, card):
    """Row 7 (the one-geometry march) on the recorded ``calls`` [(args, kw)]
    of sphere_trace_tiles: per call the gated rays and the blocks and warps
    that hold one; the shipped march (specialized on its code) against the
    generic march's build (-DGPRT_SPHERE_MARCH_GENERIC, the parent's) bit
    for bit, and under set_sync_debug_mode("error"); SIMT and the march
    samples (the SIMT build's counters); resident blocks; both builds'
    times in one call, in turns (generic, shipped, shipped, generic); and
    the longest ray alone: the ray that the plain version marches longest,
    marched by itself, less a call that marches nothing (a measurement of
    the march's own chain, not a bound). Returns the sums over the calls."""
    from gpuraytracer_tpu_torch.geometry import sdf
    from gpuraytracer_tpu_torch.kernels import build, megakernel

    libs = {"generic": build.load("megakernel", defines=megakernel.GENERIC_DEFINES),
            "shipped": build.load("megakernel")}
    simt_lib = build.load("megakernel", count_simt=True)
    tot = dict(ms={k: 0.0 for k in libs}, longest_ms=0.0)

    def call(args, kw, lib=None, ops=None):
        return megakernel.sphere_trace_tiles(*args, lib=lib, ops=ops, **kw)

    for j, (args, kw) in enumerate(calls):
        o, d, gate, t_max, step_scale = args
        n, gated = o.shape[0], int(gate.sum())
        pad = torch.zeros(-(-n // 128) * 128, dtype=torch.bool, device=dev)
        pad[:n] = gate
        blocks, warps = int(pad.view(-1, 128).any(1).sum()), int(pad.view(-1, 32).any(1).sum())
        resident = {k: megakernel.sphere_residency(dev, kw["prim_code"], lib=lib)
                    for k, lib in libs.items()}
        generic = call(args, kw, libs["generic"])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            shipped = call(args, kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        # Rays whose t or normal differ from the generic march's, bit for bit.
        differ = int(((shipped[1] != generic[1]) | (shipped[2] != generic[2]).any(1)).sum())
        if differ or not all(torch.equal(x, y) for x, y in zip(shipped, generic)):
            raise AssertionError(f"1080p march call {j}: {differ} rays of the specialized march "
                                 f"differ from the generic march's bit for bit")
        cnt = torch.zeros(megakernel.MARCH_SIMT_COUNTERS, dtype=torch.int64, device=dev)
        call(args, kw, simt_lib, cnt)
        sim = megakernel.march_simt(cnt)
        ms = {k: [] for k in libs}
        for k in ("generic", "shipped", "shipped", "generic"):
            ms[k].append(cuda_ms(lambda: call(args, kw, libs[k]), 20)[0])
        # The longest ray alone: the ray the plain version marches longest
        # (its samples from the SIMT build), less a call that marches nothing.
        st = sdf.march_state(o, d, gate, t_max, step_scale, prim_code=kw["prim_code"],
                             cull_backface=kw["cull_backface"], max_steps=kw["max_steps"],
                             t_start=kw.get("t_start"), relax=kw["relax"])
        samples = torch.zeros(st.lanes.numel(), dtype=torch.int64, device=dev)
        while st.marching:
            samples[st.cur] += 1
            st.step()
        r = int(st.lanes[int(torch.argmax(samples))])
        one_kw = dict(kw, t_start=None if kw.get("t_start") is None else kw["t_start"][r:r + 1])
        one = (o[r:r + 1], d[r:r + 1], gate[r:r + 1], t_max[r:r + 1], step_scale)
        none = (o[r:r + 1], d[r:r + 1], ~gate[r:r + 1], t_max[r:r + 1], step_scale)
        cnt.zero_()
        call(one, one_kw, simt_lib, cnt)
        one_samples = megakernel.march_simt(cnt)["max_samples"]
        one_ms = cuda_ms(lambda: call(one, one_kw), SHORT_REPS)[0]
        none_ms = cuda_ms(lambda: call(none, one_kw), SHORT_REPS)[0]
        g_one_ms = cuda_ms(lambda: call(one, one_kw, libs["generic"]), SHORT_REPS)[0]
        g_none_ms = cuda_ms(lambda: call(none, one_kw, libs["generic"]), SHORT_REPS)[0]
        sample_ns = (one_ms - none_ms) * 1e6 / max(one_samples, 1)
        g_sample_ns = (g_one_ms - g_none_ms) * 1e6 / max(one_samples, 1)
        longest_ms = sim["max_samples"] * sample_ns * 1e-6
        print(f"[mesh] row 7, 1080p march call {j} (code {kw['prim_code']}, budget "
              f"{kw['max_steps']}): {gated} of {n} rays gated ({100 * gated / n:.2f}%), in "
              f"{blocks} of {-(-n // 128)} blocks and {warps} of {-(-n // 32)} warps; march "
              f"samples mean {sim['samples'] / max(gated, 1):.2f}, max {sim['max_samples']}; "
              f"SIMT {100 * sim['simt']:.2f}% ({sim['warp_samples']} warp-samples; the generic "
              f"march takes the same samples on the same lanes); resident blocks/SM generic "
              f"{resident['generic'][0]}, shipped {resident['shipped'][0]}; bit for bit the "
              f"generic march's on every ray, 0 host syncs; in turns: generic "
              f"{ms['generic'][0]:.4f} / {ms['generic'][1]:.4f} ms, shipped (the march "
              f"specialized on its code) {ms['shipped'][0]:.4f} / {ms['shipped'][1]:.4f} ms; the "
              f"longest ray alone (ray {r}, {one_samples} samples): {one_ms:.4f} ms, an empty "
              f"call {none_ms:.4f} ms, {sample_ns:.2f} ns a sample (generic {g_sample_ns:.2f}: "
              f"{g_one_ms:.4f} and {g_none_ms:.4f} ms), so the longest march alone "
              f"{longest_ms:.4f} ms (a measurement, not a bound); {card}", flush=True)
        for k in ms:
            tot["ms"][k] += sum(ms[k]) / len(ms[k])
        tot["longest_ms"] += longest_ms
        tot.setdefault("resident", resident)
        tot.setdefault("code", kw["prim_code"])
    print(f"[mesh] row 7, the {len(calls)} 1080p march calls (same call): generic "
          f"{tot['ms']['generic']:.4f} ms, shipped {tot['ms']['shipped']:.4f} ms "
          f"({100 * (tot['ms']['shipped'] / tot['ms']['generic'] - 1):+.1f}%); the longest "
          f"marches alone {tot['longest_ms']:.4f} ms; {card}", flush=True)
    return tot


def png_size(data: bytes):
    """(width, height) from a PNG's IHDR."""
    if data[:8] != b"\x89PNG\r\n\x1a\n" or data[12:16] != b"IHDR":
        raise AssertionError("not a PNG")
    return struct.unpack(">II", data[16:24])


def http_get(port, path, timeout=30):
    """(status, body) of a GET on the local preview server."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def host_phase(dev, card, pack_m):
    """Phase 13: the host runtime, the CLI, its frame loop, checkpoint and
    resume, a profiler trace, recovery and the preview server on the card
    (see the module docstring). Raises on any failure."""
    from gpuraytracer_tpu_torch.apps import render_cli, serve
    from gpuraytracer_tpu_torch.core.config import RenderConfig
    from gpuraytracer_tpu_torch.kernels import frame_kernel
    from gpuraytracer_tpu_torch.models import builtin
    from gpuraytracer_tpu_torch.models.animate import AnimationState
    from gpuraytracer_tpu_torch.parallel.device import pick_device
    from gpuraytracer_tpu_torch.parallel.pipeline import FramePipeline
    from gpuraytracer_tpu_torch.parallel.recovery import DeviceTimeoutError, RecoveringExecutor
    from gpuraytracer_tpu_torch.render import trace
    from gpuraytracer_tpu_torch.render.renderer import Renderer
    from gpuraytracer_tpu_torch.runtime import hostrt
    from gpuraytracer_tpu_torch.utils import png as png_mod
    from gpuraytracer_tpu_torch.utils import profile

    info = pick_device("cuda")
    if not hostrt.available():
        raise AssertionError("the native host runtime did not build")
    print(f"[host] {info.description}; native host runtime {hostrt.library_path()}",
          flush=True)
    host_dir = os.path.join(ROOT, "build", "chip_smoke_host")
    shutil.rmtree(host_dir, ignore_errors=True)
    dt = 1.0 / 60.0
    cli = ["--device", "cuda", "--width", str(W_MAIN), "--height", str(H_MAIN),
           "--dt", repr(dt), "--frames-in-flight", "3"]

    def pngs(d):
        return sorted(f for f in os.listdir(d) if f.endswith(".png"))

    def read(path):
        with open(path, "rb") as f:
            return f.read()

    # (a) the CLI: 8 frames through the native async writer.
    full = os.path.join(host_dir, "full")
    t_cli = time.perf_counter()
    if render_cli.main(cli + ["--frames", "8", "--out", full]) != 0:
        raise AssertionError("the CLI failed (a write error returns 1)")
    t_cli = time.perf_counter() - t_cli
    names = pngs(full)
    if names != [f"frame_{i:05d}.png" for i in range(8)]:
        raise AssertionError(f"the CLI wrote {names}")
    for n in names:
        if png_size(read(os.path.join(full, n))) != (W_MAIN, H_MAIN):
            raise AssertionError(f"{n} is not a {W_MAIN}x{H_MAIN} PNG")
    cfg = RenderConfig(width=W_MAIN, height=H_MAIN)
    state1 = AnimationState.initial().tick(dt, cfg)
    img = trace.render_frame(state1.scene(cfg.aspect_ratio, device=dev), W_MAIN, H_MAIN)
    ref_png = os.path.join(host_dir, "frame0_direct.png")
    hostrt.write_png(ref_png, png_mod.image_f32_to_rgba8(img.cpu().numpy()))
    if read(ref_png) != read(os.path.join(full, names[0])):
        raise AssertionError("the CLI's frame 0 differs from the render of the state "
                             "ticked once")
    print(f"[host] CLI 1920x1080 --dt 1/60, 8 frames, 3 in flight: 8 PNGs "
          f"({os.path.getsize(os.path.join(full, names[0]))} bytes each) from the native "
          f"writer, no write error, {t_cli:.2f} s with start-up; frame 0 byte for byte the "
          f"native encoding of render_frame at t = {state1.geometry_time:.6f}", flush=True)

    # (b) 4 frames with --checkpoint, then 4 with --resume.
    split = os.path.join(host_dir, "split")
    ckpt = os.path.join(host_dir, "state.json")
    if render_cli.main(cli + ["--frames", "4", "--out", split, "--checkpoint", ckpt]) != 0 \
            or render_cli.main(cli + ["--frames", "4", "--out", split, "--resume", ckpt]) != 0:
        raise AssertionError("the CLI failed")
    if pngs(split) != names or read(os.path.join(split, names[-1])) != \
            read(os.path.join(full, names[-1])):
        raise AssertionError("the resumed run does not end on the unbroken run's bytes")
    print("[host] checkpoint after 4 frames, resumed for 4: frame 7 byte for byte the "
          "unbroken 8-frame run's", flush=True)

    # (c) the CLI's frame loop over a 64-frame 1080p window, no PNGs, through
    # the CLI's trace.make_renderer (its frame program, built by the warm-up
    # window below).
    cli_renderer = trace.make_renderer(builtin.LAYOUT, W_MAIN, H_MAIN)

    def loop_window(fif, frames=FRAMES, sync_check_from=2):
        sums = []

        def render(scene):
            out = cli_renderer(scene.arrays)
            sums.append(out.view(torch.int32).sum(dtype=torch.int64))
            return out

        pipe = FramePipeline(render, fif, device=dev)
        state = AnimationState.initial()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = render_cli.frame_loop(pipe, state, cfg, range(sync_check_from), dt=dt)
        torch.cuda.set_sync_debug_mode("error")
        try:
            render_cli.frame_loop(pipe, state, cfg, range(sync_check_from, frames), dt=dt)
            pipe.drain()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        return wall * 1e3 / frames, pipe.wait_seconds * 1e3 / frames, torch.stack(sums)

    loop_window(3, frames=8)  # warm-up: first-use allocations, pinned blocks
    kernel_ms, _ = cuda_ms(
        lambda: frame_kernel.render_frame_tiles(pack_m, width=W_MAIN, height=H_MAIN), 10)
    loop_ms = {}
    for fif in (1, 3, 1, 3):
        ms, wait_ms, sums = loop_window(fif)
        loop_ms.setdefault(fif, []).append((ms, wait_ms))
        print(f"[host] frame loop, builtin 1080p, {FRAMES} frames, {fif} in flight: "
              f"{ms:.3f} ms/frame (wall clock), host {ms - wait_ms:.3f} ms/frame outside the "
              f"event waits ({wait_ms:.3f} waiting); frame kernel {kernel_ms:.3f} ms (CUDA "
              f"events): device busy {FRAMES * kernel_ms / (FRAMES * ms):.4f}; host syncs "
              f"in frames 2-{FRAMES - 1} under set_sync_debug_mode('error'): 0", flush=True)
    state, direct = AnimationState.initial(), []
    for _ in range(FRAMES):
        state = state.tick(dt, cfg)
        out = trace.render_frame(state.scene(cfg.aspect_ratio, device=dev), W_MAIN, H_MAIN)
        direct.append(out.view(torch.int32).sum(dtype=torch.int64))
    if not torch.equal(torch.stack(direct), sums):
        raise AssertionError("a frame of the pipelined loop differs from a direct render")
    host_loop = {fif: (min(m for m, _ in v), max(m for m, _ in v)) for fif, v in
                 loop_ms.items()}
    print(f"[host] every frame of the loop bit-equal to a direct render of its state "
          f"(bit sums of {FRAMES} frames); ms/frame at 1 in flight {host_loop[1]}, at 3 "
          f"{host_loop[3]}; {card}", flush=True)

    # Where the host's time in a frame goes: each step alone over 16 frames
    # by the host clock, the card idle at the start of each step (nothing
    # here waits for it).
    steps = {}

    def host_ms(label, fn, n=16):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [fn(k) for k in range(n)]
        steps[label] = (time.perf_counter() - t0) * 1e3 / n
        return outs

    states = host_ms("tick", lambda k: AnimationState.initial().tick(dt * (k + 1), cfg))
    scenes = host_ms("scene", lambda k: states[k].scene(cfg.aspect_ratio, device=dev))
    packs = host_ms("pack_frame", lambda k: frame_kernel.pack_frame(scenes[k]))
    host_ms("frame kernel launch", lambda k: frame_kernel.render_frame_tiles(
        packs[k], width=W_MAIN, height=H_MAIN))
    host_ms("render_frame", lambda k: trace.render_frame(scenes[k], W_MAIN, H_MAIN))
    host_ms("make_renderer replay", lambda k: cli_renderer(scenes[k].arrays))
    torch.cuda.synchronize()
    print("[host] host ms a frame by step (16 frames each, host clock): " + ", ".join(
        f"{k} {v:.3f}" for k, v in steps.items()), flush=True)

    # (d) a torch.profiler trace of 4 frames at 3 in flight.
    prof_dir = os.path.join(host_dir, "profile")
    pipe = FramePipeline(lambda scene: cli_renderer(scene.arrays), 3, device=dev)
    torch.cuda.synchronize()
    with profile.trace(prof_dir):
        with profile.span("four frames"):
            render_cli.frame_loop(pipe, AnimationState.initial(), cfg, range(4), dt=dt)
            pipe.drain()
    trace_file = os.path.join(prof_dir, profile.TRACE_FILE)
    if not os.path.getsize(trace_file):
        raise AssertionError("the profiler wrote no trace")
    summary = profile.device_summary(trace_file)
    print(f"[host] torch.profiler, 4 frames at 3 in flight: {trace_file} "
          f"({os.path.getsize(trace_file)} bytes); device busy {summary['busy_ms']:.3f} of "
          f"{summary['span_ms']:.3f} ms ({summary['busy_share']:.4f}); top device "
          f"operations: " + "; ".join(f"{n[:60]} {ms:.3f} ms x{c}"
                                       for n, ms, c in summary["top"]), flush=True)

    # (e) RecoveringExecutor over Renderer.render.
    w_r, h_r, t_r = 320, 180, 0.5
    direct_r = Renderer(w_r, h_r, device=dev).render(t_r)
    builds = []

    def make_step(fault):
        def make():
            builds.append(1)
            first = len(builds) == 1
            renderer = Renderer(w_r, h_r, device=dev)

            def step(t):
                if first:
                    fault()
                return renderer.render(t)

            return step

        return make

    def cuda_fault():
        raise RuntimeError("frame kernel launch failed: CUDA error 9 "
                           "(invalid configuration argument; injected)")

    ex = RecoveringExecutor(make_step(cuda_fault), retry_delay_seconds=0.0, device=dev)
    out = ex(t_r)
    if ex.recoveries != 1 or not torch.equal(out, direct_r):
        raise AssertionError("no recovery from a CUDA launch error, or a different frame")
    builds.clear()
    abandoned = []

    def wedge():
        abandoned.append(threading.current_thread())
        time.sleep(2.5)

    ex = RecoveringExecutor(make_step(wedge), retry_delay_seconds=0.0,
                            watchdog_seconds=1.0, device=dev)
    try:
        t_wd = time.perf_counter()
        out = ex(t_r)
        t_wd = time.perf_counter() - t_wd
    finally:
        ex.close()
        # The abandoned step still renders once it wakes: wait for it, so
        # that its frame kernel launch lands in no later phase's counts.
        for worker in abandoned:
            worker.join(60)
    if ex.recoveries != 1 or not torch.equal(out, direct_r):
        raise AssertionError("no recovery from a step past the watchdog")
    builds.clear()

    def bad_input():
        raise ValueError("bad frame size (injected)")

    ex = RecoveringExecutor(make_step(bad_input), retry_delay_seconds=0.0, device=dev)
    try:
        ex(t_r)
        raise AssertionError("a ValueError did not propagate")
    except ValueError:
        pass
    if ex.recoveries:
        raise AssertionError("a ValueError was retried")
    print(f"[host] RecoveringExecutor over Renderer.render 320x180: a CUDA launch error "
          f"recovered (1 rebuild, frame bit-equal to a direct render); a step past the 1 s "
          f"watchdog recovered as {DeviceTimeoutError.__name__} in {t_wd:.2f} s; a "
          f"ValueError propagated with no retry", flush=True)

    # (f) the preview server on an ephemeral port.
    srv = serve.PreviewServer(320, 180, device="cuda", host="127.0.0.1", port=0).start()
    try:
        def frame_of(size, timeout=120.0):
            t_end = time.perf_counter() + timeout
            while time.perf_counter() < t_end:
                code, body = http_get(srv.port, "/frame.png")
                if code == 200 and png_size(body) == size:
                    return body
                time.sleep(0.05)
            raise AssertionError(f"the server showed no {size} frame ({srv.state.status})")

        frame_of((320, 180))
        code, stats_body = http_get(srv.port, "/stats")
        if code != 200 or not stats_body.startswith(b"fps:"):
            raise AssertionError(f"/stats gave {code} {stats_body[:80]!r}")
        if http_get(srv.port, "/resize?w=640&h=360")[0] != 200:
            raise AssertionError("/resize?w=640&h=360 was refused")
        frame_of((640, 360))
        bad = http_get(srv.port, "/resize?w=4&h=4")[0]
        if bad != 400:
            raise AssertionError(f"/resize?w=4&h=4 gave {bad}, not 400")
        frames_served = srv.state.frames
    finally:
        srv.close()
    print(f"[host] preview server 127.0.0.1:{srv.port}: /frame.png 320x180, /stats "
          f"{stats_body.decode()!r}, /resize?w=640&h=360 shown as a 640x360 frame, "
          f"/resize?w=4&h=4 answered 400; {frames_served} frames rendered", flush=True)


def band_window_times(call, frames, reps=3):
    """(host-clock ms/frame, CUDA-event ms/frame), medians over ``reps``:
    ``call(arrays)`` for each of ``frames`` issued back to back, then one
    value of the last frame read (the host clock runs from the first issue
    to that read)."""
    import statistics

    host, events = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for arrays in frames:
            out = call(arrays)
        end.record()
        last = out if isinstance(out, torch.Tensor) else out[-1]
        float(last.reshape(-1)[0])
        host.append((time.perf_counter() - t0) * 1e3 / len(frames))
        end.synchronize()
        events.append(start.elapsed_time(end) / len(frames))
    return statistics.median(host), statistics.median(events)


def bands_phase(dev, card):
    """Phase 14: row-band sharding on the card, eager and as band programs
    (see the module docstring). Raises on any failure."""
    from gpuraytracer_tpu_torch import entry
    from gpuraytracer_tpu_torch.accel.instances import Scene
    from gpuraytracer_tpu_torch.kernels import frame_kernel
    from gpuraytracer_tpu_torch.models import builtin, meshes
    from gpuraytracer_tpu_torch.parallel import sharding
    from gpuraytracer_tpu_torch.render import trace

    t_phase = time.perf_counter()
    t_band = 0.0333 * 8
    arrays = builtin.animate_arrays(
        builtin.build_scene(aspect=W_MAIN / H_MAIN, device=dev).arrays, t_band)
    scene = Scene(builtin.LAYOUT, arrays)
    pack = frame_kernel.pack_frame(scene)
    kw = dict(width=W_MAIN, height=H_MAIN)
    zero = {k: 0 for k in mode_counts()}

    def differing(img, whole):
        return int((img.cpu() != whole.cpu()).any(dim=-1).sum())

    def band_sums(images):
        total = None
        for image in images:
            part = torch.sum(image[..., :3], dtype=torch.float32)
            total = part if total is None else total + part
        return total

    def replayed(render, args):
        """The program's replay of ``render(*args)`` with the counts set to
        0 just before it and read just after, under
        set_sync_debug_mode("error"): (output, counts)."""
        torch.cuda.synchronize()
        reset_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = render(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return out, (counts(), mode_counts())

    def graph_of(render):
        ((_, prog),) = render.programs.values()
        return prog

    for n in (4, 8):
        mesh = sharding.make_mesh(["cuda:0"] * n)
        # (label, knobs, the whole frame of the band renderer's route, the
        # launches a banded frame makes)
        cases = (
            ("plain", {}, lambda: frame_kernel.render_frame_tiles(pack, **kw), {"plain": n}),
            ("compact", {"GPURT_FRAME_MODE": "compact"},
             lambda: frame_kernel.render_frame_compact(pack, **kw),
             {"compact": n, "bin": n, "dense": n, "gated": n}),
            ("defer (compact route)", {"GPURT_FRAME_MODE": "defer"},
             lambda: frame_kernel.render_frame_compact(pack, **kw),
             {"compact": n, "bin": n, "dense": n, "gated": n}),
            ("merged", {"GPURT_MERGED_SHADOW": "1"},
             lambda: frame_kernel.render_frame_tiles(pack, **kw), {"merged": n}))
        for label, knobs, whole_fn, want in cases:
            want = {**{k: 0 for k in zero if k != "queued"}, **want}
            with env(**knobs):
                whole = whole_fn()
                # The eager bands, each packing the scene itself.
                torch.cuda.synchronize()
                reset_counts()
                eager = sharding.render_bands(scene, W_MAIN, H_MAIN, n, range(n))
                torch.cuda.synchronize()
                launched_eager = mode_counts()
                eager_mean = band_sums(eager) / (W_MAIN * H_MAIN * 3)
                # The band program: built by its first call, then replayed.
                render = sharding.make_sharded_renderer(scene.layout, W_MAIN, H_MAIN, mesh,
                                                        compute_stats=True)
                t0 = time.perf_counter()
                render(arrays)
                torch.cuda.synchronize()
                build_s = time.perf_counter() - t0
                (bands, mean), (_, launched) = replayed(render, (arrays,))
                again, _ = replayed(render, (arrays,))
            prog = graph_of(render)
            img = torch.from_numpy(sharding.gather_image(bands))
            for c in (launched, launched_eager):
                c.pop("queued")
            differ = differing(img, whole)
            differ_eager = differing(torch.cat(eager), whole)
            equal_bands = all(torch.equal(a, b) for a, b in zip(bands.images, eager))
            ref_mean = float(img[..., :3].double().mean())
            rel = abs(float(mean) - ref_mean) / ref_mean
            print(f"[bands] {n} bands of {H_MAIN // n} rows, {label}: eager bands {differ_eager} "
                  f"of {W_MAIN * H_MAIN} pixels differ from the whole frame, launches "
                  f"{ {k: v for k, v in launched_eager.items() if v} }; band program (built in "
                  f"{build_s:.2f} s, {prog.nodes} graph nodes, private pool peak "
                  f"{prog.pool_peak_bytes} bytes): replay {differ} pixels differ from the whole "
                  f"frame, bands bit-equal to the eager bands {equal_bands}, mean radiance "
                  f"{float(mean)!r} vs the eager bands' {float(eager_mean)!r} and the image's "
                  f"{ref_mean:.7f} (rel {rel:.3g}), launches "
                  f"{ {k: v for k, v in launched.items() if v} }, 0 host syncs", flush=True)
            if differ or differ_eager or not equal_bands or rel > 1e-5 \
                    or not torch.equal(mean, eager_mean) or not bool(torch.isfinite(img).all()):
                raise AssertionError(f"{n} bands, {label}: not the whole frame")
            if launched != want or launched_eager != want:
                raise AssertionError(f"{n} bands, {label}: launches {launched} (program), "
                                     f"{launched_eager} (eager), not {want}")
            if not all(torch.equal(a, b) for a, b in zip(again[0].images, bands.images)):
                raise AssertionError(f"{n} bands, {label}: a second replay differs")
            render.close()
        lh = H_MAIN // n
        whole = frame_kernel.render_frame_deferred(pack, **kw)
        parts = [frame_kernel.render_frame_deferred(pack, row_offset=k * lh, local_height=lh, **kw)
                 for k in range(n)]
        differ = differing(torch.cat(parts).cpu(), whole)
        print(f"[bands] {n} bands, render_frame_deferred(row_offset, local_height): {differ} "
              f"pixels differ from its whole frame", flush=True)
        if differ:
            raise AssertionError(f"{n} deferred bands: not the whole deferred frame")

    # The wavefront routes at 320x180 in 4 bands of 45 rows, eager and as a
    # band program.
    w, h = 320, 180
    mesh = sharding.make_mesh(["cuda:0"] * 4)
    for label, knobs, build_scene, want in (
            ("scene kernel (GPURT_DISABLE_FUSED=1)", {"GPURT_DISABLE_FUSED": "1"},
             lambda: builtin.build_scene(aspect=w / h, elapsed_time=t_band, device=dev),
             (0, 1, 0, 0, 0)),
            ("per-geometry route (mesh_heightfield_sdf)", {},
             lambda: meshes.get_config("mesh_heightfield_sdf").build(w / h, t_band, device=dev),
             (0, 0, 0, 0, 1))):
        with env(**knobs):
            sc = build_scene()
            whole = trace.render_frame(sc, w, h)
            torch.cuda.synchronize()
            reset_counts()
            eager = sharding.render_bands(sc, w, h, 4, range(4))
            torch.cuda.synchronize()
            launched_eager = counts()
            render = sharding.make_sharded_renderer(sc.layout, w, h, mesh)
            render(sc.arrays)
            bands, (launched, _) = replayed(render, (sc.arrays,))
        prog = graph_of(render)
        img = torch.from_numpy(sharding.gather_image(bands))
        differ, differ_eager = differing(img, whole), differing(torch.cat(eager), whole)
        equal_bands = all(torch.equal(a, b) for a, b in zip(bands.images, eager))
        ran = all([bool(c) for c in got] == [bool(c) for c in want]
                  for got in (launched, launched_eager))
        print(f"[bands] 4 bands of {h // 4} rows at {w}x{h}, {label}: eager bands {differ_eager} "
              f"pixels differ from the whole frame, launches (frame, scene, march, mesh, pass) "
              f"{launched_eager}; band program ({prog.nodes} graph nodes, private pool peak "
              f"{prog.pool_peak_bytes} bytes): {differ} pixels differ, bands bit-equal to the "
              f"eager bands {equal_bands}, launches {launched}, 0 host syncs", flush=True)
        if differ or differ_eager or not equal_bands or not ran:
            raise AssertionError(f"{label}: bands not the whole frame, or launches {launched}, "
                                 f"{launched_eager}")
        render.close()

    # One band per rank of a 2-rank gloo world, both ranks on card 0, each
    # rank's band a program.
    t0 = time.perf_counter()
    entry.dryrun_multichip(2, device="cuda", size=(W_MAIN, H_MAIN), timeout=300)
    print(f"[bands] dryrun_multichip(2, device=\"cuda\") over gloo with a {W_MAIN}x{H_MAIN} "
          f"frame, each rank's band a program: bit for bit the one-process frame "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # Row 1 with the band arguments: the whole frame at row_offset 0, and the
    # same frame as 4 band launches.
    whole_ms, _ = cuda_ms(lambda: frame_kernel.render_frame_tiles(
        pack, row_offset=0, local_height=H_MAIN, **kw), 10)
    lh = H_MAIN // 4
    bands_ms, _ = cuda_ms(lambda: [frame_kernel.render_frame_tiles(
        pack, row_offset=k * lh, local_height=lh, **kw) for k in range(4)], 10)
    each_ms = [cuda_ms(lambda k=k: frame_kernel.render_frame_tiles(
        pack, row_offset=k * lh, local_height=lh, **kw), 10)[0] for k in range(4)]
    print(f"[bands] frame kernel 1920x1080 at row_offset 0: {whole_ms:.3f} ms; as 4 band "
          f"launches: {bands_ms:.3f} ms a frame; each band alone "
          f"{', '.join(f'{t:.3f}' for t in each_ms)} ms (sum {sum(each_ms):.3f}); {card}",
          flush=True)

    # A 64-frame window of animated builtin 1080p frames (the caller's arrays
    # at t_i = 0.0333 i, made before timing) in 4 bands on cuda:0: the band
    # program (one replay a frame: the arrays copied in, the pack and the 4
    # band launches in the graph), the eager bands (each band packs the
    # scene and launches), and the whole frame's make_renderer program.
    base = builtin.build_scene(aspect=W_MAIN / H_MAIN, device=dev).arrays
    frames = [builtin.animate_arrays(base, 0.0333 * i) for i in range(FRAMES)]
    render = sharding.make_sharded_renderer(builtin.LAYOUT, W_MAIN, H_MAIN, mesh)
    whole = trace.make_renderer(builtin.LAYOUT, W_MAIN, H_MAIN)
    render(frames[0])
    whole(frames[0])
    prog = graph_of(render)
    (_, whole_prog), = whole.programs.values()
    reset_counts()
    ms, ms_ev = band_window_times(lambda a: render(a).images, frames)
    per_frame = {k: v / (3 * FRAMES) for k, v in mode_counts().items() if v and k != "queued"}
    e_ms, e_ev = band_window_times(
        lambda a: sharding.render_bands(Scene(builtin.LAYOUT, a), W_MAIN, H_MAIN, 4, range(4)),
        frames)
    w_ms, w_ev = band_window_times(whole, frames)
    print(f"[bands] window of {FRAMES} builtin {W_MAIN}x{H_MAIN} frames in 4 bands on cuda:0: "
          f"band program {ms:.4f} ms/frame by the host clock, {ms_ev:.4f} by CUDA events "
          f"({prog.nodes} graph nodes a frame, private pool peak {prog.pool_peak_bytes} bytes, "
          f"launches a frame {per_frame}); eager bands {e_ms:.4f} / {e_ev:.4f}; the whole "
          f"frame's make_renderer program {w_ms:.4f} / {w_ev:.4f} ({whole_prog.nodes} graph "
          f"nodes); 4 band launches alone {bands_ms:.3f} ms; {card}", flush=True)
    render.close()
    for _, p in whole.programs.values():
        p.close()
    print(f"[bands] done {time.perf_counter() - t_phase:.1f} s; {card}", flush=True)


def parity_phase(card):
    """Phase 15: the port against the committed CPU reference renders, the
    parity floor and the bisect (see the module docstring). Raises on any
    failure; returns the bisect's distance stage (the distance entry's
    launches, error, times, bytes and FLOPs)."""
    from tools import torch_parity, torch_parity_bisect, torch_parity_floor

    def log(msg):
        print(msg, flush=True)

    t0 = time.perf_counter()
    results = torch_parity.run("cuda", log=log)
    bad = torch_parity.failures(results)
    if bad:
        raise AssertionError("parity: " + "; ".join(bad))
    print(f"[parity] {len(results['entries'])} scene/route entries meet their bars, "
          f"{time.perf_counter() - t0:.1f} s; {card}", flush=True)
    floor, images = torch_parity_floor.run(log)
    print(f"[floor] A' bit-equal to A: {floor['a_prime_bit_equal']}", flush=True)
    bisect = torch_parity_bisect.run(log, cpu_image=images["g_cpu_wavefront"])
    dist = bisect["dist"]
    print(f"[bisect] distance entry: {dist['launches']} launches, max |diff| vs plain "
          f"{dist['max_abs_vs_plain']:.3e}, {dist['ms']:.4f} ms the nine codes "
          f"(plain {dist['plain_ms']:.4f} ms); {card}", flush=True)
    return dist


# tests/conftest.py's seed: the rays of the property tests.
PROPS_SEED = 20260816
PROPS_RAYS = 2048


def property_rays(dev):
    """tests/test_properties.py's 2,048 rays, drawn from a fresh generator
    with the tests' seed: from a shell around the scene to random scene
    points."""
    import numpy as np

    rng = np.random.default_rng(PROPS_SEED)
    origins = rng.uniform(-14, 14, size=(PROPS_RAYS, 3))
    origins[:, 1] = rng.uniform(0.5, 12, size=PROPS_RAYS)
    targets = rng.uniform(-7, 7, size=(PROPS_RAYS, 3))
    targets[:, 1] = rng.uniform(0.0, 3.0, size=PROPS_RAYS)
    dirs = targets - origins
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return (torch.as_tensor(origins, dtype=torch.float32, device=dev),
            torch.as_tensor(dirs, dtype=torch.float32, device=dev))


def bench_phase(dev, card):
    """Phase 16: the port's bench suite through its command line, then the
    reference's ray invariants on the CUDA scene kernel (see the module
    docstring). Raises on any failure."""
    import io

    from gpuraytracer_tpu_torch.accel import traverse
    from gpuraytracer_tpu_torch.apps import bench_suite
    from gpuraytracer_tpu_torch.core.types import RAY_TMAX, RAY_TMIN
    from gpuraytracer_tpu_torch.kernels import frame_kernel, scene_kernel
    from gpuraytracer_tpu_torch.models import builtin, scenes
    from gpuraytracer_tpu_torch.render import trace

    t0 = time.perf_counter()
    # out/ is gitignored; out/bench_suite.json itself is the reference's
    # committed TPU artifact, which this run must not overwrite.
    out_dir = os.path.join(ROOT, "out", "torch")
    os.makedirs(out_dir, exist_ok=True)
    one = "analytic_grid_720p"
    runs = [("round_end", ["--json", os.path.join(out_dir, "bench_suite.json")]),
            ("README, scale 0.25", ["--scale", "0.25", "--json",
                                    os.path.join(out_dir, "bench_suite_scale_0.25.json")]),
            ("warmup 2, chain 4", ["--configs", one, "--warmup", "2", "--chain", "4", "--json",
                                   os.path.join(out_dir, "bench_suite_chain4.json")]),
            ("no device time", ["--configs", one, "--no-device-time", "--json",
                                os.path.join(out_dir, "bench_suite_no_device_time.json")])]
    for label, argv in runs:
        args = bench_suite.build_parser().parse_args(argv)
        configs = ([scenes.get_config(n) for n in args.configs.split(",")] if args.configs
                   else list(scenes.BENCH_CONFIGS))
        timed = not args.no_device_time and args.chain > 1
        # Each window is a frame program (render/program.py): its build runs
        # one eager frame before the capture (one for each of the programs of
        # 1, --wall-chain and --chain frames), and every replayed frame counts
        # its launches as an eager frame does.
        programs = {1, args.wall_chain} | ({args.chain} if timed else set())
        frames_per_scene = (len(programs) + 1 + max(0, args.warmup - 1)
                            + args.reps * args.frames * (args.wall_chain + 1
                                                         + (args.chain if timed else 0)))
        fused = [trace.frame_route(c.build(c.width / c.height, 0.0, device=dev))[0] == "frame"
                 for c in configs]
        stdout = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(stdout):
            rc = bench_suite.main(argv)
        torch.cuda.synchronize()
        launched = frame_kernel.LAUNCHES
        with open(args.json[:-len(".json")] + ".txt", "w") as f:
            f.write(stdout.getvalue())
        if rc != 0:
            raise AssertionError(f"bench {label}: main exited {rc}")
        with open(args.json) as f:
            lines = json.load(f)
        if [line["config"] for line in lines] != [c.name for c in configs]:
            raise AssertionError(f"bench {label}: lines for {[x['config'] for x in lines]}")
        if launched != frames_per_scene * sum(fused):
            raise AssertionError(f"bench {label}: {launched} frame kernel launches, expected "
                                 f"{frames_per_scene} for each of {sum(fused)} scenes")
        for line, is_fused in zip(lines, fused):
            name = line["config"]
            missing = [k for k in bench_suite.REFERENCE_KEYS if k not in line]
            if missing:
                raise AssertionError(f"bench {label} {name}: no {missing}")
            device_keys = set(bench_suite.DEVICE_TIME_KEYS) | {"device_frame_ms_below_resolution"}
            if timed and not set(bench_suite.DEVICE_TIME_KEYS) <= set(line):
                raise AssertionError(f"bench {label} {name}: no device-time keys")
            if not timed and device_keys & set(line):
                raise AssertionError(f"bench {label} {name}: device-time keys under {argv}")
            if not (math.isfinite(line["frame_ms"]) and line["frame_ms"] > 0):
                raise AssertionError(f"bench {label} {name}: frame_ms {line['frame_ms']}")
            if is_fused and line["launches_per_frame"]["frame_kernel"] != 1.0:
                raise AssertionError(f"bench {label} {name}: launches per frame "
                                     f"{line['launches_per_frame']}")
            if not line["frame_ms_events"] <= line["frame_ms"] * 1.01:
                raise AssertionError(f"bench {label} {name}: frame_ms_events "
                                     f"{line['frame_ms_events']} past frame_ms {line['frame_ms']}")
            print(f"[bench] {label}: {name} {line['width']}x{line['height']} depth "
                  f"{line['max_depth']}: frame_ms {line['frame_ms']} (min {line['frame_ms_min']}, "
                  f"max {line['frame_ms_max']}), frame_ms_events {line['frame_ms_events']} "
                  f"(host's share {line['frame_ms'] - line['frame_ms_events']:.3f} ms/frame), "
                  f"frame_ms_1dispatch {line['frame_ms_1dispatch']}, device_frame_ms "
                  f"{line.get('device_frame_ms')}"
                  f"{' (below resolution)' if line.get('device_frame_ms_below_resolution') else ''}"
                  f", mrays_fps {line['mrays_fps']}, compile_s {line['compile_s']}, "
                  f"launches/frame {line['launches_per_frame']['frame_kernel']}; {card}",
                  flush=True)
    print(f"[bench] the bench's runs done in {time.perf_counter() - t0:.1f} s", flush=True)

    # The reference's ray invariants on the scene kernel's two passes.
    scene = builtin.build_scene(aspect=1.0, elapsed_time=1.3, device=dev)
    o, d = property_rays(dev)
    reset_counts()
    hit = traverse.closest_hit(o, d, scene)
    occluded = traverse.any_hit(o, d, scene)
    sky_o = torch.tensor([[0.0, 30.0, 0.0]], device=dev)
    sky_d = torch.tensor([[0.0, 1.0, 0.0]], device=dev)
    sky = builtin.build_scene(aspect=1.0, elapsed_time=0.0, device=dev)
    sky_hit = traverse.closest_hit(sky_o, sky_d, sky).hit
    sky_occ = traverse.any_hit(sky_o, sky_d, sky)
    torch.cuda.synchronize()
    if scene_kernel.LAUNCHES != 4:
        raise AssertionError(f"props: {scene_kernel.LAUNCHES} scene kernel launches, not 4")
    plain = traverse.closest_hit(o, d, scene, plain=True)
    plain_occ = traverse.any_hit(o, d, scene, plain=True)
    h, t, g = hit.hit, hit.t, hit.geometry_id
    lens = hit.normal[h].norm(dim=-1)
    broken = {
        "t outside [RAY_TMIN, RAY_TMAX] on a hit": int(((t[h] < RAY_TMIN) | (t[h] > RAY_TMAX)).sum()),
        "t != RAY_TMAX on a miss": int((t[~h] != RAY_TMAX).sum()),
        "normal not unit (1e-3)": int(((lens - 1).abs() > 1e-3).sum()),
        "gid outside the rows on a hit": int(((g[h] < 0) | (g[h] > scene.layout.plane_geometry_id))
                                             .sum()),
        "gid != -1 on a miss": int((g[~h] != -1).sum()),
        "hit but not occluded": int((h & ~occluded).sum()),
        "sky ray hit or occluded": int(sky_hit[0] | sky_occ[0]),
    }
    if not bool(h.any()):
        raise AssertionError("props: no random ray hit the scene")
    agree = g == plain.geometry_id
    print(f"[props] scene kernel, builtin t=1.3, {PROPS_RAYS} random rays (seed {PROPS_SEED}): "
          f"{int(h.sum())} hits (plain {int(plain.hit.sum())}), {int(occluded.sum())} occluded "
          f"(plain {int(plain_occ.sum())}); gid equal to the plain pass's on "
          f"{float(agree.float().mean()):.6f}, max |t diff| where equal "
          f"{float((t - plain.t)[agree].abs().max()):.3e}, occlusion equal on "
          f"{float((occluded == plain_occ).float().mean()):.6f}; max ||n| - 1| "
          f"{float((lens - 1).abs().max()):.3e}; rays breaking an invariant: {broken}", flush=True)
    if any(broken.values()):
        raise AssertionError(f"props: the scene kernel breaks an invariant: {broken}")
    print(f"[props] done; phase {time.perf_counter() - t0:.1f} s; {card}", flush=True)

# FLOPs of row 10 (csrc/frame_state.cu), counted as csrc/frame_math.cuh
# counts them (cos and sin one each): per instance R diag(scale) (9
# products), diag(1/scale) R^T (9 divisions) and the translation column (9
# products, 6 sums), and where it rotates the angle's product, cos and sin;
# the metaball thread's interpolant (fmod, the product by the reciprocal,
# the triangle wave's 3, the clamp's 2, smoothstep's 4) and the three
# lerped centres (27).
STATE_FLOPS_INSTANCE = 33
STATE_FLOPS_ROTATES = 3
STATE_FLOPS_METABALLS = 38
# Frames in each 320x180 program window of phase 17.
PROGRAM_WINDOW = 8


def eager_window(scene, animate, n, w, h, depth, keep=()):
    """The bench's window of n animated frames as eager frames through the
    same kernels (animate, pack_frame and render_frame per frame, frame_t(i)
    as the window program's times): (checksum, per-frame sums, the kept
    frames' images)."""
    from gpuraytracer_tpu_torch.accel.instances import Scene
    from gpuraytracer_tpu_torch.apps import bench_suite
    from gpuraytracer_tpu_torch.render import trace

    acc = torch.zeros((), dtype=torch.float32, device=scene.arrays.aabb_min.device)
    sums, images = [], []
    for i, t in enumerate(bench_suite.frame_times(n)):
        img = trace.render_frame(Scene(scene.layout, animate(scene.arrays, t)), w, h,
                                 max_depth=depth)
        total = torch.sum(img)
        acc = acc + total
        sums.append(total)
        if i in keep:
            images.append(img)
    return acc, torch.stack(sums), images


def window_times(call, n, windows=4, reps=3):
    """(host-clock ms/frame, CUDA-event ms/frame), medians over ``reps``:
    ``windows`` calls of an n-frame window issued back to back, then each
    window's checksum read (the bench's _timed_window)."""
    import statistics

    host, events = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        outs = [call() for _ in range(windows)]
        end.record()
        for out in outs:
            float(out[0] if isinstance(out, tuple) else out)
        host.append((time.perf_counter() - t0) * 1e3 / (windows * n))
        end.synchronize()
        events.append(start.elapsed_time(end) / (windows * n))
    return statistics.median(host), statistics.median(events)


def programs_phase(dev, card, frame_ms):
    """Phase 17: frame programs (render/program.py) and row 10
    (kernels/frame_state.py) on the card (see the module docstring). Returns
    row 10's entry of the kernels line; raises on any failure."""
    import dataclasses

    import numpy as np

    from gpuraytracer_tpu_torch.accel.instances import Scene
    from gpuraytracer_tpu_torch.apps import bench_suite
    from gpuraytracer_tpu_torch.kernels import frame_kernel, frame_state
    from gpuraytracer_tpu_torch.models import builtin, meshes, scenes
    from gpuraytracer_tpu_torch.render import program, trace
    from gpuraytracer_tpu_torch.utils import profile

    t_phase = time.perf_counter()
    if program.knobs():
        raise AssertionError(f"programs: knobs left set by an earlier phase: {program.knobs()}")
    # (a) row 10 against its plain version, every field of the buffer bit for
    # bit, at 64 times (the bench's first 32, the metaball cycle's turning
    # point, 31 seeded in [0, 40)) of builtin and each bench scene.
    rng = np.random.default_rng(17)
    times_h = np.asarray([0.033 * i for i in range(32)] + [6.0]
                         + list(rng.uniform(0.0, 40.0, 31)), dtype=np.float32)
    times = torch.from_numpy(times_h).to(dev)
    cases = [("builtin", builtin.build_scene(aspect=W_MAIN / H_MAIN, device=dev),
              builtin.animate_arrays)]
    cases += [(c.name, c.build(c.width / c.height, 0.0, device=dev), c.builder().animator())
              for c in scenes.BENCH_CONFIGS]
    reset_counts()
    for name, scene, animate in cases:
        base = frame_kernel.pack_static(scene)
        differ = 0
        for i in range(times.shape[0]):
            k = dataclasses.replace(base, params=base.params.clone())
            p = dataclasses.replace(base, params=base.params.clone())
            frame_state.advance(k, animate, scene.arrays, times, i)
            frame_state.advance_plain(p, animate, scene.arrays, times, i)
            if not torch.equal(k.params, p.params):
                differ += 1
                print(f"[programs] row 10 {name} t={float(times_h[i])}: {int((k.params != p.params).sum())} "
                      f"floats differ, max |diff| {float((k.params - p.params).abs().max()):.3g}",
                      flush=True)
        print(f"[programs] row 10 {name}, {pack_fields(base)} per-frame floats, {times.shape[0]} "
              f"times: {times.shape[0] - differ} of {times.shape[0]} buffers bit-equal to the plain "
              f"version's", flush=True)
        if differ:
            raise AssertionError(f"row 10 differs from its plain version on {name}")
    if frame_state.LAUNCHES != times.shape[0] * len(cases):
        raise AssertionError(f"row 10: {frame_state.LAUNCHES} launches")
    name, scene, animate = cases[0]
    pack = frame_kernel.pack_static(scene)
    state_ms, _ = cuda_ms(lambda: frame_state.advance(pack, animate, scene.arrays, times, 8),
                          SHORT_REPS)
    state_plain_ms, _ = cuda_ms(
        lambda: frame_state.advance_plain(pack, animate, scene.arrays, times, 8), 20)
    g = pack.num_geometries
    rotating = sum(1 for row in animate.table if row[1])
    state_bytes = 4 * (g * frame_state.STATE_STRIDE + len(frame_state.METABALL_TABLE) + 1
                       + 1 + 21 * g + 12)
    state_ops = STATE_FLOPS_INSTANCE * g + STATE_FLOPS_ROTATES * rotating + STATE_FLOPS_METABALLS
    state_bound, state_bound_by = bound(state_bytes, state_ops)
    print(f"[programs] row 10 builtin ({g} instances, {rotating} rotating): {state_ms:.4f} ms a "
          f"launch (CUDA events, {SHORT_REPS} launches; {state_ops} FLOPs, {state_bytes} bytes: "
          f"bound {state_bound:.6f} ms by {state_bound_by}); plain {state_plain_ms:.4f} ms; "
          f"library none; {card}", flush=True)

    def report(label, prog, n, eager_call, kernel_note, traced=True):
        """Time a built program's windows beside the eager window's, trace
        one window for the busy share (unless ``traced`` is False), print
        the program's line."""
        ms, ms_ev = window_times(prog, n)
        e_ms, e_ev = window_times(eager_call, n)
        summary = {"busy_ms": 0.0}
        busy = ("not measured: a torch.profiler (CUPTI) trace of a replay whose gate launches "
                "the frame kernel from the device stops the card with an illegal instruction")
        if traced:
            slug = "".join(ch if ch.isalnum() else "_" for ch in label)
            prof_dir = os.path.join(ROOT, "build", "chip_smoke_programs", slug)
            torch.cuda.synchronize()
            with profile.trace(prof_dir):
                prog()
                torch.cuda.synchronize()
            summary = profile.device_summary(os.path.join(prof_dir, profile.TRACE_FILE))
            busy = (f"{summary['busy_share']:.4f} ({summary['busy_ms'] / n:.4f} ms of device "
                    f"work a frame)" if summary["busy_ms"] > 0
                    else "not measured (no device time traced)")
        nodes = (f"{prog.nodes} graph nodes ({prog.nodes / n:.2f} a frame)" if prog.nodes
                 else "graph nodes not measured")
        per_frame = dict(sorted((f"{mod.__name__.rsplit('.', 1)[1]}.{name}", d / n)
                                for (mod, name), d in prog.deltas.items()))
        print(f"[programs] {label}, {n}-frame window: {nodes}, private pool peak "
              f"{prog.pool_peak_bytes} bytes; program {ms:.4f} ms/frame by the host clock, "
              f"{ms_ev:.4f} by CUDA events; eager window {e_ms:.4f} / {e_ev:.4f}; "
              f"{kernel_note}; busy share of the traced program window {busy}; "
              f"launches a frame {per_frame}; "
              f"{card}", flush=True)
        return dict(ms=ms, ms_events=ms_ev, eager_ms=e_ms, eager_ms_events=e_ev,
                    nodes=prog.nodes, pool=prog.pool_peak_bytes,
                    busy=summary["busy_share"] if summary["busy_ms"] > 0 else None)

    def check(label, scene, animate, n, w, h, depth, keep):
        """Build the window program, replay it under
        set_sync_debug_mode("error") with the counts at 0, and hold every
        frame's checksum and the kept images to the eager frames bit for
        bit. Returns (program, counts of the replay)."""
        prog = bench_suite.window_program(scene, animate, n, animated=True, width=w, height=h,
                                          max_depth=depth, keep=keep)
        t0 = time.perf_counter()
        prog.build()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        reset_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            acc, sums, *images = prog()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        launched = (counts(), frame_state.LAUNCHES, mode_counts())
        e_acc, e_sums, e_images = eager_window(scene, animate, n, w, h, depth, keep)
        equal_sums = int((sums == e_sums).sum())
        equal_images = [bool(torch.equal(a, b)) for a, b in zip(images, e_images)]
        print(f"[programs] {label} {w}x{h} depth {depth}: built in {build_s:.2f} s; one replay "
              f"of {n} frames under set_sync_debug_mode('error'): checksums bit-equal to the "
              f"eager frames' on {equal_sums} of {n} frames (window sum {float(acc)!r} vs "
              f"{float(e_acc)!r}), frames {list(keep)} bit-equal {equal_images}", flush=True)
        if equal_sums != n or not all(equal_images) or not torch.equal(acc, e_acc):
            raise AssertionError(f"programs: {label} differs from its eager frames")
        return prog, launched

    # (b) the main path's window: builtin 1080p, 64 frames.
    b_scene = builtin.build_scene(aspect=W_MAIN / H_MAIN, device=dev)
    prog, (launched, states, _) = check("builtin", b_scene, builtin.animate_arrays, FRAMES,
                                        W_MAIN, H_MAIN, 3, (0, FRAMES // 2 - 1, FRAMES - 1))
    if launched != (FRAMES, 0, 0, 0, 0) or states != FRAMES:
        raise AssertionError(f"programs: builtin window launched {launched}, {states} row 10")
    state_launches = states
    # (d) a replay runs no eager frame: the frame entry and row 10's wrapper
    # raise if called while the program replays.
    saved = trace.render_frame, frame_state.advance

    def refuse(*args, **kwargs):
        raise AssertionError("a replay ran an eager frame")

    trace.render_frame = frame_state.advance = refuse
    try:
        out = prog()
        torch.cuda.synchronize()
    finally:
        trace.render_frame, frame_state.advance = saved
    print(f"[programs] builtin 1080p replay with trace.render_frame and frame_state.advance "
          f"patched to raise: ran (checksum {float(out[0])!r})", flush=True)
    results = {"builtin 1080p": report(
        "builtin 1080p", prog, FRAMES,
        lambda: eager_window(b_scene, builtin.animate_arrays, FRAMES, W_MAIN, H_MAIN, 3)[0],
        f"frame kernel alone {frame_ms:.4f} ms (phase 6)")}
    prog.close()

    # (c) every other route and mode at 320x180.
    w, h = 320, 180
    hf = meshes.get_config("mesh_heightfield_sdf")
    cases = [("compact", None, {"GPURT_FRAME_MODE": "compact"}),
             ("compact overflowing (GPURT_COMPACT_BUDGET=1)", None,
              {"GPURT_FRAME_MODE": "compact", "GPURT_COMPACT_BUDGET": "1"}),
             ("defer", None, {"GPURT_FRAME_MODE": "defer"}),
             ("merged (GPURT_MERGED_SHADOW=1)", None, {"GPURT_MERGED_SHADOW": "1"}),
             ("scene-kernel route (GPURT_DISABLE_FUSED=1)", None, {"GPURT_DISABLE_FUSED": "1"}),
             ("per-geometry route (mesh_heightfield_sdf)", hf, {})]
    for label, cfg, knobs in cases:
        with env(**knobs):
            if cfg is None:
                scene, animate, depth = (builtin.build_scene(aspect=w / h, device=dev),
                                         builtin.animate_arrays, 3)
            else:
                b = cfg.builder()
                scene, animate, depth = b.build(w / h, 0.0, device=dev), b.animator(), cfg.max_depth
            route = trace.frame_route(scene)
            prog, (launched, states, modes) = check(label, scene, animate, PROGRAM_WINDOW, w, h,
                                                    depth, (0, PROGRAM_WINDOW - 1))
            if states != PROGRAM_WINDOW or modes["syncs"]:
                raise AssertionError(f"programs: {label}: {states} row 10 launches, "
                                     f"{modes['syncs']} host syncs")
            if "GPURT_COMPACT_BUDGET" in knobs:
                pack = frame_kernel.pack_frame(Scene(scene.layout, animate(scene.arrays, 0.0)))
                _, queued = frame_kernel.render_frame_compact(pack, width=w, height=h,
                                                              max_depth=depth, debug_count=True)
                if not queued.overflow or modes["gated"] != PROGRAM_WINDOW:
                    raise AssertionError(f"programs: {label}: no overflow ({int(queued)} queued, "
                                         f"{modes})")
                print(f"[programs] {label}: frame 0 queues {int(queued)} pixels past the "
                      f"capacity {frame_kernel.queue_capacity(w, h)}: the gate under capture "
                      f"launched the plain frame kernel from the device", flush=True)
            results[label] = report(label, prog, PROGRAM_WINDOW,
                                    lambda: eager_window(scene, animate, PROGRAM_WINDOW, w, h,
                                                         depth)[0],
                                    f"route {route}", traced="GPURT_COMPACT_BUDGET" not in knobs)
            prog.close()
    print(f"[programs] every program bit-equal to its eager frames, "
          f"{time.perf_counter() - t_phase:.1f} s; {card}", flush=True)
    return {
        "name": "frame_state",
        "route": "cuda",
        "source": "gpuraytracer_tpu_torch/kernels/csrc/frame_state.cu",
        "replaces": "gpuraytracer_tpu/models/builtin.py:306",
        "launches": state_launches,
        "max_abs_err": 0.0,
        "ms": state_ms,
        "plain_ms": state_plain_ms,
        "bound_ms": state_bound,
        "bound_by": state_bound_by,
        "library_ms": None,
        "programs": results,
    }


def pack_fields(pack):
    """Floats of a pack's per-frame fields (kernels/frame_kernel.frame_fields)."""
    return 1 + 21 * pack.num_geometries + 12


def main() -> int:
    # 1. device -------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    import numpy as np

    from gpuraytracer_tpu_torch.accel import traverse
    from gpuraytracer_tpu_torch.accel.instances import Scene
    from gpuraytracer_tpu_torch.core import camera as cam
    from gpuraytracer_tpu_torch.core import hlsl
    from gpuraytracer_tpu_torch.geometry import sdf
    from gpuraytracer_tpu_torch.kernels import (build, frame_kernel, megakernel, op_probe,
                                                scene_kernel, wavefront)
    from gpuraytracer_tpu_torch.models import builtin, scenes
    from gpuraytracer_tpu_torch.render import trace
    from gpuraytracer_tpu_torch.render.renderer import Renderer
    from tools.torch_parity import fmad_build

    # The plain version keeps explicit row math, but pin full-f32 matrix
    # products and convolutions anyway so no reference step runs in TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    print(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    def golden(name):
        path = os.path.join(ROOT, "tests", f"golden_{name}_96x54_t0p7.npz")
        return torch.from_numpy(np.load(path)["image"])

    # 2. build --------------------------------------------------------------
    with Phase("build"):
        builds = [(name, fmad, count)
                  for name in ("frame_kernel", "scene_kernel", "megakernel")
                  for fmad, count in ((build.DEFAULT_FMAD, False), (not build.DEFAULT_FMAD, False),
                                      (build.DEFAULT_FMAD, True))]
        builds.append(("op_probe", build.DEFAULT_FMAD, False))
        builds += [("wavefront", fmad, False) for fmad in (build.DEFAULT_FMAD,
                                                          not build.DEFAULT_FMAD)]
        builds += [(name, build.DEFAULT_FMAD, False, True) for name in ("frame_kernel",
                                                                        "scene_kernel",
                                                                        "megakernel")]
        # The megakernel's unculled face loop (-DGPRT_FACE_LOOP_GLOBAL): what
        # phase 9 holds the shipped loop to, in both contraction modes, and
        # its operation count.
        builds += [("megakernel", fmad, count, False, True)
                   for fmad, count in ((build.DEFAULT_FMAD, False),
                                       (not build.DEFAULT_FMAD, False),
                                       (build.DEFAULT_FMAD, True))]
        # The repair's whole traversal (-DGPRT_REPAIR_FULL, the parent's
        # repair): what phase 10 holds the resumed repair to in both
        # contraction modes and times it beside, its operation count (the
        # work the resumption removes) and its SIMT efficiency (phase 12).
        builds += [("scene_kernel", fmad, count, simt, False, True)
                   for fmad, count, simt in ((build.DEFAULT_FMAD, False, False),
                                             (not build.DEFAULT_FMAD, False, False),
                                             (build.DEFAULT_FMAD, True, False),
                                             (build.DEFAULT_FMAD, False, True))]
        # The two-phase finisher over its queue (both contraction modes, the
        # op-counting build, and the parent's one thread per ray,
        # -DGPRT_FINISH_PER_RAY, that phase 11 holds it to) and the overflow
        # gate with its device-side launch (-ewp, cudadevrt; both
        # contraction modes, as phase 10 runs the modes).
        builds += [("scene_finish", fmad, count)
                   for fmad, count in ((build.DEFAULT_FMAD, False), (not build.DEFAULT_FMAD, False),
                                       (build.DEFAULT_FMAD, True))]
        builds.append(("scene_finish", build.DEFAULT_FMAD, False, False, False, False, True))
        # Row 7's generic march (-DGPRT_SPHERE_MARCH_GENERIC, the parent's),
        # which phase 9 holds the specialized march to and times beside it;
        # row 8's parent bf16 form, one element a thread
        # (-DGPRT_PROBE_BF16_SCALAR), which phase 11 holds the packed pairs to.
        builds.append(("megakernel", build.DEFAULT_FMAD, False, False, False, False, False,
                       megakernel.GENERIC_DEFINES))
        builds.append(("op_probe", build.DEFAULT_FMAD, False, False, False, False, False,
                       op_probe.SCALAR_DEFINES))
        builds += [("frame_gate", fmad, False) for fmad in (build.DEFAULT_FMAD,
                                                            not build.DEFAULT_FMAD)]
        # Row 10, the frame programs' per-frame state (always --fmad=false).
        builds.append(("frame_state", build.DEFAULT_FMAD, False))
        reports = build.compile_all(builds)
        registers, spills = {}, {}
        for (name, fmad, count, *rest), report in reports.items():
            simt, unculled, full, per_ray = (rest + [False] * 4)[:4]
            defines = rest[4] if len(rest) > 4 else ()
            print(f"[build] {name}.cu fmad={fmad}{' count_ops' if count else ''}"
                  f"{' count_simt' if simt else ''}{' faces_global' if unculled else ''}"
                  f"{' repair_full' if full else ''}{' finish_per_ray' if per_ray else ''}"
                  f"{''.join(' -D' + m for m in defines)}: {ptxas_summary(report)}", flush=True)
            if fmad == build.DEFAULT_FMAD and not (count or simt or unculled or full or per_ray
                                                   or defines):
                # frame_gate.cu holds its own build of the frame kernel.
                prefix = "frame_gate.cu " if name == "frame_gate" else ""
                registers.update({prefix + k: v for k, v in ptxas_registers(report).items()})
                spills.update({prefix + k: v for k, v in ptxas_spill_stores(report).items()})

    # 3. the fractals' device distance functions, before any render ----------
    with Phase("probe"):
        gen = torch.Generator().manual_seed(7)
        pts = (torch.rand(65536, 3, generator=gen) * 2.2 - 1.1).to(dev)
        for code in (7, 8):
            got = scene_kernel.sdf_distance(code, pts)
            want = sdf.DISTANCE_FUNCTIONS[code](pts)
            rel = (got - want).abs() / want.abs().clamp(min=1e-6)
            far = float((rel > 1e-4).float().mean())
            print(f"[probe] distance code {code} at 65536 points in [-1.1, 1.1]^3: exact "
                  f"{float((got == want).float().mean()):.6f}, rel diff > 1e-4 on {far:.6f}, "
                  f"max |diff| {float((got - want).abs().max()):.6g}", flush=True)
            if far > 0.01 or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"distance code {code} disagrees with its plain version")

    # 4. frame kernel vs plain at 320x180 -------------------------------------
    with Phase("plain"):
        w, h = 320, 180
        pack = frame_kernel.pack_frame(builtin.build_scene(aspect=w / h, elapsed_time=0.7, device=dev))
        img = frame_kernel.render_frame_tiles(pack, width=w, height=h)
        plain = frame_kernel.render_frame_plain(pack, width=w, height=h)
        ok, frac, tight, max_err = bar(img, plain)
        print(f"[plain] kernel vs plain 320x180 t=0.7: flipped {frac:.6f} (bar < 0.02), "
              f"within 1e-5 {tight:.6f} (bar > 0.75), max |diff| {max_err:.6g}", flush=True)
        if not ok:
            raise AssertionError("frame kernel disagrees with its plain version")
        pack_320, plain_320 = pack, plain

    # 5. frame kernel vs golden at 96x54 --------------------------------------
    with Phase("golden"):
        pack_g = frame_kernel.pack_frame(builtin.build_scene(aspect=96 / 54, elapsed_time=0.7, device=dev))
        rates = {}
        for fmad in (build.DEFAULT_FMAD, not build.DEFAULT_FMAD):
            out = frame_kernel.render_frame_tiles(pack_g, width=96, height=54,
                                                  lib=build.load("frame_kernel", fmad=fmad))
            rates[fmad] = bar(out, golden("builtin"))
        ok, frac, tight, _ = rates[build.DEFAULT_FMAD]
        alt = rates[not build.DEFAULT_FMAD]
        print(f"[golden] kernel vs golden 96x54: fmad={build.DEFAULT_FMAD} (shipped) flipped "
              f"{frac:.6f} within-1e-5 {tight:.6f}; fmad={not build.DEFAULT_FMAD} flipped "
              f"{alt[1]:.6f} within-1e-5 {alt[2]:.6f}", flush=True)
        if not ok:
            raise AssertionError("frame kernel disagrees with the golden image")

    # 6. main path: Renderer at 1920x1080, 64 animated frames -----------------
    with Phase("main"):
        ms_frame, launched, bg_max = animated_window(
            Renderer(W_MAIN, H_MAIN, device=dev), dev, "builtin 1080p", W_MAIN, H_MAIN)
        if launched != (FRAMES, 0, 0, 0, 0):
            raise AssertionError(f"{launched} launches for {FRAMES} frames")
        frame_launches = f_launch = launched[0]
        scene = builtin.animate_arrays(
            builtin.build_scene(aspect=W_MAIN / H_MAIN, device=dev).arrays, 0.0333 * 8)
        pack_m = frame_kernel.pack_frame(Scene(builtin.LAYOUT, scene))
        frame_ms, kimg = cuda_ms(
            lambda: frame_kernel.render_frame_tiles(pack_m, width=W_MAIN, height=H_MAIN), 10)
        ops = torch.zeros(1, dtype=torch.int64, device=dev)
        frame_kernel.render_frame_tiles(pack_m, width=W_MAIN, height=H_MAIN, ops=ops,
                                        lib=build.load("frame_kernel", count_ops=True))
        frame_ops = int(ops.item())
        frame_bytes = (pack_m.params.numel() + pack_m.layout.numel()) * 4 + W_MAIN * H_MAIN * 16
        frame_bound, frame_bound_by = bound(frame_bytes, frame_ops)
        frame_plain_ms, pimg = cuda_ms(
            lambda: frame_kernel.render_frame_plain(pack_m, width=W_MAIN, height=H_MAIN), 1,
            warmup=False)
        ok, frac, tight, frame_err = bar(kimg, pimg)
        plain_m, main_img = pimg, kimg
        print(f"[main] kernel vs plain 1920x1080 t={0.0333 * 8:.4f}: flipped {frac:.6f}, "
              f"within 1e-5 {tight:.6f}, max |diff| {frame_err:.6g}", flush=True)
        if not ok:
            raise AssertionError("frame kernel disagrees with its plain version at 1080p")
        resident = {"frame_kernel": frame_kernel.residency(pack_m)}
        with env(GPURT_MERGED_SHADOW="1"):
            resident["frame_kernel_merged"] = frame_kernel.residency(pack_m)
        resident["scene_kernel"] = scene_kernel.residency(pack_m)
        print(f"[main] resident blocks (per SM, in all): {resident}; registers: " + ", ".join(
            f"{k} {registers.get(k)}" for k in ("frame_kernel<false, true>", "frame_kernel<true, true>",
                                                "scene_kernel<false, true>")), flush=True)
        print(f"[main] Renderer 1920x1080, {FRAMES} frames t=0.0333k: {f_launch} frame kernel "
              f"launches, all finite, background <= {bg_max:.3f}; {ms_frame:.3f} ms/frame, "
              f"{W_MAIN * H_MAIN / ms_frame / 1e3:.3f} Mrays/s (W*H*fps/1e6); kernel alone "
              f"{frame_ms:.3f} ms ({frame_ops} f32 FLOPs, {frame_bytes} bytes: bound "
              f"{frame_bound:.4f} ms by {frame_bound_by}); plain wavefront "
              f"{frame_plain_ms:.1f} ms/frame; {card}", flush=True)

    # 7. the five bench scenes through the frame kernel ------------------------
    with Phase("suite"):
        for cfg in scenes.BENCH_CONFIGS:
            reset_counts()
            img = trace.render_frame(cfg.build(96 / 54, 0.7, device=dev), 96, 54,
                                     max_depth=cfg.max_depth)
            if counts() != (1, 0, 0, 0, 0):
                raise AssertionError(f"{cfg.name}: 96x54 frame launched {counts()}")
            ok, frac, tight, _ = bar(img, golden(cfg.name))
            print(f"[suite] {cfg.name} 96x54 vs golden: flipped {frac:.6f}, within 1e-5 "
                  f"{tight:.6f}", flush=True)
            if not ok:
                raise AssertionError(f"{cfg.name}: frame kernel disagrees with the golden")
            pack_s = frame_kernel.pack_frame(cfg.build(320 / 180, 0.7, device=dev))
            img = frame_kernel.render_frame_tiles(pack_s, width=320, height=180,
                                                  max_depth=cfg.max_depth)
            t0 = time.perf_counter()
            plain = frame_kernel.render_frame_plain(pack_s, width=320, height=180,
                                                    max_depth=cfg.max_depth)
            torch.cuda.synchronize()
            ok, frac, tight, err = bar(img, plain)
            print(f"[suite] {cfg.name} 320x180 kernel vs plain: flipped {frac:.6f}, within "
                  f"1e-5 {tight:.6f}, max |diff| {err:.6g} (plain {time.perf_counter() - t0:.1f} s)",
                  flush=True)
            if not ok:
                raise AssertionError(f"{cfg.name}: frame kernel disagrees with its plain version")
            renderer = Renderer(cfg.width, cfg.height, device=dev, scene_factory=cfg.build,
                                animate=cfg.builder().animator(), max_depth=cfg.max_depth)
            ms, launched, bg_max = animated_window(renderer, dev, cfg.name, cfg.width, cfg.height)
            if launched != (FRAMES, 0, 0, 0, 0):
                raise AssertionError(f"{cfg.name}: {launched} launches for {FRAMES} frames")
            pack_f = frame_kernel.pack_frame(cfg.build(cfg.width / cfg.height, 0.0333 * 8,
                                                       device=dev))
            kernel_ms, _ = cuda_ms(lambda: frame_kernel.render_frame_tiles(
                pack_f, width=cfg.width, height=cfg.height, max_depth=cfg.max_depth), 10)
            print(f"[suite] {cfg.name} {cfg.width}x{cfg.height} depth {cfg.max_depth}, {FRAMES} "
                  f"frames: {launched[0]} frame kernel launches, background <= {bg_max:.3f}; "
                  f"{ms:.3f} ms/frame, {cfg.width * cfg.height / ms / 1e3:.3f} Mrays/s; kernel "
                  f"alone {kernel_ms:.3f} ms; {card}", flush=True)

    # 8. the scene kernel (GPURT_DISABLE_FUSED=1) ------------------------------
    os.environ["GPURT_DISABLE_FUSED"] = "1"
    with Phase("scene"):
        scene_err = 0.0

        def check_batch(label, scene_b, pack_b, o, d, active, level, accept_first):
            """The shipped scene kernel and its no-contraction build against
            the plain version on one batch."""
            nonlocal scene_err
            hit_p, ob, db, act, t0 = traverse.pass_inputs(o, d, scene_b, active=active,
                                                          occlusion=accept_first)
            pt, _, pg = scene_kernel.scene_closest_plain(scene_b, ob, db, act, t0, level=level,
                                                         accept_first=accept_first)
            line = []
            for fmad in (build.DEFAULT_FMAD, not build.DEFAULT_FMAD):
                kt, _, kg = scene_kernel.scene_closest_tiles(
                    scene_b, ob, db, act, t0, level=level, accept_first=accept_first,
                    pack=pack_b, lib=build.load("scene_kernel", fmad=fmad))
                same = kg == pg
                dt = (kt - pt).abs()[same & (pg >= 0)]
                agree = float(same.float().mean())
                close = float((dt <= 1e-3).float().mean()) if dt.numel() else 1.0
                dt_max = float(dt.max()) if dt.numel() else 0.0
                line.append(f"fmad={fmad}: gid agrees on {agree:.6f}, |dt| <= 1e-3 on {close:.6f} "
                            f"of those hits, max |dt| {dt_max:.6g}")
                if fmad == build.DEFAULT_FMAD:
                    # Contraction moves a crossing by a march step on a few rays.
                    scene_err = max(scene_err, dt_max)
                    ok = agree >= 0.98 and close >= 0.98
                else:
                    # Without contraction the kernel repeats the plain arithmetic.
                    ok = ok and agree >= 0.98 and dt_max <= 1e-3
            print(f"[scene] {label}: {int(act.sum())} live rays, {int((pg >= 0).sum())} plain "
                  f"hits; " + "; ".join(line), flush=True)
            if not ok:
                raise AssertionError(f"{label}: scene kernel disagrees with its plain version")

        w, h = 320, 180
        for name in ("builtin", "sdf_primitives_720p", "fractal_mandelbulb_julia_1080p"):
            scene_b = (builtin.build_scene(aspect=w / h, elapsed_time=0.7, device=dev)
                       if name == "builtin" else
                       scenes.get_config(name).build(w / h, 0.7, device=dev))
            pack_b = frame_kernel.pack_frame(scene_b)
            px, py = cam.pixel_grid(w, h, dev)
            c = scene_b.arrays.constants
            o, d = cam.generate_camera_rays(px, py, w, h, c.camera_position, c.projection_to_world)
            o, d = o.reshape(-1, 3), d.reshape(-1, 3)
            hit = traverse.closest_hit(o, d, scene_b, level=0, plain=True)
            hp = o + hit.t[:, None] * d
            shadow = hlsl.normalize(c.light_position[:3] - hp)
            refl = hlsl.reflect(d, hit.normal)
            check_batch(f"{name} camera rays, closest, level 0", scene_b, pack_b, o, d, None, 0,
                        False)
            check_batch(f"{name} reflection rays, closest, level 1", scene_b, pack_b, hp, refl,
                        hit.hit, 1, False)
            for level in (0, 1):
                check_batch(f"{name} shadow rays, accept-first, level {level}", scene_b, pack_b,
                            hp, shadow, hit.hit, level, True)

        scene_s = builtin.build_scene(aspect=w / h, elapsed_time=0.7, device=dev)
        reset_counts()
        img = trace.render_frame(scene_s, w, h)
        torch.cuda.synchronize()
        if counts() != (0, 5, 0, 0, 0):
            raise AssertionError(f"builtin 320x180 wavefront frame launched {counts()}")
        pack_s = frame_kernel.pack_frame(scene_s)
        for label, ref in (("frame kernel", frame_kernel.render_frame_tiles(pack_s, width=w, height=h)),
                           ("plain", frame_kernel.render_frame_plain(pack_s, width=w, height=h))):
            ok, frac, tight, err = bar(img, ref)
            print(f"[scene] builtin 320x180 wavefront + scene kernel vs {label}: flipped "
                  f"{frac:.6f}, within 1e-5 {tight:.6f}, max |diff| {err:.6g}", flush=True)
            if not ok:
                raise AssertionError(f"scene-kernel frame disagrees with the {label}")

        # The wavefront's device form (render/trace.render_lanes): every frame
        # of the window with each synchronizing torch call an error. The
        # plain versions above leave large blocks in the allocator's cache:
        # released first, and the allocator's retries (a cudaFree and a
        # retried cudaMalloc each) counted over the window.
        torch.cuda.empty_cache()
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        ms_scene_frame, launched, bg_max = animated_window(
            Renderer(W_MAIN, H_MAIN, device=dev), dev, "builtin 1080p wavefront", W_MAIN, H_MAIN,
            sync_error=True)
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
        lane_launches = wavefront.launches()
        if launched != (0, 5 * FRAMES, 0, 0, 0) or lane_launches != LANE_LAUNCHES:
            raise AssertionError(f"builtin 1080p wavefront: {launched} launches and lane "
                                 f"kernels {lane_launches} for {FRAMES} frames (expected 0 "
                                 f"frame, {5 * FRAMES} scene, {LANE_LAUNCHES})")
        scene_launches = launched[1]
        print(f"[scene] Renderer 1920x1080 with GPURT_DISABLE_FUSED=1, {FRAMES} frames under "
              f"set_sync_debug_mode('error'): 0 host syncs; {launched[1]} scene kernel launches "
              f"(3 closest + 2 occlusion per frame), lane kernels {lane_launches}, "
              f"background <= {bg_max:.3f}; allocator retries {retries}; {ms_scene_frame:.3f} ms/frame, "
              f"{W_MAIN * H_MAIN / ms_scene_frame / 1e3:.3f} Mrays/s; frame-kernel path "
              f"{ms_frame:.3f} ms/frame in phase 6; {card}", flush=True)
        # The same 1080p frame as phase 6's, against its plain version there
        # (the compacted wavefront with plain passes).
        img = trace.render_frame(Scene(builtin.LAYOUT, scene), W_MAIN, H_MAIN)
        ok, frac, tight, err = bar(img, plain_m)
        print(f"[scene] builtin 1920x1080 t={0.0333 * 8:.4f} device wavefront vs the plain "
              f"wavefront: flipped {frac:.6f}, within 1e-5 {tight:.6f}, max |diff| {err:.6g}",
              flush=True)
        if not ok:
            raise AssertionError("1080p device wavefront disagrees with the plain wavefront")
        # The lane kernels compute each level as the frame kernel does (the
        # same expressions; csrc/shading.cuh, csrc/wavefront.cu) and the
        # scene kernel its traversal: the frame kernel's frame of phase 6,
        # compared bit for bit.
        exact, flips, err = exactness(img, main_img)
        print(f"[scene] builtin 1920x1080 device wavefront vs the frame kernel's frame: bit-equal "
              f"{exact:.6f}, flipped {flips:.6f}, max |diff| {err:.6g}", flush=True)
        lane_rows, lane_passes = lane_kernels("builtin (scene kernel)", Scene(builtin.LAYOUT, scene),
                                              pack_m, "scene", card)

        # The main path's largest pass: 1080p camera rays, closest, level 0.
        scene_m = Scene(builtin.LAYOUT, scene)
        px, py = cam.pixel_grid(W_MAIN, H_MAIN, dev)
        c = scene_m.arrays.constants
        o, d = cam.generate_camera_rays(px, py, W_MAIN, H_MAIN, c.camera_position,
                                        c.projection_to_world)
        _, ob, db, act, t0 = traverse.pass_inputs(o.reshape(-1, 3), d.reshape(-1, 3), scene_m)
        n = ob.shape[0]
        scene_ms, (kt, _, kg) = cuda_ms(
            lambda: scene_kernel.scene_closest_tiles(scene_m, ob, db, act, t0, pack=pack_m), 10)
        ops.zero_()
        scene_kernel.scene_closest_tiles(scene_m, ob, db, act, t0, pack=pack_m, ops=ops,
                                         lib=build.load("scene_kernel", count_ops=True))
        scene_ops = int(ops.item())
        scene_bytes = n * (29 + 20) + (pack_m.params.numel() + pack_m.layout.numel()) * 4
        scene_bound, scene_bound_by = bound(scene_bytes, scene_ops)
        scene_plain_ms, (pt, _, pg) = cuda_ms(
            lambda: scene_kernel.scene_closest_plain(scene_m, ob, db, act, t0), 1, warmup=False)
        same = kg == pg
        dts = (kt - pt).abs()[same & (pg >= 0)]
        dt, close = float(dts.max()), float((dts <= 1e-3).float().mean())
        scene_err = max(scene_err, dt)
        print(f"[scene] 1080p camera rays, closest, level 0 ({n} rays): gid agrees on "
              f"{float(same.float().mean()):.6f}, |dt| <= 1e-3 on {close:.6f} of those hits, "
              f"max |dt| {dt:.6g}; kernel {scene_ms:.3f} ms "
              f"({scene_ops} f32 FLOPs, {scene_bytes} bytes: bound {scene_bound:.4f} ms by "
              f"{scene_bound_by}); plain {scene_plain_ms:.1f} ms; {card}", flush=True)
        if float(same.float().mean()) < 0.98 or close < 0.98:
            raise AssertionError("1080p pass: scene kernel disagrees with its plain version")

        # The 1,600-instance frame at depth 2 (closest, shadow and reflection
        # queries on the global-memory tables): its plain version runs
        # 1,600 geometries a pass on the host, ~4.5 s a pass.
        for nx, nz, n_mat, w, h, depth in ((4, 4, 16, 160, 90, 3), (24, 16, 8, 160, 90, 3),
                                           (40, 40, 8, 64, 36, 2)):
            scene_x = scenes.instance_grid(nx, nz, n_mat).build(w / h, 0.7, device=dev)
            pack_x = frame_kernel.pack_frame(scene_x)
            t0_plain = time.perf_counter()
            plain = frame_kernel.render_frame_plain(pack_x, width=w, height=h, max_depth=depth)
            torch.cuda.synchronize()
            t_plain = time.perf_counter() - t0_plain
            shared = frame_kernel.shared_bytes(pack_x.num_geometries, pack_x.num_materials,
                                               shading=True)
            layout = {kind: "shared" if frame_kernel.tables_in_shared(
                          pack_x.num_geometries, pack_x.num_materials, shading=sh) else "global"
                      for kind, sh in (("frame", True), ("scene", False))}
            for disabled in (False, True):
                if disabled:
                    os.environ["GPURT_DISABLE_FUSED"] = "1"
                else:
                    del os.environ["GPURT_DISABLE_FUSED"]
                reset_counts()
                img = trace.render_frame(scene_x, w, h, max_depth=depth)
                torch.cuda.synchronize()
                f_n, s_n, m_n, t_n, p_n = counts()
                fused = not disabled and pack_x.num_materials <= frame_kernel.MAX_MATERIALS
                if (m_n, t_n, p_n) != (0, 0, 0) or (
                        (f_n, s_n) != (1, 0) if fused else not (f_n == 0 and 1 <= s_n <= 2 * depth - 1)):
                    raise AssertionError(f"{nx * nz} instances: launched {(f_n, s_n)}")
                ok, frac, tight, err = bar(img, plain)
                print(f"[scene] {nx * nz} instances, {pack_x.num_materials} materials "
                      f"({shared} B of frame-kernel tables; tables in {layout}) {w}x{h} depth {depth}, "
                      f"GPURT_DISABLE_FUSED={int(disabled)}: {f_n} frame / {s_n} scene "
                      f"launches; vs plain flipped {frac:.6f}, within 1e-5 {tight:.6f}, "
                      f"max |diff| {err:.6g} (plain {t_plain:.1f} s)", flush=True)
                if not ok:
                    raise AssertionError(f"{nx * nz} instances: frame disagrees with plain")
    del os.environ["GPURT_DISABLE_FUSED"]

    # 9. triangle meshes and the per-geometry route ---------------------------
    with Phase("mesh"):
        from gpuraytracer_tpu_torch.geometry import analytic
        from gpuraytracer_tpu_torch.kernels import megakernel
        from gpuraytracer_tpu_torch.models import meshes

        # The march kernel against its plain version on ray batches: every SDF code,
        # closest and occlusion, at the level-0 and the bounce budget of a
        # geometry of natural budget 512, with the window of an AABB-windowed
        # code, as the per-geometry route passes them.
        gen = torch.Generator().manual_seed(9)
        n = 65536
        o = torch.rand(n, 3, generator=gen) * 6.0 - 3.0
        d = hlsl.normalize(torch.rand(n, 3, generator=gen) * 1.2 - 0.6 - o)
        o, d = o.to(dev), d.to(dev)
        mega_err = 0.0
        # Row 7's generic march (the parent's): the march specialized on its
        # code must equal it bit for bit on every ray of every batch.
        generic_lib = build.load("megakernel", defines=megakernel.GENERIC_DEFINES)
        for code in range(9):
            gate = torch.ones(n, dtype=torch.bool, device=dev)
            t_max = torch.full((n,), 10.0, device=dev)
            w_start = None
            windowed = code in sdf.AABB_WINDOWED_CODES
            if windowed:
                lo, hi = analytic.aabb_interval(o, d, torch.full((3,), -1.0, device=dev),
                                                torch.full((3,), 1.0, device=dev))
                w_start, t_max = lo.clamp(min=0.0), torch.minimum(t_max, hi)
                gate = (hi > lo) & (t_max > w_start)
            for occlusion in (False, True):
                for level in (0, 1):
                    steps, capped = sdf.march_budget(512, occlusion=occlusion, level=level)
                    kw = dict(prim_code=code, cull_backface=not windowed, max_steps=steps,
                              t_start=w_start, capped_hit=capped,
                              relax=sdf.relax_for_code(code, occlusion=occlusion))
                    p_out = megakernel.sphere_trace_plain(o, d, gate, t_max, 0.9, **kw)
                    line, ok = [], True
                    for fmad in (build.DEFAULT_FMAD, not build.DEFAULT_FMAD):
                        k_out = megakernel.sphere_trace_tiles(
                            o, d, gate, t_max, 0.9, lib=build.load("megakernel", fmad=fmad), **kw)
                        agree, close, dt_max, n_close, dn_max, outside = ray_agreement(
                            k_out, p_out, gate)
                        # Every code's normals, code 8 (the Julia set) too: its
                        # normal is rounded op by op (csrc/frame_math.cuh), so
                        # contraction no longer changes it.
                        ok = ok and agree >= 0.98 and outside and n_close >= 0.98 and (
                            close >= 0.98 if fmad == build.DEFAULT_FMAD else dt_max <= 1e-3)
                        if fmad == build.DEFAULT_FMAD:
                            mega_err = max(mega_err, dt_max)
                        line.append(f"fmad={fmad}: hit agrees on {agree:.6f} of gated rays, "
                                    f"|dt| <= 1e-3 on {close:.6f} of both-hit rays, max |dt| "
                                    f"{dt_max:.6g}, normals within 1e-2 on {n_close:.6f} "
                                    f"(max {dn_max:.6g})")
                    c_out = megakernel.sphere_trace_tiles(o, d, gate, t_max, 0.9, **kw)
                    g_out = megakernel.sphere_trace_tiles(o, d, gate, t_max, 0.9, lib=generic_lib,
                                                          **kw)
                    same = all(torch.equal(x, y) for x, y in zip(c_out, g_out))
                    print(f"[mesh] march code {code} {'occlusion' if occlusion else 'closest'} "
                          f"budget {steps}{' capped-hit' if capped else ''}: {int(gate.sum())} "
                          f"gated rays, {int(p_out[0].sum())} plain hits; bit-equal to the "
                          f"generic march: {same}; "
                          + "; ".join(line), flush=True)
                    if not ok:
                        raise AssertionError(f"march code {code}: kernel disagrees with plain")
                    if not same:
                        raise AssertionError(f"march code {code}: the specialized march is not "
                                             f"the generic march's bit for bit")

        # The three mesh scenes: 96x54 against their goldens, 320x180 against
        # their route's plain version; the octahedra also on the wavefront.
        def route_plain(scene_r, w, h, max_depth):
            if traverse._total_mesh_faces(scene_r) > traverse.TRI_FACE_TOTAL_CAP:
                return trace.render_wavefront(scene_r, w, h, max_depth=max_depth, plain=True)
            return frame_kernel.render_frame_plain(frame_kernel.pack_frame(scene_r), width=w,
                                                   height=h, max_depth=max_depth)

        sdf_cfg = meshes.get_config("mesh_heightfield_sdf")
        probe = sdf_cfg.build(1.0, 0.0, device=dev)
        n_sdf = sum(int(k) == 2 for k in probe.layout.kinds)
        n_mesh = len(probe.arrays.meshes)
        per_frame = {"mesh_octahedra": (1, 0, 0, 0, 0), "mesh_heightfield_512": (1, 0, 0, 0, 0),
                     # 3 closest + 2 occlusion passes (trace_radiance at depth
                     # 3), one pass-entry launch each; the one-geometry march
                     # and mesh entries are not launched.
                     "mesh_heightfield_sdf": (0, 0, 0, 0, 5)}
        for cfg, disabled in [(c, False) for c in meshes.MESH_CONFIGS] + [
                (meshes.get_config("mesh_octahedra"), True)]:
            expect = (0, 5, 0, 0, 0) if disabled else per_frame[cfg.name]
            if disabled:
                os.environ["GPURT_DISABLE_FUSED"] = "1"
            label = cfg.name + (" GPURT_DISABLE_FUSED=1" if disabled else "")
            reset_counts()
            img = trace.render_frame(cfg.build(96 / 54, 0.7, device=dev), 96, 54,
                                     max_depth=cfg.max_depth)
            torch.cuda.synchronize()
            if counts() != expect:
                raise AssertionError(f"{label}: 96x54 frame launched {counts()}, not {expect}")
            ref = torch.from_numpy(np.load(os.path.join(
                ROOT, "tests", f"golden_torch_{cfg.name}_96x54_t0p7.npz"))["image"])
            ok, frac, tight, _ = bar(img, ref)
            print(f"[mesh] {label} 96x54 vs golden: launched {counts()}; flipped {frac:.6f}, "
                  f"within 1e-5 {tight:.6f}", flush=True)
            if not ok:
                raise AssertionError(f"{label}: disagrees with the golden")
            scene_r = cfg.build(320 / 180, 0.7, device=dev)
            img = trace.render_frame(scene_r, 320, 180, max_depth=cfg.max_depth)
            plain = route_plain(scene_r, 320, 180, cfg.max_depth)
            ok, frac, tight, err = bar(img, plain)
            alt = ""
            if expect[0]:
                # The frame kernel's other contraction mode, on the same frame.
                other = frame_kernel.render_frame_tiles(
                    frame_kernel.pack_frame(scene_r), width=320, height=180,
                    max_depth=cfg.max_depth,
                    lib=build.load("frame_kernel", fmad=not build.DEFAULT_FMAD))
                alt = f"; fmad={not build.DEFAULT_FMAD} build flipped {bar(other, plain)[1]:.6f}"
            print(f"[mesh] {label} 320x180 vs its route's plain version: flipped {frac:.6f}, "
                  f"within 1e-5 {tight:.6f}, max |diff| {err:.6g}{alt}", flush=True)
            if not ok:
                raise AssertionError(f"{label}: disagrees with its route's plain version")
            if disabled:
                del os.environ["GPURT_DISABLE_FUSED"]

        # 64-frame 1080p windows: the octahedra and the 512-face heightfield
        # through the frame kernel, the 544-face scene on the per-geometry
        # route.
        for name in ("mesh_octahedra", "mesh_heightfield_512", "mesh_heightfield_sdf"):
            cfg = meshes.get_config(name)
            renderer = Renderer(cfg.width, cfg.height, device=dev, scene_factory=cfg.build,
                                animate=cfg.builder().animator(), max_depth=cfg.max_depth)
            # The per-geometry route's window: the wavefront's device form,
            # every frame with each synchronizing torch call an error.
            route_scene = name == "mesh_heightfield_sdf"
            torch.cuda.empty_cache()
            ms, launched, bg_max = animated_window(renderer, dev, name, cfg.width, cfg.height,
                                                   sync_error=route_scene)
            expect = tuple(FRAMES * c for c in per_frame[name])
            lanes_run = wavefront.launches()
            if launched != expect or lanes_run != (LANE_LAUNCHES if route_scene else
                                                   {k: 0 for k in LANE_LAUNCHES}):
                raise AssertionError(f"{name}: {launched} launches and lane kernels {lanes_run} "
                                     f"for {FRAMES} frames, not {expect}")
            if route_scene:
                mega_launches, mesh_launches, pass_launches = launched[2:5]
                route_window_ms = ms
                lane_launches = {k: v + lanes_run[k] for k, v in lane_launches.items()}
            print(f"[mesh] {name} {cfg.width}x{cfg.height} depth {cfg.max_depth}, {FRAMES} "
                  f"frames{SYNC_ERROR_NOTE if route_scene else ''}: "
                  f"launches (frame, scene, march, mesh, pass) {launched}, lane kernels "
                  f"{lanes_run}, background <= {bg_max:.3f}; {ms:.3f} ms/frame, "
                  f"{cfg.width * cfg.height / ms / 1e3:.3f} Mrays/s; {card}", flush=True)

        # The 544-face scene's 1080p level-0 closest and shadow passes (the
        # route's largest): the pass entry against the route's plain version,
        # bit for bit against its unculled face loop (the -DGPRT_FACE_LOOP_
        # GLOBAL build: every face from global memory), and against the
        # one-geometry chain the route ran before (the march and mesh
        # entries launched per geometry over every ray, with torch ops
        # between them, the mesh entry in the unculled loop the parent ran),
        # in both contraction modes; then alone, with op counts (with the
        # skip: the work it does, which its bound counts; unculled: the work
        # the skip removed beside it), bounds and SIMT. The chain's march and
        # mesh calls are recorded from its closest pass and held to their
        # plain versions alone.
        scene_m9 = sdf_cfg.build(W_MAIN / H_MAIN, 0.0333 * 8, device=dev)
        pack_9 = frame_kernel.pack_frame(scene_m9)
        lane_rows_9, lane_passes_9 = lane_kernels("mesh_heightfield_sdf (per-geometry route)",
                                                  scene_m9, pack_9, "per_geometry", card)
        resident["megakernel_route_pass"] = megakernel.route_residency(pack_9)
        calls = {"march": [], "mesh": []}

        def unculled_lib(count_ops=False):
            return build.load("megakernel", count_ops=count_ops, faces_global=True)

        def unculled_mesh(*args, lib=None, **kw):
            return megakernel.trimesh_closest(*args, lib=lib or unculled_lib(), **kw)

        real = {"march": megakernel.sphere_trace_tiles, "mesh": unculled_mesh}

        def recorder(kind):
            def record(*args, **kw):
                if recording[0]:
                    calls[kind].append((args, kw))
                return real[kind](*args, **kw)
            return record

        recording = [True]
        chain = functools.partial(scene_kernel.scene_closest_plain, budget_level=0,
                                  march=recorder("march"), mesh_closest=recorder("mesh"))
        px, py = cam.pixel_grid(W_MAIN, H_MAIN, dev)
        c = scene_m9.arrays.constants
        o9, d9 = cam.generate_camera_rays(px, py, W_MAIN, H_MAIN, c.camera_position,
                                          c.projection_to_world)
        o9, d9 = o9.reshape(-1, 3), d9.reshape(-1, 3)
        hit_p9, ob9, db9, act9, t09 = traverse.pass_inputs(o9, d9, scene_m9)
        st9, _, sg9 = chain(scene_m9, ob9, db9, act9, t09)
        recording[0] = False
        if (len(calls["march"]), len(calls["mesh"])) != (n_sdf, n_mesh):
            raise AssertionError(f"1080p chain made {len(calls['march'])} march and "
                                 f"{len(calls['mesh'])} mesh calls")
        hp9 = o9 + torch.where(sg9 >= 0, st9, t09)[:, None] * d9
        _, obs9, dbs9, acts9, t0s9 = traverse.pass_inputs(
            hp9, hlsl.normalize(c.light_position[:3] - hp9), scene_m9, active=(sg9 >= 0) | hit_p9,
            occlusion=True)
        route_passes = {"closest": ((ob9, db9, act9, t09), False),
                        "shadow": ((obs9, dbs9, acts9, t0s9), True)}
        faces_9 = pack_9.tri.shape[0]
        simt_lib = build.load("megakernel", count_simt=True)
        route = {}
        for kind, (args, af) in route_passes.items():
            n_rays, live = args[0].shape[0], int(args[2].sum())

            def run(lib=None, ops=None):
                return megakernel.route_pass(scene_m9, *args, accept_first=af, pack=pack_9,
                                             lib=lib, ops=ops)

            k_out = run()
            same = all(torch.equal(x, y) for x, y in zip(k_out, run(unculled_lib())))
            p_ms, p_out = cuda_ms(lambda: megakernel.route_pass_plain(
                scene_m9, *args, accept_first=af), 1, warmup=False)
            chain_ms, c_out = cuda_ms(lambda: chain(scene_m9, *args, accept_first=af), 5)
            line, agree_plain = [], {}
            for ref_name, ref in (("plain", p_out), ("chain", c_out)):
                g_eq = k_out[2] == ref[2]
                both = g_eq & (ref[2] >= 0)
                dt = (k_out[0] - ref[0]).abs()[both]
                close = float((dt <= 1e-3).float().mean()) if dt.numel() else 1.0
                dt_max = float(dt.max()) if dt.numel() else 0.0
                agree = float(g_eq.float().mean())
                if ref_name == "plain":
                    agree_plain = dict(agree=agree, close=close, err=dt_max)
                line.append(f"vs {ref_name}: gid agrees on {agree:.6f} ({int((~g_eq).sum())} rays "
                            f"differ), t within 1e-3 on {close:.6f} of both-hit rays (max |dt| "
                            f"{dt_max:.6g})")
            # Without contraction the pass entry and the chain (the parent's
            # route) take the same operations: every differing ray printed.
            with fmad_build(False):
                k_nf = run()
                same = same and all(torch.equal(x, y) for x, y in zip(k_nf, run(unculled_lib())))
                c_nf = chain(scene_m9, *args, accept_first=af)
            diff_nf = torch.nonzero(k_nf[2] != c_nf[2]).squeeze(1)
            both_nf = (k_nf[2] == c_nf[2]) & (c_nf[2] >= 0)
            dt_nf = (k_nf[0] - c_nf[0]).abs()[both_nf]
            line.append(f"fmad=false vs the chain: gid differs on {diff_nf.numel()} rays, t "
                        f"bit-equal on {float((k_nf[0] == c_nf[0])[both_nf].float().mean()):.6f} of "
                        f"both-hit rays (max |dt| {float(dt_nf.max()) if dt_nf.numel() else 0.0:.6g})")
            for r in diff_nf[:8].tolist():
                line.append(f"ray {r}: pass gid {int(k_nf[2][r])} t {float(k_nf[0][r]):.9g}, "
                            f"chain gid {int(c_nf[2][r])} t {float(c_nf[0][r]):.9g}")
            print(f"[mesh] 1080p level-0 {kind} pass ({n_rays} rays, {live} live): bit-equal to "
                  f"the unculled face loop in both builds: {same}; " + "; ".join(line), flush=True)
            if not (same and agree_plain["agree"] >= 0.999 and agree_plain["close"] >= 0.999):
                raise AssertionError(f"1080p {kind} pass: the pass entry disagrees")
            k_ms = cuda_ms(run, 20)[0]
            u_ms = cuda_ms(lambda: run(unculled_lib()), 20)[0]
            n_ops = {}
            for label, lib in (("skip", build.load("megakernel", count_ops=True)),
                               ("unculled", unculled_lib(count_ops=True))):
                ops.zero_()
                run(lib, ops)
                n_ops[label] = int(ops.item())
            cnt = torch.zeros(frame_kernel.SIMT_COUNTERS, dtype=torch.int64, device=dev)
            run(simt_lib, cnt)
            sim = megakernel.route_simt(cnt)
            # Rays read once (o, d, active, t0: 29 B), outputs written once
            # (best_t, normal, gid: 20 B), the face rows once; the operations
            # the shipped loop performs.
            nbytes = n_rays * (29 + 20) + faces_9 * 48
            b_ms, b_by = bound(nbytes, n_ops["skip"])
            u_b_ms = bound(nbytes, n_ops["unculled"])[0]
            route[kind] = dict(ms=k_ms, plain_ms=p_ms, chain_ms=chain_ms, bound_ms=b_ms,
                               bound_by=b_by, err=agree_plain["err"])
            print(f"[mesh] pass entry alone, 1080p level-0 {kind} pass: {k_ms:.4f} ms (the "
                  f"unculled face loop from global memory {u_ms:.4f} ms); the chain "
                  f"{chain_ms:.4f} ms (its launches and torch ops); plain {p_ms:.1f} ms; "
                  f"{n_ops['skip']} f32 FLOPs with the skip, {nbytes} bytes: bound {b_ms:.4f} ms "
                  f"by {b_by} ({100 * b_ms / k_ms:.1f}% of bound); unculled {n_ops['unculled']} "
                  f"FLOPs (the skip removed {100 * (1 - n_ops['skip'] / n_ops['unculled']):.1f}%; "
                  f"bound {u_b_ms:.4f} ms); SIMT march {100 * sim['march'][0]:.2f}%, faces "
                  f"{100 * sim['faces'][0]:.2f}% of lanes ({100 * sim['faces needed'][0]:.2f}% "
                  f"needed the chunk; {sim['faces'][2]:.1f} warp face tests); {card}", flush=True)

        # Larger meshes on the same route: the staging area holds the largest
        # mesh, so it lowers the blocks resident per SM. The pass entry as it
        # ships against its unculled loop (no staging area) on the 1080p
        # level-0 closest pass of the scene with a 24x24 (1,152 faces) and a
        # 40x40 (3,200 faces) heightfield.
        for nx in (24, 40):
            scene_l = meshes.heightfield_sdf_builder(nx=nx, nz=nx).build(
                W_MAIN / H_MAIN, 0.0333 * 8, device=dev)
            pack_l = frame_kernel.pack_frame(scene_l)
            _, obl, dbl, actl, t0l = traverse.pass_inputs(o9, d9, scene_l)
            libs_l = (None, unculled_lib())
            outs_l = [megakernel.route_pass(scene_l, obl, dbl, actl, t0l, pack=pack_l, lib=lib)
                      for lib in libs_l]
            same_l = all(torch.equal(x, y) for x, y in zip(*outs_l))
            ms_l = [cuda_ms(lambda lib=lib: megakernel.route_pass(
                scene_l, obl, dbl, actl, t0l, pack=pack_l, lib=lib), 10)[0] for lib in libs_l]
            res_l = [megakernel.route_residency(pack_l, lib=lib) for lib in libs_l]
            print(f"[mesh] {pack_l.tri.shape[0]}-face heightfield, 1080p level-0 closest pass: "
                  f"pass entry {ms_l[0]:.4f} ms at {res_l[0][0]} blocks/SM, its unculled face "
                  f"loop {ms_l[1]:.4f} ms at {res_l[1][0]} blocks/SM; bit-equal {same_l}; {card}",
                  flush=True)
            if not same_l:
                raise AssertionError(f"{nx}x{nx} heightfield: the face loops disagree")

        # The chain's one-geometry calls alone (no render path launches them);
        # the mesh entry as it ships, beside the parent's unculled loop.
        alone = {}
        for kind, plain_fn in (("march", megakernel.sphere_trace_plain),
                               ("mesh", megakernel.trimesh_closest_plain)):
            k_ms = p_ms = nbytes = err = 0.0
            k_ops = 0
            shipped = megakernel.trimesh_closest if kind == "mesh" else real[kind]
            for args, kw in calls[kind]:
                t, _ = cuda_ms(lambda: shipped(*args, **kw), 10)
                k_ms += t
                t, p_out = cuda_ms(lambda: plain_fn(*args, **kw), 1, warmup=False)
                p_ms += t
                k_out = shipped(*args, **kw)
                # march: (o, d, gate, ...); mesh entry: (rows, o, d, gate, ...)
                rays, gate = (args[0], args[2]) if kind == "march" else (args[1], args[3])
                rays, gated = rays.shape[0], int(gate.sum())
                agree, close, dt_max, n_close, dn_max, outside = ray_agreement(k_out, p_out, gate)
                err = max(err, dt_max)
                ops.zero_()
                shipped(*args, ops=ops, lib=build.load("megakernel", count_ops=True), **kw)
                k_ops += int(ops.item())
                mesh_fl = ""
                if kind == "mesh":
                    same = all(torch.equal(x, y) for x, y in zip(k_out, unculled_mesh(*args, **kw)))
                    u_ms = cuda_ms(lambda: unculled_mesh(*args, **kw), 10)[0]
                    ops.zero_()
                    unculled_mesh(*args, ops=ops, lib=unculled_lib(count_ops=True), **kw)
                    u_ops = int(ops.item())
                    cnt = torch.zeros(frame_kernel.SIMT_COUNTERS, dtype=torch.int64, device=dev)
                    megakernel.trimesh_closest(*args, ops=cnt, lib=simt_lib, **kw)
                    sim = megakernel.route_simt(cnt)
                    mesh_fl = (f"; bit-equal to the unculled face loop: {same} (its {u_ms:.4f} ms, "
                               f"{u_ops} f32 FLOPs, of which the skip removed "
                               f"{100 * (1 - (k_ops / u_ops if u_ops else 1)):.1f}%); SIMT faces "
                               f"{100 * sim['faces'][0]:.2f}% ({100 * sim['faces needed'][0]:.2f}% "
                               f"needed)")
                    if not same:
                        raise AssertionError("mesh entry: disagrees with the unculled face loop")
                print(f"[mesh] 1080p {kind} call: {gated} of {rays} rays gated; hit agrees on "
                      f"{agree:.6f} of them, |dt| <= 1e-3 on {close:.6f} of both-hit rays "
                      f"(max {dt_max:.6g}), normals within 1e-2 on {n_close:.6f} (max "
                      f"{dn_max:.6g}), gated-out rays miss: {outside}{mesh_fl}", flush=True)
                if not (agree >= 0.98 and close >= 0.98 and n_close >= 0.98 and outside):
                    raise AssertionError(f"1080p {kind} call disagrees with its plain version")
                # Every ray reads its gate and writes t_hit and its normal; only
                # a gated ray reads o, d, t_max (and the march's t_start).
                t_start_b = 4 if kw.get("t_start") is not None else 0
                nbytes += rays * (1 + 16) + gated * (12 + 12 + 4 + t_start_b)
                if kind == "mesh":
                    nbytes += args[0].numel() * 4
            b_ms, b_by = bound(nbytes, k_ops)
            alone[kind] = dict(ms=k_ms, plain_ms=p_ms, ops=k_ops, nbytes=nbytes, bound_ms=b_ms,
                               bound_by=b_by, err=err)
            print(f"[mesh] {kind} calls of the chain's 1080p level-0 closest pass "
                  f"({len(calls[kind])} calls): kernel {k_ms:.4f} ms ({k_ops} f32 FLOPs, "
                  f"{int(nbytes)} bytes: bound {b_ms:.4f} ms by {b_by}, {100 * b_ms / k_ms:.1f}% "
                  f"of bound); plain {p_ms:.1f} ms; {card}", flush=True)

        # Row 7's redesign on the chain's 1080p march calls: the specialized
        # march against the generic march's build, and the longest ray alone.
        march_row = march_designs(calls["march"], dev, card)

        # The mesh body inside the frame kernel at 1080p: one mesh_octahedra
        # frame against its plain version, as phase 6 holds the builtin one.
        oct_cfg = meshes.get_config("mesh_octahedra")
        pack_o = frame_kernel.pack_frame(oct_cfg.build(oct_cfg.width / oct_cfg.height,
                                                       0.0333 * 8, device=dev))
        kimg = frame_kernel.render_frame_tiles(pack_o, width=oct_cfg.width,
                                               height=oct_cfg.height, max_depth=oct_cfg.max_depth)
        pimg = frame_kernel.render_frame_plain(pack_o, width=oct_cfg.width,
                                               height=oct_cfg.height, max_depth=oct_cfg.max_depth)
        ok, frac, tight, oct_err = bar(kimg, pimg)
        print(f"[mesh] mesh_octahedra {oct_cfg.width}x{oct_cfg.height} t={0.0333 * 8:.4f} frame "
              f"kernel vs plain: flipped {frac:.6f}, within 1e-5 {tight:.6f}, max |diff| "
              f"{oct_err:.6g}", flush=True)
        if not ok:
            raise AssertionError("mesh_octahedra: frame kernel disagrees with plain at 1080p")

    # 10. the compacted frame modes (GPURT_FRAME_MODE=compact|defer) ---------
    with Phase("modes"):
        modes = {"compact": frame_kernel.render_frame_compact,
                 "defer": frame_kernel.render_frame_deferred}
        cap_arg = {"compact": "budget_cap", "defer": "shadow_cap"}

        def mode_frame(mode, pack_x, w, h, cap, cap_lanes, max_depth=3):
            """(image, QueueCount, counters) of one frame; the chain ran whole
            (main entry, dense or queue and compose, gated) or the scene had
            no cappable march."""
            reset_counts()
            img, n = modes[mode](pack_x, width=w, height=h, max_depth=max_depth,
                                 cap_lanes=cap_lanes, debug_count=True, **{cap_arg[mode]: cap})
            torch.cuda.synchronize()
            c = mode_counts()
            chain = ({"compact": 1, "bin": 1, "dense": 1, "gated": 1} if mode == "compact" else
                     {"defer": 1, "bin": 1, "queue": 1, "compose": 1, "gated": 1})
            if c["plain"] == 0 and any(c[k] != v for k, v in chain.items()):
                raise AssertionError(f"{mode} {w}x{h}: the chain launched {c}")
            return img, n, c

        # builtin 96x54 vs the golden, 320x180 vs the plain frame kernel:
        # default cap; cap 8 with a queue that holds every pixel (the dense
        # pass / queue kernel run); cap 1 with a one-tile queue (overflow).
        tile = frame_kernel.TILE_ROWS * frame_kernel.TILE_COLS
        for w, h in ((96, 54), (320, 180)):
            pack_x = frame_kernel.pack_frame(builtin.build_scene(aspect=w / h, elapsed_time=0.7,
                                                                 device=dev))
            for fmad in (build.DEFAULT_FMAD, not build.DEFAULT_FMAD):
                with fmad_build(fmad):
                    ref = (golden("builtin") if w == 96 else
                           frame_kernel.render_frame_tiles(pack_x, width=w, height=h))
                    for mode in modes:
                        for cap, cap_lanes, form in ((None, None, "main"), (8, w * h, "repair"),
                                                     (1, tile, "overflow")):
                            img, n, c = mode_frame(mode, pack_x, w, h, cap, cap_lanes)
                            ok, frac, tight, err = bar(img, ref)
                            exact, flips, _ = exactness(img, ref)
                            # 96x54 has too few pixels to overflow a one-tile queue.
                            ran = {"main": not n.overflow,
                                   "overflow": n.overflow or w == 96,
                                   "repair": not n.overflow}[form] and c["plain"] == 0
                            print(f"[modes] {mode} {w}x{h} fmad={fmad} cap {cap}"
                                  f"{'' if cap_lanes is None else f' queue {cap_lanes}'}: "
                                  f"{int(n)} queued, overflow {n.overflow}, launches {c}; vs "
                                  f"{'golden' if w == 96 else 'plain kernel'}: bit-equal "
                                  f"{exact:.6f}, flipped {flips:.6f}, within 1e-5 {tight:.6f}, "
                                  f"max |diff| {err:.6g}", flush=True)
                            if not (ok and n > 0 and ran):
                                raise AssertionError(f"{mode} {w}x{h} cap {cap}: disagrees or "
                                                     f"took the wrong path")
                            if w == 320 and mode == "compact" and fmad is False and exact < 1.0:
                                raise AssertionError("the --fmad=false compact frame is not the "
                                                     "plain kernel's bit for bit")
                            if w == 320 and mode == "defer" and fmad is False and err > 4e-6:
                                raise AssertionError("the --fmad=false defer frame is not within "
                                                     "4e-6 of the plain kernel")

        # The bench scenes and the octahedra in both modes vs the plain kernel.
        w, h = 320, 180
        for cfg in list(scenes.BENCH_CONFIGS) + [meshes.get_config("mesh_octahedra")]:
            pack_x = frame_kernel.pack_frame(cfg.build(w / h, 0.7, device=dev))
            ref = frame_kernel.render_frame_tiles(pack_x, width=w, height=h,
                                                  max_depth=cfg.max_depth)
            for mode in modes:
                img, n, c = mode_frame(mode, pack_x, w, h, None, None, cfg.max_depth)
                ok, frac, tight, err = bar(img, ref)
                exact, _, _ = exactness(img, ref)
                print(f"[modes] {cfg.name} {mode} {w}x{h}: {int(n)} queued, launches {c}; vs plain "
                      f"kernel bit-equal {exact:.6f}, flipped {frac:.6f}, max |diff| {err:.6g}",
                      flush=True)
                if not ok:
                    raise AssertionError(f"{cfg.name} {mode}: disagrees with the plain kernel")

        # A 17-material scene takes the scene kernel in any mode (the
        # reference reads the mode only for fused-eligible scenes).
        os.environ["GPURT_FRAME_MODE"] = "compact"
        scene_x = scenes.instance_grid(4, 4, 16).build(160 / 90, 0.7, device=dev)
        reset_counts()
        img = trace.render_frame(scene_x, 160, 90)
        torch.cuda.synchronize()
        c, launched = mode_counts(), counts()
        ok, frac, _, _ = bar(img, frame_kernel.render_frame_plain(
            frame_kernel.pack_frame(scene_x), width=160, height=90))
        print(f"[modes] 17 materials, GPURT_FRAME_MODE=compact 160x90: launches {c}, scene "
              f"kernel {launched[1]}; vs plain flipped {frac:.6f}", flush=True)
        if not ok or launched[1] == 0 or c["plain"] + c["compact"] + c["defer"] != 0:
            raise AssertionError("17-material scene under compact: wrong route or image")

        # 64-frame 1080p windows of the main path in each mode, beside a
        # plain one of the same call.
        windows = {}
        for mode in ("plain",) + tuple(modes):
            os.environ["GPURT_FRAME_MODE"] = mode
            ms, _, bg_max = animated_window(Renderer(W_MAIN, H_MAIN, device=dev), dev,
                                            f"builtin 1080p {mode}", W_MAIN, H_MAIN)
            c = mode_counts()
            windows[mode] = c
            per = {k: v / FRAMES for k, v in c.items()}
            print(f"[modes] Renderer 1920x1080 GPURT_FRAME_MODE={mode}, {FRAMES} frames: "
                  f"{ms:.3f} ms/frame, {W_MAIN * H_MAIN / ms / 1e3:.3f} Mrays/s; per frame: "
                  f"launches {per}; background <= {bg_max:.3f}; {card}", flush=True)
            want = {"plain": ("plain",), "compact": ("compact", "bin", "dense", "gated"),
                    "defer": ("defer", "bin", "queue", "compose", "gated")}[mode]
            if any(c[k] != FRAMES for k in want) or c["syncs"] != 0 or (
                    mode != "plain" and c["plain"] != 0):
                raise AssertionError(f"{mode} window: launches {c}")
        del os.environ["GPURT_FRAME_MODE"]

        # One 1080p frame in each mode with every synchronizing torch call an
        # error: the chain reads nothing back.
        for mode, fn in modes.items():
            fn(pack_m, width=W_MAIN, height=H_MAIN)
            torch.cuda.synchronize()
            syncs = frame_kernel.HOST_SYNCS
            torch.cuda.set_sync_debug_mode("error")
            try:
                img = fn(pack_m, width=W_MAIN, height=H_MAIN)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            exact, flips, err = exactness(img, main_img)
            print(f"[modes] {mode} 1920x1080 under set_sync_debug_mode('error'): completed, host "
                  f"syncs {frame_kernel.HOST_SYNCS - syncs}; vs the plain kernel bit-equal "
                  f"{exact:.6f}, flipped {flips:.6f}, max |diff| {err:.6g}", flush=True)
            if frame_kernel.HOST_SYNCS != syncs or not bar(img, main_img)[0]:
                raise AssertionError(f"{mode} 1080p frame synced or disagrees")

        # Each new kernel alone at the 1080p frame's shapes (phase 6's frame),
        # against its plain version on the same inputs.
        alone_m = {}
        frame_in = (pack_m.params.numel() + pack_m.layout.numel()) * 4
        npix = W_MAIN * H_MAIN
        kw_m = dict(width=W_MAIN, height=H_MAIN)
        count_lib = build.load("frame_kernel", count_ops=True)

        def record(name, fn, p_ms, err, nbytes, ops_fn, detail):
            # The plain versions leave large blocks in the allocator's cache.
            torch.cuda.empty_cache()
            k_ms, _ = cuda_ms(fn, 10)
            ops.zero_()
            ops_fn()
            torch.cuda.synchronize()
            k_ops = int(ops.item())
            b_ms, b_by = bound(nbytes, k_ops)
            alone_m[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, err=err)
            print(f"[modes] {name} alone 1920x1080: {detail}; kernel {k_ms:.3f} ms ({k_ops} f32 "
                  f"FLOPs, {int(nbytes)} bytes: bound {b_ms:.4f} ms by {b_by}); plain "
                  f"{p_ms:.1f} ms; {card}", flush=True)

        def plain_run(fn):
            """(ms, output) of one call of a plain version."""
            return cuda_ms(fn, 1, warmup=False)

        # compact's main pass: the dirty plane against its plain version, then
        # the path's form, the queue, against that plane
        k_img, k_dirty = frame_kernel.render_frame_capped(pack_m, budget_cap=64, **kw_m)
        p_ms, (p_img, p_dirty) = plain_run(
            lambda: frame_kernel.render_frame_capped_plain(pack_m, budget_cap=64, **kw_m))
        clean = (k_dirty == 0) & (p_dirty == 0)
        ok, frac, tight, err = bar(k_img[clean][:, None], p_img[clean][:, None])
        agree = float((k_dirty == p_dirty).float().mean())
        if not ok or agree < 0.999:
            raise AssertionError("compact main pass disagrees with its plain version")
        cap_m = frame_kernel.queue_capacity(W_MAIN, H_MAIN)
        q_img, queue_m = frame_kernel.render_frame_compact_main(pack_m, budget_cap=64, cap=cap_m,
                                                                **kw_m)
        n_q = int(queue_m.count[0])
        q_pix = queue_m.entries[:n_q, 0].long()
        q_levels = queue_m.entries[:n_q, 1] & 255
        same_set = bool(torch.equal(torch.sort(q_pix).values,
                                    torch.nonzero(k_dirty.reshape(-1)).squeeze(1)))
        same_img = bool(torch.equal(q_img[k_dirty == 0], k_img[k_dirty == 0]))
        hist = torch.bincount(q_levels.long(), minlength=3).tolist()
        print(f"[modes] compact queue 1920x1080 cap 64: {n_q} queued of capacity {cap_m}; the "
              f"queue's set is the dirty plane's: {same_set}; clean pixels as the dirty-plane "
              f"form's: {same_img}; level histogram (where the cap stopped the pixel, the "
              f"dense pass resumes): {hist}", flush=True)
        if not (same_set and same_img and 0 < n_q <= cap_m):
            raise AssertionError("the compact queue is not the dirty plane's set")
        record("frame_compact", lambda: frame_kernel.render_frame_compact_main(
                   pack_m, budget_cap=64, cap=cap_m, **kw_m), p_ms, err,
               frame_in + npix * 16 + n_q * 64 + 4, lambda: frame_kernel.render_frame_compact_main(
                   pack_m, budget_cap=64, cap=cap_m, ops=ops, lib=count_lib, **kw_m),
               f"{int((k_dirty != 0).sum())} dirty ({int((p_dirty != 0).sum())} plain), masks "
               f"agree on {agree:.6f}; clean pixels flipped {frac:.6f}, max |diff| {err:.6g}")
        # the queue's binned order: the plain version's key order, the same set
        queue_a = queue_m
        queue_m = frame_kernel.bin_queue(queue_a)
        b_keys = frame_kernel.bin_keys(queue_m)[:n_q]
        p_ms, queue_p = plain_run(lambda: frame_kernel.bin_queue_plain(queue_a))
        b_ok = (bool(torch.equal(b_keys, frame_kernel.bin_keys(queue_p)[:n_q]))
                and bool(torch.equal(torch.sort(queue_m.entries[:n_q, 0]).values,
                                     torch.sort(queue_a.entries[:n_q, 0]).values)))
        if not b_ok:
            raise AssertionError("the compact queue's binned order is not its plain version's")
        torch.cuda.empty_cache()
        bin_ms, _ = cuda_ms(lambda: frame_kernel.bin_queue(queue_a), SHORT_REPS)

        def bin_bytes(counts, nbins, read, written, cap):
            """Bytes the one-launch bin moves, as (least, shipped). Least: each
            live entry read (read bytes: the slot, and for a defer key the
            status word) and written once, each segment's histogram read
            once, the counts, and the cursors reset. Shipped: the same with
            the histogram read once by each live block of the launch
            (csrc/frame_kernel.cu gprt_queue_bin: 1024-thread blocks, at most
            128 a launch, shared among the segments)."""
            per_seg = max(1, min((cap + 1023) // 1024, 128 // len(counts)))
            blocks = sum(min((n + 1023) // 1024, per_seg) for n in counts)
            rest = sum(counts) * (read + written) + 4 * len(counts) + 4 * len(counts) * nbins
            return rest + len(counts) * nbins * 4, rest + blocks * nbins * 4

        c_bin_bytes, c_launch_bytes = bin_bytes([n_q], 32, 64, 64, queue_a.entries.shape[0])
        b_ms, b_by = bound(c_bin_bytes, 0)
        # The one PyTorch call that computes the same order: a stable sort of
        # the live slots' keys (timed here only; the port never calls it).
        live_keys = frame_kernel.bin_keys(queue_a)[:n_q].contiguous()
        lib_ms, _ = cuda_ms(lambda: torch.sort(live_keys, stable=True), SHORT_REPS)
        alone_m["queue_bin"] = dict(ms=bin_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                                    err=0.0, library_ms=lib_ms)
        print(f"[modes] queue_bin's library call, torch.sort(keys, stable=True) of the {n_q} "
              f"live slots' keys: {lib_ms:.4f} ms; {card}", flush=True)
        print(f"[modes] queue_bin alone, compact queue 1920x1080: {n_q} entries in "
              f"{len(set(b_keys.tolist()))} keys, the plain version's key order: {b_ok}; one "
              f"launch {bin_ms:.4f} ms (the compact entry counted the keys; {c_bin_bytes} bytes: "
              f"bound {b_ms:.4f} ms by {b_by}; the launch's blocks move {c_launch_bytes}; the "
              f"four launches' count before: "
              f"{n_q * (64 + 64) + 4 + 32 * 4} bytes); plain {p_ms:.1f} ms; {card}", flush=True)
        # the dense pass resumed from the binned queue, against its plain
        # version and the plain kernel's pixels (bit for bit without
        # contraction; every differing pixel counted in the shipped build)
        m_img = frame_kernel.render_frame_tiles(pack_m, **kw_m)
        r_img = frame_kernel.render_frame_resume(pack_m, queue_m, q_img.clone(), **kw_m)
        p_ms, pr_img = plain_run(lambda: frame_kernel.render_frame_resume_plain(
            pack_m, queue_m, q_img.clone(), **kw_m))
        r_out, pr_out, m_out = (x.reshape(-1, 4)[q_pix] for x in (r_img, pr_img, m_img))
        ok, frac, tight, err = bar(r_out[:, None], pr_out[:, None])
        differ = ~(r_out == m_out).all(dim=-1)
        d_max = float((r_out - m_out).abs().max())
        with fmad_build(False):
            _, queue_f = frame_kernel.render_frame_compact_main(pack_m, budget_cap=64, cap=cap_m,
                                                                **kw_m)
            queue_f = frame_kernel.bin_queue(queue_f)
            rf_img = frame_kernel.render_frame_resume(pack_m, queue_f, torch.zeros_like(m_img),
                                                      **kw_m)
            mf_img = frame_kernel.render_frame_tiles(pack_m, **kw_m)
        f_pix = queue_f.entries[:int(queue_f.count[0]), 0].long()
        exact_f = bool(torch.equal(rf_img.reshape(-1, 4)[f_pix], mf_img.reshape(-1, 4)[f_pix]))
        print(f"[modes] resumed dense pass 1920x1080: --fmad=false build, {f_pix.shape[0]} "
              f"queued pixels bit-equal to the plain kernel's: {exact_f}; shipped build, "
              f"{int(differ.sum())} of {n_q} queued pixels differ from the plain kernel's "
              f"(max |diff| {d_max:.6g}); vs its plain version flipped {frac:.6f}, max |diff| "
              f"{err:.6g}", flush=True)
        if not (ok and exact_f and bar(r_out[:, None], m_out[:, None])[0]):
            raise AssertionError("the resumed dense pass disagrees with the plain kernel")
        record("frame_dense", lambda: frame_kernel.render_frame_resume(pack_m, queue_m, r_img,
                                                                       **kw_m),
               p_ms, err, frame_in + n_q * (64 + 16) + 4, lambda: frame_kernel.render_frame_resume(
                   pack_m, queue_m, r_img, ops=ops, lib=count_lib, **kw_m),
               f"{n_q} queued pixels resumed at levels {hist}; {int(differ.sum())} differ from "
               f"the plain kernel's (max {d_max:.6g})")
        # the same entry from the camera ray (render_frame_dense) at this
        # frame's queue sorted by dirty mask (the earlier host-sorted form's
        # queue), against its plain version and the plain kernel's pixels
        q = torch.nonzero(k_dirty.reshape(-1)).squeeze(1)
        q = q[torch.argsort(k_dirty.reshape(-1)[q], stable=True)].to(torch.int32)
        qpx, qpy = (q % W_MAIN).contiguous(), (q // W_MAIN).contiguous()
        k_out = frame_kernel.render_frame_dense(pack_m, qpx, qpy, **kw_m)
        p_ms, p_out = plain_run(
            lambda: frame_kernel.render_frame_dense_plain(pack_m, qpx, qpy, **kw_m))
        ok, frac, tight, err = bar(k_out[:, None], p_out[:, None])
        same = bool(torch.equal(k_out, m_img.reshape(-1, 4)[q.long()]))
        if not ok or not same:
            raise AssertionError("dense pass disagrees with its plain version or the plain kernel")
        dense_cam_ms, _ = cuda_ms(lambda: frame_kernel.render_frame_dense(pack_m, qpx, qpy, **kw_m),
                                  10)
        dense_append_ms, _ = cuda_ms(lambda: frame_kernel.render_frame_resume(
            pack_m, queue_a, r_img, **kw_m), 10)
        print(f"[modes] dense pass from the camera ray (render_frame_dense) at the same "
              f"{q.shape[0]} pixels sorted by mask: {dense_cam_ms:.3f} ms (with its scratch "
              f"image and gather); equal to the plain kernel's: {same}; vs plain flipped "
              f"{frac:.6f}, max |diff| {err:.6g}; the resumed pass at the queue in append "
              f"order (unbinned) {dense_append_ms:.3f} ms; {card}", flush=True)
        # defer's main pass: the planes against their plain version, then the
        # path's form with its queues
        k_pl = frame_kernel.render_frame_deferred_main(pack_m, shadow_cap=32, **kw_m)
        p_ms, p_pl = plain_run(
            lambda: frame_kernel.render_frame_deferred_plain(pack_m, shadow_cap=32, **kw_m))
        agree = float((k_pl.sinfo == p_pl.sinfo).float().mean())
        res = [bar(k, p) for k, p in zip(list(k_pl.lit) + list(k_pl.shadowed),
                                         list(p_pl.lit) + list(p_pl.shadowed))]
        err = max(r[3] for r in res)
        if agree < 0.999 or not all(r[0] for r in res):
            raise AssertionError("defer main pass disagrees with its plain version")
        nsl = 2
        del p_pl
        d_pl, d_queue = frame_kernel.render_frame_deferred_queue(pack_m, shadow_cap=32,
                                                                 cap=cap_m, **kw_m)
        d_counts = d_queue.count.tolist()
        for k in range(nsl):
            want = torch.nonzero((d_pl.sinfo[k].reshape(-1) & 3) == 2).squeeze(1)
            got = torch.sort(d_queue.idx[k, :d_counts[k]].long()).values
            if not torch.equal(got, want):
                raise AssertionError(f"defer queue {k} is not the unknown lanes' set")
        n_unknown = sum(d_counts)
        d_queue_a = d_queue
        d_queue = frame_kernel.bin_queue(d_queue_a, d_pl.sinfo)
        d_keys = frame_kernel.bin_keys(d_queue, d_pl.sinfo)
        pd_keys = frame_kernel.bin_keys(frame_kernel.bin_queue_plain(d_queue_a, d_pl.sinfo),
                                        d_pl.sinfo)
        for k in range(nsl):
            n = d_counts[k]
            if not (torch.equal(d_keys[k, :n], pd_keys[k, :n]) and torch.equal(
                    torch.sort(d_queue.idx[k, :n]).values, torch.sort(d_queue_a.idx[k, :n]).values)):
                raise AssertionError(f"defer queue {k}: binned order is not its plain version's")
        d_bin_ms, _ = cuda_ms(lambda: frame_kernel.bin_queue(d_queue_a, d_pl.sinfo),
                              SHORT_REPS)
        d_live_keys = torch.cat([d_keys[k, :d_counts[k]] for k in range(nsl)]).contiguous()
        d_lib_ms, _ = cuda_ms(lambda: torch.sort(d_live_keys, stable=True), SHORT_REPS)
        d_bin_bytes, d_launch_bytes = bin_bytes(d_counts, frame_kernel.defer_bins(npix), 4 + 4, 4,
                                                d_queue_a.idx.shape[1])
        d_bound_ms = bound(d_bin_bytes, 0)[0]
        repair_append_ms, _ = cuda_ms(lambda: scene_kernel.shadow_queue_planes(
            pack_m, d_pl.rays, d_queue_a.idx, d_queue_a.count, d_queue_a.rec), 10)
        print(f"[modes] queue_bin, defer queues 1920x1080 {d_counts}: one launch "
              f"{d_bin_ms:.4f} ms ({d_bin_bytes} bytes: bound {d_bound_ms:.4f} ms by bytes; the "
              f"launch's blocks move {d_launch_bytes}, {bound(d_launch_bytes, 0)[0]:.4f} ms); "
              f"torch.sort(keys, stable=True) of the live slots' keys {d_lib_ms:.4f} ms; the "
              f"repair at the queues in append order (unbinned) {repair_append_ms:.3f} ms; "
              f"{card}", flush=True)
        record("frame_defer", lambda: frame_kernel.render_frame_deferred_queue(
                   pack_m, shadow_cap=32, cap=cap_m, **kw_m), p_ms,
               err, frame_in + npix * (16 * 3 + (16 + 4 + 24) * nsl) + n_unknown * (4 + 16)
               + 4 * nsl,
               lambda: frame_kernel.render_frame_deferred_queue(
                   pack_m, shadow_cap=32, cap=cap_m, ops=ops, lib=count_lib, **kw_m),
               f"status agrees on {agree:.6f} of lanes; queues {d_counts} (each the unknown "
               f"lanes' set); contribution planes flipped <= {max(r[1] for r in res):.6f}, max "
               f"|diff| {err:.6g}")
        # the occlusion repair over those queues, resumed from the defer
        # entry's march records: against its plain version at the queued
        # pixels, and bit for bit against the whole traversal of the
        # -DGPRT_REPAIR_FULL build (the parent's repair) in both contraction
        # builds, beside which it is timed
        def repair(queue_x, **kw):
            return scene_kernel.shadow_queue_planes(pack_m, d_pl.rays, queue_x.idx, queue_x.count,
                                                    queue_x.rec, **kw)

        k_occ_p = repair(d_queue)
        p_ms, p_occ_p = plain_run(lambda: scene_kernel.shadow_queue_planes_plain(
            pack_m, d_pl.rays, d_queue.idx, d_queue.count))
        unknown = (d_pl.sinfo & 3) == 2
        agree = float((k_occ_p[unknown] == p_occ_p[unknown]).float().mean())
        if agree < 0.999:
            raise AssertionError("queue kernel disagrees with its plain version")
        full_libs = {f: build.load("scene_kernel", fmad=f, repair_full=True)
                     for f in (build.DEFAULT_FMAD, not build.DEFAULT_FMAD)}
        for f, lib_f in full_libs.items():
            with fmad_build(f):
                d_pl_f, d_queue_f = frame_kernel.render_frame_deferred_queue(
                    pack_m, shadow_cap=32, cap=cap_m, **kw_m)
                d_queue_f = frame_kernel.bin_queue(d_queue_f, d_pl_f.sinfo)
                unknown_f = (d_pl_f.sinfo & 3) == 2
                resumed_f = scene_kernel.shadow_queue_planes(
                    pack_m, d_pl_f.rays, d_queue_f.idx, d_queue_f.count, d_queue_f.rec)
            whole_f = scene_kernel.shadow_queue_planes(
                pack_m, d_pl_f.rays, d_queue_f.idx, d_queue_f.count, d_queue_f.rec, lib=lib_f)
            n_differ = int((resumed_f[unknown_f] != whole_f[unknown_f]).sum())
            print(f"[modes] resumed repair 1920x1080 fmad={f}: {int(unknown_f.sum())} queued "
                  f"rays, {n_differ} differ from the whole traversal (-DGPRT_REPAIR_FULL)",
                  flush=True)
            if n_differ:
                raise AssertionError(f"the resumed repair differs from the whole traversal "
                                     f"(fmad={f})")
        trav = frame_kernel.shared_bytes(pack_m.num_geometries, pack_m.num_materials,
                                         shading=False)
        # Per queued ray: its index, its shadow ray, its march record, its answer.
        repair_bytes = trav + n_unknown * (4 + 24 + 16 + 4) + 4 * nsl
        full_ms, _ = cuda_ms(lambda: repair(d_queue, lib=full_libs[build.DEFAULT_FMAD]), 10)
        ops.zero_()
        repair(d_queue, ops=ops, lib=build.load("scene_kernel", count_ops=True, repair_full=True))
        full_ops = int(ops.item())
        record("shadow_queue", lambda: repair(d_queue),
               p_ms, float((k_occ_p[unknown] - p_occ_p[unknown]).abs().max()), repair_bytes,
               lambda: repair(d_queue, ops=ops, lib=build.load("scene_kernel", count_ops=True)),
               f"{n_unknown} queued rays in {nsl} levels {d_counts}, resumed from their march "
               f"records; occlusion agrees with the plain version on {agree:.6f} of them; the "
               f"whole traversal (-DGPRT_REPAIR_FULL) {full_ms:.3f} ms in the same call, "
               f"{full_ops} f32 FLOPs (bound {bound(repair_bytes, full_ops)[0]:.4f} ms)")
        alone_m["shadow_queue"]["full_ms"] = full_ms
        # the recomposition, against its plain version on the same planes
        c_img = frame_kernel.frame_compose(d_pl, k_occ_p)
        alone_m["queue_bin"].update(defer_ms=d_bin_ms, defer_bound_ms=d_bound_ms,
                                    defer_library_ms=d_lib_ms)
        p_ms, pc_img = plain_run(lambda: frame_kernel.frame_compose_plain(d_pl, k_occ_p))
        c_exact = bool(torch.equal(c_img, pc_img))
        c_ok, _, _, c_err = bar(c_img, main_img)
        if not (c_exact and c_ok):
            raise AssertionError("compose kernel disagrees with its plain version or the frame")
        # Per pixel and level one contribution (lit or shadowed) and the
        # status, the occlusion plane at the unknown lanes, the image out.
        depth = 3
        compose_bytes = npix * (16 * depth + 4 * nsl + 16) + 4 * n_unknown
        torch.cuda.empty_cache()
        compose_ms, _ = cuda_ms(lambda: frame_kernel.frame_compose(d_pl, k_occ_p), SHORT_REPS)
        compose_ops = npix * 4 * (depth - 1)
        b_ms, b_by = bound(compose_bytes, compose_ops)
        alone_m["frame_compose"] = dict(ms=compose_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                                        err=0.0)
        print(f"[modes] frame_compose alone 1920x1080: bit-equal to its plain version: "
              f"{c_exact}; the deferred frame vs the plain kernel max |diff| {c_err:.6g}; kernel "
              f"{compose_ms:.3f} ms ({compose_ops} f32 adds, {compose_bytes} bytes: bound "
              f"{b_ms:.4f} ms by {b_by}); plain {p_ms:.1f} ms; {card}", flush=True)
        # the overflow gate (csrc/frame_gate.cu): the path's launch (no
        # overflow: one warp reads the count and launches nothing; the image
        # keeps every bit), and an overflowing count (the gate launches the
        # plain frame kernel from the device: the plain kernel's frame, seen
        # by a clone queued right after the gate with no synchronize between)
        g_img = m_img.clone()
        frame_kernel.render_frame_gated(pack_m, g_img, queue_m.count, cap_m, **kw_m)
        over = torch.full((1,), cap_m + 1, dtype=torch.int32, device=dev)
        o_img = torch.zeros_like(m_img)
        o_seen = frame_kernel.render_frame_gated(pack_m, o_img, over, cap_m, **kw_m).clone()
        p_ms, po_img = plain_run(lambda: frame_kernel.render_frame_gated_plain(
            pack_m, torch.zeros_like(m_img), over, cap_m, **kw_m))
        g_ok = all(bool(torch.equal(x, m_img)) for x in (g_img, o_img, o_seen))
        if not g_ok or not bar(o_img, po_img)[0]:
            raise AssertionError("overflow gate: wrong image")
        gated_ms, _ = cuda_ms(lambda: frame_kernel.render_frame_gated(
            pack_m, g_img, queue_m.count, cap_m, **kw_m), SHORT_REPS)
        gated_over_ms, _ = cuda_ms(lambda: frame_kernel.render_frame_gated(
            pack_m, o_img, over, cap_m, **kw_m), 10)
        plain_frame_ms, _ = cuda_ms(lambda: frame_kernel.render_frame_tiles(pack_m, **kw_m), 10)
        b_ms, b_by = bound(4, 0)
        alone_m["frame_gated"] = dict(ms=gated_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                                      err=float((o_img - po_img).abs().max()),
                                      overflow_ms=gated_over_ms, frame_ms=plain_frame_ms)
        print(f"[modes] frame_gated alone 1920x1080: no overflow {gated_ms:.5f} ms (one warp "
              f"reads the count; bound {b_ms:.6f} ms by {b_by}); overflow {gated_over_ms:.4f} ms "
              f"(the frame kernel launched from the device; the plain frame kernel "
              f"{plain_frame_ms:.4f} ms in the same place, ratio "
              f"{gated_over_ms / plain_frame_ms:.4f}), the plain kernel's frame bit for bit and "
              f"seen by the next operation on the stream: {g_ok}; plain {p_ms:.1f} ms; {card}",
              flush=True)

    # 11. the last kernel-table items: merged occlusion, two-phase, op probe --
    with Phase("last"):
        from gpuraytracer_tpu_torch.apps import op_probe as probe_app
        from gpuraytracer_tpu_torch.core.types import IntersectorKind, RAY_TMAX
        from gpuraytracer_tpu_torch.kernels import op_probe

        def build_scene(name, w, h, t=0.7):
            if name == "builtin":
                return builtin.build_scene(aspect=w / h, elapsed_time=t, device=dev)
            if name == "padded_sdf_showcase(28)":
                return scenes.padded_sdf_showcase(28).build(w / h, t, device=dev)
            return scenes.get_config(name).build(w / h, t, device=dev)

        t11 = time.perf_counter()
        three = ("builtin", "sdf_primitives_720p", "fractal_mandelbulb_julia_1080p")
        depth = {name: 3 if name == "builtin" else scenes.get_config(name).max_depth
                 for name in three}
        # closed forms first, its marches at geometries 28-34: the lanes of a
        # warp hold different sets of SDF geometries
        depth["padded_sdf_showcase(28)"] = depth["sdf_primitives_720p"]
        merged_env = dict(GPURT_MERGED_SHADOW="1")

        # (a) merged against sequential, the same build, bit for bit: plain,
        # compact at cap 8 (the dense entry runs merged) and defer at cap 8
        # (the queue entry runs merged), both with a queue that holds every
        # pixel.
        cases = [(name, frame_kernel.pack_frame(build_scene(name, 320, 180)), 320, 180, depth[name])
                 for name in three + ("padded_sdf_showcase(28)",)]
        cases.append(("builtin", pack_m, W_MAIN, H_MAIN, 3))
        forms = {"plain": lambda p, w, h, dd: frame_kernel.render_frame_tiles(
                     p, width=w, height=h, max_depth=dd),
                 "compact": lambda p, w, h, dd: frame_kernel.render_frame_compact(
                     p, width=w, height=h, max_depth=dd, budget_cap=8, cap_lanes=w * h),
                 "defer": lambda p, w, h, dd: frame_kernel.render_frame_deferred(
                     p, width=w, height=h, max_depth=dd, shadow_cap=8, cap_lanes=w * h)}
        ran = {"plain": "merged", "compact": "dense_merged", "defer": "queue_merged"}
        unmerged = {"plain": "plain", "compact": "dense", "defer": "queue"}
        merged_imgs = {}
        for fmad in (build.DEFAULT_FMAD, not build.DEFAULT_FMAD):
            with fmad_build(fmad):
                for name, pack_x, w, h, dd in cases:
                    for form, fn in forms.items():
                        seq = fn(pack_x, w, h, dd)
                        reset_counts()
                        with env(**merged_env):
                            img = fn(pack_x, w, h, dd)
                        torch.cuda.synchronize()
                        c = mode_counts()
                        exact = bool(torch.equal(img, seq))
                        print(f"[last] merged {name} {w}x{h} {form} fmad={fmad}: bit-equal to the "
                              f"sequential frame: {exact}; launches {c}", flush=True)
                        if not exact or c[ran[form]] != 1 or c[unmerged[form]] != 0:
                            raise AssertionError(f"merged {name} {w}x{h} {form} fmad={fmad}: "
                                                 f"not the sequential frame, or wrong entry")
                        if fmad == build.DEFAULT_FMAD and form == "plain":
                            merged_imgs[(name, w)] = img

        # (b) the merged frame against the frame kernel's plain version (the
        # other scenes' merged frames are their sequential frames, which
        # phase 7 holds to the plain version).
        ok, frac, tight, err = bar(merged_imgs[("builtin", 320)], plain_320)
        print(f"[last] merged builtin 320x180 vs plain: flipped {frac:.6f}, within 1e-5 "
              f"{tight:.6f}, max |diff| {err:.6g}; {time.perf_counter() - t11:.1f} s into the "
              f"phase", flush=True)
        if not ok:
            raise AssertionError("merged builtin frame disagrees with the plain version")
        merged_err = bar(merged_imgs[("builtin", W_MAIN)], plain_m)[3]

        # (c) a 17-material scene under the knob: the scene kernel, in sequence.
        scene_x = scenes.instance_grid(4, 4, 16).build(160 / 90, 0.7, device=dev)
        seq = trace.render_frame(scene_x, 160, 90)
        reset_counts()
        with env(**merged_env):
            img = trace.render_frame(scene_x, 160, 90)
        torch.cuda.synchronize()
        launched, c = counts(), mode_counts()
        ok, frac, _, _ = bar(img, frame_kernel.render_frame_plain(
            frame_kernel.pack_frame(scene_x), width=160, height=90))
        print(f"[last] 17 materials, GPURT_MERGED_SHADOW=1 160x90: scene kernel {launched[1]} "
              f"launches, frame-kernel family {c}; equal to the frame without the knob: "
              f"{bool(torch.equal(img, seq))}; vs plain flipped {frac:.6f}", flush=True)
        if not (ok and torch.equal(img, seq) and launched[1] > 0 and c["merged"] == 0
                and c["plain"] == 0):
            raise AssertionError("17-material scene under the knob: wrong route or image")

        # (d) 64-frame 1080p windows with and without the knob, and each
        # merged kernel alone at the shapes of phase 6 and 10.
        merged_windows = {}
        for label, mode, knob in (("plain", "plain", False), ("merged", "plain", True),
                                  ("compact merged", "compact", True),
                                  ("defer merged", "defer", True)):
            with env(GPURT_FRAME_MODE=mode, **(merged_env if knob else {})):
                ms, _, bg_max = animated_window(Renderer(W_MAIN, H_MAIN, device=dev), dev,
                                                f"builtin 1080p {label}", W_MAIN, H_MAIN)
            c = mode_counts()
            merged_windows[label] = c
            print(f"[last] Renderer 1920x1080 {label} (GPURT_FRAME_MODE={mode}, "
                  f"GPURT_MERGED_SHADOW={int(knob)}), {FRAMES} frames: {ms:.3f} ms/frame, "
                  f"{W_MAIN * H_MAIN / ms / 1e3:.3f} Mrays/s; launches {c}; background <= "
                  f"{bg_max:.3f}; {card}", flush=True)
            want = {"plain": ("plain",), "merged": ("merged",),
                    "compact merged": ("compact", "dense_merged"),
                    "defer merged": ("defer", "queue_merged")}[label]
            if c[want[0]] != FRAMES or any(c[k] == 0 for k in want) or (
                    knob and c["plain"] + c["dense"] + c["queue"] != 0):
                raise AssertionError(f"{label} window: launches {c}")

        def merged_alone(name, fn, count_fn, nbytes, p_ms, err, twin_ms, detail):
            with env(**merged_env):
                k_ms, _ = cuda_ms(fn, 10)
                ops.zero_()
                count_fn()
            torch.cuda.synchronize()
            k_ops = int(ops.item())
            b_ms, b_by = bound(nbytes, k_ops)
            alone_m[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, err=err,
                                 twin_ms=twin_ms)
            print(f"[last] {name} alone 1920x1080: {detail}; kernel {k_ms:.3f} ms ({k_ops} f32 "
                  f"FLOPs, {int(nbytes)} bytes: bound {b_ms:.4f} ms by {b_by}); plain "
                  f"{p_ms:.1f} ms (measured above on the same inputs); {card}", flush=True)

        seq_ms, _ = cuda_ms(lambda: frame_kernel.render_frame_tiles(pack_m, **kw_m), 10)
        merged_alone("frame_kernel_merged",
                     lambda: frame_kernel.render_frame_tiles(pack_m, **kw_m),
                     lambda: frame_kernel.render_frame_tiles(pack_m, ops=ops, lib=count_lib, **kw_m),
                     frame_bytes, frame_plain_ms, merged_err, seq_ms,
                     f"the sequential instantiation {seq_ms:.3f} ms in the same call; vs plain "
                     f"max |diff| {merged_err:.6g}")
        with env(**merged_env):
            rm_img = frame_kernel.render_frame_resume(pack_m, queue_m, q_img.clone(), **kw_m)
        rm_out = rm_img.reshape(-1, 4)[q_pix]
        if not torch.equal(rm_img, r_img):
            raise AssertionError("merged dense pass is not the sequential one")
        # The sequential twins timed here, beside the merged entries.
        seq_dense_ms, _ = cuda_ms(lambda: frame_kernel.render_frame_resume(
            pack_m, queue_m, rm_img, **kw_m), 10)
        merged_alone("frame_dense_merged",
                     lambda: frame_kernel.render_frame_resume(pack_m, queue_m, rm_img, **kw_m),
                     lambda: frame_kernel.render_frame_resume(pack_m, queue_m, rm_img, ops=ops,
                                                              lib=count_lib, **kw_m),
                     frame_in + n_q * (64 + 16) + 4, alone_m["frame_dense"]["plain_ms"],
                     float((rm_out - pr_out).abs().max()), seq_dense_ms,
                     f"{n_q} queued pixels resumed, equal to the sequential dense pass; the "
                     f"sequential instantiation {seq_dense_ms:.3f} ms in the same call")
        with env(**merged_env):
            m_occ = repair(d_queue)
        mq_ms, p_m_occ = plain_run(lambda: scene_kernel.shadow_queue_planes_plain(
            pack_m, d_pl.rays, d_queue.idx, d_queue.count, merged=True))
        m_agree = float((m_occ[unknown] == p_m_occ[unknown]).float().mean())
        if not torch.equal(m_occ[unknown], k_occ_p[unknown]) or m_agree < 0.999:
            raise AssertionError("merged queue disagrees with the sequential one or its plain version")
        seq_queue_ms, _ = cuda_ms(lambda: repair(d_queue), 10)
        merged_alone("shadow_queue_merged", lambda: repair(d_queue),
                     lambda: repair(d_queue, ops=ops,
                                    lib=build.load("scene_kernel", count_ops=True)),
                     repair_bytes,
                     mq_ms, float((m_occ[unknown] - p_m_occ[unknown]).abs().max()), seq_queue_ms,
                     f"{n_unknown} queued rays; equal to the sequential queue; vs its plain version "
                     f"(occluded_merged_plain) agrees on {m_agree:.6f}; the sequential "
                     f"instantiation {seq_queue_ms:.3f} ms in the same call")

        print(f"[last] merged checks done {time.perf_counter() - t11:.1f} s into the phase",
              flush=True)

        # (e) the two-phase pass on the builtin 1080p level-0 closest and
        # shadow passes (as tools/profile_dirty.py builds them), against the
        # single pass of the same build and against its plain version.
        mb_gid = [g for g, k in enumerate(scene_m.layout.kinds) if k == IntersectorKind.VOLUMETRIC]

        def explain(single, two, dirty):
            """Counts of the rays whose (t, gid) differ between the single pass
            and the two-phase form, by cause: the finisher stepped a capped
            metaball march over the interval clipped to the final best t
            (metaball), a tie of two geometries at one t (tie); and the rest
            (unexplained), which fails the phase."""
            (t1, _, g1), (t2, _, g2) = single, two
            differ = (t1 != t2) | (g1 != g2)
            mb = torch.zeros_like(differ)
            for g in mb_gid:
                mb |= ((dirty >> min(g, 31)) & 1) != 0
            tie = ~mb & (g1 != g2) & (t1 == t2)
            rest = differ & ~mb & ~tie
            return dict(metaball=int((differ & mb).sum()), tie=int((differ & tie).sum()),
                        unexplained=int(rest.sum()))

        px, py = cam.pixel_grid(W_MAIN, H_MAIN, dev)
        c0 = scene_m.arrays.constants
        o, d = cam.generate_camera_rays(px, py, W_MAIN, H_MAIN, c0.camera_position,
                                        c0.projection_to_world)
        o, d = o.reshape(-1, 3), d.reshape(-1, 3)
        hit_p, ob, db, act, t0 = traverse.pass_inputs(o, d, scene_m)
        st, sn, sg = scene_kernel.scene_closest_tiles(scene_m, ob, db, act, t0, pack=pack_m)
        t_hit = torch.where(sg >= 0, st, torch.where(hit_p, t0, RAY_TMAX))
        hp = o + t_hit[:, None] * d
        sd = hlsl.normalize(c0.light_position[:3] - hp)
        _, obs, dbs, acts, t0s = traverse.pass_inputs(hp, sd, scene_m, active=(sg >= 0) | hit_p,
                                                      occlusion=True)
        passes = {"closest": (ob, db, act, t0, False), "shadow": (obs, dbs, acts, t0s, True)}
        reset_counts()
        two = {k: scene_kernel.scene_closest_tiles(scene_m, o_, d_, a_, t_, accept_first=af,
                                                   two_phase=True, debug_dirty=True, pack=pack_m)
               for k, (o_, d_, a_, t_, af) in passes.items()}
        torch.cuda.synchronize()
        two_phase_launches = (scene_kernel.MAIN_LAUNCHES, scene_kernel.FINISH_LAUNCHES,
                              scene_kernel.FINISH_QUEUE_LAUNCHES)
        if two_phase_launches != (2, 2, 2) or scene_kernel.LAUNCHES != 0:
            raise AssertionError(f"two-phase passes launched (main, finish, compaction) "
                                 f"{two_phase_launches}")
        two_phase = {}
        for k, (o_, d_, a_, t_, af) in passes.items():
            single = scene_kernel.scene_closest_tiles(scene_m, o_, d_, a_, t_, accept_first=af,
                                                      pack=pack_m)
            *two_out, dirty = two[k]
            # An occlusion pass answers occluded or not; which geometry
            # occludes first is not part of the answer.
            answer = (lambda g: (g >= 0).to(torch.int32)) if af else (lambda g: g)
            causes = explain((single[0], None, answer(single[2])),
                             (two_out[0], None, answer(two_out[2])), dirty)
            bits = {}
            for g in range(scene_m.layout.num_procedural):
                nb = int((((dirty >> min(g, 31)) & 1) != 0).sum())
                if nb:
                    bits[f"{g} {scene_m.layout.kinds[g].name.lower()}"] = nb
            n = dirty.shape[0]
            warps = float((dirty.reshape(-1, 32) != 0).any(dim=1).float().mean())
            exact = float(((single[0] == two_out[0])
                           & (answer(single[2]) == answer(two_out[2]))).float().mean())
            print(f"[last] two-phase 1080p level-0 {k} pass ({n} rays, {int(a_.sum())} live): "
                  f"bit-equal to the single pass on {exact:.6f}; differing rays by cause "
                  f"{causes}; dirty rays {int((dirty != 0).sum())} "
                  f"({100 * float((dirty != 0).float().mean()):.3f}%), warps with a dirty ray "
                  f"{100 * warps:.2f}%; dirty rays per geometry {bits}", flush=True)
            if causes["unexplained"]:
                raise AssertionError(f"two-phase {k} pass: rays differ without a named cause")
            # Each entry alone (the finisher on fresh copies of the main
            # pass's outputs), with op counts and bounds.
            kw_p = dict(level=0, accept_first=af, pack=pack_m)
            main_ms, main_out = cuda_ms(lambda: scene_kernel.scene_main_pass(
                scene_m, o_, d_, a_, t_, **kw_p), 10)
            ops.zero_()
            scene_kernel.scene_main_pass(scene_m, o_, d_, a_, t_, ops=ops,
                                         lib=build.load("scene_kernel", count_ops=True),
                                         **kw_p)
            torch.cuda.synchronize()
            main_ops = int(ops.item())
            dirty_m = main_out[3]
            n_dirty = int((dirty_m != 0).sum())

            def finish_ms(lib=None, reps=10):
                """Mean ms of the finish step (the compaction and the finisher
                over the queue; the per-ray build: one launch over every ray)
                on fresh copies of the main pass's outputs, and its
                outputs."""
                work = [x.clone() for x in main_out[:3]]
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                total = 0.0
                for r in range(reps + 1):
                    # The card waits first, so that the host's launches are
                    # queued before the timed ones run (as cuda_ms does).
                    torch.cuda._sleep(10 ** 6)
                    for w_, m_ in zip(work, main_out[:3]):
                        w_.copy_(m_)
                    start.record()
                    scene_kernel.scene_finish(scene_m, o_, d_, dirty_m, *work, accept_first=af,
                                              pack=pack_m, lib=lib)
                    end.record()
                    torch.cuda.synchronize()
                    if r:
                        total += start.elapsed_time(end) / reps
                return total, work

            # The parent's finisher (one thread per ray, -DGPRT_FINISH_PER_RAY)
            # around the shipped one, in turns; the outputs bit for bit.
            per_ray = build.load("scene_finish", finish_per_ray=True)
            ray_ms_a, ray_out = finish_ms(per_ray)
            fin_ms, fin_out = finish_ms()
            ray_ms_b, _ = finish_ms(per_ray)
            ray_ms = (ray_ms_a + ray_ms_b) / 2
            fin_equal = all(bool(torch.equal(a_, b_)) for a_, b_ in zip(fin_out, ray_out))
            if not fin_equal:
                raise AssertionError(f"two-phase {k} pass: the queued finisher is not the "
                                     f"per-ray finisher bit for bit")
            # The compaction alone, its queue against its plain version.
            queue_ms, queue_k = cuda_ms(lambda: scene_kernel.scene_finish_queue(dirty_m),
                                        SHORT_REPS)
            live = int(queue_k.count[0])
            p_queue_ms, queue_p = plain_run(lambda: scene_kernel.scene_finish_queue_plain(dirty_m))
            q_live, p_live = queue_k.idx[:live].long(), queue_p.idx[:live].long()
            queue_ok = (live == int(queue_p.count[0]) == n_dirty
                        and bool(torch.equal(torch.sort(q_live).values,
                                             torch.sort(p_live).values))
                        and bool(torch.equal(scene_kernel.finish_key(dirty_m[q_live]),
                                             scene_kernel.finish_key(dirty_m[p_live]))))
            if not queue_ok:
                raise AssertionError(f"two-phase {k} pass: the finisher's queue is not its "
                                     f"plain version's set in key order")
            # The one PyTorch call that orders the same keys: a stable sort
            # of the dirty rays' keys (as the bin's row 2q reads it).
            dirty_keys = scene_kernel.finish_key(dirty_m[dirty_m != 0])
            queue_lib_ms = cuda_ms(lambda: torch.sort(dirty_keys, stable=True), SHORT_REPS)[0]
            ops.zero_()
            scene_kernel.scene_finish(scene_m, o_, d_, dirty_m,
                                      *[x.clone() for x in main_out[:3]], accept_first=af,
                                      pack=pack_m, ops=ops,
                                      lib=build.load("scene_finish", count_ops=True))
            torch.cuda.synchronize()
            fin_ops = int(ops.item())
            shared = frame_kernel.shared_bytes(pack_m.num_geometries, pack_m.num_materials,
                                               shading=False)
            main_bytes = shared + n * (29 + 20 + 4)
            # The finish step reads every dirty word and, at each dirty ray,
            # o, d and the main pass's answer, and writes the answer there;
            # the compaction reads every word and writes the queue and count.
            fin_bytes = shared + n * 4 + n_dirty * (24 + 2 * 20)
            queue_bytes = n * 4 + live * 4 + 4
            warps_ray = int((dirty_m.reshape(-1, 32) != 0).any(dim=1).sum())
            warps_queue = (live + 31) // 32
            two_phase[k] = dict(main_ms=main_ms, main_ops=main_ops, main_bytes=main_bytes,
                                fin_ms=fin_ms, fin_ops=fin_ops, fin_bytes=fin_bytes,
                                ray_ms=ray_ms, queue_ms=queue_ms, queue_plain_ms=p_queue_ms,
                                queue_bytes=queue_bytes, queue_library_ms=queue_lib_ms)
            mb_, mby = bound(main_bytes, main_ops)
            fb_, fby = bound(fin_bytes, fin_ops)
            qb_, qby = bound(queue_bytes, 0)
            print(f"[last] two-phase 1080p {k} entries alone: main {main_ms:.3f} ms ({main_ops} "
                  f"f32 FLOPs, {main_bytes} bytes: bound {mb_:.4f} ms by {mby}); finish step "
                  f"{fin_ms:.4f} ms over {n_dirty} dirty rays (the compaction alone "
                  f"{queue_ms:.4f} ms, bound {qb_:.4f} ms by {qby}; the finisher over the queue "
                  f"{fin_ms - queue_ms:.4f} ms by difference; {fin_ops} f32 FLOPs, {fin_bytes} "
                  f"bytes: bound {fb_:.4f} ms by {fby}); the parent's finisher (one thread per "
                  f"ray) {ray_ms_a:.4f} / {ray_ms_b:.4f} ms in turns, its outputs bit for bit: "
                  f"{fin_equal}; warps that march {warps_queue} (one thread per ray: "
                  f"{warps_ray} warps hold a dirty ray); queue of {live} rays in key order, its "
                  f"plain version {p_queue_ms:.1f} ms, torch.sort(keys, stable=True) of its keys "
                  f"{queue_lib_ms:.4f} ms; {card}", flush=True)
        # The plain version of both entries on the closest pass.
        ob_, db_, a_, t_, _ = passes["closest"]
        tp_main_ms, p_main = plain_run(lambda: scene_kernel.scene_main_plain(
            scene_m, ob_, db_, a_, t_))
        tp_fin_ms, p_fin = plain_run(lambda: scene_kernel.scene_finish_plain(
            scene_m, ob_, db_, p_main[3], *p_main[:3]))
        *k_two, k_dirty = two["closest"]
        same = k_two[2] == p_fin[2]
        dts = (k_two[0] - p_fin[0]).abs()[same & (p_fin[2] >= 0)]
        tp_err = float(dts.max())
        dirty_agree = float((k_dirty == p_main[3]).float().mean())
        # The finisher changes only dirty rays: hold them on their own too.
        on_dirty = float(same[p_main[3] != 0].float().mean())
        print(f"[last] two-phase 1080p closest vs its plain version: gid agrees on "
              f"{float(same.float().mean()):.6f} (on the {int((p_main[3] != 0).sum())} dirty "
              f"rays {on_dirty:.6f}), |dt| <= 1e-3 on "
              f"{float((dts <= 1e-3).float().mean()):.6f}, max |dt| {tp_err:.6g}; dirty words "
              f"agree on {dirty_agree:.6f}; plain main {tp_main_ms:.1f} ms, plain finish "
              f"{tp_fin_ms:.1f} ms", flush=True)
        if float(same.float().mean()) < 0.9999 or dirty_agree < 0.9999 or on_dirty < 0.999:
            raise AssertionError("two-phase 1080p pass disagrees with its plain version")

        print(f"[last] 1080p two-phase done {time.perf_counter() - t11:.1f} s into the phase",
              flush=True)

        # (f) two-phase against its plain version on 320x180 ray batches: per
        # scene the reflections of the camera rays (closest, level 1: the
        # finisher marches at the level-0 budget where the single pass takes
        # the bounce budget) and, for the builtin scene, the camera rays
        # (closest, level 0) and the shadow rays (level 0; at level 1 the main
        # pass's cap is the plain budget, so capped shadow rays are occluded
        # there and the finisher has nothing to do). Each plain two-phase
        # pass takes 3-6 s on the host; (e) holds the 1080p closest and
        # shadow passes to the single pass.
        for name in three:
            scene_b = build_scene(name, 320, 180)
            pack_b = frame_kernel.pack_frame(scene_b)
            px, py = cam.pixel_grid(320, 180, dev)
            cb = scene_b.arrays.constants
            o, d = cam.generate_camera_rays(px, py, 320, 180, cb.camera_position,
                                            cb.projection_to_world)
            o, d = o.reshape(-1, 3), d.reshape(-1, 3)
            hit = traverse.closest_hit(o, d, scene_b, level=0, plain=True)
            hp = o + hit.t[:, None] * d
            sh = hlsl.normalize(cb.light_position[:3] - hp)
            batches = [("reflection, closest, level 1", hp, hlsl.reflect(d, hit.normal),
                        hit.hit, 1, False)]
            if name == "builtin":
                batches += [("camera, closest, level 0", o, d, None, 0, False),
                            ("shadow, level 0", hp, sh, hit.hit, 0, True)]
            for label, o_, d_, a_, level, af in batches:
                _, obb, dbb, ab, tb = traverse.pass_inputs(o_, d_, scene_b, active=a_,
                                                           occlusion=af)
                pt, _, pg, pdirty = scene_kernel.scene_two_phase_plain(
                    scene_b, obb, dbb, ab, tb, level=level, accept_first=af)
                line, ok = [], True
                for fmad in (build.DEFAULT_FMAD, not build.DEFAULT_FMAD):
                    kt, _, kg, kdirty = scene_kernel.scene_closest_tiles(
                        scene_b, obb, dbb, ab, tb, level=level, accept_first=af, two_phase=True,
                        debug_dirty=True, pack=pack_b, lib=build.load("scene_kernel", fmad=fmad),
                        finish_lib=build.load("scene_finish", fmad=fmad))
                    same = kg == pg
                    dt = (kt - pt).abs()[same & (pg >= 0)]
                    agree = float(same.float().mean())
                    # The finisher changes only dirty rays: hold them on their own too.
                    on_dirty = float(same[pdirty != 0].float().mean()) if bool(
                        (pdirty != 0).any()) else 1.0
                    close = float((dt <= 1e-3).float().mean()) if dt.numel() else 1.0
                    dt_max = float(dt.max()) if dt.numel() else 0.0
                    dirty_ok = float((kdirty == pdirty).float().mean())
                    ok = ok and agree >= 0.9999 and dirty_ok >= 0.9999 and on_dirty >= 0.99 and (
                        close >= 0.98 if fmad == build.DEFAULT_FMAD else dt_max <= 1e-3)
                    if fmad == build.DEFAULT_FMAD:
                        tp_err = max(tp_err, dt_max)
                    line.append(f"fmad={fmad}: gid agrees on {agree:.6f} (dirty rays "
                                f"{on_dirty:.6f}), |dt| <= 1e-3 on {close:.6f}, max |dt| "
                                f"{dt_max:.6g}, dirty words agree on {dirty_ok:.6f}")
                print(f"[last] two-phase {name} 320x180 {label}: {int(ab.sum())} live rays, "
                      f"{int((pdirty != 0).sum())} dirty; " + "; ".join(line), flush=True)
                if not ok:
                    raise AssertionError(f"two-phase {name} {label}: disagrees with plain")

        print(f"[last] 320x180 two-phase batches done {time.perf_counter() - t11:.1f} s into "
              f"the phase", flush=True)

        # (g) the op probe: every variant against its plain version (bf16:
        # the packed pairs element for element against the scalar build,
        # -DGPRT_PROBE_BF16_SCALAR, and the plain version, on the reference's
        # array and on a seeded one), then the reference's run (2000
        # iterations) through apps/op_probe.py, and each variant priced by
        # pipe from its SASS.
        probe_err = 0.0
        scalar_lib = build.load("op_probe", defines=op_probe.SCALAR_DEFINES)
        gen = torch.Generator().manual_seed(11)
        seeded = torch.rand(op_probe.SHAPE, generator=gen) * 1.5 + 0.25
        for name, dtype in op_probe.DTYPES.items():
            x = torch.full(op_probe.SHAPE, op_probe.FILL, dtype=dtype, device=dev)
            for opn in op_probe.OPS:
                for iters in (1, 4):  # the fma chain is inf from the second iteration
                    if name == "bf16":
                        line, ok = [], True
                        for label, xs in (("reference", x), ("seeded", seeded.to(dev, dtype))):
                            got = op_probe.op_probe(xs, opn, iters)
                            scalar = op_probe.op_probe(xs, opn, iters, lib=scalar_lib)
                            want = op_probe.op_probe_plain(xs, opn, iters)
                            d_s, d_p = int((got != scalar).sum()), int((got != want).sum())
                            ok = ok and d_s == 0 and d_p == 0
                            line.append(f"{label} array: {d_s} elements differ from the scalar "
                                        f"build, {d_p} from plain")
                        print(f"[last] op probe {opn} bf16 packed pairs, {iters} iterations: "
                              + "; ".join(line), flush=True)
                        if not ok:
                            raise AssertionError(f"op probe {opn} bf16: the packed pairs are not "
                                                 f"the scalar build and the plain version")
                        continue
                    got = op_probe.op_probe(x, opn, iters).float()
                    want = op_probe.op_probe_plain(x, opn, iters).float()
                    inf = torch.isinf(want)
                    diff = (got - want)[~inf].abs()
                    rel = float((diff / want[~inf].abs().clamp(min=1e-30)).max()) if diff.numel() else 0.0
                    ok = bool(torch.equal(got[inf], want[inf])) and rel <= 1e-6
                    if diff.numel() and iters == 4:  # the bounded mixes (fma is inf)
                        probe_err = max(probe_err, float(diff.max()))
                    print(f"[last] op probe {opn} {name}, {iters} iterations: max relative diff "
                          f"{rel:.3g} (bar 1e-06), inf where plain is inf: "
                          f"{bool(torch.equal(got[inf], want[inf]))}", flush=True)
                    if not ok:
                        raise AssertionError(f"op probe {opn} {name} disagrees with its plain "
                                             f"version")
        reset_counts()
        op_probe.LAUNCHES = 0
        probe = probe_app.run(2000, 20, dev)
        probe_launches = op_probe.LAUNCHES
        op_probe.LATENCY_LAUNCHES = 0
        pipes = probe_app.pipes(2000, 8, dev)
        scalar_sass = probe_app.sass_loop_counts(scalar_lib._name)
        lat = pipes["latencies"]
        print(f"[last] op probe latency chains ({op_probe.LATENCY_LAUNCHES} launches, one "
              f"thread, {op_probe.CHAIN_LENGTH} dependent links a round), cycles an "
              f"instruction: " + "; ".join(
                  f"{k} {c['cycles']:.2f} (family {c['family']}; SASS a round {c['opcodes']})"
                  for k, c in lat["classes"].items())
              + "; the prices: " + ", ".join(f"{k} {v:.2f}" for k, v in lat["families"].items())
              + f", any other family {lat['floor']:.2f}; {card}", flush=True)
        if op_probe.LATENCY_LAUNCHES == 0 or not all(
                0.5 < c["cycles"] < 200 for c in lat["classes"].values()):
            raise AssertionError(f"op probe latency chains: {lat['classes']}")
        probe_ms = probe_plain_ms = probe_bound = probe_pipe_bound = 0.0
        bound_share = {"bytes": 0.0, "operations": 0.0}
        pipe_share = {}
        rates = {"f32": F32_OPS_PER_S, "bf16": BF16_OPS_PER_S}
        for key, r in probe["variants"].items():
            opn, name = key.split("_")
            x = torch.full(op_probe.SHAPE, op_probe.FILL, dtype=op_probe.DTYPES[name], device=dev)
            p_ms, _ = plain_run(lambda: op_probe.op_probe_plain(x, opn, 2000))
            nbytes = 2 * x.numel() * x.element_size()
            n_ops = 2000 * x.numel() * op_probe.FLOPS_PER_ITER[opn]
            b_ms, b_by = bound(nbytes, n_ops, rates[name])
            pp = pipes["variants"][key]
            probe_ms += r["ms"]
            probe_plain_ms += p_ms
            probe_bound += b_ms
            probe_pipe_bound += pp["bound_ms"]
            bound_share[b_by] += b_ms
            pipe_share[pp["bound_by"]] = pipe_share.get(pp["bound_by"], 0.0) + pp["bound_ms"]
            scalar_line = ""
            if name == "bf16":
                s_ms = probe_app.time_variant(x, opn, 2000, 20, scalar_lib)
                scalar_line = (f"; the scalar build {s_ms:.4f} ms (packed/scalar "
                               f"{r['ms'] / s_ms:.3f}), its SASS a iteration "
                               f"{scalar_sass[(opn, 'bf16')]['pipes']}")
            terms = ", ".join(f"{k} {v:.4f}" for k, v in pp["terms"].items())
            print(f"[last] op probe {key}, 2000 iterations over {x.numel()} elements: "
                  f"{r['ms']:.4f} ms, {r['ns_per_elem_iter']:.6f} ns/elem-iter; SASS a iteration "
                  f"{pp['sass']['pipes']} ({pp['sass']['opcodes']}); dependent chain "
                  f"{pp['chain_cycles_per_iter']:.2f} cycles an iteration at the chains' "
                  f"latencies (a lower bound); read: one warp {pp['one_warp_cycles_per_iter']:.2f} cycles "
                  f"({pp['one_warp_ns_per_iter']:.3f} ns) an iteration, the full card "
                  f"{pp['throughput_ns_per_elem_iter']:.7f} "
                  f"ns/elem-iter; bound by pipe {pp['bound_ms']:.4f} ms by {pp['bound_by']} "
                  f"({terms}); FLOP bound {b_ms:.4f} ms by {b_by} ({n_ops} {name} FLOPs at "
                  f"{rates[name] / 1e12:.1f} TFLOP/s, {nbytes} bytes); plain {p_ms:.1f} ms"
                  f"{scalar_line}; {card}", flush=True)
        print(f"[last] op probe bf16/f32: " + ", ".join(
            f"{k} {v:.3f}" for k, v in probe["bf16_over_f32"].items()) + f"; {probe_launches} "
            f"launches; bound over the ten variants: by pipe {probe_pipe_bound:.4f} ms, by FLOPs "
            f"{probe_bound:.4f} ms; SM clock {pipes['clock_hz'] / 1e6:.0f} MHz (nvidia-smi's "
            f"maximum), {pipes['sms']} SMs; {card}", flush=True)
        probe_bound_by = max(bound_share, key=bound_share.get)
        probe_pipe_bound_by = max(pipe_share, key=pipe_share.get)

    # 12. SIMT efficiency of the frame kernel and the scene pass --------------
    with Phase("simt"):
        simt_libs = {name: build.load(name, count_simt=True)
                     for name in ("frame_kernel", "scene_kernel")}
        fr_cfg = scenes.get_config("fractal_mandelbulb_julia_1080p")
        pack_fr = frame_kernel.pack_frame(fr_cfg.build(W_MAIN / H_MAIN, 0.0333 * 8, device=dev))
        simt = {}

        def simt_report(label, cnt):
            eff = frame_kernel.simt_efficiency(cnt)
            simt[label] = eff
            for key, (e, lanes, warps) in eff.items():
                where = "all levels" if key == "all" else f"level {key[0]} {key[1]}"
                print(f"[simt] {label}, {where}: {100 * e:.2f}% of the warp's lanes march "
                      f"({lanes} lane-samples, {warps:.1f} warp-samples)", flush=True)

        for label, pack_x, depth, ref in (("builtin", pack_m, 3, main_img),
                                          ("fractal_mandelbulb_julia_1080p", pack_fr,
                                           fr_cfg.max_depth, None)):
            cnt = torch.zeros(frame_kernel.SIMT_COUNTERS, dtype=torch.int64, device=dev)
            img = frame_kernel.render_frame_tiles(pack_x, width=W_MAIN, height=H_MAIN,
                                                  max_depth=depth, lib=simt_libs["frame_kernel"],
                                                  ops=cnt)
            # The counting build adds atomics only: the shipped build's frame.
            if ref is not None and not torch.equal(img, ref):
                raise AssertionError("the SIMT-counting frame kernel changed the frame")
            simt_report(f"frame kernel {label} 1080p", cnt)
        for kind, (o_, d_, a_, t_, af) in passes.items():
            cnt = torch.zeros(frame_kernel.SIMT_COUNTERS, dtype=torch.int64, device=dev)
            scene_kernel.scene_closest_tiles(scene_m, o_, d_, a_, t_, accept_first=af,
                                             pack=pack_m, lib=simt_libs["scene_kernel"], ops=cnt)
            simt_report(f"scene kernel builtin 1080p level-0 {kind} pass", cnt)
        # Rows 1m, 2m and 4m beside their sequential twins (rows 1, 2's
        # dense pass and 4) on the same inputs: the builtin 1080p frame, the
        # dense pass at phase 10's binned compact queue, the repair at its
        # binned defer queues.
        for knob in (False, True):
            tag = " GPURT_MERGED_SHADOW=1" if knob else ""
            with env(**(merged_env if knob else {})):
                if knob:
                    cnt = torch.zeros(frame_kernel.SIMT_COUNTERS, dtype=torch.int64, device=dev)
                    img = frame_kernel.render_frame_tiles(pack_m, width=W_MAIN, height=H_MAIN,
                                                          lib=simt_libs["frame_kernel"], ops=cnt)
                    if not torch.equal(img, main_img):
                        raise AssertionError("the SIMT-counting merged frame kernel changed the frame")
                    simt_report(f"frame kernel builtin 1080p{tag}", cnt)
                cnt = torch.zeros(frame_kernel.SIMT_COUNTERS, dtype=torch.int64, device=dev)
                img = frame_kernel.render_frame_resume(pack_m, queue_m, q_img.clone(), **kw_m,
                                                       lib=simt_libs["frame_kernel"], ops=cnt)
                if not torch.equal(img, r_img):
                    raise AssertionError("the SIMT-counting dense pass changed the frame")
                simt_report(f"dense pass builtin 1080p, {n_q} queued pixels{tag}", cnt)
                cnt = torch.zeros(frame_kernel.SIMT_COUNTERS, dtype=torch.int64, device=dev)
                occ_s = repair(d_queue, lib=simt_libs["scene_kernel"], ops=cnt)
                if not torch.equal(occ_s[unknown], k_occ_p[unknown]):
                    raise AssertionError("the SIMT-counting repair changed its answers")
                simt_report(f"repair builtin 1080p, {n_unknown} queued rays{tag}", cnt)
        # The resumed repair's occlusion samples beside the whole traversal's
        # (the -DGPRT_REPAIR_FULL build) on the same queues.
        cnt = torch.zeros(frame_kernel.SIMT_COUNTERS, dtype=torch.int64, device=dev)
        occ_s = repair(d_queue, lib=build.load("scene_kernel", count_simt=True, repair_full=True),
                       ops=cnt)
        if not torch.equal(occ_s[unknown], k_occ_p[unknown]):
            raise AssertionError("the SIMT-counting whole-traversal repair changed its answers")
        simt_report(f"repair builtin 1080p, {n_unknown} queued rays, whole traversal "
                    f"(-DGPRT_REPAIR_FULL)", cnt)

    # 13. host: the CLI and the preview server on the card --------------------
    with Phase("host"):
        host_phase(dev, card, pack_m)

    # 14. bands: row-band sharding over a mesh and a gloo world ---------------
    with Phase("bands"):
        bands_phase(dev, card)

    # 15. parity against the committed CPU reference renders ------------------
    with Phase("parity"):
        dist = parity_phase(card)
        dist_bound, dist_bound_by = bound(dist["bytes"], dist["flops"])

    # 16. bench: the bench suite's command line and report on the card -------
    with Phase("bench"):
        bench_phase(dev, card)

    # 17. programs: the frame programs and row 10 -----------------------------
    with Phase("programs"):
        state_row = programs_phase(dev, card, frame_ms)

    print(f"[total] {time.perf_counter() - t_start:.1f} s", flush=True)
    kernels = [{
        "name": "frame_kernel",
        "route": "cuda",
        "source": "gpuraytracer_tpu_torch/kernels/csrc/frame_kernel.cu",
        "replaces": "gpuraytracer_tpu/kernels/frame_kernel.py:672",
        "launches": frame_launches,
        "max_abs_err": frame_err,
        "ms": frame_ms,
        "plain_ms": frame_plain_ms,
        "bound_ms": frame_bound,
        "bound_by": frame_bound_by,
        "library_ms": None,
    }, {
        "name": "scene_kernel",
        "route": "cuda",
        "source": "gpuraytracer_tpu_torch/kernels/csrc/scene_kernel.cu",
        "replaces": "gpuraytracer_tpu/kernels/scene_kernel.py:1854",
        "launches": scene_launches,
        "max_abs_err": scene_err,
        "ms": scene_ms,
        "plain_ms": scene_plain_ms,
        "bound_ms": scene_bound,
        "bound_by": scene_bound_by,
        "library_ms": None,
    }, {
        "name": "megakernel_route_pass",
        "route": "cuda",
        "source": "gpuraytracer_tpu_torch/kernels/csrc/megakernel.cu",
        "replaces": "gpuraytracer_tpu/kernels/megakernel.py:103",
        "launches": pass_launches,
        "max_abs_err": route["closest"]["err"],
        "ms": route["closest"]["ms"],
        "plain_ms": route["closest"]["plain_ms"],
        "bound_ms": route["closest"]["bound_ms"],
        "bound_by": route["closest"]["bound_by"],
        "library_ms": None,
    }, {
        "name": "megakernel_sphere_trace",
        "route": "cuda",
        "source": "gpuraytracer_tpu_torch/kernels/csrc/megakernel.cu",
        "replaces": "gpuraytracer_tpu/kernels/megakernel.py:103",
        "launches": mega_launches,
        "max_abs_err": max(mega_err, alone["march"]["err"]),
        "ms": alone["march"]["ms"],
        "plain_ms": alone["march"]["plain_ms"],
        "bound_ms": alone["march"]["bound_ms"],
        "bound_by": alone["march"]["bound_by"],
        "library_ms": None,
        # The generic march's build (the parent's) timed in the same call
        # in turns, and the longest marches alone (a measurement).
        "generic_ms": march_row["ms"]["generic"],
        "shipped_in_turns_ms": march_row["ms"]["shipped"],
        "longest_ray_ms": march_row["longest_ms"],
    }, {
        "name": "megakernel_trimesh",
        "route": "cuda",
        "source": "gpuraytracer_tpu_torch/kernels/csrc/megakernel.cu",
        "replaces": "gpuraytracer_tpu/geometry/trimesh.py:135",
        "launches": mesh_launches,
        "max_abs_err": alone["mesh"]["err"],
        "ms": alone["mesh"]["ms"],
        "plain_ms": alone["mesh"]["plain_ms"],
        "bound_ms": alone["mesh"]["bound_ms"],
        "bound_by": alone["mesh"]["bound_by"],
        "library_ms": None,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"gpuraytracer_tpu_torch/kernels/csrc/{src}",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": alone_m[name]["err"],
        "ms": alone_m[name]["ms"],
        "plain_ms": alone_m[name]["plain_ms"],
        "bound_ms": alone_m[name]["bound_ms"],
        "bound_by": alone_m[name]["bound_by"],
        "library_ms": alone_m[name].get("library_ms"),
        # The merged rows: their sequential instantiation, timed in the same
        # call; the repair: its whole traversal (-DGPRT_REPAIR_FULL); the bin:
        # its time, bound and library call on the defer queues.
        # the gate: its overflow's time beside the plain frame kernel's.
        **{key: alone_m[name][key] for key in ("twin_ms", "full_ms", "defer_ms",
                                               "defer_bound_ms", "defer_library_ms",
                                               "overflow_ms", "frame_ms")
           if key in alone_m[name]},
    } for name, src, replaces, launches in (
        ("frame_compact", "frame_kernel.cu", "gpuraytracer_tpu/kernels/frame_kernel.py:803",
         windows["compact"]["compact"]),
        ("frame_dense", "frame_kernel.cu", "gpuraytracer_tpu/kernels/frame_kernel.py:803",
         windows["compact"]["dense"]),
        ("frame_defer", "frame_kernel.cu", "gpuraytracer_tpu/kernels/frame_kernel.py:1075",
         windows["defer"]["defer"]),
        ("shadow_queue", "scene_kernel.cu", "gpuraytracer_tpu/kernels/frame_kernel.py:1016",
         windows["defer"]["queue"]),
        ("frame_compose", "frame_kernel.cu", "gpuraytracer_tpu/kernels/frame_kernel.py:1075",
         windows["defer"]["compose"]),
        ("frame_gated", "frame_gate.cu", "gpuraytracer_tpu/kernels/frame_kernel.py:1004",
         windows["compact"]["gated"] + windows["defer"]["gated"]),
        ("queue_bin", "frame_kernel.cu", "gpuraytracer_tpu/kernels/frame_kernel.py:934",
         windows["compact"]["bin"] + windows["defer"]["bin"]),
        ("frame_kernel_merged", "frame_kernel.cu", "gpuraytracer_tpu/kernels/scene_kernel.py:466",
         merged_windows["merged"]["merged"]),
        ("frame_dense_merged", "frame_kernel.cu", "gpuraytracer_tpu/kernels/scene_kernel.py:466",
         merged_windows["compact merged"]["dense_merged"]),
        ("shadow_queue_merged", "scene_kernel.cu", "gpuraytracer_tpu/kernels/scene_kernel.py:466",
         merged_windows["defer merged"]["queue_merged"]))] + [{
        "name": f"scene_two_phase_{entry}",
        "route": "cuda",
        "source": f"gpuraytracer_tpu_torch/kernels/csrc/{src}",
        "replaces": f"gpuraytracer_tpu/kernels/scene_kernel.py:{line}",
        "launches": launches,
        "max_abs_err": tp_err,
        "ms": two_phase["closest"][f"{key}_ms"],
        "plain_ms": plain_ms,
        "bound_ms": bound(two_phase["closest"][f"{key}_bytes"], two_phase["closest"][f"{key}_ops"])[0],
        "bound_by": bound(two_phase["closest"][f"{key}_bytes"], two_phase["closest"][f"{key}_ops"])[1],
        "library_ms": None,
        # the finish step: the parent's one thread per ray in the same call.
        **({"ray_ms": two_phase["closest"]["ray_ms"]} if entry == "finish" else {}),
    } for entry, key, src, line, launches, plain_ms in (
        ("main", "main", "scene_kernel.cu", 2008, two_phase_launches[0], tp_main_ms),
        ("finish", "fin", "scene_finish.cu", 2017, two_phase_launches[1], tp_fin_ms))] + [{
        "name": "scene_finish_queue",
        "route": "cuda",
        "source": "gpuraytracer_tpu_torch/kernels/csrc/scene_finish.cu",
        "replaces": "gpuraytracer_tpu/kernels/scene_kernel.py:2017",
        "launches": two_phase_launches[2],
        "max_abs_err": 0.0,
        "ms": two_phase["closest"]["queue_ms"],
        "plain_ms": two_phase["closest"]["queue_plain_ms"],
        "bound_ms": bound(two_phase["closest"]["queue_bytes"], 0)[0],
        "bound_by": bound(two_phase["closest"]["queue_bytes"], 0)[1],
        "library_ms": two_phase["closest"]["queue_library_ms"],
    }] + [{
        "name": "sdf_distance",
        "route": "cuda",
        "source": "gpuraytracer_tpu_torch/kernels/csrc/scene_kernel.cu",
        "replaces": "tools/parity_bisect.py:107",
        "launches": dist["launches"],
        "max_abs_err": dist["max_abs_vs_plain"],
        "ms": dist["ms"],
        "plain_ms": dist["plain_ms"],
        "bound_ms": dist_bound,
        "bound_by": dist_bound_by,
        "library_ms": None,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "gpuraytracer_tpu_torch/kernels/csrc/wavefront.cu",
        "replaces": "gpuraytracer_tpu/render/trace.py:127",
        "launches": lane_launches[name],
        "max_abs_err": lane_rows[name]["err"],
        "ms": lane_rows[name]["ms"],
        "plain_ms": lane_rows[name]["plain_ms"],
        "bound_ms": lane_rows[name]["bound_ms"],
        "bound_by": lane_rows[name]["bound_by"],
        "library_ms": None,
        # the same kernel at mesh_heightfield_sdf's level-0 inputs (the
        # per-geometry route), in the same run
        "route_ms": lane_rows_9[name]["ms"],
        "route_plain_ms": lane_rows_9[name]["plain_ms"],
    } for name in ("wavefront_start", "wavefront_hit", "wavefront_shade")] + [{
        "name": "op_probe",
        "route": "cuda",
        "source": "gpuraytracer_tpu_torch/kernels/csrc/op_probe.cu",
        "replaces": "tools/profile_vpu.py:36",
        "launches": probe_launches,
        "max_abs_err": probe_err,
        "ms": probe_ms,
        "plain_ms": probe_plain_ms,
        "bound_ms": probe_bound,
        "bound_by": probe_bound_by,
        "library_ms": None,
        # The bound by pipe: each variant's SASS priced at its pipes' rates,
        # its issue slots and its dependent chain at the latency chains'
        # latencies (apps/op_probe.py pipes).
        "pipe_bound_ms": probe_pipe_bound,
        "pipe_bound_by": probe_pipe_bound_by,
    }, {key: v for key, v in state_row.items() if key != "programs"}]
    # Registers of the shipped build's shared-layout instantiations (ptxas)
    # and, for rows 1, 1m, 5 and the two-phase main pass, resident blocks
    # per SM.
    ptxas_name = {
        "frame_kernel": "frame_kernel<false, true>", "scene_kernel": "scene_kernel<false, true>",
        "megakernel_sphere_trace": f"sphere_trace<{march_row['code']}>",
        "megakernel_trimesh": "trimesh",
        "megakernel_route_pass": "route_pass<true>",
        "frame_compact": "frame_compact_kernel<true>",
        "frame_dense": "frame_dense_kernel<false, true>", "frame_defer": "frame_defer_kernel<true>",
        "shadow_queue": "shadow_queue_kernel<false, true, true>",
        "frame_compose": "frame_compose_kernel",
        "frame_gated": "frame_gate.cu frame_gate_kernel<false, true>",
        "queue_bin": "queue_bin_kernel<false>",
        "frame_kernel_merged": "frame_kernel<true, true>",
        "frame_dense_merged": "frame_dense_kernel<true, true>",
        "shadow_queue_merged": "shadow_queue_kernel<true, true, true>",
        "scene_two_phase_main": "scene_kernel<true, true>",
        "scene_two_phase_finish": "finish_queue_kernel<true>",
        "scene_finish_queue": "finish_append_kernel", "op_probe": "op_probe_kernel",
        "wavefront_start": "wavefront_start_kernel", "wavefront_hit": "wavefront_hit_kernel",
        "wavefront_shade": "wavefront_shade_kernel",
        "sdf_distance": "sdf_probe", "frame_state": "frame_state_kernel"}
    resident["megakernel_sphere_trace"] = march_row["resident"]["shipped"]
    resident["scene_two_phase_main"] = scene_kernel.residency(pack_m, entry="main")
    resident["frame_dense"] = frame_kernel.residency(pack_m, dense=True)
    resident["shadow_queue"] = scene_kernel.residency(pack_m, entry="repair")
    with env(GPURT_MERGED_SHADOW="1"):
        resident["frame_dense_merged"] = frame_kernel.residency(pack_m, dense=True)
        resident["shadow_queue_merged"] = scene_kernel.residency(pack_m, entry="repair")
    for k in kernels:
        k["registers"] = registers.get(ptxas_name.get(k["name"], ""))
        k["spill_stores"] = spills.get(ptxas_name.get(k["name"], ""))
        k["resident_blocks"] = resident[k["name"]][0] if k["name"] in resident else None
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
