#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases (each prints its result and its seconds; any failure raises and
exits non-zero):
  1. device   fail without CUDA; print the card's name and power limit
  2. build    build the three kernel libraries from csrc/ with nvcc, all
              builds at once (each with --fmad true and false, and the
              op-counting build of each); print ptxas' registers
  3. probe    the extension fractals' device distance functions against
              their plain versions point by point across the local AABB
  4. plain    frame kernel vs its plain PyTorch version, builtin 320x180
  5. golden   frame kernel vs tests/golden_builtin_96x54_t0p7.npz, both
              fmad modes
  6. main     Renderer(1920, 1080, device="cuda") over a 16-frame animated
              window: every frame through the frame kernel (launch count),
              finite, not background; ms/frame from CUDA events; the kernel
              alone, its op count and bound, and one plain 1080p frame
  7. suite    the five BENCH_CONFIGS through trace.render_frame: 96x54
              t=0.7 against their goldens, 320x180 against the frame
              kernel's plain version, and a 16-frame animated window at
              their published sizes through the frame kernel
  8. scene    GPURT_DISABLE_FUSED=1: the scene kernel against its plain
              version on ray batches (builtin, sdf_primitives_720p, the
              fractal scene; 320x180; closest at levels 0/1, accept-first
              at levels 0/1); a builtin 320x180 frame through the
              wavefront with the scene kernel against the frame kernel and
              the plain version; the builtin 1080p 16-frame window on this
              path with its exact launch count; the 1080p level-0 closest
              pass timed; then two builder scenes at 160x90 against the
              plain version, with GPURT_DISABLE_FUSED unset and set: 16
              instances of 16 materials (17 with the plane, past the frame
              kernel's cap, so the scene kernel renders it either way),
              and 384 instances, whose buffers take over the 48 KB of
              shared memory a block gets without opting in
  9. mesh     the march kernel (csrc/megakernel.cu) against its plain version
              on ray batches for every SDF code, closest and occlusion, at
              the level-0 and the bounce budget; the three mesh scenes of
              models/meshes.py at 96x54 against their goldens and at
              320x180 against their route's plain version (the octahedra
              also with GPURT_DISABLE_FUSED=1, through the scene kernel);
              16-frame 1080p windows of mesh_octahedra and
              mesh_heightfield_512 (frame kernel) and mesh_heightfield_sdf
              (per-geometry route, its exact march and mesh launch counts);
              the march and mesh calls of the 1080p level-0 closest pass
              against their plain versions (ray-batch bar over the gated
              rays, normals, gated-out rays miss) and alone, with op counts
              and bounds; one 1080p mesh_octahedra frame-kernel frame
              against its plain version
 10. modes    GPURT_FRAME_MODE=compact|defer (the compact, dense and defer
              entries of csrc/frame_kernel.cu, the queue kernel of
              csrc/scene_kernel.cu): builtin 96x54 against the golden and
              320x180 against the plain frame kernel, each at the default
              cap, at cap 8 with a queue that holds every pixel (the dense
              pass and the queue kernel run) and at cap 1 with a one-tile
              queue (the overflow renders the plain kernel), in both fmad
              builds (bit-equal share, flips, max |diff|, queued lanes);
              the --fmad=false compact frame equals its plain kernel bit for
              bit; the bench scenes and mesh_octahedra at 320x180 in both
              modes against the plain kernel; a 17-material scene under
              compact through the scene kernel; a 16-frame 1080p builtin
              window in each mode (launches, host syncs and queued lanes
              per frame); each new kernel alone at the 1080p frame's
              shapes against its plain version, with op counts and bounds
Then the kernel JSON line, the card line, and the final JSON status line.

Image bar (as tests/test_frame_kernel.py holds the reference's Pallas
kernel to its XLA path): fewer than 2% of pixels with max-channel |diff| >
1e-3, every other pixel within 1e-3, and more than 75% of those within
1e-5. Ray-batch bar: gid equal on >= 98% of rays, and |best_t| within 1e-3
where gid agrees: on every such ray for the scene kernel built without
contraction (--fmad=false), which repeats the plain arithmetic; on >= 98%
of them for the shipped build, where contraction moves a march crossing by
a step on a few rays. The one-geometry calls of phase 9 are held to the
same bar over the rays their gate admits (hits for gid), and in addition:
normals within 1e-2 on >= 98% of the valid hits whose t agrees (printed
only for the shipped build's code-8 batches, see phase 9), and every ray
outside the gate a miss.

Bounds: the larger of the bytes a call must move (inputs read once,
outputs written once) over 3.35 TB/s and its f32 FLOPs over 67 TFLOP/s,
the H100 SXM's published peaks. The -DGPRT_COUNT_OPS build counts the
FLOPs on the same inputs, in the unit of that peak: a multiply-add is two
(csrc/frame_math.cuh says what else counts).
"""

import contextlib
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
W_MAIN, H_MAIN, FRAMES = 1920, 1080, 16
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


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
    """Mean device-clock ms of fn() over reps launches, and the last output."""
    if warmup:
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def bound(nbytes, ops):
    """(bound ms, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
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


def reset_counts():
    from gpuraytracer_tpu_torch.kernels import frame_kernel, megakernel, scene_kernel

    frame_kernel.LAUNCHES = 0
    scene_kernel.LAUNCHES = 0
    megakernel.LAUNCHES = 0
    megakernel.MESH_LAUNCHES = 0
    frame_kernel.COMPACT_LAUNCHES = frame_kernel.DENSE_LAUNCHES = 0
    frame_kernel.DEFER_LAUNCHES = scene_kernel.QUEUE_LAUNCHES = 0
    frame_kernel.HOST_SYNCS = frame_kernel.QUEUED_LANES = 0


def mode_counts():
    """The compacted modes' counters: launches of the plain frame kernel,
    the compact, dense and defer entries and the queue kernel; host syncs;
    queued lanes."""
    from gpuraytracer_tpu_torch.kernels import frame_kernel, scene_kernel

    return dict(plain=frame_kernel.LAUNCHES, compact=frame_kernel.COMPACT_LAUNCHES,
                dense=frame_kernel.DENSE_LAUNCHES, defer=frame_kernel.DEFER_LAUNCHES,
                queue=scene_kernel.QUEUE_LAUNCHES, syncs=frame_kernel.HOST_SYNCS,
                queued=frame_kernel.QUEUED_LANES)


@contextlib.contextmanager
def fmad_build(fmad):
    """Every kernel wrapper's default library is the build with
    --fmad=<fmad> (the modes' host code takes no library argument)."""
    from gpuraytracer_tpu_torch.kernels import build

    real = build.load
    build.load = lambda name, count_ops=False: real(name, fmad=fmad, count_ops=count_ops)
    try:
        yield
    finally:
        build.load = real


def exactness(img, ref):
    """(bit-equal pixel share, flip share, max |diff|) of two images."""
    img, ref = img.float().cpu(), ref.float().cpu()
    diff = (img - ref).abs().amax(dim=-1)
    return (float((img == ref).all(dim=-1).float().mean()), float((diff > 1e-3).float().mean()),
            float(diff.max()))


def counts():
    """(frame kernel, scene kernel, megakernel march, megakernel mesh entry)
    launches."""
    from gpuraytracer_tpu_torch.kernels import frame_kernel, megakernel, scene_kernel

    return (frame_kernel.LAUNCHES, scene_kernel.LAUNCHES, megakernel.LAUNCHES,
            megakernel.MESH_LAUNCHES)


def animated_window(renderer, dev, label, w, h):
    """16 animated frames through renderer.render, timed by CUDA events:
    (ms/frame, counts(), max background share); every frame is checked
    finite and not mostly background."""
    renderer.render(0.0)  # warm-up (module load), not counted
    torch.cuda.synchronize()
    reset_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    frames = [renderer.render(0.0333 * k) for k in range(FRAMES)]
    end.record()
    torch.cuda.synchronize()
    launched = counts()
    bg = torch.tensor([0.8, 0.9, 1.0, 1.0], device=dev)
    bg_frac = []
    for k, f in enumerate(frames):
        if f.shape != (h, w, 4) or not bool(torch.isfinite(f).all()):
            raise AssertionError(f"{label} frame {k}: shape {tuple(f.shape)} or non-finite")
        bg_frac.append(float(((f - bg).abs().amax(dim=-1) <= 1e-3).float().mean()))
    if max(bg_frac) >= 0.70:
        raise AssertionError(f"{label}: a frame is mostly background ({max(bg_frac):.3f})")
    return start.elapsed_time(end) / FRAMES, launched, max(bg_frac)


def instance_grid(nx, nz, n_materials):
    """A SceneBuilder with nx * nz closed-form instances (spheres and hollow
    boxes, alternating) over the builtin grid's footprint, cycling through
    n_materials albedos."""
    from gpuraytracer_tpu_torch.core.types import AnalyticPrimitive, IntersectorKind
    from gpuraytracer_tpu_torch.models import builder

    b = builder.SceneBuilder()
    for k in range(nx * nz):
        ix, iz = divmod(k, nz)
        mn = (-7.0 + 14.0 * ix / nx, -1.0, -7.0 + 14.0 * iz / nz)
        mx = (mn[0] + 7.0 / nx, mn[1] + 14.0 / nx, mn[2] + 7.0 / nz)
        kind = AnalyticPrimitive.SPHERES if (ix + iz) % 2 else AnalyticPrimitive.AABB
        albedo = (0.2 + 0.8 * (k % n_materials) / n_materials, 0.5, 0.5, 1.0)
        b.add_instance(builder.InstanceSpec(
            kind=IntersectorKind.ANALYTIC, prim_type=int(kind), aabb_min=mn, aabb_max=mx,
            material=builder.Material(albedo)))
    return b


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
    from gpuraytracer_tpu_torch.kernels import build, frame_kernel, scene_kernel
    from gpuraytracer_tpu_torch.models import builtin, scenes
    from gpuraytracer_tpu_torch.render import trace
    from gpuraytracer_tpu_torch.render.renderer import Renderer

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
        reports = build.compile_all(builds)
        for (name, fmad, count), report in reports.items():
            used = " | ".join(line.split("ptxas info    : ")[-1].strip()
                              for line in report.splitlines()
                              if "Used" in line or "spill" in line)
            print(f"[build] {name}.cu fmad={fmad}{' count_ops' if count else ''}: {used}",
                  flush=True)

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

    # 6. main path: Renderer at 1920x1080, 16 animated frames -----------------
    with Phase("main"):
        ms_frame, launched, bg_max = animated_window(
            Renderer(W_MAIN, H_MAIN, device=dev), dev, "builtin 1080p", W_MAIN, H_MAIN)
        if launched != (FRAMES, 0, 0, 0):
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
        print(f"[main] kernel vs plain 1920x1080 t={0.0333 * 8:.4f}: flipped {frac:.6f}, "
              f"within 1e-5 {tight:.6f}, max |diff| {frame_err:.6g}", flush=True)
        if not ok:
            raise AssertionError("frame kernel disagrees with its plain version at 1080p")
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
            if counts() != (1, 0, 0, 0):
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
            if launched != (FRAMES, 0, 0, 0):
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
        if counts() != (0, 5, 0, 0):
            raise AssertionError(f"builtin 320x180 wavefront frame launched {counts()}")
        pack_s = frame_kernel.pack_frame(scene_s)
        for label, ref in (("frame kernel", frame_kernel.render_frame_tiles(pack_s, width=w, height=h)),
                           ("plain", frame_kernel.render_frame_plain(pack_s, width=w, height=h))):
            ok, frac, tight, err = bar(img, ref)
            print(f"[scene] builtin 320x180 wavefront + scene kernel vs {label}: flipped "
                  f"{frac:.6f}, within 1e-5 {tight:.6f}, max |diff| {err:.6g}", flush=True)
            if not ok:
                raise AssertionError(f"scene-kernel frame disagrees with the {label}")

        ms_scene_frame, launched, bg_max = animated_window(
            Renderer(W_MAIN, H_MAIN, device=dev), dev, "builtin 1080p wavefront", W_MAIN, H_MAIN)
        if launched != (0, 5 * FRAMES, 0, 0):
            raise AssertionError(f"builtin 1080p wavefront: {launched} launches for {FRAMES} "
                                 f"frames (expected 0 frame, {5 * FRAMES} scene)")
        scene_launches = launched[1]
        print(f"[scene] Renderer 1920x1080 with GPURT_DISABLE_FUSED=1, {FRAMES} frames: "
              f"{launched[1]} scene kernel launches (3 closest + 2 occlusion per frame), "
              f"background <= {bg_max:.3f}; {ms_scene_frame:.3f} ms/frame, "
              f"{W_MAIN * H_MAIN / ms_scene_frame / 1e3:.3f} Mrays/s; frame-kernel path "
              f"{ms_frame:.3f} ms/frame in phase 6; {card}", flush=True)

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

        w, h = 160, 90
        for nx, nz, n_mat in ((4, 4, 16), (24, 16, 8)):
            scene_x = instance_grid(nx, nz, n_mat).build(w / h, 0.7, device=dev)
            pack_x = frame_kernel.pack_frame(scene_x)
            plain = frame_kernel.render_frame_plain(pack_x, width=w, height=h)
            shared = frame_kernel.shared_bytes(pack_x.num_geometries, pack_x.num_materials,
                                               shading=True)
            for disabled in (False, True):
                if disabled:
                    os.environ["GPURT_DISABLE_FUSED"] = "1"
                else:
                    del os.environ["GPURT_DISABLE_FUSED"]
                reset_counts()
                img = trace.render_frame(scene_x, w, h)
                torch.cuda.synchronize()
                f_n, s_n, m_n, t_n = counts()
                fused = not disabled and pack_x.num_materials <= frame_kernel.MAX_MATERIALS
                if (m_n, t_n) != (0, 0) or (
                        (f_n, s_n) != (1, 0) if fused else not (f_n == 0 and 1 <= s_n <= 5)):
                    raise AssertionError(f"{nx * nz} instances: launched {(f_n, s_n)}")
                ok, frac, tight, err = bar(img, plain)
                print(f"[scene] {nx * nz} instances, {pack_x.num_materials} materials "
                      f"({shared} B of frame-kernel shared memory) 160x90, "
                      f"GPURT_DISABLE_FUSED={int(disabled)}: {f_n} frame / {s_n} scene "
                      f"launches; vs plain flipped {frac:.6f}, within 1e-5 {tight:.6f}, "
                      f"max |diff| {err:.6g}", flush=True)
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
                        # Code 8's 11 quaternion Julia iterations are chaotic:
                        # contraction changes the last bits of its distances and
                        # the tetrahedral normal (a difference at offset 5.8e-5)
                        # amplifies them, so the shipped build's code-8 normals
                        # are printed, not held; the build without contraction,
                        # which repeats the plain arithmetic, holds them.
                        normals_held = code != 8 or fmad != build.DEFAULT_FMAD
                        ok = ok and agree >= 0.98 and outside and (
                            n_close >= 0.98 or not normals_held) and (
                            close >= 0.98 if fmad == build.DEFAULT_FMAD else dt_max <= 1e-3)
                        if fmad == build.DEFAULT_FMAD:
                            mega_err = max(mega_err, dt_max)
                        line.append(f"fmad={fmad}: hit agrees on {agree:.6f} of gated rays, "
                                    f"|dt| <= 1e-3 on {close:.6f} of both-hit rays, max |dt| "
                                    f"{dt_max:.6g}, normals within 1e-2 on {n_close:.6f} "
                                    f"(max {dn_max:.6g})")
                    print(f"[mesh] march code {code} {'occlusion' if occlusion else 'closest'} "
                          f"budget {steps}{' capped-hit' if capped else ''}: {int(gate.sum())} "
                          f"gated rays, {int(p_out[0].sum())} plain hits; " + "; ".join(line),
                          flush=True)
                    if not ok:
                        raise AssertionError(f"march code {code}: kernel disagrees with plain")

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
        per_frame = {"mesh_octahedra": (1, 0, 0, 0), "mesh_heightfield_512": (1, 0, 0, 0),
                     # 3 closest + 2 occlusion passes (trace_radiance at depth
                     # 3), each one launch per SDF geometry and one per mesh.
                     "mesh_heightfield_sdf": (0, 0, 5 * n_sdf, 5 * n_mesh)}
        for cfg, disabled in [(c, False) for c in meshes.MESH_CONFIGS] + [
                (meshes.get_config("mesh_octahedra"), True)]:
            expect = (0, 5, 0, 0) if disabled else per_frame[cfg.name]
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

        # 16-frame 1080p windows: the octahedra and the 512-face heightfield
        # through the frame kernel, the 544-face scene on the per-geometry
        # route.
        for name in ("mesh_octahedra", "mesh_heightfield_512", "mesh_heightfield_sdf"):
            cfg = meshes.get_config(name)
            renderer = Renderer(cfg.width, cfg.height, device=dev, scene_factory=cfg.build,
                                animate=cfg.builder().animator(), max_depth=cfg.max_depth)
            ms, launched, bg_max = animated_window(renderer, dev, name, cfg.width, cfg.height)
            expect = tuple(FRAMES * c for c in per_frame[name])
            if launched != expect:
                raise AssertionError(f"{name}: {launched} launches for {FRAMES} frames, "
                                     f"not {expect}")
            if name == "mesh_heightfield_sdf":
                mega_launches, mesh_launches = launched[2], launched[3]
            print(f"[mesh] {name} {cfg.width}x{cfg.height} depth {cfg.max_depth}, {FRAMES} "
                  f"frames: launches (frame, scene, march, mesh) {launched}, background <= "
                  f"{bg_max:.3f}; {ms:.3f} ms/frame, {cfg.width * cfg.height / ms / 1e3:.3f} "
                  f"Mrays/s; {card}", flush=True)

        # The march kernel and the mesh entry alone, at the shapes of the 544-face
        # scene's 1080p level-0 closest pass (the route's largest): the
        # calls are recorded from the pass itself.
        scene_m9 = sdf_cfg.build(W_MAIN / H_MAIN, 0.0333 * 8, device=dev)
        calls = {"march": [], "mesh": []}
        real = {"march": megakernel.sphere_trace_tiles, "mesh": megakernel.trimesh_closest}

        def recorder(kind):
            def record(*args, **kw):
                calls[kind].append((args, kw))
                return real[kind](*args, **kw)
            return record

        megakernel.sphere_trace_tiles = recorder("march")
        megakernel.trimesh_closest = recorder("mesh")
        try:
            px, py = cam.pixel_grid(W_MAIN, H_MAIN, dev)
            c = scene_m9.arrays.constants
            o, d = cam.generate_camera_rays(px, py, W_MAIN, H_MAIN, c.camera_position,
                                            c.projection_to_world)
            traverse.closest_hit(o.reshape(-1, 3), d.reshape(-1, 3), scene_m9, level=0)
        finally:
            megakernel.sphere_trace_tiles, megakernel.trimesh_closest = real["march"], real["mesh"]
        if (len(calls["march"]), len(calls["mesh"])) != (n_sdf, n_mesh):
            raise AssertionError(f"1080p pass made {len(calls['march'])} march and "
                                 f"{len(calls['mesh'])} mesh calls")
        alone = {}
        for kind, plain_fn in (("march", megakernel.sphere_trace_plain),
                               ("mesh", megakernel.trimesh_closest_plain)):
            k_ms = p_ms = nbytes = err = 0.0
            k_ops = 0
            for args, kw in calls[kind]:
                t, _ = cuda_ms(lambda: real[kind](*args, **kw), 10)
                k_ms += t
                ops.zero_()
                real[kind](*args, ops=ops, lib=build.load("megakernel", count_ops=True), **kw)
                k_ops += int(ops.item())
                t, p_out = cuda_ms(lambda: plain_fn(*args, **kw), 1, warmup=False)
                p_ms += t
                k_out = real[kind](*args, **kw)
                # march: (o, d, gate, ...); mesh entry: (rows, o, d, gate, ...)
                rays, gate = (args[0], args[2]) if kind == "march" else (args[1], args[3])
                rays, gated = rays.shape[0], int(gate.sum())
                agree, close, dt_max, n_close, dn_max, outside = ray_agreement(k_out, p_out, gate)
                err = max(err, dt_max)
                print(f"[mesh] 1080p {kind} call: {gated} of {rays} rays gated; hit agrees on "
                      f"{agree:.6f} of them, |dt| <= 1e-3 on {close:.6f} of both-hit rays "
                      f"(max {dt_max:.6g}), normals within 1e-2 on {n_close:.6f} (max "
                      f"{dn_max:.6g}), gated-out rays miss: {outside}", flush=True)
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
            print(f"[mesh] {kind} calls of the 1080p level-0 closest pass ({len(calls[kind])} "
                  f"calls): kernel {k_ms:.3f} ms ({k_ops} f32 FLOPs, {int(nbytes)} bytes: bound "
                  f"{b_ms:.4f} ms by {b_by}); plain {p_ms:.1f} ms; {card}", flush=True)

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
            reset_counts()
            img, n = modes[mode](pack_x, width=w, height=h, max_depth=max_depth,
                                 cap_lanes=cap_lanes, debug_count=True, **{cap_arg[mode]: cap})
            torch.cuda.synchronize()
            return img, n, mode_counts()

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
                            ran = {"main": c["plain"] == 0,
                                   "overflow": c["plain"] == 1 or w == 96,
                                   "repair": c["plain"] == 0 and c["dense" if mode == "compact"
                                                                   else "queue"] == 1}[form]
                            print(f"[modes] {mode} {w}x{h} fmad={fmad} cap {cap}"
                                  f"{'' if cap_lanes is None else f' queue {cap_lanes}'}: "
                                  f"{n} queued, launches {c}; vs "
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
                print(f"[modes] {cfg.name} {mode} {w}x{h}: {n} queued, launches {c}; vs plain "
                      f"kernel bit-equal {exact:.6f}, flipped {frac:.6f}, max |diff| {err:.6g}",
                      flush=True)
                if not ok:
                    raise AssertionError(f"{cfg.name} {mode}: disagrees with the plain kernel")

        # A 17-material scene takes the scene kernel in any mode (the
        # reference reads the mode only for fused-eligible scenes).
        os.environ["GPURT_FRAME_MODE"] = "compact"
        scene_x = instance_grid(4, 4, 16).build(160 / 90, 0.7, device=dev)
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

        # 16-frame 1080p windows of the main path in each mode, beside a
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
            want = {"plain": ("plain",), "compact": ("compact", "dense"),
                    "defer": ("defer", "queue")}[mode]
            if c[want[0]] != FRAMES or any(c[k] == 0 for k in want) or (
                    mode != "plain" and c["plain"] != 0):
                raise AssertionError(f"{mode} window: launches {c}")
        del os.environ["GPURT_FRAME_MODE"]

        # Each new kernel alone at the 1080p frame's shapes (phase 6's frame),
        # against its plain version on the same inputs.
        alone_m = {}
        frame_in = (pack_m.params.numel() + pack_m.layout.numel()) * 4
        npix = W_MAIN * H_MAIN
        kw_m = dict(width=W_MAIN, height=H_MAIN)
        count_lib = build.load("frame_kernel", count_ops=True)

        def record(name, fn, p_ms, err, nbytes, ops_fn, detail):
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

        # compact's main pass
        k_img, k_dirty = frame_kernel.render_frame_capped(pack_m, budget_cap=64, **kw_m)
        p_ms, (p_img, p_dirty) = plain_run(
            lambda: frame_kernel.render_frame_capped_plain(pack_m, budget_cap=64, **kw_m))
        clean = (k_dirty == 0) & (p_dirty == 0)
        ok, frac, tight, err = bar(k_img[clean][:, None], p_img[clean][:, None])
        agree = float((k_dirty == p_dirty).float().mean())
        if not ok or agree < 0.999:
            raise AssertionError("compact main pass disagrees with its plain version")
        record("frame_compact", lambda: frame_kernel.render_frame_capped(
                   pack_m, budget_cap=64, **kw_m), p_ms, err,
               frame_in + npix * (16 + 4), lambda: frame_kernel.render_frame_capped(
                   pack_m, budget_cap=64, ops=ops, lib=count_lib, **kw_m),
               f"{int((k_dirty != 0).sum())} dirty ({int((p_dirty != 0).sum())} plain), masks "
               f"agree on {agree:.6f}; clean pixels flipped {frac:.6f}, max |diff| {err:.6g}")
        # the dense pass at this frame's queue, against its plain version and
        # the plain kernel's pixels
        m_img = frame_kernel.render_frame_tiles(pack_m, **kw_m)
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
        record("frame_dense", lambda: frame_kernel.render_frame_dense(pack_m, qpx, qpy, **kw_m),
               p_ms, err, frame_in + q.shape[0] * (8 + 16), lambda: frame_kernel.render_frame_dense(
                   pack_m, qpx, qpy, ops=ops, lib=count_lib, **kw_m),
               f"{q.shape[0]} queued pixels; equal to the plain kernel's: {same}; vs plain "
               f"flipped {frac:.6f}, max |diff| {err:.6g}")
        # defer's main pass
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
        record("frame_defer", lambda: frame_kernel.render_frame_deferred_main(
                   pack_m, shadow_cap=32, **kw_m), p_ms,
               err, frame_in + npix * (16 * 3 + (16 + 4 + 24) * nsl),
               lambda: frame_kernel.render_frame_deferred_main(
                   pack_m, shadow_cap=32, ops=ops, lib=count_lib, **kw_m),
               f"status agrees on {agree:.6f} of lanes ({int(((k_pl.sinfo & 3) == 2).sum())} "
               f"unknown); contribution planes flipped <= {max(r[1] for r in res):.6f}, max "
               f"|diff| {err:.6g}")
        # the occlusion repair queue at this frame's unknown lanes
        idxs = [torch.nonzero((k_pl.sinfo[k].reshape(-1) & 3) == 2).squeeze(1) for k in range(nsl)]
        seg = max(i.shape[0] for i in idxs)
        q_rays = torch.zeros((nsl, seg, 6), device=dev)
        q_act = torch.zeros((nsl, seg), dtype=torch.bool, device=dev)
        for k, i in enumerate(idxs):
            q_rays[k, :i.shape[0]] = k_pl.rays[k].reshape(-1, 6)[i]
            q_act[k, :i.shape[0]] = True
        q_rays, q_act = q_rays.reshape(-1, 6), q_act.reshape(-1)
        k_occ = scene_kernel.shadow_queue(pack_m, q_rays, q_act, seg)
        p_ms, p_occ = plain_run(lambda: scene_kernel.shadow_queue_plain(pack_m, q_rays, q_act, seg))
        agree = float((k_occ == p_occ).float().mean())
        if agree < 0.999:
            raise AssertionError("queue kernel disagrees with its plain version")
        # An inactive entry reads its flag and writes its answer only.
        n_act = int(q_act.sum())
        record("shadow_queue", lambda: scene_kernel.shadow_queue(pack_m, q_rays, q_act, seg),
               p_ms, float((k_occ - p_occ).abs().max()),
               frame_kernel.shared_bytes(pack_m.num_geometries, pack_m.num_materials,
                                         shading=False) + n_act * 24 + q_rays.shape[0] * (1 + 4),
               lambda: scene_kernel.shadow_queue(pack_m, q_rays, q_act, seg, ops=ops,
                                                 lib=build.load("scene_kernel", count_ops=True)),
               f"{n_act} queued rays in {nsl} segments of {seg}; occlusion agrees on "
               f"{agree:.6f}")

    print(f"[total] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [{
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
        "library_ms": None,
    } for name, src, replaces, launches in (
        ("frame_compact", "frame_kernel.cu", "gpuraytracer_tpu/kernels/frame_kernel.py:803",
         windows["compact"]["compact"]),
        ("frame_dense", "frame_kernel.cu", "gpuraytracer_tpu/kernels/frame_kernel.py:803",
         windows["compact"]["dense"]),
        ("frame_defer", "frame_kernel.cu", "gpuraytracer_tpu/kernels/frame_kernel.py:1075",
         windows["defer"]["defer"]),
        ("shadow_queue", "scene_kernel.cu", "gpuraytracer_tpu/kernels/frame_kernel.py:1016",
         windows["defer"]["queue"]))]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
