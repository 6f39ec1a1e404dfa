#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases (each prints its result; any failure raises and exits non-zero):
  1. device   fail without CUDA; print the card's name and power limit
  2. build    build the frame kernel from csrc/ with nvcc (both --fmad modes)
  3. plain    kernel vs its plain PyTorch version (the wavefront), 320x180
  4. golden   kernel vs tests/golden_builtin_96x54_t0p7.npz, both fmad modes
  5. main     Renderer(1920, 1080, device="cuda") over a 16-frame animated
              window: every frame through the kernel, finite, not background;
              ms/frame from CUDA events, and one plain 1080p frame for scale
Then the kernel JSON line, the card line, and the final JSON status line.

Comparison bar (as tests/test_frame_kernel.py holds the reference's Pallas
kernel to its XLA path): fewer than 2% of pixels with max-channel |diff| >
1e-3, every other pixel within 1e-3, and more than 75% of those within 1e-5.
"""

import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
W_MAIN, H_MAIN, FRAMES = 1920, 1080, 16


def bar(img, ref):
    """(passes, flip fraction, max abs diff over all pixels) of the bar."""
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


def main() -> int:
    # 1. device -------------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from gpuraytracer_tpu_torch.accel.instances import Scene
    from gpuraytracer_tpu_torch.kernels import build, frame_kernel
    from gpuraytracer_tpu_torch.models import builtin
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

    # 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    reports = {}
    for fmad in (build.DEFAULT_FMAD, not build.DEFAULT_FMAD):
        _, report = build.compile_kernel("frame_kernel", fmad=fmad)
        reports[fmad] = " ".join(line.split("ptxas info    : ")[-1].strip()
                                 for line in report.splitlines() if "Used" in line)
    print(f"[build] frame_kernel.cu built in {time.perf_counter() - t0:.2f} s; "
          f"fmad={build.DEFAULT_FMAD} (shipped): {reports[build.DEFAULT_FMAD]}; "
          f"fmad={not build.DEFAULT_FMAD}: {reports[not build.DEFAULT_FMAD]}", flush=True)

    # 3. kernel vs plain at 320x180 ------------------------------------------
    w, h = 320, 180
    pack = frame_kernel.pack_frame(builtin.build_scene(aspect=w / h, elapsed_time=0.7, device=dev))
    img = frame_kernel.render_frame_tiles(pack, width=w, height=h)
    plain = frame_kernel.render_frame_plain(pack, width=w, height=h)
    torch.cuda.synchronize()
    ok, frac, tight, max_err = bar(img, plain)
    print(f"[plain] kernel vs plain 320x180 t=0.7: flipped {frac:.6f} (bar < 0.02), "
          f"within 1e-5 {tight:.6f} (bar > 0.75), max |diff| {max_err:.6g}", flush=True)
    if not ok:
        raise AssertionError("kernel disagrees with its plain version")

    # 4. kernel vs golden at 96x54 --------------------------------------------
    import numpy as np

    golden = torch.from_numpy(
        np.load(os.path.join(ROOT, "tests", "golden_builtin_96x54_t0p7.npz"))["image"])
    pack_g = frame_kernel.pack_frame(builtin.build_scene(aspect=96 / 54, elapsed_time=0.7, device=dev))
    rates = {}
    for fmad in (build.DEFAULT_FMAD, not build.DEFAULT_FMAD):
        out = frame_kernel.render_frame_tiles(pack_g, width=96, height=54,
                                              lib=build.load("frame_kernel", fmad=fmad))
        rates[fmad] = bar(out, golden)
    ok, frac, tight, _ = rates[build.DEFAULT_FMAD]
    alt = rates[not build.DEFAULT_FMAD]
    print(f"[golden] kernel vs golden 96x54: fmad={build.DEFAULT_FMAD} (shipped) flipped "
          f"{frac:.6f} within-1e-5 {tight:.6f}; fmad={not build.DEFAULT_FMAD} flipped "
          f"{alt[1]:.6f} within-1e-5 {alt[2]:.6f}", flush=True)
    if not ok:
        raise AssertionError("kernel disagrees with the golden image")

    # 5. main path: Renderer at 1920x1080, 16 animated frames -----------------
    renderer = Renderer(W_MAIN, H_MAIN, device=dev)
    renderer.render(0.0)  # warm-up (module load), not counted
    torch.cuda.synchronize()
    frame_kernel.LAUNCHES = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    frames = [renderer.render(0.0333 * k) for k in range(FRAMES)]
    end.record()
    torch.cuda.synchronize()
    launches = frame_kernel.LAUNCHES
    ms_frame = start.elapsed_time(end) / FRAMES
    if launches != FRAMES:
        raise AssertionError(f"{launches} kernel launches for {FRAMES} frames")
    bg = torch.tensor([0.8, 0.9, 1.0, 1.0], device=dev)
    bg_frac = []
    for k, f in enumerate(frames):
        if f.shape != (H_MAIN, W_MAIN, 4) or not bool(torch.isfinite(f).all()):
            raise AssertionError(f"frame {k}: shape {tuple(f.shape)} or non-finite values")
        bg_frac.append(float(((f - bg).abs().amax(dim=-1) <= 1e-3).float().mean()))
    if max(bg_frac) >= 0.70:
        raise AssertionError(f"frame is mostly background: {max(bg_frac):.3f}")
    del frames

    scene = builtin.animate_arrays(
        builtin.build_scene(aspect=W_MAIN / H_MAIN, device=dev).arrays, 0.0333 * 8)
    pack_m = frame_kernel.pack_frame(Scene(builtin.LAYOUT, scene))
    kernel_ms, kimg = cuda_ms(
        lambda: frame_kernel.render_frame_tiles(pack_m, width=W_MAIN, height=H_MAIN), 5)
    plain_ms, pimg = cuda_ms(
        lambda: frame_kernel.render_frame_plain(pack_m, width=W_MAIN, height=H_MAIN), 1,
        warmup=False)
    ok, frac, tight, max_err = bar(kimg, pimg)
    print(f"[main] kernel vs plain 1920x1080 t={0.0333 * 8:.4f}: flipped {frac:.6f}, "
          f"within 1e-5 {tight:.6f}, max |diff| {max_err:.6g}", flush=True)
    if not ok:
        raise AssertionError("kernel disagrees with its plain version at 1080p")
    mrays = W_MAIN * H_MAIN / ms_frame / 1e3
    print(f"[main] Renderer 1920x1080, {FRAMES} frames t=0.0333k: {launches} kernel launches, "
          f"all finite, background <= {max(bg_frac):.3f}; {ms_frame:.3f} ms/frame, "
          f"{mrays:.3f} Mrays/s (W*H*fps/1e6); kernel alone {kernel_ms:.3f} ms; plain "
          f"wavefront {plain_ms:.1f} ms/frame; {card}", flush=True)

    print(json.dumps({"kernels": [{
        "name": "frame_kernel",
        "route": "cuda",
        "source": "gpuraytracer_tpu_torch/kernels/csrc/frame_kernel.cu",
        "replaces": "gpuraytracer_tpu/kernels/frame_kernel.py:672",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
