"""Count the work of a configuration's frames once, and freeze it in
``rtbench/work/<config>.json``: the yardstick of ``kernel_roofline_pct``.

Run once on the card (it builds the port's counting libraries):

    python3 -m rtbench.tools.count_work --commit <sha> [--configs a,b]
        [--windows 3] [--frames 64] [--seed 1]

For each configuration, over ``--windows`` windows of ``--frames``
animated frames (frame i of a window at t0 + 0.033 i, each window's t0
drawn in [0, 60) s from the seed), every frame on the configuration's
route, as the window program runs it (the pack built once, row 10's
animation state, then the route):

- operations: the f32 operations the route's kernels perform, counted by
  the port's counting builds (``-DGPRT_COUNT_OPS``): the frame kernel
  (row 1) on route "frame"; the per-geometry route's pass entry (row 7p)
  on route "per_geometry". The lane kernels (row 9) have no counting
  build; their operations are the per-lane counts of the port's kernel
  table (start 57, hit 181, shade 181 + 81 on a plane hit a lane);
- bytes from shapes, on every route alike: each input byte of the frame
  read once and each output byte written once, that is the scene as the
  kernels read it (the pack: its parameters, its layout and the mesh
  rows, where the scene has meshes) and the (H, W, 4) f32 image. What a
  route moves between its own kernels (a wavefront's lanes) is the
  route's choice, not the frame's work, and is not counted.

The bound per frame is max(operations / 67 TFLOP/s, bytes / 3.35 TB/s),
the H100 SXM's published f32 and HBM peaks; the file records the mean per
frame, each window's mean, the spread across windows, the builds, the
commit of the port counted and the card with its power limit. No run
recomputes these counts.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from rtbench import core

F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
START_FLOPS, LEVEL_FLOPS, CHECKERS_FLOPS = 57, 181, 81


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def frame_bytes(pack, cfg) -> int:
    """The frame's bytes: the pack's tensors read once (its parameters,
    its layout and, where the scene has meshes, the mesh rows) and the
    (H, W, 4) f32 image written once."""
    pack_bytes = sum(t.numel() * t.element_size() for t in (pack.params, pack.layout, pack.tri))
    return pack_bytes + cfg["width"] * cfg["height"] * 16


def frame_route_work(scene, pack, cfg, lib, ops):
    """Operations of one frame kernel launch."""
    from gpuraytracer_tpu_torch.kernels import frame_kernel

    ops.zero_()
    frame_kernel.render_frame_tiles(pack, width=cfg["width"], height=cfg["height"],
                                    max_depth=int(cfg["max_depth"]), lib=lib, ops=ops)
    return int(ops.item())


def per_geometry_work(scene, pack, cfg, lib, ops):
    """Operations of one frame of the per-geometry route: the
    render/trace.render_lanes loop with the counting pass entry, and the
    lane kernels' per-lane counts."""
    from gpuraytracer_tpu_torch.kernels import megakernel, wavefront

    w, h, depth = cfg["width"], cfg["height"], int(cfg["max_depth"])

    def route(*args, **kw):
        return megakernel.route_pass(scene, *args, pack=pack, lib=lib, ops=ops, **kw)

    ops.zero_()
    lanes = wavefront.start(scene, pack, width=w, height=h)
    flops = lanes.o.shape[0] * START_FLOPS
    for level in range(depth):
        a = int(lanes.active.sum())
        answer = route(lanes.ob, lanes.d, lanes.active, lanes.t0, level=level, cull_backface=True)
        shadow = sgid = None
        if level + 1 < depth:
            shadow = wavefront.hit(scene, pack, lanes, answer)
            flops += a * LEVEL_FLOPS
            _, _, sgid = route(shadow.ob, shadow.d, shadow.active, shadow.t0, level=level,
                               accept_first=True)
        plane = int((wavefront._active_hits(scene, lanes, answer)[3].geometry_id
                     == scene.layout.plane_geometry_id).sum())
        wavefront.shade(scene, pack, lanes, answer, shadow, sgid, level=level, max_depth=depth,
                        width=w, height=h)
        flops += a * LEVEL_FLOPS + plane * CHECKERS_FLOPS
    return int(ops.item()) + flops


ROUTES = {"frame": (frame_route_work, ("frame_kernel",)),
          "per_geometry": (per_geometry_work, ("megakernel",))}


def count(cfg: dict, windows: int, frames: int, seed: int, dev) -> dict:
    from gpuraytracer_tpu_torch.accel.instances import Scene
    from gpuraytracer_tpu_torch.kernels import build, frame_kernel, frame_state

    scene0, animate = core.load_module("scenes", cfg["port_scene"]).build(cfg, dev)
    work_fn, libs = ROUTES[cfg["route"]]
    lib = build.load(libs[0], count_ops=True)
    ops = torch.zeros(1, dtype=torch.int64, device=dev)
    pack = frame_kernel.pack_static(scene0)
    rng = np.random.default_rng(seed)
    per_window, t0s = [], []
    for _ in range(windows):
        t0 = float(rng.uniform(0.0, 60.0))
        t0s.append(t0)
        times = torch.from_numpy(
            (t0 + 0.033 * np.arange(frames, dtype=np.float64)).astype(np.float32)).to(dev)
        f, b = [], []
        for i in range(frames):
            arrays = frame_state.advance(pack, animate, scene0.arrays, times, i)
            f.append(work_fn(Scene(scene0.layout, arrays), pack, cfg, lib, ops))
            b.append(frame_bytes(pack, cfg))
        per_window.append((float(np.mean(f)), float(np.mean(b))))
    flops = float(np.mean([x for x, _ in per_window]))
    nbytes = float(np.mean([y for _, y in per_window]))
    t_ops, t_bytes = flops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S

    def spread(vals):
        return (max(vals) - min(vals)) / float(np.mean(vals))

    return {
        "config": cfg["name"],
        "route": cfg["route"],
        "flops_per_frame": flops,
        "bytes_per_frame": nbytes,
        "bound_ms_per_frame": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "peaks": {"f32_ops_per_s": F32_OPS_PER_S, "hbm_bytes_per_s": HBM_BYTES_PER_S,
                  "of": "NVIDIA H100 SXM data sheet, at 700 W"},
        "windows": [{"t0_s": t0, "flops_per_frame": f, "bytes_per_frame": b}
                    for t0, (f, b) in zip(t0s, per_window)],
        "frames_per_window": frames,
        "spread": {"flops": spread([x for x, _ in per_window]),
                   "bytes": spread([y for _, y in per_window])},
        "builds": [build.library_path(n, count_ops=True).name for n in libs],
        "lane_kernel_flops": ({"start": START_FLOPS, "level": LEVEL_FLOPS,
                               "checkers": CHECKERS_FLOPS}
                              if cfg["route"] == "per_geometry" else None),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--configs", default="builtin_1080p")
    p.add_argument("--windows", type=int, default=3)
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--commit", required=True, help="the commit of the port counted")
    p.add_argument("--out", default=str(core.ROOT / "work"))
    args = p.parse_args(argv)
    dev = torch.device("cuda:0")
    card = card_line()
    for name in args.configs.split(","):
        cfg = core.load_json(core.ROOT / "configs" / f"{name}.json")
        t = time.perf_counter()
        work = count(cfg, args.windows, args.frames, args.seed, dev)
        work.update(commit=args.commit, card=card, seconds=time.perf_counter() - t)
        with open(f"{args.out}/{name}.json", "w") as f:
            json.dump(work, f, indent=1)
            f.write("\n")
        print(json.dumps(work), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
