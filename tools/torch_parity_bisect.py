"""Which stage makes the port's card frame miss its CPU reference.

The counterpart of tools/parity_bisect.py, which split the TPU-XLA and
CPU-XLA renders of one program by stage. Here the two sides are the card's
kernels and the port's plain path on the CPU, on the builtin scene at
320x180, t = 0.7:

  hit    the level-0 closest hit on the frame's camera rays (the same rays on
         both sides): the scene kernel (csrc/scene_kernel.cu) on the card,
         scene_kernel.scene_closest_plain on the CPU. Geometry-id flips, then
         per geometry n, max |dt|, p99.9 |dt| and the count of |dt| > 1e-4.
  dist   the device distance functions of csrc/frame_math.cuh at the 4,096
         points of tests/parity_refs/distance_seed7.npz, one thread a point
         (scene_kernel.sdf_distance), for SDF codes 0-8: against their plain
         versions (geometry/sdf.DISTANCE_FUNCTIONS) on the same card and
         against the JAX package's CPU values in the file. Max abs, max rel,
         the count that differ and the largest difference in units of
         2^-23 * max(|d|, 1) (ulps at the function's scale). The entry fails
         past DIST_ULPS of the plain version.
  shade  the full frame on the card (default route) against the CPU port's
         frame: the share of pixels past 1e-3 and which level-0 geometry
         (the CPU's hit) owns them.

Usage: python tools/torch_parity_bisect.py [--json PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tools import torch_parity  # noqa: E402

W, H = 320, 180
DISTANCE = os.path.join(REPO, "tests", "parity_refs", "distance_seed7.npz")
CODES = tuple(range(9))
# Largest |card - plain| the distance entry may show at any point, in
# units of 2^-23 * max(|d|, 1): an H100 reads 10.9 for code 7 (the
# Mandelbulb's eight iterations, contracted) and at most 2.7 for the rest.
DIST_ULPS = 16


def ulps(got, want):
    """|got - want| in units of 2^-23 * max(|want|, 1), elementwise."""
    return np.abs(got.astype(np.float64) - want) / (2.0 ** -23 * np.maximum(np.abs(want), 1.0))


def is_cuda(device):
    return torch.device(device).type == "cuda"


def sync(device):
    if is_cuda(device):
        torch.cuda.synchronize()


def camera_rays(scene, w, h):
    """(N, 3) origins and directions of the w x h frame's camera rays."""
    from gpuraytracer_tpu_torch.core import camera as cam

    px, py = cam.pixel_grid(w, h, scene.arrays.aabb_min.device)
    c = scene.arrays.constants
    o, d = cam.generate_camera_rays(px, py, w, h, c.camera_position, c.projection_to_world)
    return o.reshape(-1, 3), d.reshape(-1, 3)


def stage_hit(log=print, device="cuda", size=(W, H)):
    """The level-0 closest hit on the card's scene kernel (on ``device``; a
    CPU rehearsal runs the plain pass there) and the CPU's plain pass: a
    dict of the flips and per-geometry |dt|, and the CPU's (h, w) geometry
    ids."""
    from gpuraytracer_tpu_torch.accel import traverse
    from gpuraytracer_tpu_torch.kernels import scene_kernel

    w, h = size
    cpu, _ = torch_parity.build_scene("builtin", w / h, torch_parity.T_ANIM, "cpu")
    gpu, _ = torch_parity.build_scene("builtin", w / h, torch_parity.T_ANIM, device)
    o, d = camera_rays(cpu, w, h)
    scene_kernel.LAUNCHES = 0
    h_gpu = traverse.closest_hit(o.to(device), d.to(device), gpu)
    sync(device)
    if is_cuda(device) and scene_kernel.LAUNCHES == 0:
        raise AssertionError("hit: the scene kernel did not launch")
    h_cpu = traverse.closest_hit(o, d, cpu)
    g_cpu, g_gpu = h_cpu.geometry_id.numpy(), h_gpu.geometry_id.cpu().numpy()
    t_cpu, t_gpu = h_cpu.t.numpy(), h_gpu.t.cpu().numpy()
    flip = g_cpu != g_gpu
    both = h_cpu.hit.numpy() & h_gpu.hit.cpu().numpy() & ~flip
    dt = np.abs(t_cpu - t_gpu)
    out = {"rays": int(flip.size), "gid_flips": int(flip.sum()),
           "gid_flip_pct": round(100 * float(flip.mean()), 4), "per_geometry": {}}
    log(f"[bisect hit] {w}x{h} level-0 closest, scene kernel (card) vs plain (CPU): "
        f"geometry-id flips {out['gid_flips']} / {out['rays']} ({out['gid_flip_pct']}%)")
    log(f"[bisect hit] {'gid':>4} {'n':>8} {'max|dt|':>12} {'p99.9|dt|':>12} {'n>1e-4':>8}")
    for g in range(int(cpu.layout.plane_geometry_id) + 1):
        m = both & (g_cpu == g)
        if not m.any():
            continue
        row = {"n": int(m.sum()), "max_dt": float(dt[m].max()),
               "p999_dt": float(np.quantile(dt[m], 0.999)),
               "n_dt_gt_1e4": int((dt[m] > 1e-4).sum())}
        out["per_geometry"][str(g)] = row
        log(f"[bisect hit] {g:>4} {row['n']:>8} {row['max_dt']:>12.3e} {row['p999_dt']:>12.3e} "
            f"{row['n_dt_gt_1e4']:>8}")
    return out, g_cpu.reshape(h, w)


def _ms(fn, reps):
    """Mean device ms of fn() over reps runs after a warm-up, the card
    made to wait first so that the events time the card, not the host."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(10 ** 8)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def stage_dist(log=print, reps=20, device="cuda"):
    """The distance entry at the committed points, each code against its
    plain version on the card and the JAX CPU values. A dict by code, with
    the entry's launches (each code once), the device ms of the nine
    launches and of their plain versions, the bytes they move and the
    FLOPs the counting build counts (on the CPU, where the entry is its
    plain version: no times, no count); raises past DIST_ULPS."""
    from gpuraytracer_tpu_torch.geometry import sdf
    from gpuraytracer_tpu_torch.kernels import build, scene_kernel

    z = np.load(DISTANCE)
    pts = torch.from_numpy(z["points"]).to(device)
    n = int(pts.shape[0])
    out, bad = {"points": n, "codes": {}}, []
    scene_kernel.PROBE_LAUNCHES = 0
    got = {c: scene_kernel.sdf_distance(c, pts) for c in CODES}
    sync(device)
    out["launches"] = scene_kernel.PROBE_LAUNCHES
    for c in CODES:
        g = got[c].cpu().numpy()
        plain = sdf.DISTANCE_FUNCTIONS[c](pts).cpu().numpy()
        row = {}
        for name, want in (("plain", plain), ("jax_cpu", z[f"d{c}"])):
            diff = np.abs(g.astype(np.float64) - want)
            row[name] = {"max_abs": float(diff.max()),
                         "max_rel": float((diff / np.maximum(np.abs(want), 1e-12)).max()),
                         "n_diff": int((diff > 0).sum()), "max_ulps": float(ulps(g, want).max())}
        out["codes"][str(c)] = row
        log(f"[bisect dist] code {c}: vs plain max abs {row['plain']['max_abs']:.3e}, max rel "
            f"{row['plain']['max_rel']:.3e}, n_diff {row['plain']['n_diff']}, "
            f"{row['plain']['max_ulps']:.1f} ulps (bar {DIST_ULPS}); vs JAX CPU max abs "
            f"{row['jax_cpu']['max_abs']:.3e}, max rel {row['jax_cpu']['max_rel']:.3e}, "
            f"n_diff {row['jax_cpu']['n_diff']}, {row['jax_cpu']['max_ulps']:.1f} ulps")
        if not np.isfinite(g).all() or row["plain"]["max_ulps"] > DIST_ULPS:
            bad.append(c)
    out["max_abs_vs_plain"] = max(r["plain"]["max_abs"] for r in out["codes"].values())
    if bad:
        raise AssertionError(f"dist: the distance entry disagrees with its plain version on "
                             f"codes {bad} (bar {DIST_ULPS} ulps)")
    if not is_cuda(device):
        return out
    out["ms"] = _ms(lambda: [scene_kernel.sdf_distance(c, pts) for c in CODES], reps)
    out["plain_ms"] = _ms(lambda: [sdf.DISTANCE_FUNCTIONS[c](pts) for c in CODES], reps)
    ops = torch.zeros(1, dtype=torch.int64, device=pts.device)
    counting = build.load("scene_kernel", count_ops=True)
    for c in CODES:
        scene_kernel.sdf_distance(c, pts, lib=counting, ops=ops)
    out["flops"] = int(ops.item())
    out["bytes"] = len(CODES) * n * (12 + 4)
    log(f"[bisect dist] the nine codes at {n} points: {out['ms']:.4f} ms "
        f"(plain {out['plain_ms']:.4f} ms), {out['flops']} FLOPs, {out['bytes']} bytes, "
        f"{out['launches']} launches")
    return out


def stage_shade(gid, cpu_image=None, log=print, device="cuda"):
    """The card's default-route frame against the CPU port's frame
    (``cpu_image`` if already rendered): the share past 1e-3, the largest
    |diff|, and the divergent pixels by their level-0 geometry id."""
    h, w = gid.shape
    img, launches, key = torch_parity.render("builtin", w, h, device)
    if key is not None and launches[key] == 0:
        raise AssertionError(f"shade: the route's kernel ({key}) did not launch")
    if cpu_image is None:
        cpu_image = torch_parity.render("builtin", w, h, "cpu")[0]
    di = np.abs(img - cpu_image).max(axis=-1)
    bad = di > 1e-3
    owners = {str(int(g)): int((bad & (gid == g)).sum()) for g in np.unique(gid[bad])}
    out = {"pct_gt_1e3": round(100 * float(bad.mean()), 3), "max_abs": float(di.max()),
           "owners": owners}
    log(f"[bisect shade] card ({key}) vs CPU port {w}x{h}: pct > 1e-3 {out['pct_gt_1e3']}%, "
        f"max {out['max_abs']:.4f}; divergent pixels by level-0 gid (-1 miss): {owners}")
    return out


def run(log=print, cpu_image=None, device="cuda", size=(W, H)):
    """All three stages; a dict by stage. ``cpu_image``: the CPU port's
    builtin frame if already rendered (it takes a minute at 320x180);
    ``device``, ``size``: a CPU rehearsal at a small size."""
    if is_cuda(device) and not torch.cuda.is_available():
        raise RuntimeError("the bisect runs on a CUDA GPU; torch.cuda.is_available() is False")
    hit, gid = stage_hit(log, device, size)
    return {**torch_parity.device_info(device), "width": size[0], "height": size[1],
            "t": torch_parity.T_ANIM, "hit": hit, "dist": stage_dist(log, device=device),
            "shade": stage_shade(gid, cpu_image, log, device)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--json", default=None, help="also write the stages' numbers here")
    args = p.parse_args(argv)
    from gpuraytracer_tpu_torch.kernels import build

    build.compile_all([("frame_kernel", build.DEFAULT_FMAD, False),
                       ("scene_kernel", build.DEFAULT_FMAD, False),
                       ("scene_kernel", build.DEFAULT_FMAD, True)])
    out = run()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
