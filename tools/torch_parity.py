"""Radiance parity of the PyTorch port against committed CPU reference renders.

The counterpart of tools/parity.py for the port. The reference renders come
from the JAX package's XLA path on the CPU (tools/torch_make_refs.py writes
them into tests/parity_refs/); this tool needs only the port, torch and
numpy, so it runs on the GPU machine, where JAX is not installed.

For every reference it builds the scene with the port's builders at t = 0.7,
renders it with render/trace.render_frame at the reference's size and depth
on --device, and compares the frame with utils/parity.compare under the
reference's chaos mask. The builtin scene also renders on its other routes:

  default   the scene's own route (trace.frame_route): the frame kernel for
            a fused-eligible scene, else the scene kernel, else the
            per-geometry route
  compact   GPURT_FRAME_MODE=compact
  defer     GPURT_FRAME_MODE=defer
  merged    GPURT_MERGED_SHADOW=1
  scene     GPURT_DISABLE_FUSED=1 (the wavefront with the scene kernel)

Before each render the launch counters are set to 0; after it, a route
whose kernel did not launch is an error. Each entry also carries the image
bar of chip_smoke.py (flipped share, within-1e-5 share) and its errors:
a frame that is not finite, a route that launched no kernel, a missed
BARS entry (against a golden, which has no chaos mask: the image bar).
The run writes every entry, then fails (exit 1) if any has an error.

Writes TORCH_PARITY.json (the name keeps the port's artifacts out of
tests/test_parity.py's PARITY*.json glob, which reads the TPU's), with the
card's name and power limit as nvidia-smi reports them.

Usage:
  python tools/torch_parity.py [--device cuda] [--scenes a,b] [--out PATH]
  python tools/torch_parity.py --device cpu --refs tests/golden_builtin_96x54_t0p7.npz
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

REFS = os.path.join(REPO, "tests", "parity_refs")
T_ANIM = 0.7
ROUTE_ENV = ("GPURT_FRAME_MODE", "GPURT_MERGED_SHADOW", "GPURT_DISABLE_FUSED")
ROUTES = {
    "default": {},
    "compact": {"GPURT_FRAME_MODE": "compact"},
    "defer": {"GPURT_FRAME_MODE": "defer"},
    "merged": {"GPURT_MERGED_SHADOW": "1"},
    "scene": {"GPURT_DISABLE_FUSED": "1"},
}
# tests/test_parity.py's bars on the TPU's artifact: the least builtin's
# default route may read.
TPU_BARS = (89.0, 95.5, 95.5)
# (pct_within_1e3, interior_pct_1e3, stable_pct_1e3) each (scene, route)
# must reach on the card: its first reading on an H100 (80GB HBM3, 700 W;
# TORCH_PARITY.json) less that file's 2-point margin, and for builtin's
# default route at least TPU_BARS.
BARS = {
    ("builtin", "default"): tuple(max(b, r) for b, r in zip(TPU_BARS, (97.113, 97.895, 97.96))),
    ("builtin", "compact"): (97.113, 97.895, 97.96),
    ("builtin", "defer"): (97.113, 97.895, 97.96),
    ("builtin", "merged"): (97.113, 97.895, 97.96),
    ("builtin", "scene"): (97.141, 97.909, 97.964),
    ("single_sphere_plane_256", "default"): (97.993, 98.0, 98.0),
    ("analytic_grid_720p", "default"): (97.965, 98.0, 98.0),
    ("sdf_primitives_720p", "default"): (97.931, 98.0, 98.0),
    ("metaballs_1080p", "default"): (97.062, 98.0, 97.984),
    ("fractal_mandelbulb_julia_1080p", "default"): (97.181, 97.91, 97.497),
    ("mesh_octahedra", "default"): (97.993, 98.0, 98.0),
    ("mesh_heightfield_512", "default"): (98.0, 98.0, 98.0),
    ("mesh_heightfield_sdf", "default"): (97.931, 98.0, 97.976),
}


def card():
    """The GPU's 'name, power limit' as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def device_info(device):
    """{"device", "power_limit"} of the run: the card's, or the CPU's."""
    if torch.device(device).type != "cuda":
        return {"device": "cpu", "power_limit": None}
    name, limit = (s.strip() for s in card().rsplit(",", 1))
    return {"device": name, "power_limit": limit}


def reference_paths(refs=REFS):
    """The reference files under ``refs`` (a directory or one .npz), builtin
    first."""
    if os.path.isfile(refs):
        return [refs]
    return sorted(glob.glob(os.path.join(refs, "*_t0p7.npz")),
                  key=lambda p: (not os.path.basename(p).startswith("builtin_"), p))


def load_reference(path):
    """A reference as a dict: image, sens (an (H, W) bool mask or None),
    scene, width, height, t, max_depth (None: the scene's own). A golden
    (tests/golden_<scene>_<W>x<H>_t0p7.npz, image only) reads as a
    reference without a mask."""
    from gpuraytracer_tpu_torch.utils import parity

    z = np.load(path)
    image = z["image"].astype(np.float32)
    h, w = image.shape[:2]
    if "scene" in z.files:
        scene = str(z["scene"])
    else:
        m = re.match(r"(?:golden_(?:torch_)?)?(.+)_\d+x\d+_t0p7\.npz$", os.path.basename(path))
        scene = m.group(1)
    return {
        "image": image, "scene": scene, "width": w, "height": h,
        "t": float(z["t"]) if "t" in z.files else T_ANIM,
        "max_depth": int(z["max_depth"]) if "max_depth" in z.files else None,
        "sens": parity.unpack_mask(z["sens"], h, w) if "sens" in z.files else None,
        "sens_fraction": float(z["sens_fraction"]) if "sens_fraction" in z.files else None,
    }


def build_scene(name, aspect, t, device):
    """(port Scene, its max_depth) of a builtin, bench or mesh scene."""
    from gpuraytracer_tpu_torch.models import builtin, meshes, scenes
    from gpuraytracer_tpu_torch.render.trace import MAX_RAY_RECURSION_DEPTH

    if name == "builtin":
        return builtin.build_scene(aspect, t, device=device), MAX_RAY_RECURSION_DEPTH
    try:
        cfg = scenes.get_config(name)
    except KeyError:
        cfg = meshes.get_config(name)
    return cfg.build(aspect, t, device=device), cfg.max_depth


@contextlib.contextmanager
def route_env(route):
    """The route's environment for the block (the other knobs unset)."""
    old = {k: os.environ.pop(k, None) for k in ROUTE_ENV}
    os.environ.update(ROUTES[route])
    try:
        yield
    finally:
        for k in ROUTE_ENV:
            os.environ.pop(k, None)
            if old[k] is not None:
                os.environ[k] = old[k]


# The counter that shows a route's kernel ran: (module, attribute) by the
# route trace.frame_route names (under "default") or by the knob.
COUNTERS = {
    "frame": ("frame_kernel", "LAUNCHES"),
    "scene": ("scene_kernel", "LAUNCHES"),
    "per_geometry": ("megakernel", "PASS_LAUNCHES"),
    "compact": ("frame_kernel", "COMPACT_LAUNCHES"),
    "defer": ("frame_kernel", "DEFER_LAUNCHES"),
    "merged": ("frame_kernel", "MERGED_LAUNCHES"),
}


def _kernel_module(name):
    from gpuraytracer_tpu_torch.kernels import frame_kernel, megakernel, scene_kernel

    return {"frame_kernel": frame_kernel, "scene_kernel": scene_kernel,
            "megakernel": megakernel}[name]


@contextlib.contextmanager
def fmad_build(fmad):
    """Every kernel wrapper's default library is the build with
    --fmad=<fmad> (the modes' host code takes no library argument)."""
    from gpuraytracer_tpu_torch.kernels import build

    real = build.load
    build.load = lambda name, **kw: real(name, **{**kw, "fmad": fmad})
    try:
        yield
    finally:
        build.load = real


def reset_counts():
    for mod, attr in COUNTERS.values():
        setattr(_kernel_module(mod), attr, 0)


def read_counts():
    return {key: getattr(_kernel_module(mod), attr) for key, (mod, attr) in COUNTERS.items()}


def render(name, width, height, device, route="default", t=T_ANIM, max_depth=None):
    """(image as numpy, launches by counter, the counter the route must
    have moved or None on the CPU) of one frame of scene ``name`` on
    ``route``."""
    from gpuraytracer_tpu_torch.render import trace

    with route_env(route):
        scene, depth = build_scene(name, width / height, t, device)
        key = trace.frame_route(scene)[0] if route in ("default", "scene") else route
        reset_counts()
        img = trace.render_frame(scene, width, height,
                                 max_depth=depth if max_depth is None else max_depth)
        launches = read_counts()
    return img.cpu().numpy(), launches, key if torch.device(device).type == "cuda" else None


def image_bar(img, ref):
    """chip_smoke.py's image bar: (passes, flipped share, within-1e-5 share
    of the other pixels)."""
    diff = np.abs(img - ref).max(axis=-1)
    flipped = diff > 1e-3
    agree = diff[~flipped]
    tight = float((agree < 1e-5).mean()) if agree.size else 0.0
    frac = float(flipped.mean())
    return bool(frac < 0.02 and agree.size > 0 and tight > 0.75), frac, tight


def misses(entry):
    """The bars ``entry`` misses (a list of strings; empty when it meets
    them or has none): against a reference with a chaos mask its BARS
    entry, against a golden (no mask) the image bar."""
    if "stable_pct_1e3" not in entry:
        bar = entry["image_bar"]
        return [] if bar["passes"] else [f"the image bar (flipped {bar['flipped']:.6f}, "
                                         f"within 1e-5 {bar['within_1e5']:.6f})"]
    bars = BARS.get((entry["scene"], entry["route"]))
    if bars is None:
        return []
    keys = ("pct_within_1e3", "interior_pct_1e3", "stable_pct_1e3")
    return [f"{k} {entry[k]} < {b}" for k, b in zip(keys, bars) if entry[k] < b]


def problems(entry):
    """What is wrong with an entry (a list of strings, empty when nothing
    is): a frame that is not finite, a route whose kernel did not launch,
    missed bars."""
    out = [] if entry["finite"] else ["the frame is not finite"]
    key = entry["counter"]
    if key is not None and entry["launches"][key] == 0:
        out.append(f"the route's kernel ({key}) did not launch")
    return out + [f"misses its bar: {m}" for m in misses(entry)]


def compare_reference(ref, device, route="default"):
    """One entry: the port's frame of the reference's scene on ``route``
    against the reference."""
    from gpuraytracer_tpu_torch.utils import parity

    img, launches, key = render(ref["scene"], ref["width"], ref["height"], device, route,
                                ref["t"], ref["max_depth"])
    ok, flipped, tight = image_bar(img, ref["image"])
    return {
        "scene": ref["scene"], "route": route, "width": ref["width"], "height": ref["height"],
        "t": ref["t"], **parity.compare(img, ref["image"], ref["sens"]),
        "image_bar": {"passes": ok, "flipped": flipped, "within_1e5": tight},
        "finite": bool(np.isfinite(img).all()), "counter": key, "launches": launches,
    }


def line(entry):
    """One printed line of an entry."""
    keys = ("pct_within_1e3", "interior_pct_1e3", "sens_fraction", "stable_pct_1e3",
            "stable_max_abs")
    vals = ", ".join(f"{k} {entry[k]}" for k in keys if k in entry)
    key = entry["counter"]
    launched = f"; {entry['launches'][key]} {key} launches" if key else ""
    return (f"[parity] {entry['scene']} {entry['width']}x{entry['height']} {entry['route']}: "
            f"{vals}{launched}")


def failures(results):
    """'scene route: problem' for every problem of every entry."""
    return [f"{e['scene']} {e['route']}: {m}" for e in results["entries"] for m in e["errors"]]


def run(device="cuda", refs=REFS, scenes=None, routes=tuple(ROUTES), log=print):
    """Every reference under ``refs`` (``scenes``: only these) on its
    default route, and builtin on each of ``routes`` too; returns the
    artifact's dict, each entry with its ``errors`` (``failures`` lists
    them)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch.cuda.is_available() is False")
    out = {**device_info(device), "torch": torch.__version__, "cuda": torch.version.cuda,
           "refs": os.path.relpath(refs, REPO), "entries": []}
    for path in reference_paths(refs):
        ref = load_reference(path)
        if scenes and ref["scene"] not in scenes:
            continue
        for route in (routes if ref["scene"] == "builtin" else ("default",)):
            entry = compare_reference(ref, device, route)
            entry["errors"] = problems(entry)
            out["entries"].append(entry)
            log(line(entry) + "".join(f" FAIL: {m}" for m in entry["errors"]))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--refs", default=REFS, help="a reference directory or one .npz")
    p.add_argument("--scenes", default="", help="comma-separated scenes (default: all)")
    p.add_argument("--routes", default=",".join(ROUTES),
                   help="builtin's routes (default: all five)")
    p.add_argument("--out", default=os.path.join(REPO, "TORCH_PARITY.json"))
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        from gpuraytracer_tpu_torch.kernels import build

        build.compile_all([(n, build.DEFAULT_FMAD, False)
                           for n in ("frame_kernel", "scene_kernel", "megakernel",
                                     "frame_gate")])
    scenes = [s for s in args.scenes.split(",") if s]
    results = run(args.device, args.refs, scenes, tuple(args.routes.split(",")))
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {args.out}")
    bad = failures(results)
    for m in bad:
        print(f"torch_parity: {m}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
