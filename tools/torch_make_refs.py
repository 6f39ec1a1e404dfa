"""Write the reference renders that the PyTorch port is held to.

The port's parity tools (tools/torch_parity.py, torch_parity_floor.py,
torch_parity_bisect.py and chip_smoke.py's parity phase) run where JAX is
not installed. They compare the port with the files this script writes,
which come from the JAX package's XLA path on the CPU, the path that
rendered every golden:

  tests/parity_refs/<scene>_<W>x<H>_t0p7.npz   one per scene:
      image          f32 (H, W, 4), trace.render_frame at t = 0.7
      sens           the chaos mask, np.packbits of the (H, W) union of the
                     pixels that move by more than 1e-3 under each of the
                     three camera moves of tools/parity.py (1e-6, -1e-6 and
                     (1e-6, -1e-6, 1e-6) on the camera position)
      sens_fraction  the mask's mean
      width, height, t, max_depth, scene, source, jax_version
  tests/parity_refs/distance_seed7.npz
      points         (4096, 3) f32, numpy default_rng(7), uniform in
                     [-1.5, 1.5]^3 (tools/parity_bisect.py's draw)
      d<code>        the JAX package's distance of SDF code <code> at those
                     points on the CPU, for codes 0-6 (sdf.DISTANCE_FUNCTIONS)
                     and the fractals 7 (distance_mandelbulb) and 8
                     (distance_julia_quaternion at its default c)

Scenes: builtin (depth 3) at 320x180, the size tools/parity.py's live test
renders; the five BENCH_CONFIGS at their own depth and the three mesh
scenes of the port's models/meshes.py (built by the JAX package's builder)
at 160x90, a quarter of the pixels, so that the nine files stay near 2 MB.
Every render is trace.render_frame called as tools/parity.py and
tools/make_goldens.py call it, without an enclosing jax.jit: under one jit
of the whole frame XLA's CPU backend gives NaN on 115 of the fractal
scene's 14,400 pixels at 160x90 (jax 0.9.0), which the un-jitted frame
does not.

--goldens writes tests/golden_torch_mesh_*_96x54_t0p7.npz instead, as
tests/test_torch_trimesh.py has always written them (the un-jitted frame).

Without --force no existing file is overwritten. The fractal and metaball
scenes take minutes each on the CPU; run one process per scene:

  JAX_PLATFORMS=cpu python tools/torch_make_refs.py              # all
  JAX_PLATFORMS=cpu python tools/torch_make_refs.py --scenes builtin
  JAX_PLATFORMS=cpu python tools/torch_make_refs.py --distance
  JAX_PLATFORMS=cpu python tools/torch_make_refs.py --goldens [--out DIR]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

REFS = os.path.join(REPO, "tests", "parity_refs")
T_ANIM = 0.7
PROBES = (1e-6, -1e-6, (1e-6, -1e-6, 1e-6))
BENCH = ("single_sphere_plane_256", "analytic_grid_720p", "sdf_primitives_720p",
         "metaballs_1080p", "fractal_mandelbulb_julia_1080p")
MESH = ("mesh_octahedra", "mesh_heightfield_512", "mesh_heightfield_sdf")
SCENES = ("builtin",) + BENCH + MESH
GOLDEN_W, GOLDEN_H = 96, 54


def size(scene):
    return (320, 180) if scene == "builtin" else (160, 90)


def ref_path(scene, out=REFS):
    w, h = size(scene)
    return os.path.join(out, f"{scene}_{w}x{h}_t0p7.npz")


def build(scene, aspect):
    """(JAX Scene, max_depth) of a scene at t = 0.7."""
    if scene == "builtin":
        from gpuraytracer_tpu.models import builtin
        from gpuraytracer_tpu.render.trace import MAX_RAY_RECURSION_DEPTH

        return builtin.build_scene(aspect=aspect, elapsed_time=T_ANIM), MAX_RAY_RECURSION_DEPTH
    if scene in BENCH:
        from gpuraytracer_tpu.models import scenes

        cfg = scenes.get_config(scene)
        return cfg.build(aspect, T_ANIM), cfg.max_depth
    from gpuraytracer_tpu.models import builder as j_builder
    from gpuraytracer_tpu_torch.models import meshes

    cfg = meshes.get_config(scene)
    return cfg.builder(j_builder).build(aspect, T_ANIM), cfg.max_depth


def moved(arrays, eps):
    """The arrays with the camera position moved by eps (tools/parity.py)."""
    import numpy as np

    cp = np.asarray(arrays.constants.camera_position)
    delta = np.zeros_like(cp)
    e = np.atleast_1d(np.asarray(eps, dtype=cp.dtype))
    if e.size > 1:
        delta[:3] += e
    else:
        delta += e[0]
    c = dataclasses.replace(arrays.constants,
                            camera_position=arrays.constants.camera_position + delta)
    return dataclasses.replace(arrays, constants=c)


def make_ref(scene, out, force):
    import jax
    import numpy as np

    from gpuraytracer_tpu.render import trace
    from gpuraytracer_tpu_torch.utils import parity

    path = ref_path(scene, out)
    if os.path.exists(path) and not force:
        print(f"exists: {path}", flush=True)
        return
    w, h = size(scene)
    sc, depth = build(scene, w / h)

    def render(arrays):
        return np.asarray(trace.render_frame(type(sc)(sc.layout, arrays), w, h, max_depth=depth))

    image = render(sc.arrays)
    assert image.shape == (h, w, 4) and np.isfinite(image).all(), scene
    sens = np.zeros((h, w), bool)
    for eps in PROBES:
        sens |= parity.sensitivity_mask(image, render(moved(sc.arrays, eps)))
    np.savez_compressed(
        path, image=image.astype(np.float32), sens=parity.pack_mask(sens),
        sens_fraction=np.float64(sens.mean()), width=np.int32(w), height=np.int32(h),
        t=np.float32(T_ANIM), max_depth=np.int32(depth), scene=np.str_(scene),
        source=np.str_("gpuraytracer_tpu XLA, cpu"), jax_version=np.str_(jax.__version__))
    print(f"wrote {path}: mean {image.mean():.6f}, sens {100 * sens.mean():.2f}%", flush=True)


def make_distance(out, force):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gpuraytracer_tpu.geometry import fractal, sdf

    path = os.path.join(out, "distance_seed7.npz")
    if os.path.exists(path) and not force:
        print(f"exists: {path}", flush=True)
        return
    pts = np.random.default_rng(7).uniform(-1.5, 1.5, size=(4096, 3)).astype(np.float32)
    fns = {c: sdf.DISTANCE_FUNCTIONS[c] for c in range(7)}
    fns[7] = fractal.distance_mandelbulb
    fns[8] = fractal.distance_julia_quaternion
    data = {f"d{c}": np.asarray(jax.jit(fn)(jnp.asarray(pts))).astype(np.float32)
            for c, fn in fns.items()}
    for c, d in data.items():
        assert d.shape == (4096,) and np.isfinite(d).all(), c
    np.savez_compressed(path, points=pts, **data,
                        source=np.str_("gpuraytracer_tpu XLA, cpu"),
                        jax_version=np.str_(jax.__version__))
    print(f"wrote {path}", flush=True)


def make_goldens(out, force):
    """tests/golden_torch_mesh_*_96x54_t0p7.npz from the un-jitted frame."""
    import numpy as np

    from gpuraytracer_tpu.render import trace

    for scene in MESH:
        path = os.path.join(out, f"golden_torch_{scene}_{GOLDEN_W}x{GOLDEN_H}_t0p7.npz")
        if os.path.exists(path) and not force:
            print(f"exists: {path}", flush=True)
            continue
        sc, depth = build(scene, GOLDEN_W / GOLDEN_H)
        image = np.asarray(trace.render_frame(sc, GOLDEN_W, GOLDEN_H, max_depth=depth))
        assert image.shape == (GOLDEN_H, GOLDEN_W, 4) and np.isfinite(image).all(), scene
        np.savez_compressed(path, image=image.astype(np.float32), max_depth=np.int32(depth))
        print(f"wrote {path}", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scenes", default=",".join(SCENES),
                   help="comma-separated scenes (default: all nine)")
    p.add_argument("--distance", action="store_true",
                   help="write only distance_seed7.npz")
    p.add_argument("--goldens", action="store_true",
                   help="write only the three mesh goldens (default --out: tests/)")
    p.add_argument("--out", default=None, help="output directory")
    p.add_argument("--force", action="store_true", help="overwrite existing files")
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.goldens:
        out = args.out or os.path.join(REPO, "tests")
        os.makedirs(out, exist_ok=True)
        make_goldens(out, args.force)
        return 0
    out = args.out or REFS
    os.makedirs(out, exist_ok=True)
    if args.distance:
        make_distance(out, args.force)
        return 0
    for scene in args.scenes.split(","):
        if scene not in SCENES:
            p.error(f"unknown scene {scene!r}; one of {', '.join(SCENES)}")
        make_ref(scene, out, args.force)
    if args.scenes == ",".join(SCENES):
        make_distance(out, args.force)
    return 0


if __name__ == "__main__":
    sys.exit(main())
