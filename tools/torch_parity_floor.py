"""What the port agrees with itself to on one card: the parity floor.

The counterpart of tools/parity_floor.py, which compiled the JAX render in
three fusion contexts on one backend and found them bit-identical. Here the
builtin scene renders at 320x180, t = 0.7, in every form the port has, and
each form is compared with A by utils/parity.compare under the chaos mask
of the committed builtin reference (tests/parity_refs/):

  A   the shipped build (--fmad=build.DEFAULT_FMAD) on the default route:
      the frame kernel
  A'  A launched again (bit-equal unless a kernel is not deterministic)
  B   the other --fmad build of every kernel library, default route
  C   GPURT_FRAME_MODE=compact
  D   GPURT_FRAME_MODE=defer
  E   GPURT_MERGED_SHADOW=1
  F   GPURT_DISABLE_FUSED=1: the wavefront with the scene kernel
  G   the port's CPU wavefront (the kernels' plain versions)

Each comparison also carries the share of bit-equal pixels and the largest
|diff|; ``vs_reference`` holds each form's pct, interior and stable share
against the CPU reference itself. Every card render must launch its route's kernel (the counters of
tools/torch_parity.py). Writes TORCH_PARITY_FLOOR.json with the card's name
and power limit.

Usage: python tools/torch_parity_floor.py [--out PATH]
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

from gpuraytracer_tpu_torch.kernels import build  # noqa: E402
from tools import torch_parity  # noqa: E402

W, H = 320, 180
REF = os.path.join(torch_parity.REFS, f"builtin_{W}x{H}_t0p7.npz")
SHIPPED = build.DEFAULT_FMAD
# (name, route, kernel build's --fmad, device)
VARIANTS = (
    ("a_prime", "default", SHIPPED, "cuda"),
    (f"b_fmad_{str(not SHIPPED).lower()}", "default", not SHIPPED, "cuda"),
    ("c_compact", "compact", SHIPPED, "cuda"),
    ("d_defer", "defer", SHIPPED, "cuda"),
    ("e_merged", "merged", SHIPPED, "cuda"),
    ("f_scene_kernel", "scene", SHIPPED, "cuda"),
    ("g_cpu_wavefront", "default", SHIPPED, "cpu"),
)


def agreement(img, ref, sens):
    """compare() of img against ref, with the bit-equal share and max |diff|."""
    from gpuraytracer_tpu_torch.utils import parity

    return {**parity.compare(img, ref, sens),
            "bit_equal_pct": round(float((img == ref).all(axis=-1).mean()) * 100, 3),
            "max_abs": float(np.abs(img - ref).max())}


def run(log=print, cpu_image=None, device="cuda", size=(W, H)):
    """The floor's dict, and the images by variant ("a" and each name).
    ``cpu_image``: G's frame if already rendered (the CPU frame is the
    slowest step);
    ``device``, ``size``: a CPU rehearsal at a small size, where every
    variant is the plain path and the chaos mask is left out."""
    from gpuraytracer_tpu_torch.utils import parity

    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("the floor runs on a CUDA GPU; torch.cuda.is_available() is False")
    w, h = size
    ref = torch_parity.load_reference(REF) if (w, h) == (W, H) else None
    sens = ref["sens"] if ref is not None else None
    images, out = {}, {**torch_parity.device_info(device), "torch": torch.__version__,
                       "cuda": torch.version.cuda, "width": w, "height": h,
                       "t": torch_parity.T_ANIM,
                       "experiment": "the builtin frame in every form of the port, "
                                     "each against A",
                       "mask": "tests/parity_refs chaos mask" if sens is not None else None,
                       "variants": {}}
    for name, route, fmad, where in (("a", "default", SHIPPED, "cuda"),) + VARIANTS:
        dev = where if cuda else "cpu"
        if dev == "cpu" and cpu_image is not None:
            img, key = cpu_image, None
        else:
            with torch_parity.fmad_build(fmad):
                img, launches, key = torch_parity.render("builtin", w, h, dev, route)
            if key is not None and launches[key] == 0:
                raise AssertionError(f"{name}: the route's kernel ({key}) did not launch")
        images[name] = img
        vs_ref = ""
        if ref is not None:
            r = parity.compare(img, ref["image"], sens)
            out.setdefault("vs_reference", {})[name] = {
                k: r[k] for k in ("pct_within_1e3", "interior_pct_1e3", "stable_pct_1e3")}
            vs_ref = (f"; vs the CPU reference {r['pct_within_1e3']} / "
                      f"{r['interior_pct_1e3']} / {r['stable_pct_1e3']}")
        if name == "a":
            log(f"[floor] a{vs_ref}")
            continue
        res = agreement(img, images["a"], sens)
        out["variants"][name] = {"route": route, "fmad": fmad, "device": dev, **res}
        log(f"[floor] {name} vs A: bit-equal {res['bit_equal_pct']}%, pct_within_1e3 "
            f"{res['pct_within_1e3']}, interior {res['interior_pct_1e3']}, stable "
            f"{res.get('stable_pct_1e3')}, max |diff| {res['max_abs']:.6g}{vs_ref}")
    out["a_prime_bit_equal"] = bool(np.array_equal(images["a_prime"], images["a"]))
    return out, images


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=os.path.join(REPO, "TORCH_PARITY_FLOOR.json"))
    args = p.parse_args(argv)
    build.compile_all([(n, fmad, False) for n in ("frame_kernel", "scene_kernel", "frame_gate")
                       for fmad in (True, False)])
    out, _ = run()
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
