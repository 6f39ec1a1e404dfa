"""Build the CUDA kernels in csrc/ with nvcc on first use, load with ctypes.

Each kernel source compiles to a shared library with a plain C interface
(no PyTorch headers, so a build takes seconds), for Hopper:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
         -Xcompiler -fPIC --fmad=<true|false> -Xptxas -v

never with --use_fast_math (the fog kill depends on expf underflowing to
an exact 0, and march crossings are ulp-sensitive). ``count_ops`` adds
-DGPRT_COUNT_OPS: a build that counts the f32 operations it performs (for
a measurement's operation bound; never the shipped build); ``count_simt``
adds -DGPRT_COUNT_SIMT: a build that counts, at every march sample, how
many lanes of the warp marched (SIMT efficiency; csrc/frame_math.cuh;
never the shipped build); ``faces_global`` adds -DGPRT_FACE_LOOP_GLOBAL:
a megakernel build whose pass and mesh entries test every face from
global memory (the unculled face loop that checks hold the shipped one
to; never the shipped build); ``repair_full`` adds -DGPRT_REPAIR_FULL: a
scene-kernel build whose occlusion repair runs the whole traversal from
geometry 0 instead of resuming from the defer entry's march records (the
parent's repair, which checks hold the resumed one to; never the shipped
build); ``finish_per_ray`` adds -DGPRT_FINISH_PER_RAY: a scene_finish
build whose two-phase finisher runs one thread per ray over every ray (the
parent's finisher, which checks hold the queued one to; never the shipped
build).

The source that launches a kernel from device code (DEVICE_LAUNCH:
frame_gate.cu, through its GPRT_TAIL_LAUNCH) is compiled as
extensible whole-program device code (-ewp: whole-program compilation whose
calls into the device runtime are resolved at the link) and linked against
the toolkit's device runtime (-lcudadevrt, a static library of the CUDA
toolkit), in a library of its own, so that no other kernel's build
changes. (-rdc=true, separate compilation, gave its frame kernel 156
registers instead of -ewp's 128 and the whole-program build's 118;
PERF.md.) The library
lands in build/gpuraytracer_tpu_torch/ at the repository root, named after
a hash of the sources and flags, so a changed source rebuilds and an
unchanged one loads the existing build. A failed build raises with nvcc's
stderr. ``compile_all`` runs several builds at once, one nvcc each.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gpuraytracer_tpu_torch"

# Contraction of a*b+c into FMA, chosen by the flip rate against the 96x54
# builtin golden (rendered by the reference's fused XLA program, which
# contracts too): on an H100, 1.10% of pixels flip with contraction and
# 1.29% without (PERF.md).
DEFAULT_FMAD = True

# Shared headers every kernel source may include.
_HEADERS = ("frame_math.cuh", "traverse.cuh")
# Kernel sources that another source includes: {source: included sources}.
_INCLUDES = {"frame_gate": ("frame_kernel.cu",)}
# Sources with device-side launches, their compile flags and the libraries
# their link needs.
DEVICE_LAUNCH = ("frame_gate",)
DEVICE_LAUNCH_FLAGS = ["-ewp"]
DEVICE_LAUNCH_LIBS = ["-lcudadevrt"]


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _flags(name: str, fmad: bool, count_ops: bool = False, count_simt: bool = False,
           faces_global: bool = False, repair_full: bool = False,
           finish_per_ray: bool = False):
    return (["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
             "-shared", "-Xcompiler", "-fPIC", f"--fmad={'true' if fmad else 'false'}",
             "-Xptxas", "-v"] + (["-DGPRT_COUNT_OPS"] if count_ops else [])
            + (["-DGPRT_COUNT_SIMT"] if count_simt else [])
            + (["-DGPRT_FACE_LOOP_GLOBAL"] if faces_global else [])
            + (["-DGPRT_REPAIR_FULL"] if repair_full else [])
            + (["-DGPRT_FINISH_PER_RAY"] if finish_per_ray else [])
            + (DEVICE_LAUNCH_FLAGS if name in DEVICE_LAUNCH else []))


def library_path(name: str, fmad: bool = DEFAULT_FMAD, count_ops: bool = False,
                 count_simt: bool = False, faces_global: bool = False,
                 repair_full: bool = False, finish_per_ray: bool = False) -> Path:
    """Where the build of csrc/<name>.cu with these flags lives."""
    flags = _flags(name, fmad, count_ops, count_simt, faces_global, repair_full, finish_per_ray)
    h = hashlib.sha256(" ".join(flags + _libs(name)).encode())
    for src in (f"{name}.cu",) + _INCLUDES.get(name, ()) + _HEADERS:
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _libs(name: str) -> list:
    return DEVICE_LAUNCH_LIBS if name in DEVICE_LAUNCH else []


def compile_kernel(name: str, fmad: bool = DEFAULT_FMAD, count_ops: bool = False,
                   count_simt: bool = False, faces_global: bool = False,
                   repair_full: bool = False, finish_per_ray: bool = False) -> tuple[Path, str]:
    """Compile csrc/<name>.cu unless its build exists. Returns the library
    path and ptxas' report (registers, spills), kept beside the library so
    that a reused build reports it too."""
    variant = (fmad, count_ops, count_simt, faces_global, repair_full, finish_per_ray)
    out = library_path(name, *variant)
    report = out.with_suffix(".ptxas")
    if out.exists():
        return out, report.read_text() if report.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path()] + _flags(name, *variant) + [
        "-o", tmp, str(CSRC / f"{name}.cu")] + _libs(name)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {name}.cu:\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    report.write_text(proc.stderr)
    os.replace(tmp, out)
    return out, proc.stderr


def compile_all(builds) -> dict:
    """Run compile_kernel for every (name, fmad, count_ops[, count_simt[,
    faces_global[, repair_full[, finish_per_ray]]]]) in ``builds`` at once
    (one nvcc process each); returns {build: ptxas report}."""
    builds = list(builds)
    with ThreadPoolExecutor(max_workers=max(1, len(builds))) as pool:
        reports = list(pool.map(lambda b: compile_kernel(*b)[1], builds))
    return dict(zip(builds, reports))


@functools.lru_cache(maxsize=None)
def load(name: str, fmad: bool = DEFAULT_FMAD, count_ops: bool = False,
         count_simt: bool = False, faces_global: bool = False,
         repair_full: bool = False, finish_per_ray: bool = False) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; declares the C interface
    (every pointer and the stream as c_void_p). repair_full
    (-DGPRT_REPAIR_FULL, scene_kernel.cu): the occlusion repair runs the
    whole traversal instead of resuming from the defer entry's march
    records, for checks; finish_per_ray (-DGPRT_FINISH_PER_RAY,
    scene_finish.cu): the two-phase finisher runs one thread per ray
    without the queue, for checks."""
    path, _ = compile_kernel(name, fmad, count_ops, count_simt, faces_global, repair_full,
                             finish_per_ray)
    lib = ctypes.CDLL(str(path))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # (entry, pointers, ints) of the entries that end in (ops, device, stream)
    entries = {
        "frame_kernel": (("gprt_frame_render", 4, 9), ("gprt_frame_compact", 7, 13),
                         ("gprt_frame_dense", 6, 10), ("gprt_frame_defer", 10, 11)),
        "frame_gate": (("gprt_frame_gated", 5, 11),),
        "scene_kernel": (("gprt_scene_closest", 11, 9), ("gprt_shadow_queue", 9, 7)),
        "scene_finish": (("gprt_scene_finish", 11, 6),),
    }
    for fn, n_ptr, n_int in entries.get(name, ()):
        getattr(lib, fn).argtypes = [vp] * n_ptr + [ci] * n_int + [vp, ci, vp]
        getattr(lib, fn).restype = ci
    if name == "frame_kernel":
        lib.gprt_frame_residency.argtypes = [ci] * 6 + [vp, vp]
        lib.gprt_frame_residency.restype = ci
        lib.gprt_frame_compose.argtypes = [vp] * 5 + [ci, ci, ci, vp]
        lib.gprt_frame_compose.restype = ci
        lib.gprt_queue_bin.argtypes = [vp] * 6 + [ci] * 6 + [vp]
        lib.gprt_queue_bin.restype = ci
    elif name == "scene_kernel":
        lib.gprt_scene_residency.argtypes = [ci] * 5 + [vp, vp]
        lib.gprt_scene_residency.restype = ci
        lib.gprt_sdf_distance.argtypes = [ci, vp, vp, ci, vp, ci, vp]
        lib.gprt_sdf_distance.restype = ci
    elif name == "scene_finish":
        lib.gprt_finish_queue.argtypes = [vp] * 3 + [ci, ci, vp]
        lib.gprt_finish_queue.restype = ci
        lib.gprt_finish_compacts.argtypes = []
        lib.gprt_finish_compacts.restype = ci
    elif name == "megakernel":
        lib.gprt_sphere_trace.argtypes = ([vp] * 7 + [ci, ci, cf, ci, cf, cf, ci, ci, ci]
                                          + [vp, ci, vp])
        lib.gprt_sphere_trace.restype = ci
        lib.gprt_trimesh.argtypes = [vp, ci] + [vp] * 6 + [ci, ci, vp, ci, vp]
        lib.gprt_trimesh.restype = ci
        lib.gprt_route_pass.argtypes = [vp] * 10 + [ci] * 7 + [vp, ci, vp]
        lib.gprt_route_pass.restype = ci
        lib.gprt_route_residency.argtypes = [ci] * 5 + [vp, vp]
        lib.gprt_route_residency.restype = ci
    elif name == "op_probe":
        lib.gprt_op_probe.argtypes = [ci, ci, vp, vp, ci, ci, ci, vp]
        lib.gprt_op_probe.restype = ci
    lib.gprt_error_string.argtypes = [ci]
    lib.gprt_error_string.restype = ctypes.c_char_p
    return lib
