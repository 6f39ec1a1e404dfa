"""Row 10: an animated frame's per-frame state in one hand-written CUDA
kernel (csrc/frame_state.cu).

The reference never animates a frame on the host: its frame program
(render/renderer.py's jitted step, apps/bench_suite.py's make_chain) runs
the animation (models/builtin.py build_instance_transforms,
models/builder.py _transforms, the metaball keyframes) and the pack of the
frame kernel's parameters inside one XLA program. The port replays a frame
as a captured CUDA graph (render/program.py); ``advance`` is the part of
that program which XLA fused: from the animation time in device memory
(entry ``index`` of a program's time buffer) it writes the pack's
per-frame fields (kernels/frame_kernel.frame_fields: the header's time,
b2l_rows, l2b_rot and the metaball block) in place into the parameter
buffer that frame_kernel.pack_static built once.

The per-instance inputs are an animator's ``table`` (builtin.ANIMATION_TABLE
or SceneBuilder.animation_table(): rotation rate, rotates, scale, centre),
uploaded once per device (core/upload.constant), so a frame makes no
upload. The same kernel serves the builtin scene and every builder scene.

On a CUDA tensor ``advance`` launches the kernel (counted in LAUNCHES) or
raises; on a CPU tensor it runs the plain version, ``advance_plain``: the
animator itself (builtin.animate_arrays or SceneBuilder.animator()), then
frame_kernel.write_frame_fields of frame_kernel.frame_fields. The library
is built without contraction (kernels/build.NO_FMAD), so on the card the
kernel's fields equal the plain version's bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gpuraytracer_tpu_torch.core.types import METABALL_CYCLE_DURATION
from gpuraytracer_tpu_torch.core.upload import constant
from gpuraytracer_tpu_torch.geometry import metaballs
from gpuraytracer_tpu_torch.kernels import frame_kernel

# Kernel launches since import (or since a caller reset it).
LAUNCHES = 0
# Floats per instance row of the table (csrc/frame_state.cu kStateStride).
STATE_STRIDE = 8
# The metaball table: keyframe centres at t0 and t1 (3 x 3 each), the radii,
# the cycle, and the cycle's f32 reciprocal, by which PyTorch's CUDA
# division of a tensor by a Python scalar multiplies
# (hlsl.calculate_animation_interpolant's "/ cycle_duration").
METABALL_TABLE = (
    tuple(x for k in metaballs.KEYFRAME_CENTERS for x in k[0])
    + tuple(x for k in metaballs.KEYFRAME_CENTERS for x in k[1])
    + tuple(metaballs.RADII)
    + (METABALL_CYCLE_DURATION,
       float(np.float32(1.0) / np.float32(METABALL_CYCLE_DURATION))))


def advance_plain(pack, animate, arrays, times, index: int = 0):
    """The kernel's plain version: ``animate(arrays, times[index])``, then
    the pack's per-frame fields written from it in place. Returns the
    animated arrays."""
    animated = animate(arrays, times[index])
    frame_kernel.write_frame_fields(pack, frame_kernel.frame_fields(animated))
    return animated


def advance(pack, animate, arrays, times, index: int = 0, *, lib=None):
    """Write the per-frame fields of the frame at ``times[index]`` (``times``
    an (n,) f32 tensor on the pack's device) into ``pack.params`` in place,
    as ``advance_plain`` does with the animator ``animate`` over ``arrays``.

    CUDA: one launch of csrc/frame_state.cu on the current stream over
    ``animate``'s table (``lib``: a loaded build, default the shipped one),
    counted in LAUNCHES; no upload and no host sync after the tables' first
    use on the device. Returns ``arrays`` (the pack alone carries the
    frame's state). CPU: ``advance_plain``, which returns the animated
    arrays."""
    global LAUNCHES
    dev = pack.params.device
    if times.dtype != torch.float32 or times.dim() != 1 or times.device != dev:
        raise ValueError(f"times: expected a 1-D float32 tensor on {dev}, got "
                         f"{tuple(times.shape)} {times.dtype} on {times.device}")
    if not 0 <= index < times.shape[0]:
        raise ValueError(f"index {index} outside the {times.shape[0]} times")
    if dev.type == "cpu":
        return advance_plain(pack, animate, arrays, times, index)
    if dev.type != "cuda":
        raise ValueError(f"no frame state kernel for device {dev}")
    rows = getattr(animate, "table", None)
    if rows is None:
        raise ValueError("the animator has no table for the frame state kernel")
    g = pack.num_geometries
    if len(rows) != g or any(len(r) != STATE_STRIDE for r in rows):
        raise ValueError(f"table of {len(rows)} rows for {g} geometries")
    frame_kernel.check_pack(pack)
    from gpuraytracer_tpu_torch.kernels import build

    lib = lib if lib is not None else build.load("frame_state")
    table = constant(tuple(tuple(map(float, r)) for r in rows), dev)
    mb = constant(METABALL_TABLE, dev)
    times = times.contiguous()
    rc = lib.gprt_frame_state(ctypes.c_void_p(pack.params.data_ptr()),
                              ctypes.c_void_p(table.data_ptr()), ctypes.c_void_p(mb.data_ptr()),
                              ctypes.c_void_p(times.data_ptr()), index, g, dev.index,
                              ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"frame state launch failed: CUDA error {rc} "
                           f"({lib.gprt_error_string(rc).decode()})")
    LAUNCHES += 1
    return arrays
