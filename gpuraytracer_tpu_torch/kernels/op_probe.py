"""Op-cost probe in one hand-written CUDA kernel (csrc/op_probe.cu).

Replaces the reference's tools/profile_vpu.py ``make_kernel`` (a Pallas
kernel that runs ``fori_loop(0, iters, body, x)`` over a (256, 256) tile),
which priced the op classes of a distance function on the TPU's vector
unit in f32 and bf16, to decide whether a reduced-precision occlusion march
would pay. Each element runs ``iters`` dependent iterations of one op mix
(OPS) on its own value; ``apps/op_probe.py`` times every mix in both types
with CUDA events and prices each variant's SASS by pipe. On the card a bf16
thread computes two elements as one packed pair (each op rounded once, as
the plain version rounds); ``build.load("op_probe",
defines=SCALAR_DEFINES)`` is the parent's one element a thread, which it
equals element for element.

On a CPU tensor ``op_probe`` runs the plain version, the same loop in
PyTorch in the tensor's type (one rounding per op in bf16); on a CUDA
tensor it launches the kernel or raises.

``latency_cycles`` runs the same library's latency chains, the instrument
that prices a probe's dependent chain: one thread, a chain of one SASS
class's dependent instructions between two reads of the SM clock (a GPU
only: a CPU has no such clock to read).
"""

from __future__ import annotations

import ctypes

import torch

# The reference's op mixes, in the kernel's order (csrc/op_probe.cu ProbeOp).
OPS = ("fma", "minmax", "sqrt", "rsqrt", "cos")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# The reference's array: ROWS x 256 elements filled with 1.2345.
SHAPE = (256, 256)
FILL = 1.2345
# f32 FLOPs of one iteration of each mix, counted as csrc/frame_math.cuh
# counts (a multiply-add is two; min, max, sqrt, rsqrt and cos one each;
# compares and selects none): the operation bound of a measurement.
FLOPS_PER_ITER = {"fma": 19, "minmax": 7, "sqrt": 3, "rsqrt": 3, "cos": 2}

# The -D macro of the probe's parent bf16 form, one element a thread.
SCALAR_DEFINES = ("GPRT_PROBE_BF16_SCALAR",)

# The latency chains' classes, in csrc/op_probe.cu's LatencyClass order,
# and the instructions a link of each issues (fmnmx: min.f32 then max.f32;
# hmnmx2: min.bf16x2 then max.bf16x2; cvt: cvt.rzi.s32.f32 then
# cvt.rn.f32.s32; mufu: rsqrt.approx.ftz.f32; the rest one PTX op).
LATENCY_CLASSES = {"ffma": 1, "fadd": 1, "imad": 1, "fmnmx": 2, "hfma2": 1, "hmul2": 1,
                   "hadd2": 1, "hmnmx2": 2, "mufu": 1, "cvt": 2}
# Links of a chain's round (csrc/op_probe.cu kChainLength).
CHAIN_LENGTH = 64

# Kernel launches since import (or since a caller reset it): the probe, and
# the latency chains apart.
LAUNCHES = 0
LATENCY_LAUNCHES = 0


def _body(op: str, v, one, half):
    """One iteration of ``op`` (tools/profile_vpu.py make_kernel's body)."""
    if op == "fma":
        a = v * v + half
        b = v * a + one
        a = a * b + half
        b = b * a + one
        a = a * b + half
        b = b * a + one
        a = a * b + half
        b = b * a + one
        return a * half + b * half
    if op == "minmax":
        a = torch.maximum(v, half)
        b = torch.minimum(v, one)
        c = torch.where(a > b, a * half, b)
        a = torch.maximum(c, half)
        b = torch.minimum(c, one)
        return torch.where(a > b, a * half, b) * one
    if op == "sqrt":
        return torch.sqrt(v * v + one)
    if op == "rsqrt":
        return torch.rsqrt(v * v + one)
    if op == "cos":
        return torch.cos(v) + half
    raise ValueError(f"unknown op {op!r}; one of {OPS}")


def op_probe_plain(x, op: str, iters: int):
    """The kernel's plain version: ``iters`` iterations of ``op`` on every
    element of ``x`` (f32 or bf16), each op in x's type."""
    one = torch.tensor(1.0000001, dtype=x.dtype, device=x.device)
    half = torch.tensor(0.5, dtype=x.dtype, device=x.device)
    v = x
    for _ in range(iters):
        v = _body(op, v, one, half)
    return v


def op_probe(x, op: str, iters: int, lib=None):
    """``iters`` iterations of op mix ``op`` on every element of ``x`` (a
    contiguous f32 or bf16 tensor). CUDA: launches csrc/op_probe.cu on the
    current stream (``lib``: a loaded build of it, default the shipped one)
    and counts the launch in LAUNCHES; CPU: ``op_probe_plain``."""
    global LAUNCHES
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; one of {OPS}")
    if x.dtype not in DTYPES.values() or not x.is_contiguous():
        raise ValueError(f"x: expected a contiguous float32 or bfloat16 tensor, got {x.dtype}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    dev = x.device
    if dev.type == "cpu":
        return op_probe_plain(x, op, iters)
    if dev.type != "cuda":
        raise ValueError(f"no op probe kernel for device {dev}")
    from gpuraytracer_tpu_torch.kernels import build

    lib = lib if lib is not None else build.load("op_probe")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    if x.data_ptr() % 4:
        x = x.clone()  # a packed pair is read as one 4-byte word
    rc = lib.gprt_op_probe(OPS.index(op), int(x.dtype == torch.bfloat16),
                           ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
                           x.numel(), int(iters), dev.index,
                           ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"op probe launch failed: CUDA error {rc} "
                           f"({lib.gprt_error_string(rc).decode()})")
    LAUNCHES += 1
    return out


def latency_cycles(klass: str, iters: int, device, lib=None) -> int:
    """SM clocks of one latency chain of class ``klass`` (LATENCY_CLASSES):
    one thread, ``iters`` rounds of CHAIN_LENGTH dependent links between two
    clock reads. Launches csrc/op_probe.cu's chain on the current stream and
    counts it in LATENCY_LAUNCHES, then reads the clocks back (``lib``: a
    loaded build, default the shipped one). A GPU only: raises on any other
    device."""
    global LATENCY_LAUNCHES
    if klass not in LATENCY_CLASSES:
        raise ValueError(f"unknown latency class {klass!r}; one of {tuple(LATENCY_CLASSES)}")
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the latency chains read the SM clock of a GPU, not of {dev}")
    from gpuraytracer_tpu_torch.kernels import build

    lib = lib if lib is not None else build.load("op_probe")
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    sink = torch.zeros(1, dtype=torch.float32, device=dev)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    rc = lib.gprt_op_latency(list(LATENCY_CLASSES).index(klass), int(iters),
                             ctypes.c_void_p(cycles.data_ptr()), ctypes.c_void_p(sink.data_ptr()),
                             index, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"latency chain launch failed: CUDA error {rc} "
                           f"({lib.gprt_error_string(rc).decode()})")
    LATENCY_LAUNCHES += 1
    return int(cycles.item())
