"""Op-cost probe: ns per element-iteration of each op mix, f32 against bf16.

The port of the reference's tools/profile_vpu.py: for each op mix of
kernels/op_probe.OPS and each type, one launch of csrc/op_probe.cu runs
``--iters`` dependent iterations on every element of a (256, 256) array
filled with 1.2345. The time of a launch is the mean over ``--reps``
launches between two CUDA events (the reference took the slope of a chain
of calls, because its remote TPU's dispatch floor hid a single call).
Prints one line per variant (ms per launch, ns per element-iteration), the
bf16/f32 ratio per mix, and a JSON line with every number, the device and
the card.

    python -m gpuraytracer_tpu_torch.apps.op_probe [--iters 2000] [--reps 64]

``--device cpu`` runs the plain version with host-clock times (a smoke
run: its numbers are the CPU's, not the card's).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from gpuraytracer_tpu_torch.kernels import op_probe


def time_variant(x, op: str, iters: int, reps: int) -> float:
    """Mean ms of one probe launch over ``reps`` launches, after a warm-up
    (device clock on a GPU, host clock on the CPU)."""
    op_probe.op_probe(x, op, iters)
    if x.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            op_probe.op_probe(x, op, iters)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        op_probe.op_probe(x, op, iters)
    return (time.perf_counter() - t0) * 1e3 / reps


def run(iters: int, reps: int, device) -> dict:
    """{variant: {"ms": ms per launch, "ns_per_elem_iter": ...}} and the
    bf16/f32 ratio per mix, for every op mix and type."""
    results = {}
    for name, dtype in op_probe.DTYPES.items():
        x = torch.full(op_probe.SHAPE, op_probe.FILL, dtype=dtype, device=device)
        for op in op_probe.OPS:
            ms = time_variant(x, op, iters, reps)
            results[f"{op}_{name}"] = {"ms": ms, "ns_per_elem_iter": ms * 1e6 / (iters * x.numel())}
    ratios = {op: results[f"{op}_bf16"]["ns_per_elem_iter"] / results[f"{op}_f32"]["ns_per_elem_iter"]
              for op in op_probe.OPS}
    return {"variants": results, "bf16_over_f32": ratios}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--iters", type=int, default=2000)
    p.add_argument("--reps", type=int, default=64)
    p.add_argument("--device", default="cuda", help="torch device: cuda, cuda:N or cpu")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("op_probe: CUDA is not available (use --device cpu for a smoke run)")
    out = run(args.iters, args.reps, device)
    for key, r in out["variants"].items():
        print(f"{key:12s} {r['ms']:10.4f} ms/launch  {r['ns_per_elem_iter']:9.6f} ns/elem-iter",
              flush=True)
    for op, ratio in out["bf16_over_f32"].items():
        print(f"{op:8s} bf16/f32 = {ratio:.3f}", flush=True)
    out.update(iters=args.iters, reps=args.reps, elements=op_probe.SHAPE[0] * op_probe.SHAPE[1],
               device=(torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
