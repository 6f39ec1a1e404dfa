"""Op-cost probe: ns per element-iteration of each op mix, f32 against bf16.

The port of the reference's tools/profile_vpu.py: for each op mix of
kernels/op_probe.OPS and each type, one launch of csrc/op_probe.cu runs
``--iters`` dependent iterations on every element of a (256, 256) array
filled with 1.2345 (bf16: two elements a thread, as one packed pair). The
time of a launch is the mean over ``--reps`` launches between two CUDA
events (the reference took the slope of a chain of calls, because its
remote TPU's dispatch floor hid a single call). Prints one line per variant
(ms per launch, ns per element-iteration), the bf16/f32 ratio per mix, and
a JSON line with every number, the device and the card.

``--pipes`` (a GPU with the CUDA toolkit's cuobjdump) also prices each
variant by pipe: the SASS instructions that one iteration of its loop
executes (``sass_loop_counts``), each pipe's count at the pipe's rate and the
issue slots at one instruction a clock a scheduler, at the SM clock that
``nvidia-smi`` reports as the maximum; the dependent chain of one
iteration (``chain_cycles``: the loop's SASS, each instruction at its
family's latency, which the latency chains of csrc/op_probe.cu measure,
``instruction_latencies``) times the iterations; and the bytes. The
variant's bound is the largest of those terms, written beside the
FLOP-count bound of kernels/op_probe.FLOPS_PER_ITER. Beside the bound it
reads two measurements: one warp's time per iteration (the slope between
two iteration counts, nothing to hide the chain) and the throughput with
the card full (``THROUGHPUT_ELEMENTS``).

    python -m gpuraytracer_tpu_torch.apps.op_probe [--iters 2000] [--reps 64] [--pipes]

``--device cpu`` runs the plain version with host-clock times (a smoke
run: its numbers are the CPU's, not the card's).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import time

import torch

from gpuraytracer_tpu_torch.kernels import op_probe

# Lanes a clock an H100 SM is taken to serve on each pipe: fma, f32 add,
# multiply and multiply-add (and IMAD), 128, the data sheet's 67 TFLOP/s
# at 132 SMs and 1.98 GHz; fp16, the packed half and bf16 pairs (HFMA2,
# HMUL2, HADD2), 128 pairs, its 133.8 TFLOP/s; alu, compare, min, max,
# select, logic, shifts and moves (and F2FP, the pack of two f32 into a
# pair), 64; xu, the MUFU (reciprocal, rsqrt, sin, cos, ex2, lg2) and the
# conversions through it (F2I, I2F, F2F, FRND), 16, as NVIDIA's throughput
# table for compute capability 9.0 gives them. A bound takes them as the
# most the card can do; the full-card run reads what it did.
PIPE_LANES = {"fma": 128, "fp16": 128, "alu": 64, "xu": 16}
# Warp instructions an SM issues a clock: one per scheduler, four of them.
ISSUE_PER_SM = 4
PIPE_OF = {
    "fma": ("FFMA", "FMUL", "FADD", "FFMA32I", "FMUL32I", "FADD32I", "IMAD", "IMUL", "FSWZADD"),
    "fp16": ("HFMA2", "HMUL2", "HADD2", "HFMA2.MMA"),
    "alu": ("FMNMX", "FSEL", "FSETP", "FSET", "ISETP", "IADD3", "IADD", "LOP3", "LOP", "SEL",
            "SHF", "SHL", "SHR", "PRMT", "MOV", "IMNMX", "HMNMX2", "HSETP2", "HSET2", "PLOP3",
            "P2R", "R2P", "LEA", "IABS", "BMSK", "F2FP", "VIADD", "VIMNMX", "I2FP", "F2IP",
            "FCHK", "CS2R"),
    "xu": ("MUFU", "F2I", "I2F", "F2F", "FRND", "POPC", "FLO", "BREV"),
}
_PIPE = {op: pipe for pipe, ops in PIPE_OF.items() for op in ops}
# Elements of the throughput run: the reference's array 64 times over, so
# that every SM runs many full waves of resident threads.
THROUGHPUT_ELEMENTS = 64 * op_probe.SHAPE[0] * op_probe.SHAPE[1]
HBM_BYTES_PER_S = 3.35e12


def time_variant(x, op: str, iters: int, reps: int, lib=None) -> float:
    """Mean ms of one probe launch over ``reps`` launches, after a warm-up
    (device clock on a GPU, host clock on the CPU)."""
    op_probe.op_probe(x, op, iters, lib=lib)
    if x.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            op_probe.op_probe(x, op, iters, lib=lib)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        op_probe.op_probe(x, op, iters, lib=lib)
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


def pipe_of(opcode: str) -> str:
    """The pipe of a SASS opcode (PIPE_OF; U* opcodes "uniform", branches
    and anything else "other": they take an issue slot only)."""
    for key in (opcode, opcode.split(".")[0]):
        if key in _PIPE:
            return _PIPE[key]
    return "uniform" if opcode.startswith("U") else "other"


_FUNCTION = re.compile(r"Function : (\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def _variant_of(mangled: str):
    """(op, dtype) of an op_probe.cu kernel's mangled name (("latency",
    class) for a latency chain), or None."""
    m = re.search(r"latency_kernelILi(\d+)E", mangled)
    if m:
        return "latency", list(op_probe.LATENCY_CLASSES)[int(m.group(1))]
    m = re.search(r"op_probe_pair_kernelILi(\d)E", mangled)
    if m:
        return op_probe.OPS[int(m.group(1))], "bf16"
    m = re.search(r"op_probe_kernelILi(\d)E(f|13__nv_bfloat16)E", mangled)
    if m:
        return op_probe.OPS[int(m.group(1))], "f32" if m.group(2) == "f" else "bf16"
    return None


# Opcodes of a path that a probe's inputs never take: the slow paths of
# cosf's range reduction (table loads, local memory, doubles) and of sqrtf
# (a call for special and tiny inputs).
_SLOW = ("CALL", "LDG", "LDL", "STL", "DMUL", "DADD", "DFMA")


def iteration_path(lines):
    """The instructions [(address, guard, opcode, operands)] that one iteration of
    a kernel's outermost loop executes: from the target of the backward
    branch that reaches furthest back to that branch, taking each forward
    branch that skips a slow path (a region with an opcode of _SLOW),
    falling through every other (its predicated instructions counted), and
    following unconditional branches."""
    insns = []
    for line in lines:
        m = _INSN.search(line)
        if m:
            insns.append((int(m.group(1), 16), (m.group(2) or "").strip(), m.group(3),
                          m.group(4).strip()))

    def target(args):
        t = re.search(r"0x([0-9a-f]+)", args)
        return int(t.group(1), 16) if t else None

    back = [(target(a), addr) for addr, _, op, a in insns
            if op.startswith("BRA") and target(a) is not None and target(a) < addr]
    if not back:
        return []
    lo, hi = min(back, key=lambda b: (b[0], -b[1]))
    at = {addr: k for k, (addr, *_) in enumerate(insns)}
    path, k = [], at[lo]
    while k < len(insns) and insns[k][0] <= hi and len(path) < 10 * len(insns):
        addr, pred, op, args = insns[k]
        path.append((addr, pred, op, args))
        if addr == hi:
            break
        if op.startswith("BRA") and target(args) in at:
            dest = at[target(args)]
            skipped = insns[k + 1:dest] if dest > k else []
            if not pred or any(o.startswith(_SLOW) for _, _, o, _ in skipped):
                k = dest
                continue
        k += 1
    return path


def sass_loop_counts(path) -> dict:
    """{(op, dtype): {"pipes": {pipe: instructions of one iteration},
    "opcodes": {opcode: count}, "total": n, "path": the instructions}} for
    every op_probe.cu kernel in the built library at ``path`` (the latency
    chains under ("latency", class)), from ``cuobjdump -sass``: the
    instructions of iteration_path (NOPs not counted)."""
    from gpuraytracer_tpu_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    return loop_counts(subprocess.run([tool, "-sass", str(path)], capture_output=True,
                                      text=True, check=True, timeout=120).stdout)


def loop_counts(sass: str) -> dict:
    """sass_loop_counts of ``sass``, the text that ``cuobjdump -sass``
    printed."""
    out, name, lines = {}, None, []

    def flush():
        variant = _variant_of(name) if name else None
        if variant is None:
            return
        ops, insns = {}, []
        for _, guard, opcode, args in iteration_path(lines):
            if opcode != "NOP":
                ops[opcode] = ops.get(opcode, 0) + 1
                insns.append((guard, opcode, args))
        pipes = {}
        for opcode, n in ops.items():
            pipes[pipe_of(opcode)] = pipes.get(pipe_of(opcode), 0) + n
        out[variant] = {"pipes": pipes, "opcodes": ops, "total": sum(ops.values()),
                        "path": insns}

    for line in sass.splitlines():
        m = _FUNCTION.search(line)
        if m:
            flush()
            name, lines = m.group(1), []
        else:
            lines.append(line)
    flush()
    return out


# Opcodes that write no register (stores, branches, barriers), and those
# whose first two operands are both written (the predicate-setting
# compares).
_NO_DEST = ("ST", "RED", "BRA", "EXIT", "BAR", "RET", "CALL", "NOP", "BSYNC", "BSSY",
            "WARPSYNC", "YIELD", "MEMBAR", "JMP", "DEPBAR")
_REG = re.compile(r"\b(U?R)(\d+)(?:\.(64|128))?\b|\b(U?P)(\d)\b")


def _registers(text: str) -> list:
    """The registers an operand list names (RZ, PT and constants not; a
    .64 or .128 operand names its 2 or 4 registers)."""
    out = []
    for m in _REG.finditer(text):
        if m.group(1):
            width = {"64": 2, "128": 4}.get(m.group(3), 1)
            out += [f"{m.group(1)}{int(m.group(2)) + k}" for k in range(width)]
        else:
            out.append(f"{m.group(4)}{m.group(5)}")
    return out


def operands(guard: str, opcode: str, args: str) -> tuple:
    """(registers written, registers read) of one SASS instruction."""
    parts = [a.strip() for a in args.split(",")] if args.strip() else []
    base = opcode.split(".")[0]
    if base.startswith(_NO_DEST):
        n_dest = 0
    elif "SETP" in base or base == "PLOP3":
        n_dest = 2
    else:
        n_dest = 1
    dests = _registers(", ".join(parts[:n_dest]))
    reads = _registers(", ".join(parts[n_dest:])) + _registers(guard)
    return dests, reads


def family(opcode: str) -> str:
    """The family of a SASS opcode: its name before the first modifier, with
    .MMA kept (HFMA2.MMA runs on another unit than HFMA2)."""
    base = opcode.split(".")[0]
    return base + ".MMA" if ".MMA" in opcode else base


def chain_cycles(path, families: dict, floor: float, rounds: int = 6) -> float:
    """Cycles of one iteration's loop-carried dependent chain: the
    instructions of ``path`` [(guard, opcode, operands)] run ``rounds``
    times in order, each ready ``families[its opcode's family]`` cycles
    (``floor`` for a family that ``families`` lacks) after the last of the
    registers it reads, and the growth of the latest register between the
    second round and the last, a round. A lower bound on a warp's time an
    iteration where no instruction is faster than its price: issue, other
    warps and the rest can only add to it."""
    ready, marks = {}, []
    for _ in range(rounds):
        for guard, opcode, args in path:
            dests, reads = operands(guard, opcode, args)
            if not dests:
                continue
            t = max((ready.get(r, 0.0) for r in reads), default=0.0)
            t += families.get(family(opcode), floor)
            for r in dests:
                ready[r] = t
        marks.append(max(ready.values(), default=0.0))
    return (marks[-1] - marks[1]) / (rounds - 2)


def instruction_latencies(device, lib, sass, iters: int = 200) -> dict:
    """Per latency class of kernels/op_probe.LATENCY_CLASSES: "cycles" an
    instruction (the slope of the chain's clocks between ``iters`` and 3 x
    ``iters`` rounds, over the instructions of a round), its SASS
    ("opcodes": one round's loop, from ``sass``) and "family", the one
    opcode family of its chain, or None where the assembler split the chain
    between families (the pair chains between HFMA2 and HFMA2.MMA, whose
    mean is no one instruction's latency). "families": each family's least
    cycles over the classes of that family alone; "floor": the least of
    them, the price of every other family (on an H100 the ALU's and the FMA
    pipe's 4 cycles, the least that an instruction's result takes)."""
    classes, families = {}, {}
    for klass, per_link in op_probe.LATENCY_CLASSES.items():
        op_probe.latency_cycles(klass, iters, device, lib)  # warm-up
        lo = op_probe.latency_cycles(klass, iters, device, lib)
        hi = op_probe.latency_cycles(klass, 3 * iters, device, lib)
        per_round = (hi - lo) / (2 * iters)
        counts = sass[("latency", klass)]["opcodes"]
        # The chain's instructions: each opcode a round holds at least half
        # a chain's worth of (the loop's counter, compare and branch: one).
        chain = {family(op) for op, n in counts.items() if 2 * n >= op_probe.CHAIN_LENGTH}
        fam = chain.pop() if len(chain) == 1 else None
        cycles = per_round / (op_probe.CHAIN_LENGTH * per_link)
        classes[klass] = {"cycles": cycles, "opcodes": counts, "family": fam}
        if fam is not None:
            families[fam] = min(families.get(fam, math.inf), cycles)
    return {"classes": classes, "families": families, "floor": min(families.values())}


def max_sm_clock_hz(index: int = 0) -> float:
    """The SM clock that nvidia-smi reports as the card's maximum, in Hz."""
    out = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def pipe_bound(counts: dict, threads: int, iters: int, nbytes: int, chain: float, sms: int,
               clock_hz: float) -> dict:
    """The bound terms (ms) of ``iters`` iterations on ``threads`` threads
    whose one iteration issues ``counts`` (sass_loop_counts' entry): each
    pipe's warp instructions at its rate, the issue slots, the bytes over
    the memory rate, and the latency term, ``iters`` times ``chain``
    (chain_cycles of one iteration) at the clock (each warp runs its whole
    chain; at the reference's shape every warp is resident at once);
    "bound_ms" the largest, "bound_by" its name."""
    warps = math.ceil(threads / 32) * iters
    per_s = sms * clock_hz * 1e-3
    terms = {pipe: warps * counts["pipes"].get(pipe, 0) / (lanes / 32 * per_s)
             for pipe, lanes in PIPE_LANES.items()}
    terms["issue"] = warps * counts["total"] / (ISSUE_PER_SM * per_s)
    terms["bytes"] = nbytes / HBM_BYTES_PER_S * 1e3
    terms["latency"] = iters * chain / clock_hz * 1e3
    by = max(terms, key=terms.get)
    return {"terms": terms, "bound_ms": terms[by], "bound_by": by}


def pipes(iters: int, reps: int, device, lib=None) -> dict:
    """Per variant: its SASS counts by pipe, its dependent chain an
    iteration (chain_cycles at instruction_latencies' families), the bound at
    the reference's shape and ``iters`` (pipe_bound; "flop_bound_ms": the
    FLOP count at the type's peak, the bound before the pipes priced it),
    and two measurements: one warp's ms per iteration (a launch of one warp:
    the slope between iters and 3 x iters) and the throughput with the card
    full (ns per element-iteration over THROUGHPUT_ELEMENTS). Also the
    latencies ("latencies"), the clock and the SMs."""
    from gpuraytracer_tpu_torch.kernels import build

    lib = lib if lib is not None else build.load("op_probe")
    sass = sass_loop_counts(lib._name)
    index = device.index if device.index is not None else torch.cuda.current_device()
    clock = max_sm_clock_hz(index)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    lat = instruction_latencies(device, lib, sass)
    per_thread = {"f32": 1, "bf16": int(lib.gprt_op_probe_bf16_per_thread())}
    flop_rate = {"f32": 67e12, "bf16": 133.8e12}
    out = {}
    for name, dtype in op_probe.DTYPES.items():
        one_warp = torch.full((32 * per_thread[name],), op_probe.FILL, dtype=dtype, device=device)
        full = torch.full((THROUGHPUT_ELEMENTS,), op_probe.FILL, dtype=dtype, device=device)
        ref = op_probe.SHAPE[0] * op_probe.SHAPE[1]
        for op in op_probe.OPS:
            lo = time_variant(one_warp, op, iters, reps, lib)
            hi = time_variant(one_warp, op, 3 * iters, reps, lib)
            warp_ms = (hi - lo) / (2 * iters)
            t_iters = max(1, iters // 10)
            thr_ms = time_variant(full, op, t_iters, max(1, reps // 4), lib)
            nbytes = 2 * ref * full.element_size()
            counts = sass[(op, name)]
            chain = chain_cycles(counts["path"], lat["families"], lat["floor"])
            b = pipe_bound(counts, -(-ref // per_thread[name]), iters, nbytes, chain, sms, clock)
            flops = iters * ref * op_probe.FLOPS_PER_ITER[op]
            out[f"{op}_{name}"] = dict(
                sass={k: v for k, v in counts.items() if k != "path"}, chain_cycles_per_iter=chain,
                one_warp_ns_per_iter=warp_ms * 1e6,
                one_warp_cycles_per_iter=warp_ms * 1e-3 * clock,
                throughput_ns_per_elem_iter=thr_ms * 1e6 / (t_iters * THROUGHPUT_ELEMENTS),
                flop_bound_ms=max(flops / flop_rate[name], nbytes / HBM_BYTES_PER_S) * 1e3, **b)
    return {"variants": out, "latencies": lat, "clock_hz": clock, "sms": sms,
            "elements_per_thread": per_thread}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--iters", type=int, default=2000)
    p.add_argument("--reps", type=int, default=64)
    p.add_argument("--pipes", action="store_true",
                   help="also price each variant by pipe from its SASS (a GPU and cuobjdump)")
    p.add_argument("--device", default="cuda", help="torch device: cuda, cuda:N or cpu")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("op_probe: CUDA is not available (use --device cpu for a smoke run)")
    if args.pipes and device.type != "cuda":
        raise SystemExit("op_probe: --pipes prices the card's SASS and needs --device cuda")
    out = run(args.iters, args.reps, device)
    for key, r in out["variants"].items():
        print(f"{key:12s} {r['ms']:10.4f} ms/launch  {r['ns_per_elem_iter']:9.6f} ns/elem-iter",
              flush=True)
    for op, ratio in out["bf16_over_f32"].items():
        print(f"{op:8s} bf16/f32 = {ratio:.3f}", flush=True)
    if args.pipes:
        out["pipes"] = pipes(args.iters, max(4, args.reps // 8), device)
        for klass, c in out["pipes"]["latencies"]["classes"].items():
            print(f"{klass:12s} latency {c['cycles']:.2f} cycles an instruction (family "
                  f"{c['family']}; SASS a round {c['opcodes']})", flush=True)
        for key, r in out["pipes"]["variants"].items():
            terms = ", ".join(f"{k} {v:.4f}" for k, v in r["terms"].items())
            print(f"{key:12s} SASS a iteration {r['sass']['pipes']}; dependent chain "
                  f"{r['chain_cycles_per_iter']:.1f} cycles/iter (one warp read "
                  f"{r['one_warp_cycles_per_iter']:.1f}); full card "
                  f"{r['throughput_ns_per_elem_iter']:.6f} ns/elem-iter; bound "
                  f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({terms}); FLOP bound "
                  f"{r['flop_bound_ms']:.4f} ms", flush=True)
    out.update(iters=args.iters, reps=args.reps, elements=op_probe.SHAPE[0] * op_probe.SHAPE[1],
               device=(torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
