"""The op-cost probe (kernel-table row 8: tools/profile_vpu.py make_kernel)
against the reference.

The port's plain version (kernels/op_probe.op_probe_plain) runs the same
loop as the reference's Pallas kernel body, which runs here through
``pl.pallas_call(..., interpret=True)`` on the CPU, on the reference's
(256, 256) array of 1.2345, for every op mix and type at iters = 4.

Tolerance: f32 within 1e-6 relative (the two programs may round a sqrt,
rsqrt or cos differently in the last ulp; the fma chain overflows to inf on
both sides at the second iteration and must match there exactly); bf16
within 2**-7 relative, one bf16 ulp (XLA may keep an intermediate of a mix
in f32 where PyTorch rounds each op to bf16). On a GPU (the ``cuda``
marker) the kernel is held to the plain version the same way, at iters = 1
and 4 (past a few iterations the f32 build's contracted multiply-adds
drift from the plain version's separate roundings by more ulps), and the
bf16 variants, two elements a thread as one packed pair, equal the scalar
build (-DGPRT_PROBE_BF16_SCALAR, one element a thread) and the plain
version element for element (each op rounded once on all three), on the
reference's array, on a seeded one, on an odd count (the last thread
carries one element) and on a view 2 bytes off a 4-byte boundary; the
latency chains read every class on its pipe. On the CPU the dependent-chain
analysis that prices the probe's SASS (apps/op_probe.chain_cycles) runs on
a loop as cuobjdump prints it.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from gpuraytracer_tpu_torch.apps import op_probe as probe_app
from gpuraytracer_tpu_torch.kernels import build, op_probe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 4
RTOL = {"f32": 1e-6, "bf16": 2.0 ** -7}
CASES = [(op, name) for name in ("f32", "bf16") for op in op_probe.OPS]


def reference_probe(op, name, iters):
    """The reference's make_kernel through pl.pallas_call in interpret mode."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    spec = importlib.util.spec_from_file_location(
        "profile_vpu", os.path.join(ROOT, "tools", "profile_vpu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    dtype = {"f32": jnp.float32, "bf16": jnp.bfloat16}[name]
    x = jnp.full((mod.ROWS, 256), op_probe.FILL, dtype)
    out = pl.pallas_call(mod.make_kernel(op, iters, dtype),
                         out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype), interpret=True)(x)
    return np.asarray(out.astype(jnp.float32))


def assert_close(got, want, name):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    inf = np.isinf(want)
    np.testing.assert_array_equal(got[inf], want[inf])
    np.testing.assert_allclose(got[~inf], want[~inf], rtol=RTOL[name], atol=0.0)


@pytest.mark.parametrize("op, name", CASES)
def test_plain_probe_matches_reference(op, name):
    x = torch.full(op_probe.SHAPE, op_probe.FILL, dtype=op_probe.DTYPES[name])
    got = op_probe.op_probe_plain(x, op, ITERS)
    assert got.dtype == x.dtype and not torch.isnan(got.float()).any()
    assert_close(got.float().numpy(), reference_probe(op, name, ITERS), name)


def test_wrapper_runs_plain_version_on_cpu_and_cli():
    x = torch.full((8, 8), op_probe.FILL)
    launches = op_probe.LAUNCHES
    assert torch.equal(op_probe.op_probe(x, "cos", 3), op_probe.op_probe_plain(x, "cos", 3))
    assert op_probe.LAUNCHES == launches
    with pytest.raises(ValueError, match="unknown op"):
        op_probe.op_probe(x, "tan", 1)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        op_probe.op_probe(x.double(), "fma", 1)
    out = probe_app.run(2, 1, torch.device("cpu"))
    assert set(out["variants"]) == {f"{op}_{n}" for op, n in CASES}
    assert set(out["bf16_over_f32"]) == set(op_probe.OPS)


# A loop as cuobjdump prints it: a loop-carried chain through R0 (FFMA,
# FFMA, FMUL, FFMA), a counter through R2 and P0, and a store after it.
LOOP_SASS = """
        /*0070*/                   MOV R2, RZ ;
        /*0080*/                   FFMA R0, R0, R0, 0.5 ;
        /*0090*/                   IADD3 R2, R2, 0x1, RZ ;
        /*00a0*/                   FFMA R3, R0, R0, 1 ;
        /*00b0*/                   FMUL R4, R3, 0.5 ;
        /*00c0*/                   FFMA R0, R0, 0.5, R4 ;
        /*00d0*/                   ISETP.NE.AND P0, PT, R2, c[0x0][0x170], PT ;
        /*00e0*/               @P0 BRA 0x80 ;
        /*00f0*/                   STG.E desc[UR4][R6.64], R0 ;
"""


def test_chain_cycles_prices_the_loop_carried_chain():
    path = [(g, o, a) for _, g, o, a in probe_app.iteration_path(LOOP_SASS.splitlines())]
    assert [o for _, o, _ in path] == ["FFMA", "IADD3", "FFMA", "FMUL", "FFMA", "ISETP.NE.AND",
                                       "BRA"]
    assert probe_app.operands("", "ISETP.NE.AND", "P0, PT, R2, c[0x0][0x170], PT") == (
        ["P0"], ["R2"])
    assert probe_app.operands("@!P1", "STG.E", "desc[UR4][R6.64], R0") == (
        [], ["UR4", "R6", "R7", "R0", "P1"])
    # R0's chain: four instructions at 4 cycles; the counter's (IADD3 at
    # the floor, 2 cycles) is shorter, until it is priced longer.
    assert probe_app.chain_cycles(path, {"FFMA": 4.0, "FMUL": 4.0}, 2.0) == 16.0
    assert probe_app.chain_cycles(path, {"IADD3": 6.0}, 1.0) == 6.0
    assert [probe_app.family(op) for op in ("HFMA2.MMA.BF16_V2", "HFMA2.BF16_V2", "MUFU.RSQ")] \
        == ["HFMA2.MMA", "HFMA2", "MUFU"]
    with pytest.raises(ValueError, match="SM clock of a GPU"):
        op_probe.latency_cycles("ffma", 1, "cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the op probe has no CPU build)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [1, ITERS])
def test_probe_kernel_matches_plain_on_cuda(cuda_device, iters):
    for op, name in CASES:
        x = torch.full(op_probe.SHAPE, op_probe.FILL, dtype=op_probe.DTYPES[name],
                       device=cuda_device)
        launches = op_probe.LAUNCHES
        got = op_probe.op_probe(x, op, iters)
        torch.cuda.synchronize()
        assert op_probe.LAUNCHES == launches + 1
        assert_close(got.float().cpu().numpy(),
                     op_probe.op_probe_plain(x, op, iters).float().cpu().numpy(), name)


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [1, ITERS])
def test_packed_bf16_equals_the_scalar_build_and_plain_on_cuda(cuda_device, iters):
    scalar = build.load("op_probe", defines=op_probe.SCALAR_DEFINES)
    seeded = np.random.default_rng(8).uniform(0.25, 1.75, size=op_probe.SHAPE)
    base = torch.from_numpy(seeded.astype(np.float32)).to(cuda_device, torch.bfloat16)
    inputs = (torch.full(op_probe.SHAPE, op_probe.FILL, dtype=torch.bfloat16, device=cuda_device),
              base, base.reshape(-1)[:257], base.reshape(-1)[1:1025])
    for op in op_probe.OPS:
        for x in inputs:
            got = op_probe.op_probe(x, op, iters)
            torch.cuda.synchronize()
            assert torch.equal(got, op_probe.op_probe(x, op, iters, lib=scalar))
            assert torch.equal(got, op_probe.op_probe_plain(x, op, iters))


@pytest.mark.cuda
def test_latency_chains_read_every_class_on_cuda(cuda_device):
    lib = build.load("op_probe")
    sass = probe_app.sass_loop_counts(lib._name)
    launches = op_probe.LATENCY_LAUNCHES
    lat = probe_app.instruction_latencies(cuda_device, lib, sass, iters=50)
    assert op_probe.LATENCY_LAUNCHES == launches + 3 * len(op_probe.LATENCY_CLASSES)
    assert set(lat["classes"]) == set(op_probe.LATENCY_CLASSES)
    assert all(1.0 <= c["cycles"] < 100.0 for c in lat["classes"].values())
    assert {"FFMA", "FADD", "IMAD", "FMNMX", "HMNMX2", "MUFU"} <= set(lat["families"])
    assert lat["floor"] == min(lat["families"].values()) >= 1.0
