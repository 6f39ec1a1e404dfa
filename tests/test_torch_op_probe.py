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
drift from the plain version's separate roundings by more ulps).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from gpuraytracer_tpu_torch.apps import op_probe as probe_app
from gpuraytracer_tpu_torch.kernels import op_probe

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
