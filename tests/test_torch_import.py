"""The PyTorch port never imports JAX: a fresh interpreter imports every
module of the package (among them every module of the bench-scene slice
and of the host slice: the runtime, timers, devices, frames in flight,
recovery, checkpoints, the preview server; the row-band sharding, the
entry points and the version), renders a small frame on the
CPU through the CLI, runs the bench suite on
one scene at a tiny size, and checks that neither ``jax`` nor the JAX
package entered sys.modules."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SRC = r"""
import pkgutil, sys
import torch
import gpuraytracer_tpu_torch as pkg
names = set()
for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    __import__(mod.name)
    names.add(mod.name[len(pkg.__name__) + 1:])
slice_modules = {"geometry.fractal", "geometry.registry", "accel.bvh", "models.builder",
                 "models.scenes", "kernels.scene_kernel", "utils.stats", "apps.bench_suite",
                 "kernels.op_probe", "apps.op_probe", "runtime.hostrt", "utils.timers",
                 "parallel.device", "parallel.pipeline", "parallel.recovery", "utils.checkpoint",
                 "utils.introspect", "utils.debug", "utils.profile", "apps.serve", "core.upload",
                 "parallel.sharding", "entry", "version"}
assert slice_modules <= names, sorted(slice_modules - names)
from gpuraytracer_tpu_torch.apps import bench_suite, render_cli
assert bench_suite.main(["--device", "cpu", "--configs", "single_sphere_plane_256",
                         "--scale", "0.05", "--frames", "1", "--reps", "1",
                         "--wall-chain", "1"]) == 0
out = sys.argv[1]
assert render_cli.main(["--device", "cpu", "--width", "8", "--height", "8",
                        "--time", "0.7", "--out", out]) == 0
with open(out + "/frame_00000.png", "rb") as f:
    assert f.read(8) == b"\x89PNG\r\n\x1a\n"
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "gpuraytracer_tpu.")))
assert not leaked, leaked
print("ok")
"""


def test_port_imports_and_renders_without_jax(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _SRC, str(tmp_path)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
