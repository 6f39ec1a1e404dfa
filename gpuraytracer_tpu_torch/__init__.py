"""gpuraytracer_tpu_torch — the PyTorch and CUDA port of gpuraytracer_tpu.

The JAX package ``gpuraytracer_tpu`` is the reference; this package mirrors
its subpackage and module names so each module's counterpart is easy to
find, and never imports JAX.

Layout
------
core/       ABI dataclasses of tensors, HLSL-semantics math, camera, config,
            host-to-device uploads that never wait for the stream
geometry/   analytic primitives, the SDF library + sphere tracer, metaballs
accel/      scene arrays, ray space transforms, closest/any-hit traversal
render/     wavefront integrator (the frame kernel's plain version),
            Phong/Fresnel/fog shading, checkerboard, Renderer
kernels/    hand-written CUDA kernels for Hopper (sm_90a), built with nvcc
            on first use and loaded through ctypes
models/     the builtin scene and its animation
parallel/   device selection, frames in flight (CUDA events), recovery
runtime/    the native host runtime (clock, PNG encoder, async writer; g++)
utils/      timers, stats, PNG, checkpoints, introspection, debug, profiling
apps/       the CLI renderer, the preview server, the bench suite, the op probe

Every function takes tensors on an explicit device; nothing here keeps a
hidden global device. CPU tensors run the plain PyTorch path, CUDA tensors
the CUDA kernels.
"""

from gpuraytracer_tpu_torch.version import __version__

__all__ = ["__version__"]
