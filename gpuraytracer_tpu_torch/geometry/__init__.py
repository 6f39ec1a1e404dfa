"""Intersectors. Importing the package registers the extension fractals
(geometry/fractal.py) in the SDF table, as the JAX package's does."""

from gpuraytracer_tpu_torch.geometry import fractal  # noqa: F401
