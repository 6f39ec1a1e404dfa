"""The benchmark's plain reference renderer: plain PyTorch, frozen here.

A copy of the port's plain wavefront path (its geometry, animation,
traversal and shading), which imports nothing of the port and builds its
scenes from a configuration's description (``scene.SceneDescription``).
Importing the package registers the extension fractals (codes 7 and 8) in
the SDF table before the registry reads it.
"""

from rtbench.reference import fractal  # noqa: F401
