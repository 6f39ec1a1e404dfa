"""The reference renderer's built-in scene as the port's ``models/builtin``
builds and animates it (the main path's own scene and animator)."""

from __future__ import annotations


def build(cfg: dict, device):
    from gpuraytracer_tpu_torch.models import builtin

    scene = builtin.build_scene(aspect=cfg["width"] / cfg["height"], elapsed_time=0.0,
                                device=device)
    return scene, builtin.animate_arrays
