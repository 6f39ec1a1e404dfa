"""The control of the output check: the plain reference put in the
program's place and computed a precision lower than the configuration
states (bfloat16 for float32). ``LowerPrecision`` rounds the result of
every float32 operation to bfloat16 and back, as PyTorch's own bfloat16
element-wise kernels do (compute in float32, round each result), so the
reference's code runs unchanged."""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

LOWER = {"float32": torch.bfloat16}


class LowerPrecision(TorchDispatchMode):
    """Every float32 tensor an operation returns, rounded to ``dtype``."""

    def __init__(self, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if getattr(func, "is_view", False):
            return out  # a view shares its base's (already rounded) values

        def rnd(x):
            # A fresh result or the tensor an in-place operation wrote:
            # rounded where it lies.
            if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
                x.copy_(x.to(self.dtype))
            return x

        return tree_map(rnd, out)


def stand_in(run):
    """The control in the program's place (``core.execute``'s
    ``stand_in``): ``render(desc, when)``, the reference's (H, W, 4) f32
    frame at ``when`` (an animation time, or a viewer's ticked state)
    computed under LowerPrecision at the precision below the
    configuration's."""
    from rtbench.reference import trace as ref_trace

    cfg = run.cell.config
    dtype = LOWER[cfg["precision"]]

    def render(desc, when):
        with LowerPrecision(dtype):
            if isinstance(when, float):
                scene = desc.scene(run.width / run.height, when, device=run.device)
            else:
                scene = desc.scene(run.width / run.height, when.geometry_time,
                                   camera=when.camera, light_position=when.light,
                                   device=run.device)
            return ref_trace.render(scene, cfg["route"], run.width, run.height,
                                    max_depth=int(cfg["max_depth"]))

    return render
