"""Multi-device rendering: row-band sharding of one frame.

Port of gpuraytracer_tpu/parallel/sharding.py. The reference shards the
pixel rows of a frame across a 1-D mesh under shard_map: each chip renders
a horizontal band, and the only cross-chip traffic is the optional
mean-radiance psum and the output gather. Here a mesh is a tuple of torch
devices (``make_mesh``), and band i of n renders on ``mesh[i]`` at row
offset i * H / n through the same kernels as a whole frame, which take the
band's row offset and height as launch arguments
(kernels/frame_kernel.py, csrc/frame_kernel.cu). Rendering is one thread
per pixel with nothing summed across pixels, so a band is the whole
frame's pixels at its rows bit for bit, on every route and in every mode.

``make_sharded_renderer`` renders every band from one process (a device
may repeat in the mesh: its bands render one after another and share one
upload of the scene's arrays). ``make_distributed_renderer`` renders
one band per rank of a torch.distributed group; the mean radiance is an
all_reduce and ``gather_image`` an all_gather there.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from gpuraytracer_tpu_torch.accel.instances import Scene, SceneArrays, SceneLayout
from gpuraytracer_tpu_torch.core import upload
from gpuraytracer_tpu_torch.core.types import MAX_RAY_RECURSION_DEPTH
from gpuraytracer_tpu_torch.kernels import frame_kernel
from gpuraytracer_tpu_torch.parallel.device import pick_device
from gpuraytracer_tpu_torch.render import trace


def make_mesh(devices: Sequence | None = None) -> tuple:
    """A 1-D render mesh: a tuple of torch devices, band i on the i-th. By
    default every visible CUDA device; without one it raises RuntimeError
    (nothing falls back to the CPU). The CPU renders only where the caller
    lists it (``["cpu"] * 4``). A device may repeat: ``["cuda:0"] * 4``
    renders four bands one after another on one card. Each name is checked
    as parallel/device.pick_device checks it."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("make_mesh: no CUDA device is visible; list the devices to "
                               "render on (for example ['cpu'] * 4)")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = tuple(pick_device(str(torch.device(d))).device for d in devices)
    if not mesh:
        raise ValueError("make_mesh: no devices")
    return mesh


class Bands(NamedTuple):
    """A row-sharded frame: ``images`` holds band k's (H / n, W, 4) f32
    image on its device, ``offsets`` its first row in the W x H frame.
    ``group``: the torch.distributed group whose ranks hold the other bands
    (``make_distributed_renderer``; this process holds only its own), or
    None where ``images`` holds every band."""

    images: tuple
    offsets: tuple
    width: int
    height: int
    group: object = None


def _band_sum(image):
    """The f32 sum of a band's RGB (the reference's local_sum)."""
    return torch.sum(image[..., :3], dtype=torch.float32)


class _BandRenderer:
    """Renders bands of one layout's frames through render/trace.render_frame,
    which routes each band as the whole frame is routed (trace.frame_route),
    with one exception copied from the reference (sharding.py:89-93,
    :122-124; ROADMAP.md Q3 decision 7): on the frame route,
    GPURT_FRAME_MODE=defer renders through the compacted mode, as the
    reference's compact_enabled() sends "defer" to compact. The mode is
    read per frame."""

    def __init__(self, layout: SceneLayout, width: int, height: int, n_bands: int, *,
                 max_depth: int):
        if height % n_bands != 0:
            raise ValueError(f"height {height} not divisible by mesh size {n_bands}")
        self.layout, self.width, self.height = layout, width, height
        self.local_height = height // n_bands
        self.max_depth = max_depth

    def __call__(self, arrays: SceneArrays, placements):
        """Band images at ``placements``, (device, band index) pairs; the
        arrays go to each device once (core/upload.arrays_to, no host sync)."""
        scenes, images = {}, []
        for dev, k in placements:
            if dev not in scenes:
                scenes[dev] = Scene(self.layout, upload.arrays_to(arrays, dev))
            scene = scenes[dev]
            kw = dict(max_depth=self.max_depth, row_offset=k * self.local_height,
                      local_height=self.local_height)
            if trace.frame_route(scene) == ("frame", "defer"):
                if dev.type == "cuda":
                    frame_kernel.check_kernel_covers(self.layout, "frame")
                images.append(frame_kernel.render_frame_compact(
                    frame_kernel.pack_frame(scene), width=self.width, height=self.height, **kw))
            else:
                images.append(trace.render_frame(scene, self.width, self.height, **kw))
        return images


def make_sharded_renderer(layout: SceneLayout, width: int, height: int, mesh: Sequence, *,
                          max_depth: int = MAX_RAY_RECURSION_DEPTH, compute_stats: bool = False):
    """The frame function of a mesh (``make_mesh``): ``render(arrays)``
    renders band i of n = len(mesh), the rows [i * H / n, (i + 1) * H / n),
    on ``mesh[i]`` and returns the ``Bands`` (images and offsets; asynchronous
    on a GPU); with ``compute_stats`` also the mean radiance, the f32 sum of
    each band's RGB added on ``mesh[0]`` in band order, over W * H * 3 (the
    reference's psum), a 0-d tensor on ``mesh[0]``. ``height`` must divide
    by the mesh size (ValueError)."""
    mesh = tuple(torch.device(d) for d in mesh)
    bands = _BandRenderer(layout, width, height, len(mesh), max_depth=max_depth)
    offsets = tuple(k * bands.local_height for k in range(len(mesh)))

    def render(arrays: SceneArrays):
        images = tuple(bands(arrays, [(dev, k) for k, dev in enumerate(mesh)]))
        out = Bands(images, offsets, width, height)
        if not compute_stats:
            return out
        total = None
        for image in images:
            part = upload.tensor_to(_band_sum(image), mesh[0])
            total = part if total is None else total + part
        return out, total / (width * height * 3)

    return render


def _staged(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` where the group's backend takes it: on the host under gloo
    (its collectives take CPU tensors here), else where it is."""
    import torch.distributed as dist

    return t.cpu() if dist.get_backend(group) == "gloo" else t


def make_distributed_renderer(layout: SceneLayout, width: int, height: int, *, group=None,
                              device, max_depth: int = MAX_RAY_RECURSION_DEPTH,
                              compute_stats: bool = False):
    """The frame function of one rank of a torch.distributed ``group``
    (default the world; initialised by the caller): ``render(arrays)``
    renders the rank's band, rows [r * H / n, (r + 1) * H / n) for rank r
    of n, on ``device``, routed as ``make_sharded_renderer`` routes it, and
    returns ``Bands`` holding that band (``gather_image`` of it assembles
    the frame on every rank with an all_gather); with ``compute_stats`` also
    the mean radiance, an all_reduce(SUM) of the ranks' f32 RGB sums over
    W * H * 3. Under gloo the collectives' tensors are staged through the
    host: the band's RGB sum (one f32; the mean comes back as a 0-d CPU
    tensor) and, in ``gather_image``, the band image and the other ranks'
    bands; under another backend they stay on the device. ``height`` must
    divide by the group's size (ValueError)."""
    import torch.distributed as dist

    group = group if group is not None else dist.group.WORLD
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    device = pick_device(str(torch.device(device))).device
    bands = _BandRenderer(layout, width, height, n, max_depth=max_depth)

    def render(arrays: SceneArrays):
        (image,) = bands(arrays, [(device, rank)])
        out = Bands((image,), (rank * bands.local_height,), width, height, group)
        if not compute_stats:
            return out
        total = _staged(_band_sum(image), group)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return out, total / (width * height * 3)

    return render


def gather_image(bands: Bands) -> np.ndarray:
    """The (H, W, 4) f32 frame on the host from its ``Bands``: the bands in
    row order; from a distributed renderer, every rank's band by an
    all_gather over its group (a collective: every rank calls it)."""
    images = bands.images
    if bands.group is not None:
        import torch.distributed as dist

        (mine,) = images
        mine = _staged(mine.contiguous(), bands.group)
        images = [torch.empty_like(mine) for _ in range(dist.get_world_size(bands.group))]
        dist.all_gather(images, mine, group=bands.group)
    image = np.concatenate([im.cpu().numpy() for im in images])
    if image.shape != (bands.height, bands.width, 4):
        raise ValueError(f"bands assemble to {image.shape}, not ({bands.height}, "
                         f"{bands.width}, 4)")
    return image
