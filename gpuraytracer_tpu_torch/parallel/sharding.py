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
all_reduce and ``gather_image`` an all_gather there. Both replay frame
programs (render/program.py), as the reference jits its band renderer:
one captured graph per device, over every band the device renders
(``_BandPrograms``); ``render_bands`` is the bands' eager form.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple, Sequence

import numpy as np
import torch

from gpuraytracer_tpu_torch.accel.instances import Scene, SceneArrays, SceneLayout
from gpuraytracer_tpu_torch.core import upload
from gpuraytracer_tpu_torch.core.types import MAX_RAY_RECURSION_DEPTH
from gpuraytracer_tpu_torch.kernels import frame_kernel
from gpuraytracer_tpu_torch.parallel.device import pick_device
from gpuraytracer_tpu_torch.render import program, trace


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


def render_bands(scene: Scene, width: int, height: int, n_bands: int, bands, *,
                 max_depth: int = MAX_RAY_RECURSION_DEPTH, pack=None) -> list:
    """The images of bands ``bands`` (indices of ``n_bands``, each of
    H / n_bands rows) of ``scene``'s W x H frame, on the scene's device, in
    the order given: each band through render/trace.render_frame, which
    routes it as the whole frame is routed (trace.frame_route), with one
    exception copied from the reference (sharding.py:89-93, :122-124;
    ROADMAP.md Q3 decision 7): on the frame route every compacted mode
    (frame_kernel.compact_enabled) renders through
    frame_kernel.render_frame_compact, so GPURT_FRAME_MODE=defer takes the
    compacted mode, as the reference's band renderer sends it. ``pack``:
    the frame's packed buffers, shared by the bands (a band program's, which
    it repacks in its graph); each band packs the scene itself if None (the
    eager form)."""
    if height % n_bands != 0:
        raise ValueError(f"height {height} not divisible by mesh size {n_bands}")
    lh = height // n_bands
    compact = trace.frame_route(scene)[0] == "frame" and frame_kernel.compact_enabled()
    if compact and scene.arrays.aabb_min.device.type == "cuda":
        frame_kernel.check_kernel_covers(scene.layout, "frame")
    images = []
    for k in bands:
        kw = dict(max_depth=max_depth, row_offset=k * lh, local_height=lh)
        if compact:
            images.append(frame_kernel.render_frame_compact(
                pack if pack is not None else frame_kernel.pack_frame(scene), width=width,
                height=height, **kw))
        else:
            images.append(trace.render_frame(scene, width, height, pack=pack, **kw))
    return images


class _BandPrograms:
    """The band programs of one renderer: for each device, one frame
    program (render/program.FrameProgram) that renders every band the
    renderer places there, in band order, and with ``compute_stats`` each
    band's f32 RGB sum (``_band_sum``) as one more output. Its static inputs
    are a copy of the arrays (program.static_copy); its graph repacks them
    into the pack that frame_kernel.pack_static built once
    (frame_kernel.repack, as trace.make_renderer's graph does) and renders
    the bands over that one pack (``render_bands``). Programs are keyed as
    trace.make_renderer keys its own: program.key of the device, the
    arrays' shapes, the size, the depth, ``compute_stats`` and the
    device's band indices, so a changed GPURT_* knob builds a new one. A
    graph belongs to one device, so a device that repeats in the mesh gets
    one program for all its bands, the nearest a CUDA graph comes to the
    reference's one jitted program over the mesh.

    On a CUDA device a failed capture or replay raises, naming the program;
    nothing renders the bands eagerly instead. On the CPU, which has no
    graphs, each call runs the same frame function eagerly."""

    def __init__(self, layout: SceneLayout, width: int, height: int, n_bands: int, *,
                 max_depth: int, compute_stats: bool):
        if height % n_bands != 0:
            raise ValueError(f"height {height} not divisible by mesh size {n_bands}")
        self.layout, self.width, self.height, self.n_bands = layout, width, height, n_bands
        self.local_height = height // n_bands
        self.max_depth, self.compute_stats = max_depth, compute_stats
        self.programs = {}

    def _build(self, arrays: SceneArrays, dev, bands: tuple):
        static = program.static_copy(arrays)
        scene = Scene(self.layout, static)
        pack = frame_kernel.pack_static(scene)

        def frame():
            frame_kernel.repack(pack, scene)
            images = render_bands(scene, self.width, self.height, self.n_bands, bands,
                                  max_depth=self.max_depth, pack=pack)
            sums = [_band_sum(image) for image in images] if self.compute_stats else []
            return tuple(images + sums)

        route, mode = trace.frame_route(scene)
        return static, program.FrameProgram(
            frame, dev, label=f"band program {self.width}x{self.height} depth {self.max_depth}, "
                              f"bands {list(bands)} of {self.n_bands} on {dev} (route {route}, "
                              f"mode {mode})")

    def __call__(self, arrays: SceneArrays, placements):
        """(images, sums) of the bands at ``placements``, (device, band
        index) pairs in band order: the images by band, and with
        ``compute_stats`` each band's RGB sum on its device (else None). The
        arrays go to each device once (core/upload.arrays_to: itself where
        it is there, no host sync) and into its program's static inputs
        (program.copy_arrays, stream-ordered)."""
        by_device = {}
        for dev, k in placements:
            by_device.setdefault(dev, []).append(k)
        images, sums = {}, {}
        for dev, bands in by_device.items():
            bands = tuple(bands)
            src = upload.arrays_to(arrays, dev)
            shapes = tuple(tuple(t.shape) for t in program.tensor_leaves(src))
            key = program.key(Scene(self.layout, src), str(dev), shapes, self.width, self.height,
                              self.max_depth, self.compute_stats, bands)
            if key not in self.programs:
                self.programs[key] = self._build(src, dev, bands)
            static, prog = self.programs[key]
            program.copy_arrays(static, src)
            out = prog()
            for i, k in enumerate(bands):
                images[k] = out[i]
                sums[k] = out[len(bands) + i] if self.compute_stats else None
        order = [k for _, k in placements]
        return [images[k] for k in order], [sums[k] for k in order]

    def close(self) -> None:
        """Drop every program's graph and outputs."""
        _close(self.programs)


def _close(programs: dict) -> None:
    for _, prog in programs.values():
        prog.close()
    programs.clear()


def _renderer(render, bands: _BandPrograms):
    """``render`` with the renderer's ``programs`` and ``close`` attached;
    the programs close when ``render`` is collected."""
    render.programs = bands.programs
    render.close = bands.close
    # Not at interpreter exit: the process's teardown frees the graphs.
    weakref.finalize(render, _close, bands.programs).atexit = False
    return render


def make_sharded_renderer(layout: SceneLayout, width: int, height: int, mesh: Sequence, *,
                          max_depth: int = MAX_RAY_RECURSION_DEPTH, compute_stats: bool = False):
    """The frame function of a mesh (``make_mesh``): ``render(arrays)``
    renders band i of n = len(mesh), the rows [i * H / n, (i + 1) * H / n),
    on ``mesh[i]`` and returns the ``Bands`` (images and offsets; asynchronous
    on a GPU); with ``compute_stats`` also the mean radiance, the f32 sum of
    each band's RGB added on ``mesh[0]`` in band order, over W * H * 3 (the
    reference's psum), a 0-d tensor on ``mesh[0]``. ``height`` must divide
    by the mesh size (ValueError).

    The reference jits this function (sharding.py:144-148). Here each call
    replays one band program per device of the mesh (``_BandPrograms``),
    built at the first call for its key; the copies of the arrays in, the
    cross-device add of the band sums and the ``Bands`` stay outside the
    graphs. ``render.programs`` holds them, ``render.close()`` drops them
    (and so does collecting ``render``)."""
    mesh = tuple(torch.device(d) for d in mesh)
    bands = _BandPrograms(layout, width, height, len(mesh), max_depth=max_depth,
                          compute_stats=compute_stats)
    offsets = tuple(k * bands.local_height for k in range(len(mesh)))

    def render(arrays: SceneArrays):
        images, sums = bands(arrays, [(dev, k) for k, dev in enumerate(mesh)])
        out = Bands(tuple(images), offsets, width, height)
        if not compute_stats:
            return out
        total = None
        for part in sums:
            part = upload.tensor_to(part, mesh[0])
            total = part if total is None else total + part
        return out, total / (width * height * 3)

    return _renderer(render, bands)


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
    of n, on ``device``, routed as ``make_sharded_renderer`` routes it and
    replayed from one band program (``_BandPrograms``), and returns ``Bands`` holding that band (``gather_image`` of it assembles
    the frame on every rank with an all_gather); with ``compute_stats`` also
    the mean radiance, an all_reduce(SUM) of the ranks' f32 RGB sums over
    W * H * 3. Under gloo the collectives' tensors are staged through the
    host: the band's RGB sum (one f32; the mean comes back as a 0-d CPU
    tensor) and, in ``gather_image``, the band image and the other ranks'
    bands; under another backend they stay on the device. ``height`` must
    divide by the group's size (ValueError). The collectives run outside
    the program's graph, where the reference's psum is inside its jit
    (ROADMAP.md Q3 decision 13)."""
    import torch.distributed as dist

    group = group if group is not None else dist.group.WORLD
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    device = pick_device(str(torch.device(device))).device
    bands = _BandPrograms(layout, width, height, n, max_depth=max_depth,
                          compute_stats=compute_stats)

    def render(arrays: SceneArrays):
        (image,), (part,) = bands(arrays, [(device, rank)])
        out = Bands((image,), (rank * bands.local_height,), width, height, group)
        if not compute_stats:
            return out
        total = _staged(part, group)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return out, total / (width * height * 3)

    return _renderer(render, bands)


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
