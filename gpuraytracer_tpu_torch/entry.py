"""Entry points of the port: the flagship frame and the multi-device
dry run.

Port of the reference's __graft_entry__.py. ``entry`` returns the
flagship forward step, a depth-3 frame of the builtin scene, with its
arguments. ``dryrun_multichip`` starts a torch.distributed world of
``n_devices`` processes over gloo, renders one band of a builtin frame on
each rank (parallel/sharding.make_distributed_renderer) and checks the
gathered frame. The reference re-executes itself on a virtual CPU mesh
where it sees too few chips; here each rank is a process of its own, on
the CPU or all on one card, so the dry run needs no more devices than one.

    python -c "from gpuraytracer_tpu_torch import entry; entry.dryrun_multichip(2, device='cpu')"
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

from gpuraytracer_tpu_torch.accel.instances import Scene

ENTRY_W, ENTRY_H = 256, 144
DRYRUN_W, DRYRUN_T = 64, 0.25
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def entry(device="cuda"):
    """(render_fn, example_args): the flagship forward step, a full depth-3
    frame of the builtin scene at 256x144 (``render_fn(arrays)``, the
    (144, 256, 4) f32 image through render/trace.render_frame), with the
    scene's arrays at t = 0 on ``device`` (the card unless the caller asks
    for the CPU)."""
    from gpuraytracer_tpu_torch.models import builtin
    from gpuraytracer_tpu_torch.render import trace

    scene = builtin.build_scene(aspect=ENTRY_W / ENTRY_H, elapsed_time=0.0, device=device)
    layout = scene.layout

    def render_frame(arrays):
        return trace.render_frame(Scene(layout, arrays), ENTRY_W, ENTRY_H)

    return render_frame, (scene.arrays,)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device: str = "cuda", *, size=None,
                     timeout: float = 900.0) -> None:
    """Start ``n_devices`` processes in one gloo world (rendezvous on a free
    localhost port) and run ``_rank_main`` on each: every rank renders its
    band on ``device`` ("cpu", or "cuda": every rank on card 0, the way the
    dry run fits a one-card machine). Raises RuntimeError, with the failing
    rank's stderr, if a rank fails or the world outlives ``timeout``
    seconds; every process it starts has ended when it returns.

    ``size``: (W, H) of one more frame, rendered in bands on the default
    route and held bit for bit to the one-process render (``H`` must divide
    by ``n_devices``)."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be at least 1, got {n_devices}")
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    # The ranks meet on the loopback interface, whatever the host's name
    # resolves to.
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    w, h = size if size is not None else (0, 0)
    procs = []
    try:
        for rank in range(n_devices):
            code = (f"from gpuraytracer_tpu_torch import entry; "
                    f"entry._rank_main({rank}, {n_devices}, {port}, {device!r}, {w}, {h})")
            err = tempfile.TemporaryFile()
            procs.append((subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                                           stdout=subprocess.DEVNULL, stderr=err), err))
        # Poll every rank: the first that fails ends the world (its peers
        # may wait on it in a collective).
        deadline = time.monotonic() + timeout
        while True:
            for rank, (proc, err) in enumerate(procs):
                if proc.poll() not in (None, 0):
                    err.seek(0)
                    tail = err.read().decode(errors="replace")[-4000:]
                    raise RuntimeError(f"dryrun_multichip: rank {rank} failed with "
                                       f"rc={proc.returncode}:\n{tail}")
            if all(proc.returncode == 0 for proc, _ in procs):
                return
            if time.monotonic() > deadline:
                raise RuntimeError(f"dryrun_multichip: ranks still running after {timeout} s")
            time.sleep(0.05)
    finally:
        for proc, err in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            err.close()


def _check(ok: bool, what: str) -> None:
    """Raise unless ``ok``: the dry run's checks hold under python -O too."""
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _rank_main(rank: int, n: int, port: int, device: str, width: int = 0,
               height: int = 0) -> None:
    """One rank of ``dryrun_multichip``: a builtin 64 x 4n frame at t = 0.25
    with the mean radiance (shape, every value finite, mean > 0); then
    64 x 8n under GPURT_FRAME_MODE=compact (the builtin scene takes the
    frame route, so the compacted mode: its CUDA entries on the card, their
    plain versions on the CPU, as the reference runs its Pallas kernels in
    interpret mode), which rank 0 holds bit for bit to the one-process
    render; then
    the ``width`` x ``height`` frame on the default route, held the same
    way (where given)."""
    import torch.distributed as dist

    from gpuraytracer_tpu_torch.models import builtin
    from gpuraytracer_tpu_torch.parallel import sharding

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=n,
                            rank=rank)
    try:
        w, h = DRYRUN_W, 4 * n
        scene = builtin.build_scene(aspect=w / h, elapsed_time=DRYRUN_T, device=device)
        render = sharding.make_distributed_renderer(scene.layout, w, h, device=device,
                                                    compute_stats=True)
        bands, mean = render(scene.arrays)
        img = sharding.gather_image(bands)
        _check(img.shape == (h, w, 4), f"the gathered frame's shape is {img.shape}")
        _check(bool(np.isfinite(img).all()), "the gathered frame is not finite")
        _check(float(mean) > 0.0, f"mean radiance {float(mean)}")

        old = os.environ.get("GPURT_FRAME_MODE")
        os.environ["GPURT_FRAME_MODE"] = "compact"
        try:
            _check_bands(rank, device, DRYRUN_W, 8 * n)
        finally:
            if old is None:
                del os.environ["GPURT_FRAME_MODE"]
            else:
                os.environ["GPURT_FRAME_MODE"] = old
        if width:
            _check_bands(rank, device, width, height)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _check_bands(rank: int, device: str, width: int, height: int) -> None:
    """The builtin frame at t = 0.25 in bands over the world, gathered;
    rank 0 holds it bit for bit to render/trace.render_frame of the whole
    frame in this process."""
    from gpuraytracer_tpu_torch.models import builtin
    from gpuraytracer_tpu_torch.parallel import sharding
    from gpuraytracer_tpu_torch.render import trace

    scene = builtin.build_scene(aspect=width / height, elapsed_time=DRYRUN_T, device=device)
    render = sharding.make_distributed_renderer(scene.layout, width, height, device=device)
    img = sharding.gather_image(render(scene.arrays))
    _check(img.shape == (height, width, 4), f"the gathered frame's shape is {img.shape}")
    _check(bool(np.isfinite(img).all()), "the gathered frame is not finite")
    if rank == 0:
        whole = trace.render_frame(scene, width, height).cpu().numpy()
        differ = int((img != whole).any(axis=-1).sum())
        _check(differ == 0, f"{differ} pixels of the {width}x{height} bands differ from the "
                            f"one-process frame")
