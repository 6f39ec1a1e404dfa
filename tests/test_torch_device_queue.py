"""The compacted frame modes' device queues (kernel-table rows 2-4): the
queue builder, the resumed dense pass and the recomposition, each held to
the reference or to the plain frame on the CPU, and their CUDA forms on a
GPU.

- The queue builder's plain version (frame_kernel.queue_plain) against the
  reference's ``jnp.nonzero(mask, size=cap, fill_value=-1)``
  (gpuraytracer_tpu/kernels/frame_kernel.py:934, :1212) and its count on
  seeded numpy masks, one of them past the capacity (the overflow).
- The resumed dense pass's plain version (the wavefront from each queued
  pixel's saved state) equal to the plain frame at every dirty pixel, bit
  for bit, on a 48x27 builtin frame at cap 8, with pixels queued at every
  level.
- The recomposition's plain version equal to the modes' earlier
  recomposition (the loop of torch.where and sums, repeated here) on
  seeded planes, bit for bit.
- The binned order's plain version keeps each queue's set and sorts it by
  key; a deferred lane whose capped geometries lie past 29 (beyond the
  status word's mask) keys inside its block, and the deferred frame of
  such a scene is the plain frame.
- ``debug_count`` reports the overflow as well as the count.

On a GPU (the ``cuda`` marker): the device queues hold the plain builder's
sets and counts, and the bin kernels its key order; a frame in each mode completes under
``torch.cuda.set_sync_debug_mode("error")``; compact is the plain kernel bit
for bit in the --fmad=false build; an overflowing frame is the plain
kernel's; the deferred frame of a scene whose marches lie past geometry 29
is the plain kernel's within 4e-6 (--fmad=false), and the repair without a
queue (``scene_kernel.shadow_queue``) clears its inactive entries. The
repair resumed from the defer entry's march records gives the occlusion
planes of the full-traversal build (-DGPRT_REPAIR_FULL) bit for bit, and
the deferred frame that build's frame, in both contraction builds, merged
or not (builtin 1080p, the fractal scene, padded_sdf_showcase(28)); the
one-launch bin gives the plain version's key order and each segment's set
on both modes' 1080p queues, also when the same queue is binned again. The
overflow gate (csrc/frame_gate.cu) leaves the image as it was without an
overflow and, with one, gives the plain kernel's frame to the next
operation on the stream with no synchronize between them; a band whose
queues overflow in either mode is the plain kernel's band bit for bit.
"""

import numpy as np
import pytest
import torch

from gpuraytracer_tpu_torch.kernels import build, frame_kernel, scene_kernel
from gpuraytracer_tpu_torch.models import builtin, scenes
from gpuraytracer_tpu_torch.render import trace

T_ANIM = 0.7
CAP_STEPS = 8
ULP_BAR = 4e-6  # tests/test_defer.py
# Padding spheres before the sdf_primitives marches: these take geometries
# 28-34, most of them past the defer status word's mask (bits 0-29).
PAD = 28

# (lanes, capacity, share of set lanes): the last one overflows.
QUEUE_CASES = [(4096, 4096, 0.1), (96 * 54, 8192, 0.5), (3000, 4096, 0.0), (8192, 4096, 0.7)]


@pytest.mark.parametrize("lanes, cap, share", QUEUE_CASES,
                         ids=["sparse", "half", "empty", "overflow"])
def test_queue_plain_matches_reference_nonzero(lanes, cap, share):
    import jax.numpy as jnp

    mask = np.random.default_rng(lanes + cap).random(lanes) < share
    want = np.asarray(jnp.nonzero(jnp.asarray(mask), size=cap, fill_value=-1)[0])
    syncs = frame_kernel.HOST_SYNCS
    idx, count, overflow = frame_kernel.queue_plain(torch.from_numpy(mask), cap)
    assert frame_kernel.HOST_SYNCS == syncs + 1
    np.testing.assert_array_equal(idx.numpy(), want)
    assert count == int(mask.sum()) and overflow == (count > cap)
    assert overflow == (share == 0.7)


@pytest.fixture(scope="module")
def small_frame():
    w, h = 48, 27
    pack = frame_kernel.pack_frame(builtin.build_scene(aspect=w / h, elapsed_time=T_ANIM,
                                                       device="cpu"))
    return pack, w, h, frame_kernel.render_frame_plain(pack, width=w, height=h)


def test_resume_plain_is_the_plain_frame_at_dirty_pixels(small_frame):
    pack, w, h, plain = small_frame
    cap = frame_kernel.queue_capacity(w, h)
    img, queue = frame_kernel.render_frame_compact_main_plain(pack, width=w, height=h,
                                                              budget_cap=CAP_STEPS, cap=cap)
    count = int(queue.count[0])
    pix, state = frame_kernel.entry_state(queue.entries[:count])
    # Pixels stopped at every level, so the resume starts mid-path.
    assert set(state.level.tolist()) == {0, 1, 2}
    # Before the resume the dirty pixels are not the frame's.
    assert not torch.equal(img.reshape(-1, 4)[pix], plain.reshape(-1, 4)[pix])
    out = frame_kernel.render_frame_resume(pack, queue, img, width=w, height=h)
    assert out is img
    assert torch.equal(img.reshape(-1, 4)[pix], plain.reshape(-1, 4)[pix])
    assert torch.equal(img, plain)


def test_compose_plain_equals_the_earlier_recomposition():
    rng = np.random.default_rng(11)
    d, h, w = 3, 9, 13
    planes = trace.DeferPlanes(
        lit=torch.from_numpy(rng.standard_normal((d, h, w, 4)).astype(np.float32)),
        shadowed=torch.from_numpy(rng.standard_normal((d - 1, h, w, 4)).astype(np.float32)),
        sinfo=torch.from_numpy(rng.integers(0, 64, (d - 1, h, w)).astype(np.int32)),
        rays=torch.zeros((d - 1, h, w, 6)))
    occ = torch.from_numpy(rng.integers(0, 2, (d - 1, h, w)).astype(np.int32))
    acc = None
    for k in range(d):
        term = planes.lit[k]
        if k < d - 1:
            stat = planes.sinfo[k] & 3
            shad = (stat == 1) | ((stat == 2) & (occ[k].reshape(h, w) != 0))
            term = torch.where(shad[..., None], planes.shadowed[k], term)
        acc = term if acc is None else acc + term
    got = frame_kernel.frame_compose(planes, occ)
    assert torch.equal(got, acc)


def test_bin_plain_orders_each_queue_by_key(small_frame):
    # The binned order keeps each queue's set and sorts it by key: the
    # capped geometry (compact), raster block then capped geometry (defer).
    pack, w, h, _ = small_frame
    cap = frame_kernel.queue_capacity(w, h)
    _, queue = frame_kernel.render_frame_compact_main(pack, width=w, height=h,
                                                      budget_cap=CAP_STEPS, cap=cap)
    binned = frame_kernel.bin_queue(queue)
    n = int(queue.count[0])
    keys = frame_kernel.bin_keys(binned)[:n]
    assert bool((keys[1:] >= keys[:-1]).all()) and len(set(keys.tolist())) > 1
    assert torch.equal(torch.sort(binned.entries[:n, 0]).values, queue.entries[:n, 0])
    planes, dq = frame_kernel.render_frame_deferred_queue(pack, width=w, height=h,
                                                          shadow_cap=CAP_STEPS, cap=cap)
    # Slots past a count hold anything (on the device, what the allocator
    # left there): the keys never read a pixel through them.
    for k, n in enumerate(dq.count.tolist()):
        dq.idx[k, n:] = 2 ** 30
    dbinned = frame_kernel.bin_queue(dq, planes.sinfo)
    keys = frame_kernel.bin_keys(dbinned, planes.sinfo)
    for k, n in enumerate(dq.count.tolist()):
        assert n > 0 and bool((keys[k, 1:n] >= keys[k, :n - 1]).all())
        assert torch.equal(torch.sort(dbinned.idx[k, :n]).values, dq.idx[k, :n])


def test_defer_keys_of_geometries_past_29_stay_in_their_block():
    w, h = 48, 27
    pack = frame_kernel.pack_frame(scenes.padded_sdf_showcase(PAD).build(w / h, T_ANIM,
                                                                         device="cpu"))
    cap = frame_kernel.queue_capacity(w, h)
    planes, dq = frame_kernel.render_frame_deferred_queue(pack, width=w, height=h,
                                                          shadow_cap=CAP_STEPS, cap=cap)
    keys = frame_kernel.bin_keys(dq, planes.sinfo)
    nbins = 32 * ((w * h + 32767) >> 15)
    for k, n in enumerate(dq.count.tolist()):
        assert n > 0 and bool(((keys[k, :n] >= 0) & (keys[k, :n] < nbins)).all())
        # Lanes capped only past geometry 29 share key 30; 28 and 29 keep theirs.
        assert set(keys[k, :n].tolist()) == {28, 29, 30}
    img, n = frame_kernel.render_frame_deferred(pack, width=w, height=h, shadow_cap=CAP_STEPS,
                                                debug_count=True)
    assert n == int(dq.count.sum()) and not n.overflow
    assert torch.equal(img, frame_kernel.render_frame_plain(pack, width=w, height=h))


def test_deferred_queue_order_argument_warns_and_changes_nothing(small_frame):
    pack, w, h, plain = small_frame
    with pytest.warns(DeprecationWarning, match="qsort"):
        img = frame_kernel.render_frame_deferred(pack, width=w, height=h, max_depth=1,
                                                 qsort="raster")
    assert torch.equal(img, frame_kernel.render_frame_plain(pack, width=w, height=h, max_depth=1))
    with pytest.raises(ValueError, match="queue order"):
        frame_kernel.render_frame_deferred(pack, width=w, height=h, qsort="by-pixel")


@pytest.mark.parametrize("mode", ["compact", "defer"])
def test_debug_count_reports_the_overflow(monkeypatch, small_frame, mode):
    pack, w, h, plain = small_frame
    render = {"compact": frame_kernel.render_frame_compact,
              "defer": frame_kernel.render_frame_deferred}[mode]
    cap_arg = {"compact": "budget_cap", "defer": "shadow_cap"}[mode]
    img, n = render(pack, width=w, height=h, debug_count=True, **{cap_arg: CAP_STEPS})
    assert isinstance(n, frame_kernel.QueueCount) and n > 0 and not n.overflow
    # A one-row queue tile makes the capacity 64 lanes, which the queued
    # lanes of this frame at cap 1 exceed: the frame is the plain one.
    monkeypatch.setattr(frame_kernel, "TILE_ROWS", 1)
    monkeypatch.setattr(frame_kernel, "TILE_COLS", 64)
    img, n = render(pack, width=w, height=h, debug_count=True, cap_lanes=64, **{cap_arg: 1})
    assert n.overflow and n > 64
    assert torch.equal(img, plain)


# ---------------------------------------------------------------------------
# On a GPU
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the device queues have no CPU build)")
    return torch.device("cuda")


def cuda_pack(dev, w, h):
    return frame_kernel.pack_frame(builtin.build_scene(aspect=w / h, elapsed_time=T_ANIM,
                                                       device=dev))


@pytest.mark.cuda
def test_device_queues_hold_the_plain_builders_sets_on_cuda(cuda_device):
    w, h = 128, 72
    pack = cuda_pack(cuda_device, w, h)
    cap = frame_kernel.queue_capacity(w, h)
    _, dirty = frame_kernel.render_frame_capped(pack, width=w, height=h, budget_cap=CAP_STEPS)
    _, queue = frame_kernel.render_frame_compact_main(pack, width=w, height=h,
                                                      budget_cap=CAP_STEPS, cap=cap)
    want, count, _ = frame_kernel.queue_plain(dirty != 0, cap)
    assert 0 < count == int(queue.count[0])
    got = torch.sort(queue.entries[:count, 0].long()).values
    assert torch.equal(got, want[:count])
    # The bin kernels keep the set and give the plain version's key order.
    binned = frame_kernel.bin_queue(queue)
    keys = frame_kernel.bin_keys(binned)[:count]
    assert torch.equal(keys, frame_kernel.bin_keys(frame_kernel.bin_queue_plain(queue))[:count])
    assert torch.equal(torch.sort(binned.entries[:count, 0].long()).values, want[:count])
    planes, dq = frame_kernel.render_frame_deferred_queue(pack, width=w, height=h,
                                                          shadow_cap=CAP_STEPS, cap=cap)
    # Slots past a count hold anything (on the device, what the allocator
    # left there): the keys never read a pixel through them.
    for k, n in enumerate(dq.count.tolist()):
        dq.idx[k, n:] = 2 ** 30
    dbinned = frame_kernel.bin_queue(dq, planes.sinfo)
    keys = frame_kernel.bin_keys(dbinned, planes.sinfo)
    p_keys = frame_kernel.bin_keys(frame_kernel.bin_queue_plain(dq, planes.sinfo), planes.sinfo)
    for k in range(planes.sinfo.shape[0]):
        want, count, _ = frame_kernel.queue_plain((planes.sinfo[k] & 3) == 2, cap)
        assert count == int(dq.count[k])
        assert torch.equal(torch.sort(dq.idx[k, :count].long()).values, want[:count])
        assert torch.equal(torch.sort(dbinned.idx[k, :count].long()).values, want[:count])
        assert torch.equal(keys[k, :count], p_keys[k, :count])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["compact", "defer"])
def test_mode_frame_reads_nothing_back_on_cuda(cuda_device, mode):
    w, h = 128, 72
    pack = cuda_pack(cuda_device, w, h)
    render = {"compact": frame_kernel.render_frame_compact,
              "defer": frame_kernel.render_frame_deferred}[mode]
    render(pack, width=w, height=h)  # build and load the kernels first
    torch.cuda.synchronize()
    syncs = frame_kernel.HOST_SYNCS
    torch.cuda.set_sync_debug_mode("error")
    try:
        img = render(pack, width=w, height=h)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert frame_kernel.HOST_SYNCS == syncs
    assert bool(torch.isfinite(img).all())


@pytest.fixture
def no_contraction(monkeypatch):
    """Every wrapper's default library is the --fmad=false build."""
    real = build.load
    monkeypatch.setattr(build, "load", lambda name, count_ops=False: real(
        name, fmad=False, count_ops=count_ops))


@pytest.mark.cuda
@pytest.mark.parametrize("cap, cap_lanes", [(None, None), (CAP_STEPS, 320 * 180), (1, 1)],
                         ids=["default_cap", "cap8", "overflow"])
def test_compact_is_the_plain_kernel_without_contraction_on_cuda(cuda_device, no_contraction,
                                                                 cap, cap_lanes):
    w, h = 320, 180
    pack = cuda_pack(cuda_device, w, h)
    plain = frame_kernel.render_frame_tiles(pack, width=w, height=h)
    gated = frame_kernel.GATED_FALLBACK_LAUNCHES
    img, n = frame_kernel.render_frame_compact(pack, width=w, height=h, budget_cap=cap,
                                               cap_lanes=cap_lanes, debug_count=True)
    assert n > 0 and n.overflow == (cap_lanes == 1)
    assert frame_kernel.GATED_FALLBACK_LAUNCHES == gated + 1
    assert torch.equal(img, plain)


@pytest.mark.cuda
def test_overflowing_deferred_frame_is_the_plain_kernels_on_cuda(cuda_device):
    w, h = 320, 180
    pack = cuda_pack(cuda_device, w, h)
    plain = frame_kernel.render_frame_tiles(pack, width=w, height=h)
    queue = scene_kernel.QUEUE_LAUNCHES
    img, n = frame_kernel.render_frame_deferred(pack, width=w, height=h, shadow_cap=1,
                                                cap_lanes=1, debug_count=True)
    assert n.overflow and scene_kernel.QUEUE_LAUNCHES == queue + 1
    assert torch.equal(img, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["compact", "defer"])
def test_overflowing_band_is_the_plain_kernels_on_cuda(cuda_device, mode):
    # Rows 60-119 of a 320x180 frame at a one-tile queue: the band's queue
    # overflows and the gate's device-side launch renders the plain band.
    w, h, row_offset, lh = 320, 180, 60, 60
    pack = cuda_pack(cuda_device, w, h)
    band = dict(width=w, height=h, row_offset=row_offset, local_height=lh)
    plain = frame_kernel.render_frame_tiles(pack, **band)
    if mode == "compact":
        img, n = frame_kernel.render_frame_compact(pack, budget_cap=1, cap_lanes=1,
                                                   debug_count=True, **band)
    else:
        img, n = frame_kernel.render_frame_deferred(pack, shadow_cap=1, cap_lanes=1,
                                                    debug_count=True, **band)
    assert n.overflow
    assert torch.equal(img, plain)


@pytest.mark.cuda
def test_gate_renders_only_on_overflow_before_the_next_operation_on_cuda(cuda_device):
    # The gate with counts at the capacity writes nothing; with one past it,
    # a clone queued right after it (no synchronize) already holds the
    # plain kernel's frame: the frame kernel that the gate launches on the
    # device finishes before the stream's next operation starts.
    w, h, cap = 320, 180, 100
    pack = cuda_pack(cuda_device, w, h)
    kw = dict(width=w, height=h)
    plain = frame_kernel.render_frame_tiles(pack, **kw)
    gated = frame_kernel.GATED_FALLBACK_LAUNCHES
    img = torch.full_like(plain, -7.0)
    count = torch.tensor([cap, cap - 1], dtype=torch.int32, device=cuda_device)
    frame_kernel.render_frame_gated(pack, img, count, cap, **kw)
    assert bool((img == -7.0).all())
    count = torch.tensor([1, cap + 1], dtype=torch.int32, device=cuda_device)
    seen = frame_kernel.render_frame_gated(pack, img, count, cap, **kw).clone()
    assert frame_kernel.GATED_FALLBACK_LAUNCHES == gated + 2
    assert torch.equal(seen, plain)


@pytest.mark.cuda
def test_deferred_frame_past_geometry_29_is_the_plain_kernels_on_cuda(cuda_device,
                                                                       no_contraction):
    w, h = 160, 90
    pack = frame_kernel.pack_frame(scenes.padded_sdf_showcase(PAD).build(w / h, T_ANIM,
                                                                         device=cuda_device))
    cap = frame_kernel.queue_capacity(w, h)
    planes, dq = frame_kernel.render_frame_deferred_queue(pack, width=w, height=h,
                                                          shadow_cap=CAP_STEPS, cap=cap)
    binned = frame_kernel.bin_queue(dq, planes.sinfo)
    keys = frame_kernel.bin_keys(binned, planes.sinfo)
    p_keys = frame_kernel.bin_keys(frame_kernel.bin_queue_plain(dq, planes.sinfo), planes.sinfo)
    for k, n in enumerate(dq.count.tolist()):
        assert n > 0 and 30 in keys[k, :n].tolist()
        assert torch.equal(keys[k, :n], p_keys[k, :n])
        assert torch.equal(torch.sort(binned.idx[k, :n]).values, torch.sort(dq.idx[k, :n]).values)
    plain = frame_kernel.render_frame_tiles(pack, width=w, height=h)
    img, n = frame_kernel.render_frame_deferred(pack, width=w, height=h, shadow_cap=CAP_STEPS,
                                                debug_count=True)
    assert n > 0 and not n.overflow
    assert float((img - plain).abs().max()) <= ULP_BAR
    # The repair without a queue: two segments, every other entry active.
    rays = planes.rays.reshape(-1, 6)
    active = torch.zeros(rays.shape[0], dtype=torch.bool, device=cuda_device)
    active[::2] = True
    seg = w * h
    occ = scene_kernel.shadow_queue(pack, rays, active, seg)
    p_occ = scene_kernel.shadow_queue_plain(pack, rays, active, seg)
    assert bool(occ[active].any()) and not bool(occ[~active].any())
    assert float((occ == p_occ).float().mean()) >= 0.99


def _defer_scene(name, w, h, dev):
    """(pack, max_depth) of a scene of the resumed repair's checks."""
    if name == "padded":
        scene = scenes.padded_sdf_showcase(PAD).build(w / h, T_ANIM, device=dev)
        return frame_kernel.pack_frame(scene), scenes.get_config("sdf_primitives_720p").max_depth
    if name == "builtin":
        return cuda_pack(dev, w, h), 3
    cfg = scenes.get_config(name)
    return frame_kernel.pack_frame(cfg.build(w / h, T_ANIM, device=dev)), cfg.max_depth


RESUME_CASES = [("builtin", 1920, 1080), ("fractal_mandelbulb_julia_1080p", 320, 180),
                ("padded", 160, 90)]


@pytest.mark.cuda
@pytest.mark.parametrize("fmad", [True, False], ids=["fmad", "no_fmad"])
@pytest.mark.parametrize("name, w, h", RESUME_CASES, ids=[c[0] for c in RESUME_CASES])
def test_resumed_repair_equals_the_full_traversal_build_on_cuda(cuda_device, monkeypatch, fmad,
                                                                 name, w, h):
    # The repair resumed from the defer entry's march records gives the
    # occlusion planes of the -DGPRT_REPAIR_FULL build (the whole traversal
    # from geometry 0, the parent's repair) on every queued pixel, bit for
    # bit, in both contraction builds, sequential and merged
    # (GPURT_MERGED_SHADOW=1, which equals its twin); and the deferred frame
    # is the full-traversal build's frame bit for bit.
    pack, depth = _defer_scene(name, w, h, cuda_device)
    kw = dict(width=w, height=h, max_depth=depth)
    real = build.load
    lib = real("scene_kernel", fmad=fmad)
    full = real("scene_kernel", fmad=fmad, repair_full=True)
    monkeypatch.setattr(build, "load", lambda n, **k: real(n, **{**k, "fmad": fmad}))
    monkeypatch.delenv("GPURT_MERGED_SHADOW", raising=False)
    cap = frame_kernel.queue_capacity(w, h)
    planes, dq = frame_kernel.render_frame_deferred_queue(pack, shadow_cap=32, cap=cap, **kw)
    dq = frame_kernel.bin_queue(dq, planes.sinfo)
    unknown = (planes.sinfo & 3) == 2
    assert bool(unknown.any()) and not bool((dq.count > cap).any())
    occ = {}
    for merged in (False, True):
        if merged:
            monkeypatch.setenv("GPURT_MERGED_SHADOW", "1")
        for label, library in (("resumed", lib), ("full", full)):
            occ[label, merged] = scene_kernel.shadow_queue_planes(
                pack, planes.rays, dq.idx, dq.count, dq.rec, lib=library)
        monkeypatch.delenv("GPURT_MERGED_SHADOW", raising=False)
    want = occ["full", False][unknown]
    for key, got in occ.items():
        assert torch.equal(got[unknown], want), key
    assert 0 < int(want.sum()) < want.numel()
    img = frame_kernel.render_frame_deferred(pack, shadow_cap=32, **kw)
    monkeypatch.setattr(build, "load", lambda n, **k: real(
        n, **{**k, "fmad": fmad, "repair_full": n == "scene_kernel"}))
    assert torch.equal(img, frame_kernel.render_frame_deferred(pack, shadow_cap=32, **kw))


@pytest.mark.cuda
def test_bin_keeps_key_order_and_set_on_1080p_queues_on_cuda(cuda_device):
    # On both modes' 1080p queues the bin entry (one launch) gives the plain
    # version's key order and each segment's set, and binning the same queue
    # again gives the same keys (its cursors are back at zero).
    w, h = 1920, 1080
    pack = cuda_pack(cuda_device, w, h)
    cap = frame_kernel.queue_capacity(w, h)
    _, queue = frame_kernel.render_frame_compact_main(pack, width=w, height=h, budget_cap=64,
                                                      cap=cap)
    planes, dq = frame_kernel.render_frame_deferred_queue(pack, width=w, height=h,
                                                          shadow_cap=32, cap=cap)
    for q, sinfo in ((queue, None), (dq, planes.sinfo)):
        slots = q.entries[:, 0][None] if sinfo is None else q.idx
        keys_p = frame_kernel.bin_keys(frame_kernel.bin_queue_plain(q, sinfo), sinfo)
        launches = frame_kernel.BIN_LAUNCHES
        for _ in range(2):
            binned = frame_kernel.bin_queue(q, sinfo)
            got = binned.entries[:, 0][None] if sinfo is None else binned.idx
            keys = frame_kernel.bin_keys(binned, sinfo)
            keys, keys_want = (k[None] if sinfo is None else k for k in (keys, keys_p))
            for k, n in enumerate(q.count.tolist()):
                assert 0 < n <= cap
                assert torch.equal(keys[k, :n], keys_want[k, :n])
                assert torch.equal(torch.sort(got[k, :n]).values, torch.sort(slots[k, :n]).values)
        assert frame_kernel.BIN_LAUNCHES == launches + 2
