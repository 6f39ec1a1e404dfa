"""One traversal pass over every procedural geometry in one hand-written
CUDA kernel (csrc/scene_kernel.cu).

Replaces the reference's Pallas scene kernel
(gpuraytracer_tpu/kernels/scene_kernel.py: scene_closest_tiles /
_scene_kernel, phase "single"): BLAS-space rays with an initial bound t0
in, the closest procedural hit (best_t, world normal, geometry id) out,
or accept-first occlusion. The plane stays in PyTorch (accel/traverse.py),
which sets t0: the plane's t where it hits, else RAY_TMAX, for a closest
pass; 0 for plane-occluded lanes (which go in inactive) and RAY_TMAX for
the rest, for an occlusion pass.

One CUDA thread traces one ray over flat (N,) rays, with the device code
the frame kernel runs (csrc/traverse.cuh), reading the buffers
``frame_kernel.pack_frame`` builds. On a CPU tensor the wrapper runs the
plain version below, the per-geometry loop of the wavefront; on a CUDA
tensor it launches the kernel or raises.

``scene_closest_tiles(two_phase=True)`` is the reference's two-phase form
(its phases "main" and "finish"): a main pass with every march capped at
PHASE_BUDGET steps that writes a dirty word per ray, then a finisher that
marches the dirty (ray, geometry) pairs again at the level-0 plain budgets
(``scene_finish_plain``). On the card the finisher runs over a queue of the
dirty rays ordered by the first geometry each marches again
(``scene_finish_queue``), one thread per queued ray (csrc/scene_finish.cu).
``occluded_merged_plain`` is the plain version of the merged occlusion
march (GPURT_MERGED_SHADOW) that the frame kernel family and the occlusion
queue run on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import torch

from gpuraytracer_tpu_torch.accel.instances import Scene, normal_to_world, ray_to_local
from gpuraytracer_tpu_torch.core.types import (
    METABALL_MAX_STEPS,
    RAY_TMAX,
    RAY_TMIN,
    SDF_MAX_STEPS,
    IntersectorKind,
)
from gpuraytracer_tpu_torch.geometry import analytic, registry, sdf
from gpuraytracer_tpu_torch.kernels import frame_kernel

# Kernel launches since import (or since a caller reset it); PROBE_LAUNCHES
# counts the check-only distance probe (``sdf_distance``) apart,
# QUEUE_LAUNCHES and MERGED_QUEUE_LAUNCHES the occlusion repair's default
# and merged instantiations (``shadow_queue_planes``, the deferred mode's,
# and ``shadow_queue``), MAIN_LAUNCHES and
# FINISH_LAUNCHES the two-phase form's main pass and finisher,
# FINISH_QUEUE_LAUNCHES the compaction of the dirty rays into the
# finisher's queue (its append and bin kernels; ``scene_finish_queue``, and
# every ``scene_finish`` of the queued build).
LAUNCHES = 0
PROBE_LAUNCHES = 0
QUEUE_LAUNCHES = 0
MERGED_QUEUE_LAUNCHES = 0
MAIN_LAUNCHES = 0
FINISH_LAUNCHES = 0
FINISH_QUEUE_LAUNCHES = 0

# The two-phase main pass's step cap (the reference's PHASE_BUDGET,
# scene_kernel.py:92), on SDF and metaball marches alike.
PHASE_BUDGET = 64
# Gated SDF geometries a lane keeps pending at once in the merged occlusion
# march (csrc/traverse.cuh kMergeWindow).
MERGE_WINDOW = 2


# GPURT_MERGED_SHADOW as the reference's scene_kernel reads it; the port
# keeps the rule in frame_kernel.
merged_shadow_enabled = frame_kernel.merged_shadow_enabled


def pack_params(arrays, elapsed_time):
    """The reference's parameter blocks of ``arrays``: (b2l_rows (G,12),
    l2b_rot (G,9), step_scales (G,), aabbs (G,6), mb_params (3,4)), the
    metaballs' centres and radii at ``elapsed_time`` (a float or a 0-d
    tensor): the fields that frame_kernel.pack_frame packs
    (frame_kernel.frame_fields, geometry_blocks)."""
    t = torch.as_tensor(elapsed_time, dtype=torch.float32, device=arrays.aabb_min.device)
    at_t = dataclasses.replace(arrays, constants=dataclasses.replace(arrays.constants,
                                                                     elapsed_time=t))
    _, b2l_rows, l2b_rot, mb_params = frame_kernel.frame_fields(at_t)
    step_scales, aabbs = frame_kernel.geometry_blocks(arrays)
    return b2l_rows, l2b_rot, step_scales, aabbs, mb_params


def dirty_bit(g: int) -> int:
    """Geometry -> bit of the dirty mask (scene_kernel._dirty_bit):
    geometries past 31 share bit 31."""
    return 1 << min(g, 31)


def scene_closest_plain(scene: Scene, o_blas, d_blas, active, t0, *, level: int = 0,
                        accept_first: bool = False, cull_backface: bool = True,
                        budget_level: int | None = None, march=None, mesh_closest=None,
                        budget_cap: int | None = None, mb_budget_cap: int | None = None,
                        dirty=None, kill_on_cap: bool = False):
    """The kernel's plain PyTorch version: every procedural geometry in
    definition order, each gated by its BLAS-space slab against the
    running best t, with a strict-< closest reduction. accept_first: a
    lane's first valid hit ends its search (its best_t drops to 0);
    back-face culling stays on.

    The same loop is the per-geometry route (accel/traverse.
    per_geometry_route): ``budget_level`` marches every pass at that
    level's budget instead of ``level``'s; ``march`` and ``mesh_closest``
    run the SDF marches and the meshes (geometry/registry.intersect), one
    call per geometry over all N rays behind its gate.

    The capped traversal of the compacted frame modes' main passes
    (scene_kernel._traverse_tile with budget_cap, dirty_ref, kill_on_cap):
    ``budget_cap`` / ``mb_budget_cap`` cap the SDF / metaball marches
    (sdf.march_budget's ``cap``); ``dirty``, an (N,) int32 mask updated
    in place, takes ``dirty_bit(g)`` for every lane whose march of
    geometry g ran out of a capped budget (sdf.cap_marks_dirty); with
    ``kill_on_cap`` a lane whose mask is not 0 passes no further gate.
    A lane that no cap touched gets what the uncapped pass gives it: a
    capped march that resolves is a strict prefix of the full one.

    Returns (best_t (N,) f32, normal (N, 3) f32 world space, gid (N,)
    int32); gid is -1 where no procedural hit beat t0."""
    layout, arrays = scene.layout, scene.arrays
    n = o_blas.shape[0]
    dev = o_blas.device
    best_t = t0.clone()
    normal = torch.zeros_like(o_blas)
    gid = torch.full((n,), -1, dtype=torch.int32, device=dev)
    tr = arrays.transforms
    step_scales = arrays.materials.step_scale.tolist()
    march_level = level if budget_level is None else budget_level
    caps = {}
    if dirty is not None:
        caps = dict(budget_cap=budget_cap, mb_budget_cap=mb_budget_cap, return_capped=True)
    elif budget_cap is not None or mb_budget_cap is not None:
        raise ValueError("a capped traversal needs a dirty mask")
    for i in range(len(layout.kinds)):
        gate = analytic.aabb_hit_mask(o_blas, d_blas, arrays.aabb_min[i], arrays.aabb_max[i],
                                      t_min=RAY_TMIN, t_max=best_t) & active
        if accept_first:
            gate = gate & (gid < 0)
        if kill_on_cap and dirty is not None:
            gate = gate & (dirty == 0)
        kind, prim_type, o_loc, d_loc, kw = _geometry_args(scene, i, o_blas, d_blas, gate,
                                                           step_scales)
        hit, t, n_loc, *capped = registry.intersect(
            kind, prim_type, o_loc, d_loc, t_min=RAY_TMIN, t_max=best_t,
            cull_backface=True if accept_first else cull_backface,
            occlusion=accept_first, level=march_level, with_normal=not accept_first,
            march=march, mesh_closest=mesh_closest, **caps, **kw,
        )
        if capped:
            dirty.bitwise_or_(torch.where(capped[0], dirty_bit(i), 0).to(torch.int32))
        if accept_first:
            # Any valid (or capped) hit occludes, whatever its t.
            win = hit
            best_t = torch.where(win, 0.0, best_t)
        else:
            win = hit & (t < best_t)
            best_t = torch.where(win, t, best_t)
            normal = torch.where(win[:, None], normal_to_world(n_loc, tr.local_to_blas[i]),
                                 normal)
        gid = torch.where(win, i, gid)
    return best_t, normal, gid


def _geometry_args(scene: Scene, i: int, o_blas, d_blas, gate, step_scales):
    """(kind, code, local rays, the registry's keyword arguments) of
    geometry i over the gated lanes; ``step_scales`` is the scene's
    step_scale as a list (read from the device once per pass)."""
    layout, arrays = scene.layout, scene.arrays
    kind, code = layout.kinds[i], layout.prim_types[i]
    o_loc, d_loc = ray_to_local(o_blas, d_blas, arrays.transforms.blas_to_local[i])
    kw = dict(active=gate, step_scale=step_scales[i],
              elapsed_time=arrays.constants.elapsed_time,
              natural_budget=layout.step_budgets[i] if layout.step_budgets else SDF_MAX_STEPS,
              mesh=arrays.meshes[code] if kind == IntersectorKind.TRIANGLE else None)
    return kind, code, o_loc, d_loc, kw


def occluded_merged_plain(scene: Scene, o_blas, d_blas, active, t0, *, level: int = 0,
                          window: int = MERGE_WINDOW):
    """Plain version of the merged occlusion march (csrc/traverse.cuh
    occluded_merged; the reference's _march_sdf_multi and its call site,
    scene_kernel.py:466-705, :1646-1789): (N,) bool, the accept-first
    occlusion of the procedural geometries over [0, t0] that
    ``scene_closest_plain(accept_first=True)`` answers with gid >= 0.

    The closed forms, meshes and metaballs run first, in definition order;
    then the SDF geometries, ``window`` at a time, each march set up once
    (gate, window, the level's budget and rule) and advanced one sample per
    turn, round robin; a valid crossing kills the lane's marches on every
    geometry, and after the loop a march that spent its budget occludes
    where the level's occluded-on-cap rule holds (the reference's post-loop
    rule, :682-705). The kernel takes the marches in another order (whole
    marches, in turns that a warp agrees on); occlusion is the OR over the
    geometries, so the answer is the same."""
    layout, arrays = scene.layout, scene.arrays
    step_scales = arrays.materials.step_scale.tolist()
    occ = torch.zeros(o_blas.shape[0], dtype=torch.bool, device=o_blas.device)
    sdf_ids = []

    def gate_of(i):
        return analytic.aabb_hit_mask(o_blas, d_blas, arrays.aabb_min[i], arrays.aabb_max[i],
                                      t_min=RAY_TMIN, t_max=t0) & active & ~occ

    for i, kind in enumerate(layout.kinds):
        if kind == IntersectorKind.SIGNED_DISTANCE:
            sdf_ids.append(i)
            continue
        kind, code, o_loc, d_loc, kw = _geometry_args(scene, i, o_blas, d_blas, gate_of(i),
                                                      step_scales)
        hit, _, _ = registry.intersect(kind, code, o_loc, d_loc, t_min=RAY_TMIN, t_max=t0,
                                       cull_backface=True, occlusion=True, level=level,
                                       with_normal=False, **kw)
        occ = occ | hit
    for w in range(0, len(sdf_ids), window):
        marches = []
        for i in sdf_ids[w:w + window]:
            _, code, o_loc, d_loc, kw = _geometry_args(scene, i, o_blas, d_blas, gate_of(i),
                                                       step_scales)
            gate, t_hi, mkw = registry.sdf_march_args(
                code, o_loc, d_loc, t_min=RAY_TMIN, t_max=t0, cull_backface=True,
                active=kw["active"], natural_budget=kw["natural_budget"], occlusion=True,
                level=level)
            capped_hit = mkw.pop("capped_hit")
            marches.append((sdf.march_state(o_loc, d_loc, gate, t_hi, kw["step_scale"], **mkw),
                            capped_hit))
        while any(m.marching for m, _ in marches):
            for m, _ in marches:
                if not m.marching:
                    continue
                m.step()
                hits = m.hits()
                if bool(hits.any()):
                    occ = occ | hits
                    for other, _ in marches:
                        other.kill(hits)
        for m, capped_hit in marches:
            occ = occ | m.result(capped_hit=capped_hit)[0]
    return occ


def scene_finish_plain(scene: Scene, o_blas, d_blas, dirty, best_t, normal, gid, *,
                       accept_first: bool = False, cull_backface: bool = True):
    """Plain version of the two-phase finisher (csrc/traverse.cuh
    finish_procedural; the reference's _finish_tile, scene_kernel.py:
    1028-1150) over the main pass's outputs (best_t, normal, gid) and its
    (N,) int32 dirty words: every march geometry whose bit a ray's word
    holds is marched again for that ray, in definition order, behind its
    gate against the current best t, at the level-0 plain budgets with their
    occluded-on-cap rule; accept-first skips occluded rays; the metaballs
    always cull back faces (_march_metaballs_inline). Closest: a strictly
    closer hit takes the ray, with its normal. Returns new (best_t, normal,
    gid)."""
    best_t, normal, gid = best_t.clone(), normal.clone(), gid.clone()
    tr = scene.arrays.transforms
    step_scales = scene.arrays.materials.step_scale.tolist()
    for i, kind in enumerate(scene.layout.kinds):
        if kind not in (IntersectorKind.SIGNED_DISTANCE, IntersectorKind.VOLUMETRIC):
            continue
        gate = ((dirty >> min(i, 31)) & 1) != 0
        if accept_first:
            gate = gate & (gid < 0)
        gate = gate & analytic.aabb_hit_mask(o_blas, d_blas, scene.arrays.aabb_min[i],
                                             scene.arrays.aabb_max[i], t_min=RAY_TMIN,
                                             t_max=best_t)
        kind, code, o_loc, d_loc, kw = _geometry_args(scene, i, o_blas, d_blas, gate, step_scales)
        cull = accept_first or kind == IntersectorKind.VOLUMETRIC or cull_backface
        hit, t, n_loc = registry.intersect(kind, code, o_loc, d_loc, t_min=RAY_TMIN,
                                           t_max=best_t, cull_backface=cull,
                                           occlusion=accept_first, level=0,
                                           with_normal=not accept_first, **kw)
        if accept_first:
            win = hit
            best_t = torch.where(win, 0.0, best_t)
        else:
            win = hit & (t < best_t)
            best_t = torch.where(win, t, best_t)
            normal = torch.where(win[:, None], normal_to_world(n_loc, tr.local_to_blas[i]),
                                 normal)
        gid = torch.where(win, i, gid)
    return best_t, normal, gid


class FinishQueue(NamedTuple):
    """The finisher's queue of dirty rays: ``idx`` (N,) int32 ray indices,
    the first ``count[0]`` of them live, ordered by ``finish_key`` (within
    a key, in any order: on the card the order of the bin's atomics); the
    slots past the count hold anything. ``count`` (1,) int32 stays where it
    was counted (on the card, the device)."""
    idx: torch.Tensor
    count: torch.Tensor


def finish_key(dirty):
    """The queue's key of each dirty word: its lowest set bit, the first
    geometry the finisher marches again (geometries past 31 share bit 31);
    32 where the word is 0."""
    key = torch.full_like(dirty, 32)
    for b in range(31, -1, -1):
        key = torch.where(((dirty >> b) & 1) != 0, b, key)
    return key


def scene_finish_queue_plain(dirty) -> FinishQueue:
    """Plain version of ``scene_finish_queue``: the rays whose dirty word is
    not 0 (``nonzero``), stably ordered by ``finish_key`` (so within a key
    in ray order), in an N-slot queue whose slots past the count hold -1."""
    live = torch.nonzero(dirty).squeeze(1)
    live = live[torch.argsort(finish_key(dirty[live]), stable=True)]
    idx = torch.full_like(dirty, -1)
    idx[:live.shape[0]] = live.to(torch.int32)
    return FinishQueue(idx, torch.tensor([live.shape[0]], dtype=torch.int32,
                                         device=dirty.device))


def scene_finish_queue(dirty, lib=None) -> FinishQueue:
    """The compaction of the two-phase main pass's (N,) int32 dirty words into
    the finisher's queue (``FinishQueue``), with no host sync. CUDA: the
    append and bin kernels of csrc/scene_finish.cu (``lib``, default the
    shipped build; counted in FINISH_QUEUE_LAUNCHES), which ``scene_finish``
    runs before its finisher; the count stays on the device. CPU: the plain
    version."""
    global FINISH_QUEUE_LAUNCHES
    if dirty.dtype != torch.int32 or dirty.dim() != 1 or not dirty.is_contiguous():
        raise ValueError(f"dirty: expected a contiguous (N,) int32 tensor, got "
                         f"{tuple(dirty.shape)} {dirty.dtype}")
    dev, n = dirty.device, dirty.shape[0]
    if dev.type == "cpu":
        return scene_finish_queue_plain(dirty)
    if dev.type != "cuda":
        raise ValueError(f"no finisher for device {dev}")
    if n == 0:
        return FinishQueue(torch.empty(0, dtype=torch.int32, device=dev),
                           torch.zeros(1, dtype=torch.int32, device=dev))
    from gpuraytracer_tpu_torch.kernels import build

    lib = lib if lib is not None else build.load("scene_finish")
    queue, words = _finish_scratch(n, dev)
    _raise_on(lib.gprt_finish_queue(_ptr(dirty), _ptr(queue), _ptr(words), n, dev.index,
                                    _stream(dev)), lib, "finisher queue")
    FINISH_QUEUE_LAUNCHES += 1
    return FinishQueue(queue[n:], words[:1])


# The int32 words beside a finisher queue on the card: its count, the 32
# keys' histogram and the bin's cursors (csrc/scene_finish.cu kFinishWords).
FINISH_WORDS = 1 + 2 * 32


def _finish_scratch(n, dev):
    """(queue, words) of a compaction on the card: 2n int32 slots (the
    append order, then the ordered queue; 8.3 MB each at 1080p) and
    FINISH_WORDS."""
    return (torch.empty(2 * n, dtype=torch.int32, device=dev),
            torch.empty(FINISH_WORDS, dtype=torch.int32, device=dev))


def scene_finish_queued_plain(scene: Scene, o_blas, d_blas, dirty, queue: FinishQueue,
                              best_t, normal, gid, *, accept_first: bool = False,
                              cull_backface: bool = True):
    """``scene_finish_plain`` over the live rays of ``queue`` alone (the
    card's order of work), their answers scattered back into copies of the
    main pass's outputs; every other ray keeps its answer. Each ray's answer
    depends on its own inputs only, so this is ``scene_finish_plain`` over
    every ray. Returns new (best_t, normal, gid)."""
    live = queue.idx[:int(queue.count[0])].long()
    best_t, normal, gid = best_t.clone(), normal.clone(), gid.clone()
    t, nn, g = scene_finish_plain(scene, o_blas[live], d_blas[live], dirty[live], best_t[live],
                                  normal[live], gid[live], accept_first=accept_first,
                                  cull_backface=cull_backface)
    best_t[live], normal[live], gid[live] = t, nn, g
    return best_t, normal, gid


def two_phase_runs(scene: Scene) -> bool:
    """Whether the two-phase form splits the pass: some march's budget
    exceeds PHASE_BUDGET (an SDF geometry's natural budget, or the
    metaballs' 128 steps; scene_kernel.py:1928-1934)."""
    layout = scene.layout
    for i, kind in enumerate(layout.kinds):
        natural = layout.step_budgets[i] if layout.step_budgets else SDF_MAX_STEPS
        if (kind == IntersectorKind.SIGNED_DISTANCE and natural > PHASE_BUDGET) or (
                kind == IntersectorKind.VOLUMETRIC and METABALL_MAX_STEPS > PHASE_BUDGET):
            return True
    return False


def scene_main_plain(scene: Scene, o_blas, d_blas, active, t0, *, level: int = 0,
                     accept_first: bool = False, cull_backface: bool = True):
    """Plain version of the two-phase main pass: ``scene_closest_plain``
    with every march capped at PHASE_BUDGET steps and a dirty mask, without
    kill-on-cap (the traversal goes on past a capped march). Returns
    (best_t, normal, gid, dirty)."""
    dirty = torch.zeros(o_blas.shape[0], dtype=torch.int32, device=o_blas.device)
    out = scene_closest_plain(scene, o_blas, d_blas, active, t0, level=level,
                              accept_first=accept_first, cull_backface=cull_backface,
                              budget_cap=PHASE_BUDGET, mb_budget_cap=PHASE_BUDGET, dirty=dirty,
                              kill_on_cap=False)
    return out + (dirty,)


def scene_two_phase_plain(scene: Scene, o_blas, d_blas, active, t0, *, level: int = 0,
                          accept_first: bool = False, cull_backface: bool = True):
    """Plain version of the two-phase form: ``scene_main_plain``, then
    ``scene_finish_plain``. Returns (best_t, normal, gid, dirty)."""
    *main, dirty = scene_main_plain(scene, o_blas, d_blas, active, t0, level=level,
                                    accept_first=accept_first, cull_backface=cull_backface)
    return scene_finish_plain(scene, o_blas, d_blas, dirty, *main, accept_first=accept_first,
                              cull_backface=cull_backface) + (dirty,)


def _check_rays(o_blas, d_blas, active, t0):
    n = o_blas.shape[0]
    for name, x, shape, dtype in (("o_blas", o_blas, (n, 3), torch.float32),
                                  ("d_blas", d_blas, (n, 3), torch.float32),
                                  ("active", active, (n,), torch.bool),
                                  ("t0", t0, (n,), torch.float32)):
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got {tuple(x.shape)} {x.dtype}")
        if x.device != o_blas.device:
            raise ValueError(f"{name} on {x.device}, o_blas on {o_blas.device}")


def _prepare(scene: Scene, o_blas, pack, lib, name: str = "scene_kernel"):
    """(pack, library: ``lib``, default the shipped build of csrc/<name>.cu)
    of a CUDA launch over rays on o_blas's device."""
    dev = o_blas.device
    if dev.type != "cuda":
        raise ValueError(f"no scene kernel for device {dev}")
    pack = pack if pack is not None else frame_kernel.pack_frame(scene)
    frame_kernel.check_pack(pack)
    if pack.params.device != dev:
        raise ValueError(f"pack on {pack.params.device}, rays on {dev}")
    from gpuraytracer_tpu_torch.kernels import build

    return pack, lib if lib is not None else build.load(name)


def _shared(pack: frame_kernel.FramePack) -> int:
    """The scene kernel library's table layout flag for the pack (its
    traversal prefix in shared memory, or read in place)."""
    return int(frame_kernel.tables_in_shared(pack.num_geometries, pack.num_materials,
                                             shading=False))


def residency(pack: frame_kernel.FramePack, *, entry: str = "pass", lib=None) -> tuple:
    """(blocks per SM, blocks in all) that the card keeps resident for the
    packed scene of one entry: ``"pass"`` and ``"main"`` (the two-phase main
    pass) as ``scene_closest_tiles`` launches them, ``"repair"`` as
    ``shadow_queue_planes`` launches it (its merged instantiation where
    ``frame_kernel.merges`` says so); launches nothing."""
    code = {"pass": 0, "main": 1, "repair": 2}[entry]
    frame_kernel.check_pack(pack)
    dev = pack.params.device
    if dev.type != "cuda":
        raise ValueError(f"no scene kernel for device {dev}")
    from gpuraytracer_tpu_torch.kernels import build

    lib = lib if lib is not None else build.load("scene_kernel")
    per_sm, total = ctypes.c_int(0), ctypes.c_int(0)
    if entry == "repair" and frame_kernel.merges(pack):
        code = 3
    _raise_on(lib.gprt_scene_residency(pack.num_geometries, pack.num_materials, _shared(pack),
                                       code, dev.index, ctypes.byref(per_sm),
                                       ctypes.byref(total)), lib, "scene kernel residency")
    return per_sm.value, total.value


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _raise_on(rc, lib, what):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({lib.gprt_error_string(rc).decode()})")


def _closest_launch(scene, o_blas, d_blas, active, t0, level, accept_first, cull_backface,
                    main, pack, lib, ops):
    """One launch of the single-pass or the main-pass entry of
    csrc/scene_kernel.cu: (best_t, normal, gid, dirty or None)."""
    dev, n = o_blas.device, o_blas.shape[0]
    best_t = torch.empty(n, dtype=torch.float32, device=dev)
    normal = torch.empty(n, 3, dtype=torch.float32, device=dev)
    gid = torch.empty(n, dtype=torch.int32, device=dev)
    dirty = torch.zeros(n, dtype=torch.int32, device=dev) if main else None
    if n == 0:
        return best_t, normal, gid, dirty
    pack, lib = _prepare(scene, o_blas, pack, lib)
    o_blas, d_blas = o_blas.contiguous(), d_blas.contiguous()
    active, t0 = active.contiguous(), t0.contiguous()
    _raise_on(lib.gprt_scene_closest(
        _ptr(pack.params), _ptr(pack.layout), _ptr(pack.tri), _ptr(o_blas), _ptr(d_blas),
        _ptr(active), _ptr(t0), _ptr(best_t), _ptr(normal), _ptr(gid),
        _ptr(dirty) if main else ctypes.c_void_p(None), n, pack.num_geometries,
        pack.num_materials, _shared(pack), int(level), int(accept_first), int(cull_backface),
        PHASE_BUDGET, PHASE_BUDGET, frame_kernel.ops_pointer(ops), dev.index, _stream(dev)), lib,
        "two-phase main pass" if main else "scene kernel")
    return best_t, normal, gid, dirty


def scene_main_pass(scene: Scene, o_blas, d_blas, active, t0, *, level: int = 0,
                    accept_first: bool = False, cull_backface: bool = True,
                    pack: frame_kernel.FramePack | None = None, lib=None, ops=None):
    """The two-phase form's main pass, (best_t, normal, gid, dirty) as
    ``scene_main_plain`` gives them: on CUDA the main-pass entry of
    csrc/scene_kernel.cu (counted in MAIN_LAUNCHES; ``pack``, ``lib``,
    ``ops`` as for ``scene_closest_tiles``), on the CPU the plain
    version."""
    global MAIN_LAUNCHES
    _check_rays(o_blas, d_blas, active, t0)
    kw = dict(level=level, accept_first=accept_first, cull_backface=cull_backface)
    if o_blas.device.type == "cpu":
        return scene_main_plain(scene, o_blas, d_blas, active, t0, **kw)
    out = _closest_launch(scene, o_blas, d_blas, active, t0, level, accept_first,
                          cull_backface, True, pack, lib, ops)
    if o_blas.shape[0]:
        MAIN_LAUNCHES += 1
    return out


def scene_finish(scene: Scene, o_blas, d_blas, dirty, best_t, normal, gid, *,
                 accept_first: bool = False, cull_backface: bool = True,
                 pack: frame_kernel.FramePack | None = None, lib=None, ops=None):
    """The two-phase finisher over the main pass's outputs, (best_t, normal,
    gid) as ``scene_finish_plain`` gives them. CUDA: csrc/scene_finish.cu
    (``lib``, default the shipped build; ``build.load("scene_finish",
    finish_per_ray=True)`` is the parent's one thread per ray, for checks):
    the compaction of ``dirty`` into a queue ordered by the first geometry
    each dirty ray marches again (``scene_finish_queue``, counted in
    FINISH_QUEUE_LAUNCHES), then the finisher, one thread per queued ray,
    launched over the queue's capacity and reading the live count on the
    device; it updates the (contiguous) outputs in place and returns them
    (counted in FINISH_LAUNCHES). No host sync. CPU: the plain versions in
    the card's order of work (``scene_finish_queue_plain``, then
    ``scene_finish_queued_plain``)."""
    global FINISH_LAUNCHES, FINISH_QUEUE_LAUNCHES
    dev, n = o_blas.device, o_blas.shape[0]
    if dev.type == "cpu":
        return scene_finish_queued_plain(scene, o_blas, d_blas, dirty,
                                         scene_finish_queue_plain(dirty), best_t, normal, gid,
                                         accept_first=accept_first, cull_backface=cull_backface)
    for name, x, dtype in (("dirty", dirty, torch.int32), ("best_t", best_t, torch.float32),
                           ("normal", normal, torch.float32), ("gid", gid, torch.int32)):
        if x.dtype != dtype or x.shape[0] != n or x.device != dev or not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous {dtype} tensor of {n} rows on {dev}")
    if n == 0:
        return best_t, normal, gid
    pack, lib = _prepare(scene, o_blas, pack, lib, "scene_finish")
    o_blas, d_blas = o_blas.contiguous(), d_blas.contiguous()
    queue, words = _finish_scratch(n, dev)
    _raise_on(lib.gprt_scene_finish(
        _ptr(pack.params), _ptr(pack.layout), _ptr(pack.tri), _ptr(o_blas), _ptr(d_blas),
        _ptr(dirty), _ptr(queue), _ptr(words), _ptr(best_t), _ptr(normal), _ptr(gid), n,
        pack.num_geometries, pack.num_materials, _shared(pack), int(accept_first),
        int(cull_backface), frame_kernel.ops_pointer(ops), dev.index, _stream(dev)), lib,
        "two-phase finisher")
    if lib.gprt_finish_compacts():
        FINISH_QUEUE_LAUNCHES += 1
    FINISH_LAUNCHES += 1
    return best_t, normal, gid


def scene_closest_tiles(scene: Scene, o_blas, d_blas, active, t0, *, level: int = 0,
                        accept_first: bool = False, cull_backface: bool = True,
                        two_phase: bool = False, debug_dirty: bool = False,
                        pack: frame_kernel.FramePack | None = None, lib=None, ops=None,
                        finish_lib=None):
    """(best_t, normal, gid) of one traversal pass over (N, 3) BLAS-space
    rays; see ``scene_closest_plain`` for the semantics.

    ``two_phase``: the reference's two-phase form where it splits the pass
    (``two_phase_runs``): ``scene_main_pass``, then ``scene_finish`` (with
    ``finish_lib``, default the shipped csrc/scene_finish.cu build).
    ``debug_dirty``: also return the main pass's (N,) int32 dirty words
    (zeros for a single pass).

    CUDA: launches csrc/scene_kernel.cu on the current stream over the
    buffers of ``pack`` (default: ``frame_kernel.pack_frame(scene)``; pass
    one to reuse it across the passes of a frame; ``lib``, ``ops`` as for
    frame_kernel.render_frame_tiles), a single pass counted in LAUNCHES.
    CPU: runs the plain versions."""
    global LAUNCHES
    _check_rays(o_blas, d_blas, active, t0)
    kw = dict(level=level, accept_first=accept_first, cull_backface=cull_backface)
    if two_phase and two_phase_runs(scene):
        *main, dirty = scene_main_pass(scene, o_blas, d_blas, active, t0, **kw, pack=pack,
                                       lib=lib, ops=ops)
        out = scene_finish(scene, o_blas, d_blas, dirty, *main, accept_first=accept_first,
                           cull_backface=cull_backface, pack=pack, lib=finish_lib, ops=ops)
    elif o_blas.device.type == "cpu":
        out = scene_closest_plain(scene, o_blas, d_blas, active, t0, **kw)
        dirty = torch.zeros(o_blas.shape[0], dtype=torch.int32)
    else:
        *out, _ = _closest_launch(scene, o_blas, d_blas, active, t0, level, accept_first,
                                  cull_backface, False, pack, lib, ops)
        dirty = torch.zeros(o_blas.shape[0], dtype=torch.int32, device=o_blas.device)
        if o_blas.shape[0]:
            LAUNCHES += 1
    return tuple(out) + ((dirty,) if debug_dirty else ())


def sdf_distance(code: int, points, lib=None, ops=None):
    """(N,) distances of SDF code ``code`` at (N, 3) f32 local-space points:
    a check entry (no render path calls it) that holds the device distance
    functions against their plain versions point by point. CUDA: launches
    the probe kernel of csrc/scene_kernel.cu, one thread a point, and counts
    it in PROBE_LAUNCHES (``ops``: the counting build's FLOP counter, as for
    ``scene_closest_tiles``); CPU: geometry/sdf.DISTANCE_FUNCTIONS[code]."""
    global PROBE_LAUNCHES
    from gpuraytracer_tpu_torch.geometry import sdf

    if points.dim() != 2 or points.shape[1] != 3 or points.dtype != torch.float32:
        raise ValueError(f"points: expected (N, 3) float32, got {tuple(points.shape)} "
                         f"{points.dtype}")
    if int(code) not in frame_kernel.KERNEL_SDF_CODES:
        raise ValueError(f"distance code {code} has no device function")
    dev = points.device
    if dev.type == "cpu":
        return sdf.DISTANCE_FUNCTIONS[int(code)](points)
    if dev.type != "cuda":
        raise ValueError(f"no scene kernel for device {dev}")
    from gpuraytracer_tpu_torch.kernels import build

    lib = lib if lib is not None else build.load("scene_kernel")
    points = points.contiguous()
    out = torch.empty(points.shape[0], dtype=torch.float32, device=dev)
    if points.shape[0] == 0:
        return out
    _raise_on(lib.gprt_sdf_distance(int(code), _ptr(points), _ptr(out), points.shape[0],
                                    frame_kernel.ops_pointer(ops), dev.index, _stream(dev)),
              lib, "distance probe")
    PROBE_LAUNCHES += 1
    return out


def shadow_queue_plain(pack: frame_kernel.FramePack, rays, active, seg: int, *,
                       merged: bool = False):
    """Plain version of the occlusion repair (``shadow_queue``): each
    segment of ``seg`` queue entries is one accept-first
    ``scene_closest_plain`` pass at its level's plain budgets, from t = 0
    to RAY_TMAX, on the scene unpacked from the pack; ``merged``: the
    merged instantiation's plain version, ``occluded_merged_plain``."""
    scene = frame_kernel.unpack_frame(pack)
    occ = torch.zeros(rays.shape[0], dtype=torch.int32, device=rays.device)
    t0 = torch.full((seg,), RAY_TMAX, dtype=torch.float32, device=rays.device)
    for k in range(rays.shape[0] // seg):
        part = slice(k * seg, (k + 1) * seg)
        if merged:
            hit = occluded_merged_plain(scene, rays[part, :3], rays[part, 3:], active[part], t0,
                                        level=k)
        else:
            hit = scene_closest_plain(scene, rays[part, :3], rays[part, 3:], active[part], t0,
                                      level=k, accept_first=True)[2] >= 0
        occ[part] = (hit & active[part]).to(torch.int32)
    return occ


def shadow_queue(pack: frame_kernel.FramePack, rays, active, seg: int, lib=None, ops=None):
    """The deferred-shadow mode's occlusion repair (the reference's
    _shadow_queue_kernel, frame_kernel.py:1016): (N,) int32, 1 where the
    queued shadow ray is occluded. ``rays`` (N, 6) f32 (BLAS-space origin,
    direction) and ``active`` (N,) bool hold one segment of ``seg``
    entries per shadowed level, in level order; an entry's level is its
    index // seg, and its occlusion query runs at full budgets with that
    level's knobs. CUDA: the queue entry of csrc/scene_kernel.cu (the
    deferred mode's repair, ``shadow_queue_planes``) with each segment as a
    level's plane and every entry live, one thread per entry, its merged
    instantiation where frame_kernel.merges says so (counted in
    QUEUE_LAUNCHES or MERGED_QUEUE_LAUNCHES); CPU: the plain version."""
    global QUEUE_LAUNCHES, MERGED_QUEUE_LAUNCHES
    n = rays.shape[0]
    dev = rays.device
    if rays.dtype != torch.float32 or rays.dim() != 2 or rays.shape[1] != 6 \
            or not rays.is_contiguous():
        raise ValueError(f"rays: expected a contiguous (N, 6) float32 tensor, got "
                         f"{tuple(rays.shape)} {rays.dtype}")
    if active.dtype != torch.bool or tuple(active.shape) != (n,) or active.device != dev \
            or not active.is_contiguous():
        raise ValueError(f"active: expected a contiguous ({n},) bool tensor on {dev}")
    if seg <= 0 or n % seg:
        raise ValueError(f"{n} queue entries are not whole segments of {seg}")
    frame_kernel.check_pack(pack)
    if pack.params.device != dev:
        raise ValueError(f"pack on {pack.params.device}, rays on {dev}")
    if dev.type == "cpu":
        return shadow_queue_plain(pack, rays, active, seg)
    if dev.type != "cuda":
        raise ValueError(f"no scene kernel for device {dev}")
    from gpuraytracer_tpu_torch.kernels import build

    lib = lib if lib is not None else build.load("scene_kernel")
    occ = torch.empty(n, dtype=torch.int32, device=dev)
    merged = frame_kernel.merges(pack)
    null = ctypes.c_void_p(None)
    _raise_on(lib.gprt_shadow_queue(
        _ptr(pack.params), _ptr(pack.layout), _ptr(pack.tri), _ptr(rays), null, null,
        _ptr(active), null, _ptr(occ), seg, n // seg, seg, pack.num_geometries, pack.num_materials,
        _shared(pack), int(merged), frame_kernel.ops_pointer(ops), dev.index, _stream(dev)), lib,
        "shadow queue kernel")
    if merged:
        MERGED_QUEUE_LAUNCHES += 1
    else:
        QUEUE_LAUNCHES += 1
    return occ


def shadow_queue_planes_plain(pack: frame_kernel.FramePack, rays, idx, count, *,
                              merged: bool = False):
    """Plain version of ``shadow_queue_planes``: per shadowed level k, one
    accept-first ``scene_closest_plain`` pass (``occluded_merged_plain``
    where ``merged``) at level k's plain budgets over the shadow rays of the
    first count[k] pixels of idx[k], written into level k's plane; zeros
    elsewhere, and everywhere where a count passed the capacity. It runs the
    whole traversal from geometry 0 and reads no march record: the
    yardstick that the resumed repair is held to."""
    nsl, cap = idx.shape
    occ = torch.zeros(rays.shape[:-1], dtype=torch.int32, device=rays.device)
    counts = count.tolist()
    if max(counts) > cap:
        return occ
    scene = frame_kernel.unpack_frame(pack)
    for k, n in enumerate(counts):
        pix = idx[k, :n].to(torch.int64)
        r = rays[k].reshape(-1, 6)[pix]
        active = torch.ones(n, dtype=torch.bool, device=rays.device)
        t0 = torch.full((n,), RAY_TMAX, dtype=torch.float32, device=rays.device)
        if merged:
            hit = occluded_merged_plain(scene, r[:, :3], r[:, 3:], active, t0, level=k)
        else:
            hit = scene_closest_plain(scene, r[:, :3], r[:, 3:], active, t0, level=k,
                                      accept_first=True)[2] >= 0
        occ[k].view(-1)[pix] = hit.to(torch.int32)
    return occ


def shadow_queue_planes(pack: frame_kernel.FramePack, rays, idx, count, rec=None, lib=None,
                        ops=None):
    """The deferred mode's occlusion repair over its device queues
    (frame_kernel.render_frame_deferred_queue): ``rays`` (D-1, H, W, 6) f32,
    the main pass's shadow-ray planes; ``idx`` (D-1, cap) int32, each
    shadowed level's queued pixel indices, and ``count`` (D-1,) int32 their
    counts; ``rec`` (D-1, H, W, 4) int32, the defer entry's march record at
    each queued pixel (DeferQueue.rec; required on a GPU). Returns
    (D-1, H, W) int32 occlusion planes: 1 where a queued pixel's shadow ray
    is occluded at full budgets, 0 where it is not. Only the queued pixels
    are defined (what frame_kernel.frame_compose reads); where a count
    passed cap, none (the gated plain frame replaces the image). CUDA: the
    queue entry of csrc/scene_kernel.cu, launched over the capacity of every
    level, reading the counts on the device (no host sync); each query
    continues the march that the defer entry's cap stopped from its record
    and then takes the geometries after it (the answer is the whole
    traversal's: ``build.load("scene_kernel", repair_full=True)`` runs the
    whole traversal, for checks); its merged instantiation where
    frame_kernel.merges says so (counted in QUEUE_LAUNCHES or
    MERGED_QUEUE_LAUNCHES). CPU: the plain version, which needs no
    record."""
    global QUEUE_LAUNCHES, MERGED_QUEUE_LAUNCHES
    dev = rays.device
    if rays.dtype != torch.float32 or rays.dim() != 4 or rays.shape[-1] != 6 \
            or not rays.is_contiguous():
        raise ValueError(f"rays: expected contiguous (D-1, H, W, 6) float32 planes, got "
                         f"{tuple(rays.shape)} {rays.dtype}")
    nsl = rays.shape[0]
    if idx.dtype != torch.int32 or idx.dim() != 2 or idx.shape[0] != nsl or idx.device != dev \
            or not idx.is_contiguous():
        raise ValueError(f"idx: expected a contiguous ({nsl}, cap) int32 tensor on {dev}")
    if count.dtype != torch.int32 or tuple(count.shape) != (nsl,) or count.device != dev \
            or not count.is_contiguous():
        raise ValueError(f"count: expected a contiguous ({nsl},) int32 tensor on {dev}")
    want = tuple(rays.shape[:-1]) + (frame_kernel.MARCH_RECORD_WORDS,)
    if (rec is not None or dev.type != "cpu") and (
            rec is None or tuple(rec.shape) != want or rec.dtype != torch.int32
            or rec.device != dev or not rec.is_contiguous()):
        raise ValueError(f"rec: expected the defer entry's contiguous {want} int32 march "
                         f"records on {dev}")
    frame_kernel.check_pack(pack)
    if pack.params.device != dev:
        raise ValueError(f"pack on {pack.params.device}, rays on {dev}")
    if dev.type == "cpu":
        return shadow_queue_planes_plain(pack, rays, idx, count)
    if dev.type != "cuda":
        raise ValueError(f"no scene kernel for device {dev}")
    from gpuraytracer_tpu_torch.kernels import build

    lib = lib if lib is not None else build.load("scene_kernel")
    occ = torch.empty(rays.shape[:-1], dtype=torch.int32, device=dev)
    merged = frame_kernel.merges(pack)
    _raise_on(lib.gprt_shadow_queue(
        _ptr(pack.params), _ptr(pack.layout), _ptr(pack.tri), _ptr(rays), _ptr(idx), _ptr(count),
        ctypes.c_void_p(None), _ptr(rec), _ptr(occ), rays.shape[1] * rays.shape[2], nsl,
        idx.shape[1],
        pack.num_geometries, pack.num_materials, _shared(pack), int(merged),
        frame_kernel.ops_pointer(ops), dev.index, _stream(dev)), lib, "shadow queue kernel")
    if merged:
        MERGED_QUEUE_LAUNCHES += 1
    else:
        QUEUE_LAUNCHES += 1
    return occ
