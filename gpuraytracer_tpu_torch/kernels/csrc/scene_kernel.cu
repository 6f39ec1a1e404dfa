// One traversal pass over every procedural geometry: one thread per ray.
//
// Replaces: gpuraytracer_tpu/kernels/scene_kernel.py scene_closest_tiles /
// _scene_kernel, phase "single" (with _traverse_tile, _local_ray,
// _march_sdf_part, _march_metaballs_part, _metaball_normal,
// _intersect_trimesh_tile, _mt_face): BLAS-space rays
// with an initial bound t0 in; the closest procedural hit (best_t, world
// normal, geometry id; gid -1 where nothing beat t0) out, or accept-first
// occlusion (gid of the first valid hit, best_t 0 there). The wavefront
// (render/trace.py) calls it once per closest pass and once per shadow pass
// over the live lanes of a level, so N varies per call.
//
// The device code is traverse.cuh, the same the frame kernel runs. The TPU
// schedule (VMEM scratch planes, pl.when tile gates, the tile policy) is not
// behaviour and is not carried over.
//
// The two-phase form (scene_closest_tiles(two_phase=True), the reference's
// phases "main" and "finish", scene_kernel.py:2008, :2017): the main pass
// here (scene_kernel<true>) caps every SDF and metaball march at
// PHASE_BUDGET = 64 steps, sets the geometry's bit of the ray's dirty word
// where a capped march ran out below its natural budget, and goes on with
// the next geometry (no kill-on-cap, :1362-1369); the finisher, which
// marches the dirty (ray, geometry) pairs again at the level-0 plain
// budgets over a queue of the dirty rays, is scene_finish.cu. On the TPU
// the split bounded a tile's convoy by its honest work; each thread here
// already ends its own march, so it is ported for the reference's
// semantics (the finisher's level-0 budgets and its post-pass metaball
// step change some answers) and measured, not for speed.
//
// What bounds it on an H100: the same divergent per-lane march loops as the
// frame kernel (ALU- and latency-bound); its bytes are 29 per ray in (o, d,
// active, t0) and 20 out (best_t, normal, gid). What the design does about
// it: the traversal's parameters sit in shared memory per block (the
// shading blocks of the buffers are not copied; a scene whose tables do not
// fit there is read in place, kShared), rays are read and written once, and
// every march stops early by the reference's result-exact rules. The
// wavefront keeps rays in pixel order, so a warp's rays stay spatially
// coherent; sorting rays by direction or geometry is left to later work. A
// persistent form (resident blocks, warps taking 32-ray batches from a
// global counter) read 9-13% slower on an H100 at the same occupancy
// (PERF.md).
//
// Inputs: params (f32) and layout (int32) as kernels/frame_kernel.py
// pack_frame builds them; tri, the F x 12 mesh face table (null without
// meshes); o, d (N, 3) f32; active (N,) bool; t0 (N,) f32. The repair
// queue entries take their own inputs (below).
// The C entry returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "traverse.cuh"

namespace gprt {

// kMain: the two-phase main pass (marches capped by caps, the dirty word
// written to dirty_out); else the single pass (caps and dirty_out unread).
// kShared: the traversal's tables in shared memory (else read in place).
template <bool kMain, bool kShared>
__global__ void __launch_bounds__(128)
    scene_kernel(const float* __restrict__ params, const int* __restrict__ layout,
                 const float* __restrict__ tri, const float* __restrict__ o, const float* __restrict__ d,
                 const bool* __restrict__ active, const float* __restrict__ t0,
                 float* __restrict__ best_t, float* __restrict__ normal, int* __restrict__ gid,
                 int* __restrict__ dirty_out, int n, int G, int M, int level, int accept_first,
                 int cull, CapSpec caps, unsigned long long* ops) {
  extern __shared__ float smem[];
  counters_begin(ops);
  const Scene s = load_scene<false, kShared>(params, layout, tri, G, M, smem);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const V3 ob = v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]);
    const V3 dir = v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]);
    Hit h{t0[i], -1, v3(0.0f, 0.0f, 0.0f)};
    unsigned dirty = 0;
    if (active[i]) {
      if (accept_first) {
        h.gid = occluded_procedural<kMain, false>(s, ob, dir, h.t, level, caps, &dirty);
        if (h.gid >= 0) h.t = 0.0f;
      } else {
        closest_procedural<kMain, false>(s, ob, dir, level, cull != 0, &h, caps, &dirty);
      }
    }
    best_t[i] = h.t;
    normal[3 * i] = h.n.x;
    normal[3 * i + 1] = h.n.y;
    normal[3 * i + 2] = h.n.z;
    gid[i] = h.gid;
    if (kMain) dirty_out[i] = (int)dirty;
  }
  counters_end(ops);
}

// The repair's query on the shadow ray r (BLAS-space origin, direction) at
// `level`: kResume, the traversal resumed from the defer entry's march
// record (traverse.cuh occluded_resumed); else the plain accept-first
// traversal from geometry 0. kMerged: merged SDF marches.
template <bool kMerged, bool kResume>
__device__ __forceinline__ bool queue_occluded(const Scene& s, const float* r, int level,
                                               const MarchRecord* rec) {
  const V3 ob = v3(r[0], r[1], r[2]), dir = v3(r[3], r[4], r[5]);
  if (kResume) return occluded_resumed<kMerged>(s, ob, dir, kRayTMax, level, *rec);
  return kMerged ? occluded_merged(s, ob, dir, kRayTMax, level)
                 : occluded_procedural(s, ob, dir, kRayTMax, level) >= 0;
}

// The deferred-shadow mode's occlusion repair (replaces the reference's
// frame_kernel._shadow_queue_kernel, frame_kernel.py:1016) over the defer
// main pass's device queues (render_frame_deferred): block row blockIdx.y
// is shadowed level k, whose queue idx[k * cap ...] holds count[k] pixel
// indices (stored up to cap). Launched over the capacity: the live count is
// read from the device, and a block past it (every block, where any level's
// count passed cap: the gated plain frame then replaces the image) returns
// before loading the scene. A live slot answers whether its pixel's shadow
// ray in level k's ray plane (rays: (nsl, npix, 6) f32, BLAS-space origin
// and direction) is occluded from 0 to RAY_TMAX at that level's budgets
// (the occluded-on-cap rule of the plain kernel included), and writes the
// answer to its pixel in level k's occlusion plane (occ: (nsl, npix)
// int32; the other pixels are not written, and the composition reads only
// the queued ones). kResume: the traversal continues from the pixel's march
// record in level k's record plane (march: (nsl, npix) MarchRecord, which
// the defer entry wrote where the status is unknown): the march that the
// cap stopped goes on from its carries, and the geometries before it are
// not tested again (their answer, no hit, is known); else it runs whole
// from geometry 0 (the -DGPRT_REPAIR_FULL build's queue form, the parent's
// repair, kept for checks). Without idx and count every pixel of every
// level is a live slot (cap = npix), and active ((nsl, npix) bool, may be
// null) clears the answer of an inactive one (scene_kernel.shadow_queue's
// flat queue of segments; no record, the whole traversal). Bound like the
// scene kernel: divergent marches (the lanes whose capped occlusion march
// found nothing, the long tail); 44 bytes in (the ray, the record, the
// index) and 4 out per entry. kMerged: the occlusion traversal merges the
// SDF marches (GPURT_MERGED_SHADOW; the reference allocates the merged
// banks for this kernel, frame_kernel.py:1259).
template <bool kMerged, bool kShared, bool kResume>
__global__ void __launch_bounds__(128)
    shadow_queue_kernel(const float* __restrict__ params, const int* __restrict__ layout,
                        const float* __restrict__ tri, const float* __restrict__ rays,
                        const int* __restrict__ idx, const int* __restrict__ count,
                        const bool* __restrict__ active, const MarchRecord* __restrict__ march,
                        int* __restrict__ occ, int npix, int nsl, int cap, int G, int M,
                        unsigned long long* ops) {
  const int level = blockIdx.y;
  int live = cap;
  if (count != nullptr) {
    bool over = false;
    for (int k = 0; k < nsl; ++k) over = over || count[k] > cap;
    live = over ? 0 : count[level];
  }
  if ((int)(blockIdx.x * blockDim.x) >= live) return;
  extern __shared__ float smem[];
  counters_begin(ops);
  const Scene s = load_scene<false, kShared>(params, layout, tri, G, M, smem);
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot < live) {
    const size_t pix =
        (size_t)level * npix + (idx != nullptr ? idx[(size_t)level * cap + slot] : slot);
    const bool on = active == nullptr || active[pix];
    GPRT_SIMT_BUCKET(2 * level + 1);
    occ[pix] = on && queue_occluded<kMerged, kResume>(s, rays + 6 * pix, level,
                                                       kResume ? march + pix : nullptr)
                   ? 1
                   : 0;
  }
  counters_end(ops);
}

// Check entry, not on any render path: the distance function of SDF code
// `code` at n local-space points (N, 3), one thread a point, for the
// point-by-point comparison of the device distance functions with their
// plain versions (the card's side of the parity bisect's distance stage).
// `ops`: the counting build's FLOP total, else unused.
__global__ void __launch_bounds__(128)
    sdf_probe(int code, const float* __restrict__ p, float* __restrict__ out, int n,
              unsigned long long* ops) {
  counters_begin(ops);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = sdf_distance(code, v3(p[3 * i], p[3 * i + 1], p[3 * i + 2]));
  counters_end(ops);
}

}  // namespace gprt

// Checks the device and the ray count and takes the dynamic shared memory
// `kernel` needs: the traversal prefix's bytes where the host put the
// tables in shared memory (`shared`), else none.
template <typename Kernel>
static cudaError_t setup(Kernel kernel, int n, int G, int M, int shared, int device,
                         size_t* shmem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaErrorInvalidValue;
  if (GPRT_COUNTING && !shared) return cudaErrorNotSupported;
  *shmem = shared ? gprt::shared_bytes(false, G, M) : 0;
  return gprt::reserve_shared(kernel, *shmem, device);
}

// ops: a device counter that the counting builds add to (-DGPRT_COUNT_OPS:
// the pass's f32 FLOPs; -DGPRT_COUNT_SIMT: 2 x 16 + 1 SIMT counters); the
// default build ignores it. dirty: null for the single pass; else the
// two-phase main pass's (N,) int32 dirty words, its marches capped at
// sdf_cap / mb_cap steps. shared: the tables in shared memory.
extern "C" int gprt_scene_closest(const float* params, const int* layout, const float* tri,
                                  const float* o, const float* d, const bool* active, const float* t0,
                                  float* best_t, float* normal, int* gid, int* dirty, int n,
                                  int num_geometries, int num_materials, int shared, int level,
                                  int accept_first, int cull, int sdf_cap, int mb_cap,
                                  unsigned long long* ops, int device, void* stream) {
  const auto kernel = GPRT_PICK2(gprt::scene_kernel, dirty != nullptr, shared);
  size_t shmem;
  cudaError_t err = setup(kernel, n, num_geometries, num_materials, shared, device, &shmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(n + 127) / 128, 128, shmem, (cudaStream_t)stream>>>(
      params, layout, tri, o, d, active, t0, best_t, normal, gid, dirty, n, num_geometries,
      num_materials, level, accept_first, cull, gprt::CapSpec{sdf_cap, mb_cap}, ops);
  return (int)cudaGetLastError();
}

// `kernel`'s resident blocks per SM and in all as the launchers launch it
// (a report; nothing is launched).
template <typename Kernel>
static int residency(Kernel kernel, int G, int M, int shared, int device, int* per_sm,
                     int* total) {
  size_t shmem;
  cudaError_t err = setup(kernel, 1, G, M, shared, device, &shmem);
  if (err != cudaSuccess) return (int)err;
  return (int)gprt::resident_blocks(kernel, shmem, device, per_sm, total);
}

// The repair's instantiation: merged occlusion marches or not, the tables'
// layout, and the traversal resumed from the defer entry's march records
// (the queue form) or whole (the flat form; every form in the
// -DGPRT_REPAIR_FULL build).
template <bool kMerged, bool kResume>
static auto repair_layout(bool shared) {
#if GPRT_COUNTING
  (void)shared;
  return gprt::shadow_queue_kernel<kMerged, true, kResume>;
#else
  return shared ? gprt::shadow_queue_kernel<kMerged, true, kResume>
                : gprt::shadow_queue_kernel<kMerged, false, kResume>;
#endif
}
static auto repair_entry(bool merged, bool shared, bool resume) {
#ifdef GPRT_REPAIR_FULL
  resume = false;
#endif
  if (merged) {
    return resume ? repair_layout<true, true>(shared) : repair_layout<true, false>(shared);
  }
  return resume ? repair_layout<false, true>(shared) : repair_layout<false, false>(shared);
}

// The entries whose residency gprt_scene_residency reports: the pass and
// the two-phase main pass as gprt_scene_closest launches them, the repair
// (its queue form) and its instantiation with merged occlusion marches as
// gprt_shadow_queue launches them.
enum ResidencyEntry { kEntryPass = 0, kEntryMainPass, kEntryRepair, kEntryRepairMerged };

// The resident blocks per SM and in all of one ResidencyEntry.
extern "C" int gprt_scene_residency(int num_geometries, int num_materials, int shared, int entry,
                                    int device, int* per_sm, int* total) {
  const int G = num_geometries, M = num_materials;
  switch (entry) {
    case kEntryPass:
    case kEntryMainPass:
      return residency(GPRT_PICK2(gprt::scene_kernel, entry == kEntryMainPass, shared), G, M,
                       shared, device, per_sm, total);
    case kEntryRepair:
    case kEntryRepairMerged:
      return residency(repair_entry(entry == kEntryRepairMerged, shared, true), G, M, shared,
                       device, per_sm, total);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The repair: rays (nsl, npix, 6), idx (nsl, cap) int32 and count (nsl,)
// int32 (both null: every pixel, cap = npix), active (nsl, npix) bool (may
// be null), march (nsl, npix) MarchRecord (16 bytes each; the queue form
// only: with it the traversal resumes from the records, except in the
// -DGPRT_REPAIR_FULL build), occ (nsl, npix) int32; a grid of cap / 128
// blocks per level. ops and shared as for gprt_scene_closest; merged:
// launch the instantiation with merged occlusion marches.
extern "C" int gprt_shadow_queue(const float* params, const int* layout, const float* tri,
                                 const float* rays, const int* idx, const int* count,
                                 const bool* active, const void* march, int* occ, int npix,
                                 int nsl, int cap, int num_geometries, int num_materials,
                                 int shared, int merged, unsigned long long* ops, int device,
                                 void* stream) {
  if (npix <= 0 || nsl <= 0 || (idx == nullptr) != (count == nullptr)
      || (idx == nullptr && (cap != npix || march != nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const auto kernel = repair_entry(merged, shared, march != nullptr);
  size_t shmem;
  cudaError_t err = setup(kernel, cap, num_geometries, num_materials, shared, device, &shmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((cap + 127) / 128, nsl), 128, shmem, (cudaStream_t)stream>>>(
      params, layout, tri, rays, idx, count, active,
      static_cast<const gprt::MarchRecord*>(march), occ, npix, nsl, cap, num_geometries,
      num_materials, ops);
  return (int)cudaGetLastError();
}

extern "C" int gprt_sdf_distance(int code, const float* p, float* out, int n,
                                 unsigned long long* ops, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || code < 0 || code > 8) return (int)cudaErrorInvalidValue;
  gprt::sdf_probe<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(code, p, out, n, ops);
  return (int)cudaGetLastError();
}

extern "C" const char* gprt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
