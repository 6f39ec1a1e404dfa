// Per-ray traversal over the procedural geometries, shared by the frame
// kernel (frame_kernel.cu) and the scene kernel (scene_kernel.cu), so the
// two cannot drift apart.
//
// Replaces the traversal of the reference's Pallas scene kernel
// (gpuraytracer_tpu/kernels/scene_kernel.py: _traverse_tile, _local_ray,
// _march_sdf_part, _march_metaballs_part, _metaball_normal) with the
// semantics of its XLA path (accel/traverse.py), which rendered every
// golden: every geometry in definition order (layout.traversal_order is a
// cost choice of the TPU tiles and is not followed; the metaball march
// step depends on the running best t, so the order can move pixels),
// each behind its BLAS-space slab gate against the running best t; the
// clusters of the layout are conservative gates and are not evaluated.
// Closest: strict-< reduction, the winning march's normal computed once
// at its hit. Accept-first: the first valid (or capped) hit ends the
// search. AABB-windowed codes (the extension fractals; the per-geometry
// flag that pack_frame sets from geometry/sdf.AABB_WINDOWED_CODES) skip the
// back-face cull and march only inside their local unit box, over-relaxed
// with their own knobs; every march takes its geometry's budget for the
// level. Triangle meshes (the mesh body, scene_kernel._mt_face /
// _intersect_trimesh_tile) run Möller–Trumbore over their rows of the face
// table. This is the device form of geometry/registry.py's table.
//
// The compacted frame modes' main passes run the same traversal capped
// (template parameter kCaps, the reference's budget_cap, mb_budget_cap,
// dirty_ref and kill_on_cap of _traverse_tile): a march takes the smaller
// of its cap and its plain budget, reports occluded on a spent budget only
// where that budget is the plain one (scene_kernel.py:1479-1505), and a
// march that spends a capped budget below the geometry's natural one sets
// the geometry's bit of the lane's dirty mask (:1506-1529) and ends the
// lane's traversal (kill-on-cap, :1362-1369). The plain instantiation
// carries no cap and no mask. The two-phase scene pass's main pass runs
// the capped traversal without the kill (kKill), and finish_procedural is
// its finisher. occluded_merged is the accept-first traversal with the SDF
// marches merged (GPURT_MERGED_SHADOW). The defer entry's capped occlusion
// traversal also keeps the record of the march that its cap stopped
// (kSave), and the occlusion repair continues from it (occluded_resumed)
// instead of running the traversal again from geometry 0.
//
// Parameters: the f32 and int32 buffers of kernels/frame_kernel.py
// pack_frame, copied to shared memory once per block (load_scene): the
// whole buffers for the frame kernel, only their traversal prefix for the
// scene kernel. A scene whose copy would not fit in a block's shared
// memory (past 227 KB on an H100: about 1,410 geometries for the frame
// kernel) is read from global memory instead: the host picks this layout
// once per launch from the sizes (kernels/frame_kernel.py
// tables_in_shared), launches the kernels' kShared = false instantiation
// and takes no dynamic shared memory. The F x 12 face table stays in global
// memory and is read through the read-only cache: faces are many and read
// once per ray, and shared memory keeps only what every ray of the block
// reads. (The megakernel's pass and mesh entries, csrc/megakernel.cu, stage
// a gated mesh's rows in shared memory and pass their own mesh body.)
#pragma once

#include <cuda_runtime.h>

#include "frame_math.cuh"

namespace gprt {

constexpr int kFHeader = 12;
constexpr int kIHeader = 8;
constexpr int kGeoStride = 12;
constexpr int kGeoWindowed = 9;    // column of the AABB-windowed flag
constexpr int kGeoFaceStart = 10;  // a mesh's first row in the face table
constexpr int kGeoFaceCount = 11;  // and its number of faces
constexpr int kFaceStride = 12;    // v0, e1, e2, n
constexpr float kRayTMax = 10000.0f;
constexpr int kMetaballSteps = 128;

// Step caps of a capped traversal: SDF marches (INT_MAX: none), metaball
// marches (kMetaballSteps: none).
struct CapSpec {
  int sdf;
  int mb;
};

// What an intersector reports: a hit, and a spent capped budget that marks
// the lane dirty (both at once for a capped occlusion march at its plain
// budget).
enum IntersectBits { kHitBit = 1, kDirtyBit = 2 };

// Geometry -> bit of the dirty mask (scene_kernel._dirty_bit): geometries
// past 31 share bit 31.
__device__ __forceinline__ unsigned dirty_bit(int g) { return 1u << (g < 31 ? g : 31); }

enum Kind { kAnalytic = 0, kVolumetric = 1, kSignedDistance = 2, kTriangle = 3 };

struct Scene {
  // elapsed, then relax and fail scale of radiance / occlusion marches for
  // the reference codes (1..4) and the extension fractals (5..8)
  const float* hdr;
  const float* b2l;     // G x 12 (rows 0..2 of blas_to_local)
  const float* l2b;     // G x 9  (rotation of local_to_blas)
  const float* sscale;  // G
  const float* aabb;    // G x 6
  const float* mb;      // 3 x 4
  const float* mat;     // M x 8: albedo rgba, refl, diffuse, specular, power
  const float* p2w;     // 4 x 4 row-vector projection_to_world
  const float* cvec;    // 8 x 4: cam, light, ambient, diffuse, blas, plane o, plane s
  // G x 12: kind, code, budgets r0 r1 s0 s1, capped s0 s1, natural, windowed,
  // face start, face count
  const int* geo;
  const int* mat_ids;   // G + 1: material slot of each geometry row (plane last)
  const float* tri;     // F x 12 face table in global memory (null without meshes)
  int G, M, plane_gid, has_plane;
};

struct Hit {
  float t;
  int gid;
  V3 n;
};

// The traversal prefix of each buffer (the header, the per-geometry blocks
// and the metaballs; the header and the geometry rows), then the whole.
__host__ __device__ constexpr int traversal_floats(int G) {
  return kFHeader + G * (12 + 9 + 1 + 6) + 12;
}
__host__ __device__ constexpr int traversal_ints(int G) { return kIHeader + kGeoStride * G; }
__host__ __device__ constexpr int param_floats(int G, int M) {
  return traversal_floats(G) + M * 8 + 16 + 32;
}
__host__ __device__ constexpr int layout_ints(int G) { return traversal_ints(G) + G + 1; }

// Bytes of shared memory load_scene<kShading> fills.
__host__ __device__ constexpr size_t shared_bytes(bool shading, int G, int M) {
  return 4 * (size_t)(shading ? param_floats(G, M) + layout_ints(G)
                              : traversal_floats(G) + traversal_ints(G));
}

// Lets `kernel` take `bytes` of dynamic shared memory: past the default 48
// KB it opts in, up to the device's per-block limit (227 KB on an H100).
template <typename Kernel>
__host__ cudaError_t reserve_shared(Kernel kernel, size_t bytes, int device) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int cap = 0;
  cudaError_t err = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (bytes > (size_t)cap) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Blocks of 128 threads of `kernel` that the device keeps resident at once
// with `shmem` bytes of dynamic shared memory each (per SM, and in all).
template <typename Kernel>
__host__ cudaError_t resident_blocks(Kernel kernel, size_t shmem, int device, int* per_sm,
                                     int* total) {
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, 128, shmem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  *total = *per_sm * sms;
  return *total > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// The instantiation of a kernel template, <kShared> (GPRT_PICK1) or <kFlag,
// kShared> (GPRT_PICK2), that the host's flags pick. A counting build
// (-DGPRT_COUNT_OPS, -DGPRT_COUNT_SIMT) compiles the shared-memory layout
// only (it measures scenes whose tables fit there), and its launchers
// refuse the other (GPRT_COUNTING).
#if defined(GPRT_COUNT_OPS) || defined(GPRT_COUNT_SIMT)
#define GPRT_COUNTING 1
#define GPRT_PICK1(Kernel, shared) (Kernel<true>)
#define GPRT_PICK2(Kernel, flag, shared) ((flag) ? Kernel<true, true> : Kernel<false, true>)
#else
#define GPRT_COUNTING 0
#define GPRT_PICK1(Kernel, shared) ((shared) ? Kernel<true> : Kernel<false>)
#define GPRT_PICK2(Kernel, flag, shared)                          \
  ((flag) ? ((shared) ? Kernel<true, true> : Kernel<true, false>) \
          : ((shared) ? Kernel<false, true> : Kernel<false, false>))
#endif


// Points a Scene at the buffers: with kShared, copies them into the block's
// shared memory first (every thread of the block must call it), else reads
// them where they are in global memory. The host picks the instantiation
// once per launch (kShared is a template parameter, so that the shared
// layout's loads stay shared-memory loads). Without kShading only the
// traversal prefix is copied, and the shading blocks (materials, camera,
// light, plane, material slots) are null. The block synchronizes either
// way, which also publishes the counters a counting build reset before the
// call.
template <bool kShading, bool kShared>
__device__ __forceinline__ Scene load_scene(const float* __restrict__ params,
                                            const int* __restrict__ layout,
                                            const float* __restrict__ tri, int G, int M,
                                            float* smem) {
  const int nf = kShading ? param_floats(G, M) : traversal_floats(G);
  const int ni = kShading ? layout_ints(G) : traversal_ints(G);
  const float* fbase = params;
  const int* ibase = layout;
  if (kShared) {
    int* ismem = reinterpret_cast<int*>(smem + nf);
    const int tid = (threadIdx.z * blockDim.y + threadIdx.y) * blockDim.x + threadIdx.x;
    const int nthreads = blockDim.x * blockDim.y * blockDim.z;
    for (int k = tid; k < nf; k += nthreads) smem[k] = params[k];
    for (int k = tid; k < ni; k += nthreads) ismem[k] = layout[k];
    fbase = smem;
    ibase = ismem;
  }
  __syncthreads();
  Scene s;
  s.hdr = fbase;
  s.b2l = s.hdr + kFHeader;
  s.l2b = s.b2l + 12 * G;
  s.sscale = s.l2b + 9 * G;
  s.aabb = s.sscale + G;
  s.mb = s.aabb + 6 * G;
  s.mat = kShading ? s.mb + 12 : nullptr;
  s.p2w = kShading ? s.mat + 8 * M : nullptr;
  s.cvec = kShading ? s.p2w + 16 : nullptr;
  s.geo = ibase + kIHeader;
  s.mat_ids = kShading ? s.geo + kGeoStride * G : nullptr;
  s.G = G;
  s.M = M;
  s.plane_gid = ibase[2];
  s.has_plane = ibase[3];
  s.tri = tri;
  return s;
}

// The lane's index in its warp (blocks of any shape).
__device__ __forceinline__ int lane_id() {
  return (int)(((threadIdx.z * blockDim.y + threadIdx.y) * blockDim.x + threadIdx.x) & 31u);
}

// Appends the lanes of `group` (lanes of one warp that execute this call
// together, the caller among them) to a queue with one atomicAdd on *count.
// Returns the caller's slot, which may lie past the queue's capacity (the
// caller stores only below it; the count still counts it).
__device__ __forceinline__ int group_append(unsigned group, int* count) {
  const int lane = lane_id();
  const int leader = __ffs((int)group) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(group));
  base = __shfl_sync(group, base, leader);
  return base + __popc(group & ((1u << lane) - 1u));
}

// Counts the lanes of `group` (as group_append's) into the histogram bins
// of their keys: one atomicAdd per key among them (__match_any_sync).
__device__ __forceinline__ void group_count(unsigned group, int* bins, int key) {
  const unsigned same = __match_any_sync(group, key);
  if (lane_id() == __ffs((int)same) - 1) atomicAdd(bins + key, __popc(same));
}

// Resets a counting build's counters of the block (before load_scene, whose
// barrier publishes them): the op counter, and the SIMT build's counter
// pointer and every thread's bucket (0 until the thread sets its own).
__device__ __forceinline__ void counters_begin(unsigned long long* ops) {
  const int tid = (threadIdx.z * blockDim.y + threadIdx.y) * blockDim.x + threadIdx.x;
#ifdef GPRT_COUNT_OPS
  if (tid == 0) gprt_block_ops = 0;
#endif
#ifdef GPRT_COUNT_SIMT
  if (tid == 0) gprt_simt_out = ops;
  gprt_simt_bucket[tid] = 0;
#endif
  (void)tid;
  (void)ops;
}

// Adds the block's op count to the launch's total (counting build).
__device__ __forceinline__ void counters_end(unsigned long long* ops) {
#ifdef GPRT_COUNT_OPS
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0 && threadIdx.z == 0) atomicAdd(ops, gprt_block_ops);
#endif
  (void)ops;
}

__device__ __forceinline__ void local_ray(const Scene& s, int g, V3 o, V3 d, V3* ol, V3* dl) {
  GPRT_OPS(18 + 15);
  const float* m = s.b2l + 12 * g;
  *ol = v3(m[0] * o.x + m[1] * o.y + m[2] * o.z + m[3], m[4] * o.x + m[5] * o.y + m[6] * o.z + m[7],
           m[8] * o.x + m[9] * o.y + m[10] * o.z + m[11]);
  *dl = v3(m[0] * d.x + m[1] * d.y + m[2] * d.z, m[4] * d.x + m[5] * d.y + m[6] * d.z,
           m[8] * d.x + m[9] * d.y + m[10] * d.z);
}

// Straight-matrix local -> world normal, normalized by division; a zero
// normal stays zero (the squared length is floored at 1e-30).
__device__ __forceinline__ V3 normal_to_world(const Scene& s, int g, V3 n) {
  GPRT_OPS(15 + 7 + 3);
  const float* m = s.l2b + 9 * g;
  V3 w = v3(m[0] * n.x + m[1] * n.y + m[2] * n.z, m[3] * n.x + m[4] * n.y + m[5] * n.z,
            m[6] * n.x + m[7] * n.y + m[8] * n.z);
  float l = sqrtf(fmaxf(w.x * w.x + w.y * w.y + w.z * w.z, F(1e-30)));
  return v3(w.x / l, w.y / l, w.z / l);
}

// Slab gate of geometry g against [0, t_max] in BLAS space.
__device__ __forceinline__ bool gate(const Scene& s, int g, V3 ob, V3 d, float t_max) {
  GPRT_OPS(3 * 5 + 4);
  const float* a = s.aabb + 6 * g;
  Interval iv = slab(ob, d, v3(a[0], a[1], a[2]), v3(a[3], a[4], a[5]));
  return iv.tmax > iv.tmin && iv.tmax >= 0.0f && iv.tmin <= t_max;
}

__device__ __forceinline__ MarchSpec spec(const Scene& s, int g, bool occlusion, int level,
                                          bool cull, bool windowed) {
  const int* q = s.geo + kGeoStride * g;
  const float* r = s.hdr + (windowed ? 5 : 1);  // relax_r, relax_s, fail_r, fail_s
  MarchSpec m;
  int b = level > 0 ? 1 : 0;
  m.max_steps = occlusion ? q[4 + b] : q[2 + b];
  m.relax = occlusion ? r[1] : r[0];
  m.fail_scale = occlusion ? r[3] : r[2];
  m.capped_hit = occlusion && q[6 + b] != 0;
  m.cull = cull && !windowed;
  m.escape = !windowed;
  return m;
}

// Möller–Trumbore over `count` face rows (v0, e1, e2, n) against the local
// ray over [0, t_max], closest face by a strict <, as
// scene_kernel._mt_face / _intersect_trimesh_tile in the same arithmetic
// order (geometry/trimesh.mt_face is the plain version). det = dot(e1,
// d x e2) > 0 is a front face: the cull keeps det > 1e-12, no cull
// |det| > 1e-12. *nl is the winning face's n. Out of line, so the face loop
// adds no registers to the traversals that never meet a mesh.
__device__ __noinline__ bool intersect_trimesh(const float* __restrict__ tri, int count, V3 o,
                                               V3 d, float t_max, bool cull, float* t_out,
                                               V3* nl) {
  const float eps = F(1e-12);
  float best = kInf;
  int win = -1;
  for (int f = 0; f < count; ++f) {
    const float* r = tri + kFaceStride * f;
    GPRT_OPS(cull ? 14 : 15);
    const float e1x = __ldg(r + 3), e1y = __ldg(r + 4), e1z = __ldg(r + 5);
    const float e2x = __ldg(r + 6), e2y = __ldg(r + 7), e2z = __ldg(r + 8);
    const float pvx = d.y * e2z - d.z * e2y;
    const float pvy = d.z * e2x - d.x * e2z;
    const float pvz = d.x * e2y - d.y * e2x;
    const float det = e1x * pvx + e1y * pvy + e1z * pvz;
    if (!(cull ? det > eps : fabsf(det) > eps)) continue;
    GPRT_OPS(32);
    const float inv = 1.0f / det;
    const float tvx = o.x - __ldg(r), tvy = o.y - __ldg(r + 1), tvz = o.z - __ldg(r + 2);
    const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
    const float qvx = tvy * e1z - tvz * e1y;
    const float qvy = tvz * e1x - tvx * e1z;
    const float qvz = tvx * e1y - tvy * e1x;
    const float v = (d.x * qvx + d.y * qvy + d.z * qvz) * inv;
    const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv;
    if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= 0.0f && t <= t_max && t < best) {
      best = t;
      win = f;
    }
  }
  if (win < 0) return false;
  const float* r = tri + kFaceStride * win;
  *t_out = best;
  *nl = v3(__ldg(r + 9), __ldg(r + 10), __ldg(r + 11));
  return true;
}

// The mesh body of the traversals below (their Mesh parameter): geometry
// g's rows of the global face table, by intersect_trimesh. The megakernel's
// pass entry passes its own (faces staged in shared memory, chunks of faces
// skipped); the frame and scene kernels take this default.
struct GlobalMesh {
  __device__ __forceinline__ bool operator()(const Scene& s, int g, V3 ol, V3 dl, float t_max,
                                             bool cull, float* t, V3* nl) const {
    const int* q = s.geo + kGeoStride * g;
    return intersect_trimesh(s.tri + kFaceStride * q[kGeoFaceStart], q[kGeoFaceCount], ol, dl,
                             t_max, cull, t, nl);
  }
};

// An AABB-windowed code's march window: [max(entry, 0), min(exit, t_max)]
// of the local unit box; false where it is empty (the lane is not marched).
__device__ __forceinline__ bool unit_box_window(V3 ol, V3 dl, float t_max, float* t_lo,
                                                float* t_hi) {
  GPRT_OPS(3 * 5 + 4 + 2);
  Interval w = slab(ol, dl, v3(-1.0f, -1.0f, -1.0f), v3(1.0f, 1.0f, 1.0f));
  *t_lo = nmax(w.tmin, 0.0f);
  *t_hi = nmin(t_max, w.tmax);
  return w.tmax > w.tmin && *t_hi > *t_lo;
}

// Geometry g's intersector on the local ray over [0, t_max]; *nl is the
// local normal of a closed-form or mesh hit (a march's is computed by the
// caller). Returns IntersectBits; kDirtyBit only under kCaps. mesh: the
// mesh body (GlobalMesh, or the megakernel's staged faces). kSave: the
// march runs as march_sdf_saved (march_metaballs<kCarrySave>), which writes
// its carries to *rec where its budget runs out (rec may be null).
template <bool kCaps, typename Mesh = GlobalMesh, bool kSave = false>
__device__ int intersect(const Scene& s, int g, V3 ol, V3 dl, float t_max, bool occlusion,
                         int level, bool cull, CapSpec caps, float* t, V3* nl,
                         const Mesh& mesh = Mesh{}, MarchRecord* rec = nullptr) {
  const int* q = s.geo + kGeoStride * g;
  const int kind = q[0], code = q[1];
  if (kind == kAnalytic) {
    return (code == 0 ? intersect_hollow_aabb(ol, dl, t_max, cull, t, nl)
                      : intersect_spheres(ol, dl, t_max, cull, t, nl)) ? kHitBit : 0;
  }
  if (kind == kVolumetric) {
    const int mb_steps = kCaps && caps.mb < kMetaballSteps ? caps.mb : kMetaballSteps;
    const int r = march_metaballs<kSave ? kCarrySave : kCarryNone>(ol, dl, t_max, s.mb, cull,
                                                                   mb_steps, t, rec);
    if (r == kMarchHit) return kHitBit;
    return kCaps && r == kMarchCapped && mb_steps < kMetaballSteps ? kDirtyBit : 0;
  }
  if (kind == kTriangle) return mesh(s, g, ol, dl, t_max, cull, t, nl) ? kHitBit : 0;
  float t_lo = 0.0f, t_hi = t_max;
  const bool windowed = q[kGeoWindowed] != 0;
  if (windowed && !unit_box_window(ol, dl, t_max, &t_lo, &t_hi)) return 0;
  MarchSpec m = spec(s, g, occlusion, level, cull, windowed);
  bool marks_dirty = false;
  if (kCaps) {
    // The capped budget; occluded-on-cap only at the plain budget; the
    // dirty bit only where the smaller capped budget of the two kinds of
    // level sits below the natural one (sdf.march_budget, cap_marks_dirty).
    const int plain = m.max_steps;
    m.max_steps = min(caps.sdf, plain);
    m.capped_hit = m.capped_hit && m.max_steps == plain;
    marks_dirty = min(caps.sdf, q[occlusion ? 5 : 3]) < q[8];
  }
  const int r = kSave ? march_sdf_saved(code, ol, dl, t_lo, t_hi, s.sscale[g], m, t, rec)
                      : march_sdf(code, ol, dl, t_lo, t_hi, s.sscale[g], m, t);
  if (!kCaps) return march_hit(r, m) ? kHitBit : 0;
  return (march_hit(r, m) ? kHitBit : 0) | (r == kMarchCapped && marks_dirty ? kDirtyBit : 0);
}

// The world normal of march geometry g's hit at t on BLAS-space ray (ob, d).
__device__ __forceinline__ V3 march_normal(const Scene& s, int g, V3 ob, V3 d, float t) {
  V3 ol, dl;
  local_ray(s, g, ob, d, &ol, &dl);
  V3 pos = along(ol, t, dl);
  V3 nl = s.geo[kGeoStride * g] == kVolumetric ? metaballs_normal(pos, s.mb)
                                               : hit_normal(s.geo[kGeoStride * g + 1], pos);
  return normal_to_world(s, g, nl);
}

// Closest procedural hit over BLAS-space ray (ob, d): h holds the running
// best (the plane's hit, or the caller's bound with gid -1) and takes any
// geometry whose hit is strictly closer. kCaps: marches capped by caps; a
// march that marks the lane dirty ORs its bit into *dirty and gives no hit.
// kKill (the compacted frame modes' kill-on-cap) then ends the traversal,
// and a dirty lane's normal is not computed (its hit is not used); without
// it (the two-phase main pass, whose traversal goes on, scene_kernel.py:
// 1362-1369) the later geometries run against the unchanged best t. mesh:
// the mesh body (intersect's). kSave: the marches run as intersect's kSave
// form without a record (the defer entry's, whose occlusion marches keep
// one: one copy of the march serves both traversals).
template <bool kCaps = false, bool kKill = true, typename Mesh = GlobalMesh, bool kSave = false>
__device__ void closest_procedural(const Scene& s, V3 ob, V3 d, int level, bool cull, Hit* h,
                                   CapSpec caps = CapSpec{}, unsigned* dirty = nullptr,
                                   const Mesh& mesh = Mesh{}) {
  bool deferred_normal = false;
  for (int g = 0; g < s.G; ++g) {
    float running = fminf(h->t, kRayTMax);
    if (!gate(s, g, ob, d, running)) continue;
    V3 ol, dl;
    local_ray(s, g, ob, d, &ol, &dl);
    float t = kInf;
    V3 nl = v3(0.0f, 0.0f, 0.0f);
    const int kind = s.geo[kGeoStride * g];
    const bool marched = kind == kVolumetric || kind == kSignedDistance;
    const int r = intersect<kCaps, Mesh, kSave>(s, g, ol, dl, running, false, level, cull, caps,
                                                &t, &nl, mesh);
    if (kCaps && (r & kDirtyBit)) {
      *dirty |= dirty_bit(g);
      if (kKill) return;
    }
    if ((r & kHitBit) && t < h->t) {
      h->t = t;
      h->gid = g;
      deferred_normal = marched;
      if (!marched) h->n = normal_to_world(s, g, nl);
    }
  }
  // The winning march's normal, at its own hit, computed once.
  if (deferred_normal) h->n = march_normal(s, h->gid, ob, d, h->t);
}

// Accept-first occlusion over [0, t_max] with back-face culling: the first
// geometry with a valid (or capped) hit, or -1. kCaps, kKill: as in
// closest_procedural; with kKill a march that marks the lane dirty ends the
// search (with its hit, where the occluded-on-cap rule gives one). mesh: as
// in closest_procedural. kSave (with kCaps and kKill, the defer entry): the
// march that ends the search writes its record to *rec, with its geometry.
// first: the search starts at that geometry (the repair's, past the one
// whose march it resumed).
template <bool kCaps = false, bool kKill = true, typename Mesh = GlobalMesh, bool kSave = false>
__device__ int occluded_procedural(const Scene& s, V3 ob, V3 d, float t_max, int level,
                                   CapSpec caps = CapSpec{}, unsigned* dirty = nullptr,
                                   const Mesh& mesh = Mesh{}, MarchRecord* rec = nullptr,
                                   int first = 0) {
  static_assert(!kSave || (kCaps && kKill), "a record is kept of the march that ends the search");
  for (int g = first; g < s.G; ++g) {
    if (!gate(s, g, ob, d, t_max)) continue;
    V3 ol, dl;
    local_ray(s, g, ob, d, &ol, &dl);
    float t;
    V3 nl;
    const int r = intersect<kCaps, Mesh, kSave>(s, g, ol, dl, t_max, true, level, true, caps, &t,
                                                &nl, mesh, rec);
    if (kCaps && (r & kDirtyBit)) {
      *dirty |= dirty_bit(g);
      if (kSave) rec->g = g;
      if (kKill) return (r & kHitBit) ? g : -1;
    }
    if (r & kHitBit) return g;
  }
  return -1;
}

// Gated SDF geometries a lane keeps pending in the merged occlusion march
// (occluded_merged): its banks, each a geometry index, with the geometry's
// SDF code in a 4-bit field of the lane's code word (0xF: an empty bank;
// the codes are 0-8, so up to 8 banks).
constexpr int kMergeWindow = 2;

// The first live bank of a code word, or -1.
__device__ __forceinline__ int first_live_bank(unsigned codes) {
  const unsigned x = ~codes;
  const unsigned live = (x | x >> 1 | x >> 2 | x >> 3) & 0x11111111u;
  return live == 0 ? -1 : (__ffs((int)live) - 1) >> 2;
}

// The first bank of a code word that holds SDF code c, or -1.
__device__ __forceinline__ int bank_of_code(unsigned codes, int c) {
  const unsigned y = codes ^ (0x11111111u * (unsigned)c);
  const unsigned match = ~(y | y >> 1 | y >> 2 | y >> 3) & 0x11111111u;
  return match == 0 ? -1 : (__ffs((int)match) - 1) >> 2;
}

// Accept-first occlusion with the SDF marches merged (the reference's
// _march_sdf_multi, scene_kernel.py:466-705, and its call site :1646-1789,
// under GPURT_MERGED_SHADOW): the closed forms, meshes and metaballs first,
// in definition order; then the gated SDF geometries, each marched as
// occluded_procedural marches it (intersect: the gate, local ray, window,
// escape bound and the level's budget and occluded-on-cap rule, and the same
// march_sdf), until one hits. The answer is the OR over the geometries, so
// it is the sequential one in any order of marches.
//
// The TPU merged its marches to shorten its tile convoys. Here the lanes
// that enter together (__activemask) take turns: a lane's kMergeWindow
// banks hold its next gated SDF geometries in definition order; each turn's
// SDF code is the code of the first bank of the lowest lane that still
// marches (__ballot_sync, __shfl_sync), and every lane with a bank of that
// code marches its first such geometry to the march's end, so that
// sdf_distance runs one case for the warp; the bank then takes the lane's
// next gated geometry. A lane that is done stays in the loop (the turns'
// votes name every lane of the mask) until no lane of the mask marches.
// A march never outlives its turn, so a bank is a geometry index and no
// march state is kept. On an H100, turns of one to 16 samples with each
// march's state in a bank (shared memory or registers) read slower than
// whole marches, 2 banks faster than 4 or 8, and the function inlined
// faster than out of line (PERF.md). first: the geometries before it are
// not tested (occluded_resumed's).
__device__ __forceinline__ bool occluded_merged(const Scene& s, V3 ob, V3 d, float t_max,
                                                int level, int first = 0) {
  const unsigned warp = __activemask();
  bool hit = false;
  for (int g = first; g < s.G && !hit; ++g) {
    if (s.geo[kGeoStride * g] == kSignedDistance || !gate(s, g, ob, d, t_max)) continue;
    V3 ol, dl;
    local_ray(s, g, ob, d, &ol, &dl);
    float t;
    V3 nl;
    hit = (intersect<false>(s, g, ol, dl, t_max, true, level, true, CapSpec{}, &t, &nl) &
           kHitBit) != 0;
  }
  int bank[kMergeWindow];
  unsigned codes = ~0u;
  int next = hit ? s.G : first;  // the next geometry to take into a bank
  // Bank k takes the lane's next gated SDF geometry, if any is left.
  auto refill = [&](int k) {
    for (; next < s.G; ++next) {
      const int* q = s.geo + kGeoStride * next;
      if (q[0] != kSignedDistance || !gate(s, next, ob, d, t_max)) continue;
#pragma unroll
      for (int j = 0; j < kMergeWindow; ++j) {
        if (j == k) bank[j] = next;
      }
      codes = (codes & ~(0xFu << 4 * k)) | ((unsigned)q[1] << 4 * k);
      ++next;
      return;
    }
  };
#pragma unroll
  for (int k = 0; k < kMergeWindow; ++k) refill(k);
  for (;;) {
    const int mine = hit ? -1 : first_live_bank(codes);
    const unsigned want = __ballot_sync(warp, mine >= 0);
    if (want == 0) break;
    const int code = __shfl_sync(warp, mine < 0 ? 0 : (int)(codes >> 4 * mine) & 0xF,
                                 __ffs((int)want) - 1);
    const int k = hit ? -1 : bank_of_code(codes, code);
    if (k < 0) continue;
    int g = 0;
#pragma unroll
    for (int j = 0; j < kMergeWindow; ++j) {
      if (j == k) g = bank[j];
    }
    V3 ol, dl;
    local_ray(s, g, ob, d, &ol, &dl);
    float t;
    V3 nl;
    hit = (intersect<false>(s, g, ol, dl, t_max, true, level, true, CapSpec{}, &t, &nl) &
           kHitBit) != 0;
    codes |= 0xFu << 4 * k;
    if (!hit) refill(k);
  }
  return hit;
}

// The occlusion march of the geometry of march record rec (an SDF or the
// metaballs) on BLAS-space ray (ob, d) over [0, t_max] at the level's full
// budget, as intersect runs it behind the gate, continued from the record:
// kMarchHit where it occludes (a valid crossing, or a spent budget under
// the occluded-on-cap rule), else how it ended (kMarchCapped, kMarchMiss);
// *t the march's t at a crossing or a spent budget.
__device__ __forceinline__ int resumed_march(const Scene& s, V3 ob, V3 d, float t_max, int level,
                                             MarchRecord rec, float* t) {
  const int g = rec.g;
  const int* q = s.geo + kGeoStride * g;
  V3 ol, dl;
  local_ray(s, g, ob, d, &ol, &dl);
  if (q[0] == kVolumetric) {
    return march_metaballs<kCarryResume>(ol, dl, t_max, s.mb, true, kMetaballSteps, t, &rec);
  }
  float t_lo = 0.0f, t_hi = t_max;
  const bool windowed = q[kGeoWindowed] != 0;
  if (windowed && !unit_box_window(ol, dl, t_max, &t_lo, &t_hi)) return kMarchMiss;
  const MarchSpec m = spec(s, g, true, level, true, windowed);
  const int r = march_sdf_resumed(q[1], ol, dl, t_lo, t_hi, s.sscale[g], m, t, rec);
  return march_hit(r, m) ? kMarchHit : r;
}

// The deferred-shadow mode's occlusion repair on a lane whose status the
// defer entry's cap left unknown: the accept-first traversal of
// occluded_procedural (kMerged: occluded_merged) at the level's full
// budgets, from where the capped search stopped. rec is that search's
// record (MarchRecord): the geometry whose march the cap stopped, and the
// march's carries. Every geometry before it was gated and tested without a
// hit (a capped march that ends within its cap is the full march's prefix,
// and one that does not marks the lane and ends the search), so the repair
// continues that march from its carries up to the level's budget, with the
// occluded-on-cap rule, then takes the geometries after it. The answer is
// the full traversal's (occluded_procedural from geometry 0): an OR over
// geometries whose marches are deterministic. The merged form calls
// occluded_merged on every lane, so that the lanes of a warp enter it
// together.
template <bool kMerged>
__device__ __forceinline__ bool occluded_resumed(const Scene& s, V3 ob, V3 d, float t_max,
                                                 int level, MarchRecord rec) {
  const int g = rec.g;
  float t;
  const bool hit = resumed_march(s, ob, d, t_max, level, rec, &t) == kMarchHit;
  if (kMerged) {
    const bool later = occluded_merged(s, ob, d, t_max, level, hit ? s.G : g + 1);
    return hit || later;
  }
  return hit || occluded_procedural(s, ob, d, t_max, level, CapSpec{}, nullptr, GlobalMesh{},
                                    nullptr, g + 1) >= 0;
}

// The two-phase pass's finisher (scene_kernel._finish_tile, :1028-1150) on
// one ray whose main pass left dirty bits: h holds the main pass's answer.
// Each march geometry whose bit is set is marched again, in definition
// order, behind its gate against the current best t, at the level-0 plain
// budgets with their occluded-on-cap rule (_finish_tile takes no level);
// accept-first skips a lane that is already occluded. The metaballs cull
// back faces always (_march_metaballs_inline's facing check), SDF marches
// as the pass does. Closest: a strictly closer hit takes the lane, and the
// normal is computed once for a lane whose winner changed.
__device__ void finish_procedural(const Scene& s, V3 ob, V3 d, unsigned dirty, bool accept_first,
                                  bool cull, Hit* h) {
  bool updated = false;
  for (int g = 0; g < s.G; ++g) {
    const int kind = s.geo[kGeoStride * g];
    if ((kind != kVolumetric && kind != kSignedDistance) || !(dirty & dirty_bit(g))) continue;
    if (accept_first && h->gid >= 0) break;
    const float running = accept_first ? h->t : fminf(h->t, kRayTMax);
    if (!gate(s, g, ob, d, running)) continue;
    V3 ol, dl;
    local_ray(s, g, ob, d, &ol, &dl);
    float t = kInf;
    V3 nl;
    const bool cull_g = accept_first || kind == kVolumetric || cull;
    const int r = intersect<false>(s, g, ol, dl, running, accept_first, 0, cull_g, CapSpec{}, &t,
                                   &nl);
    if (!(r & kHitBit)) continue;
    if (accept_first) {
      h->gid = g;
      h->t = 0.0f;
    } else if (t < h->t) {
      h->t = t;
      h->gid = g;
      updated = true;
    }
  }
  if (updated) h->n = march_normal(s, h->gid, ob, d, h->t);
}

}  // namespace gprt
