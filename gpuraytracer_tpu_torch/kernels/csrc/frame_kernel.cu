// The whole frame in one kernel: one thread per pixel, as DXR's DispatchRays.
//
// Replaces: gpuraytracer_tpu/kernels/frame_kernel.py render_frame_tiles /
// _frame_kernel (plain mode), with the scene-kernel device functions that
// Pallas kernel inlines (scene_kernel._traverse_tile, _march_sdf_part,
// _normal_at, _march_metaballs_part, _metaball_normal, _local_ray,
// _intersect_trimesh_tile, _mt_face) and the
// device math of kernels/soa.py and geometry/fractal.py (frame_math.cuh);
// the traversal is traverse.cuh, which the scene kernel shares.
//
// Per thread: raygen; then per level the plane rect test, the closest
// traversal over the procedural instances in definition order (slab gate
// against the shrinking best t, local ray, march or closed form, normal to
// world), the material pick through the layout's material slots (a
// deduplicated table), the exact shadow-necessity gate, the
// accept-first occlusion traversal with the level's budgets, Phong with
// fake AO, checkers, Fresnel and fog, the affine colour recurrence with the
// exact dead-throughput kill, and the reflection; finally one float4 store.
//
// What bounds it on an H100: divergent per-lane march loops. Each pixel
// runs its own sphere traces (up to 160 steps of a ~30-100 flop distance
// function, plus 4 evaluations per validity check) and the warp waits for
// its slowest lane; the work is ALU- and latency-bound, and the only bytes
// are ~2 KB of parameters and the 16-byte store per pixel.
//
// What the design does about it: the parameters sit in shared memory for
// the whole block; threads map to 16x8 pixel tiles so a warp's rays are
// spatially coherent and tend to take the same gates and similar march
// lengths; marches stop early by the reference's result-exact rules (the
// escape bound, cycle retirement, the shrinking best t, the shadow-
// necessity gate and the dead-throughput kill). The TPU schedule (VMEM
// scratch banks, pl.when tile gates, unroll and tile knobs) never changed
// the image and is not carried over. A persistent schedule (as many blocks
// as stay resident, warps taking 8x4 tiles from a global counter), with or
// without refilling idle lanes per ray query, read 1.5-2.2x slower on an
// H100 than this launch, even where it raised the share of lanes that
// march together (PERF.md), and is not used. Register pressure and
// divergence are left to later work.
//
// The compacted frame modes (GPURT_FRAME_MODE; the reference's
// render_frame_compact, frame_kernel.py:803, and render_frame_deferred,
// :1075, which run _frame_kernel with budget_cap, emit_dirty, dense and
// defer_shadow) are render_pixel's other forms, each with an entry:
//   compact   the closest and occlusion marches capped; a pixel that a cap
//             touches gets its dirty mask (sticky over levels and both kinds
//             of ray) and stops (the reference's kill-on-cap and dropped
//             lanes); writes the image and the (H, W) int32 mask.
//             With a queue, it appends each dirty pixel's state at the
//             start of the level where the cap stopped it (QueueEntry) to a
//             fixed-capacity device queue.
//   dense     the dense pass: one thread per slot of that queue, launched
//             over the capacity; it reads the live count from the queue and
//             continues each pixel from its saved level with the plain
//             form's device code at full budgets, writing the colour into the
//             image. The levels before were the plain kernel's bit for bit (a
//             march that resolves within its cap is a strict prefix of the
//             full one), so the pixel is the plain kernel's pixel. An entry
//             at level -1 starts from the camera ray (render_frame_dense).
//   defer     the occlusion marches capped, each level with a dirty mask of
//             its own; per level the colour contribution with the light
//             visible and (shadowed levels) in shadow, the status (0 lit, 1
//             shadowed, 2 unknown) | mask << 2, and the shadow ray in BLAS
//             space; a level the pixel never reaches reads zeros. With a
//             queue, it appends each unknown pixel's index to its level's
//             device queue and keeps the record of the march that the cap
//             stopped (MarchRecord: the geometry and the march's carries);
//             the queue entry of scene_kernel.cu continues each such march
//             from its record into occlusion planes, and the compose entry
//             sums the levels.
//   gated     the plain frame behind a device-side flag (the reference's
//             lax.cond, decided on the device): frame_gate.cu's one-warp
//             gate reads the counts and, only where a queue overflowed,
//             launches this file's plain frame kernel from the device.
// Each mode is one stream-ordered chain of these entries: the queues' counts
// stay on the device and the host reads nothing back. On Hopper the modes'
// purpose on the TPU, breaking its tile convoys, does not arise (each thread
// already ends its own march): they are ported for the reference's
// semantics and measured, not for speed.
//
// Queue order is a schedule, not behaviour. Between the main entry and the
// dense pass or the repair, the bin entry reorders each queue by a key on
// the device (the reference's ray sorting): compact by the capped geometry,
// defer by raster block, then capped geometry, so that a warp of the dense
// pass or the repair marches one geometry. The main entries count the keys
// as they append (one atomicAdd per key among the lanes that append
// together), so that the bin is one launch. In append order (each group of
// lanes that a cap stops together) the dense pass read 1.7x and the repair
// 1.1-1.3x slower on an H100 (PERF.md).
//
// The plain and dense entries have a second instantiation (kMerged) whose
// occlusion traversal merges the SDF marches (traverse.cuh
// occluded_merged; the reference's _march_sdf_multi, which its frame kernel
// runs under GPURT_MERGED_SHADOW where it allocates the merged banks); the
// host picks it under the knob, so the default instantiation carries none
// of its state. The image is the sequential one.
//
// Every entry has an instantiation per layout of the scene's tables
// (kShared: copied to shared memory; else read in place, for a scene past a
// block's shared memory), picked on the host (traverse.cuh GPRT_PICK1/2).
//
// Bands (row-band sharding, parallel/sharding.py): every frame entry renders
// the rows [row_offset, row_offset + local_height) of a width x height
// frame, both given as launch arguments (the reference's cvec[7,0] row
// offset and local_height, frame_kernel.py:225-229, :696). width and height
// stay the whole frame's:
// raygen and the checker filter's neighbour rays take global pixel
// coordinates. The grid covers the band's rows; the image, the planes, the
// compact queue's pixel indices, the defer records and queue slots are in
// the band's own raster order (row py - row_offset), and the dense entry
// adds row_offset back when it decodes a queued pixel. A whole frame is the
// band row_offset 0, local_height height. Launch arguments and not a field
// of params: one pack of a frame serves every band on its device.
//
// Inputs: params (f32) and layout (int32) as kernels/frame_kernel.py packs
// them (header, then the reference's pack_frame_params blocks); tri, the
// F x 12 mesh face table (null without meshes); out is an (local_height, W,
// 4) f32 image. Each C entry returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <algorithm>

#include "shading.cuh"

namespace gprt {

// Closest hit over the plane and every procedural geometry; gid -1 on a miss.
// kCaps: the capped traversal (traverse.cuh) with the pixel's dirty mask.
// kSave: its marches run as the occlusion traversal's saving form (the
// defer form: one copy of the march for both).
template <bool kCaps, bool kSave = false>
__device__ Hit closest_hit(const Scene& s, V3 o, V3 d, int level, CapSpec caps,
                           unsigned* dirty) {
  Hit h{kInf, -1, v3(0.0f, 0.0f, 0.0f)};
  float tp;
  if (plane_test(s, o, d, &tp)) {
    h.t = tp;
    h.gid = s.plane_gid;
    h.n = v3(0.0f, 1.0f, 0.0f);
  }
  closest_procedural<kCaps, true, GlobalMesh, kSave>(s, to_blas(s, o), d, level, true, &h, caps,
                                                     dirty);
  return h;
}

// Accept-first occlusion over [0, RAY_TMAX] with back-face culling; kMerged:
// the SDF marches merged (traverse.cuh occluded_merged), never capped.
// kSave (the defer form): the capped march that ends the search writes its
// record to *rec.
template <bool kCaps, bool kMerged, bool kSave = false>
__device__ bool occluded(const Scene& s, V3 o, V3 d, int level, CapSpec caps, unsigned* dirty,
                         MarchRecord* rec = nullptr) {
  static_assert(!(kCaps && kMerged), "a capped pass never merges (scene_kernel.py:1653-1655)");
  float tp;
  if (plane_test(s, o, d, &tp)) return true;
  if (kMerged) return occluded_merged(s, to_blas(s, o), d, kRayTMax, level);
  return occluded_procedural<kCaps, true, GlobalMesh, kSave>(s, to_blas(s, o), d, kRayTMax, level,
                                                             caps, dirty, GlobalMesh{}, rec) >= 0;
}

enum Form { kPlainForm = 0, kCompactForm = 1, kDeferForm = 2 };

// One entry of the compact form's queue (64 bytes): the pixel's raster
// index, its level | the lowest set bit of its dirty mask << 8 (the key of
// the binned order), and its state at the start of the level where a cap
// stopped it (the ray, the colour so far and the throughput), which the
// dense pass resumes from; level -1 stands for the camera ray.
struct alignas(16) QueueEntry {
  int pix, level;
  float o[3], d[3], color[4], tw[4];
};

// A device queue: `cap` slots, count[k] the lanes appended to segment k
// (stored or not); hist[k * nbins + key] the lanes of segment k with each
// key of the binned order (bin_key), which the bin entry scans.
struct DeviceQueue {
  void* slots;  // QueueEntry (compact) or int pixel indices (defer, per level)
  int* count;
  int cap;
  int* hist;
  int nbins;
};

// Where the defer form writes: planes of n = W * H pixels, level-major.
struct DeferOut {
  float4* lit;         // D x n
  float4* shadowed;    // (D - 1) x n
  int* sinfo;          // (D - 1) x n
  float* rays;         // (D - 1) x n x 6: BLAS-space origin, direction
  MarchRecord* march;  // (D - 1) x n, where the status is unknown (may be null)
  int n;
};

// The defer form's key of the binned order: the pixel's block of 2^15
// raster pixels * 32 + the lowest set bit of the level's capped-geometry
// mask, whose bits 0-29 the status word `info` keeps (info >> 2): a lane
// whose capped geometries are all past 29 has none there, and takes key 30.
__device__ __forceinline__ int defer_key(int pix, int info) {
  const int code = (int)((unsigned)info >> 2);
  return (pix >> 15) * 32 + (code != 0 ? __ffs(code) - 1 : 30);
}

// One pixel at global coordinates (px, py), `pix` its index in the band's
// raster order: raygen, then per level the closest hit, the material pick,
// the shadow ray, the shading and the bounce; returns the colour (the
// defer form records its planes at `pix` instead and returns zeros).
// kCompactForm: caps as closest_caps / shadow_caps, *dirty the mask; a pixel
// that a cap touches stops, and goes with its state at the start of that
// level to *queue (where not null): the lanes that stop together take their
// slots with one atomicAdd, and counts its key (the capped geometry) into
// the queue's histogram. kDeferForm: occlusion capped as shadow_caps; bit k
// of *dirty set where level k's status is unknown, and the march that the
// cap stopped recorded in rec.march (where not null). kMerged (plain form
// only): the occlusion traversal merges the SDF marches
// (GPURT_MERGED_SHADOW). kResume (plain form only): start from the state in
// *from instead of the camera ray, unless its level is -1.
template <int kForm, bool kMerged = false, bool kResume = false>
__device__ float4 render_pixel(const Scene& s, int px, int py, int width, int height,
                               int max_depth, CapSpec closest_caps, CapSpec shadow_caps,
                               unsigned* dirty, const DeferOut& rec, int pix,
                               const QueueEntry* from, const DeviceQueue* queue) {
  static_assert(!kResume || kForm == kPlainForm, "only the plain form resumes");
  const V3 light = v3(s.cvec[4], s.cvec[5], s.cvec[6]);
  const float* amb = s.cvec + 8;
  const float* ldiff = s.cvec + 12;
  const float bg[4] = {F(0.8), F(0.9), F(1.0), F(1.0)};

  V3 o, d;
  float color[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float tw[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  int first = 0;
  if (kResume && from->level >= 0) {
    o = v3(from->o[0], from->o[1], from->o[2]);
    d = v3(from->d[0], from->d[1], from->d[2]);
#pragma unroll
    for (int c = 0; c < 4; ++c) color[c] = from->color[c], tw[c] = from->tw[c];
    first = from->level & 255;
  } else {
    raygen(s, px, py, width, height, &o, &d);
  }
  int reached = 0;
  // compact: queue a capped pixel with its state, for the dense pass.
  auto stop = [&](int level) {
    if (queue == nullptr) return;
    const unsigned group = __activemask();
    const int slot = group_append(group, queue->count);
    const int key = __ffs((int)*dirty) - 1;
    group_count(group, queue->hist, key);
    if (slot >= queue->cap) return;
    QueueEntry& e = static_cast<QueueEntry*>(queue->slots)[slot];
    e.pix = pix;
    e.level = level | (key << 8);
    e.o[0] = o.x, e.o[1] = o.y, e.o[2] = o.z;
    e.d[0] = d.x, e.d[1] = d.y, e.d[2] = d.z;
#pragma unroll
    for (int c = 0; c < 4; ++c) e.color[c] = color[c], e.tw[c] = tw[c];
  };

  for (int level = first; level < max_depth; ++level) {
    GPRT_OPS(6 + 13 + 7 + 22 + 18 + 1 + 3 + 8 + 4 * 9 + 7 + 2 + 5 + 3 * 14 + 11);
    reached = level + 1;
    GPRT_SIMT_BUCKET(2 * level);
    Hit h = closest_hit<kForm == kCompactForm, kForm == kDeferForm>(s, o, d, level, closest_caps,
                                                                    dirty);
    if (kForm == kCompactForm && *dirty) {
      stop(level);
      break;
    }
    const bool hit = h.gid >= 0;
    const float t = hit ? h.t : kRayTMax;
    const V3 n = h.n;
    const V3 hp = along(o, t, d);
    const float* mrow = s.mat + 8 * (hit ? s.mat_ids[h.gid] : 0);
    const float albedo[4] = {mrow[0], mrow[1], mrow[2], mrow[3]};
    const float refl = mrow[4], diff = mrow[5], spec_c = mrow[6], spec_p = mrow[7];

    // Phong geometry terms (render/shade.phong_lighting); they also decide
    // whether the shadow ray can change the pixel.
    const V3 incident = normalize(sub(hp, light));
    const float kd = saturate(dot3(neg(incident), n));
    const V3 refl_l = normalize(reflect(incident, n));
    const float ks = powf(saturate(dot3(refl_l, normalize(neg(d)))), spec_p);
    const bool shadow_level = level + 1 < max_depth;
    bool in_shadow = false;
    unsigned sdirty = 0;
    MarchRecord march;
    V3 sd = v3(0.0f, 0.0f, 0.0f);
    if (kForm == kDeferForm && shadow_level) {
      GPRT_OPS(13 + 3);
      sd = normalize(sub(light, hp));
      const V3 ob = to_blas(s, hp);
      float* r = rec.rays + 6 * ((size_t)level * rec.n + pix);
      r[0] = ob.x, r[1] = ob.y, r[2] = ob.z, r[3] = sd.x, r[4] = sd.y, r[5] = sd.z;
    }
    if (shadow_level && hit && (kd > 0.0f || spec_c * ks > 0.0f)) {
      if (kForm != kDeferForm) {
        GPRT_OPS(13);
        sd = normalize(sub(light, hp));
      }
      GPRT_SIMT_BUCKET(2 * level + 1);
      in_shadow = occluded<kForm != kPlainForm, kMerged, kForm == kDeferForm>(
          s, hp, sd, level, shadow_caps, kForm == kDeferForm ? &sdirty : dirty, &march);
    }
    if (kForm == kCompactForm && *dirty) {
      stop(level);
      break;
    }
    const float a = 1.0f - saturate(dot3(n, v3(0.0f, -1.0f, 0.0f)));

    // Phong with the shadow factor and specular of `shadowed`.
    auto phong = [&](bool shadowed, int c) {
      const float sf = shadowed ? F(0.35) : 1.0f;
      const float dterm = sf * diff * kd;
      const float sterm = shadowed ? 0.0f : spec_c * ks;
      float ambient = albedo[c] * ((amb[c] - F(0.1)) + a * (amb[c] - (amb[c] - F(0.1))));
      return ambient + dterm * ldiff[c] * albedo[c] + sterm;
    };

    const float k = (hit && h.gid == s.plane_gid) ? checkers(s, hp, n, px, py, width, height) : 1.0f;

    // Fresnel-weighted reflection multiplier, gated on reflectance > 0.001.
    const float cosi = saturate(dot3(neg(d), n));
    const float f5 = powf(1.0f - cosi, 5.0f);
    const bool reflective = hit && refl > F(0.001);
    const float fog = 1.0f - expf(F(-0.000002) * t * t * t);
    auto base = [&](float ph, int c) { return hit ? (1.0f - fog) * (k * ph) + fog * bg[c] : bg[c]; };
    if (kForm == kDeferForm) GPRT_OPS(4 * 14);  // the second shading variant
    bool live = false;
    float lit[4], shadowed[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float rm = c < 3 ? refl * (albedo[c] + (1.0f - albedo[c]) * f5) : refl * 1.0f;
      rm = reflective ? rm : 0.0f;
      float mult = hit ? (1.0f - fog) * k * rm : 0.0f;
      if (kForm == kDeferForm) {
        lit[c] = tw[c] * base(phong(false, c), c);
        shadowed[c] = tw[c] * base(phong(true, c), c);
      } else {
        color[c] = color[c] + tw[c] * base(phong(in_shadow, c), c);
      }
      tw[c] = tw[c] * mult;
      live = live || tw[c] != 0.0f;
    }
    if (kForm == kDeferForm) {
      const size_t at = (size_t)level * rec.n + pix;
      rec.lit[at] = make_float4(lit[0], lit[1], lit[2], lit[3]);
      if (shadow_level) {
        rec.shadowed[at] = make_float4(shadowed[0], shadowed[1], shadowed[2], shadowed[3]);
        const int status = in_shadow ? 1 : (sdirty != 0 ? 2 : 0);
        rec.sinfo[at] = status | (int)(sdirty << 2);
        if (status == 2) {
          *dirty |= 1u << level;
          if (rec.march != nullptr) rec.march[at] = march;
        }
      }
    }
    // Exact kills: a non-reflective hit or a throughput that is exactly
    // zero on every channel adds +0.0 at every later level.
    if (!(reflective && live)) break;
    GPRT_OPS(12);
    d = reflect(d, n);
    o = hp;
  }
  if (kForm == kDeferForm) {
    // The levels this pixel never reached read zeros.
    for (int level = reached; level < max_depth; ++level) {
      const size_t at = (size_t)level * rec.n + pix;
      rec.lit[at] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (level + 1 < max_depth) {
        rec.shadowed[at] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        rec.sinfo[at] = 0;
        float* r = rec.rays + 6 * at;
        r[0] = r[1] = r[2] = r[3] = r[4] = r[5] = 0.0f;
      }
    }
  }
  return make_float4(color[0], color[1], color[2], color[3]);
}

// The block's scene (in shared memory, or read in place: kShared), after
// resetting a counting build's counters.
template <bool kShared>
__device__ __forceinline__ Scene block_scene(const float* __restrict__ params,
                                             const int* __restrict__ layout,
                                             const float* __restrict__ tri, int G, int M,
                                             unsigned long long* ops) {
  extern __shared__ float smem[];
  counters_begin(ops);
  return load_scene<true, kShared>(params, layout, tri, G, M, smem);
}

// kMerged: the instantiation with merged occlusion marches; the default one
// carries none of their state. kShared: the scene's tables in shared memory
// (else read in place).
template <bool kMerged, bool kShared>
__global__ void __launch_bounds__(128)
    frame_kernel(const float* __restrict__ params, const int* __restrict__ layout,
                 const float* __restrict__ tri, float4* __restrict__ out, int width, int height,
                 int row_offset, int local_height, int max_depth, int G, int M,
                 unsigned long long* ops) {
  const Scene s = block_scene<kShared>(params, layout, tri, G, M, ops);
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  if (px < width && row < local_height) {
    out[row * width + px] = render_pixel<kPlainForm, kMerged>(
        s, px, row + row_offset, width, height, max_depth, CapSpec{}, CapSpec{}, nullptr,
        DeferOut{}, 0, nullptr, nullptr);
  }
  counters_end(ops);
}

// Whether any of the n queue counts passed the capacity.
__device__ __forceinline__ bool overflowed(const int* count, int n, int cap) {
  bool over = false;
  for (int k = 0; k < n; ++k) over = over || count[k] > cap;
  return over;
}

// dirty_out (may be null): the (local_height, W) int32 dirty masks. q.count
// (may be null): append each dirty pixel's QueueEntry to q where the cap
// stops it.
template <bool kShared>
__global__ void __launch_bounds__(128)
    frame_compact_kernel(const float* __restrict__ params, const int* __restrict__ layout,
                         const float* __restrict__ tri, float4* __restrict__ out,
                         int* __restrict__ dirty_out, DeviceQueue q, int width, int height,
                         int row_offset, int local_height, int max_depth, int G, int M,
                         CapSpec closest_caps, CapSpec shadow_caps, unsigned long long* ops) {
  const Scene s = block_scene<kShared>(params, layout, tri, G, M, ops);
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  if (px < width && row < local_height) {
    unsigned dirty = 0;
    const int pix = row * width + px;
    out[pix] = render_pixel<kCompactForm>(
        s, px, row + row_offset, width, height, max_depth, closest_caps, shadow_caps, &dirty,
        DeferOut{}, pix, nullptr, q.count != nullptr ? &q : nullptr);
    if (dirty_out != nullptr) dirty_out[pix] = (int)dirty;
  }
  counters_end(ops);
}

// The dense pass over the compact queue q, one thread per slot over its
// capacity: a block past the live count (every block, where the queue
// overflowed) returns before loading the scene. An entry resumes from its
// level, or renders from the camera ray where its level is -1. An entry's
// pixel index is in the band's raster order: its global row adds
// row_offset.
template <bool kMerged, bool kShared>
__global__ void __launch_bounds__(128)
    frame_dense_kernel(const float* __restrict__ params, const int* __restrict__ layout,
                       const float* __restrict__ tri, DeviceQueue q, float4* __restrict__ out,
                       int width, int height, int row_offset, int max_depth, int G, int M,
                       unsigned long long* ops) {
  const int n = *q.count;
  const int live = n > q.cap ? 0 : n;
  if ((int)(blockIdx.x * blockDim.x) >= live) return;
  const Scene s = block_scene<kShared>(params, layout, tri, G, M, ops);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < live) {
    const QueueEntry* e = static_cast<const QueueEntry*>(q.slots) + i;
    const int pix = e->pix;
    out[pix] = render_pixel<kPlainForm, kMerged, true>(
        s, pix % width, pix / width + row_offset, width, height, max_depth, CapSpec{}, CapSpec{},
        nullptr, DeferOut{}, 0, e, nullptr);
  }
  counters_end(ops);
}

// q.count (may be null): append each pixel whose status is unknown at
// shadowed level k to segment k of q (int raster indices, q.cap per level)
// and count its key (defer_key) into q.hist.
template <bool kShared>
__global__ void __launch_bounds__(128)
    frame_defer_kernel(const float* __restrict__ params, const int* __restrict__ layout,
                       const float* __restrict__ tri, DeferOut rec, DeviceQueue q, int width,
                       int height, int row_offset, int local_height, int max_depth, int G, int M,
                       CapSpec shadow_caps, unsigned long long* ops) {
  const Scene s = block_scene<kShared>(params, layout, tri, G, M, ops);
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  const bool inside = px < width && row < local_height;
  const int pix = row * width + px;
  unsigned unknown = 0;
  if (inside) {
    render_pixel<kDeferForm>(s, px, row + row_offset, width, height, max_depth, CapSpec{},
                             shadow_caps, &unknown, rec, pix, nullptr, nullptr);
  }
  if (q.count != nullptr) {
    // Every lane of the warp is here: one ballot per level.
    for (int k = 0; k + 1 < max_depth; ++k) {
      const bool queued = (unknown >> k) & 1u;
      const unsigned group = __ballot_sync(0xffffffffu, queued);
      if (!queued) continue;
      const int slot = group_append(group, q.count + k);
      group_count(group, q.hist + (size_t)k * q.nbins,
                  defer_key(pix, rec.sinfo[(size_t)k * rec.n + pix]));
      if (slot < q.cap) static_cast<int*>(q.slots)[(size_t)k * q.cap + slot] = pix;
    }
  }
  counters_end(ops);
}

// The defer form's recomposition, one thread per pixel of n: acc = term_0;
// acc = acc + term_1; ... (the defer kernel's association order), where
// term_k is level k's shadowed contribution if its status is 1, or 2 and
// its occlusion plane says occluded, else its lit one. Bytes-bound: per
// pixel and level it reads the status, the occlusion plane only where the
// status is unknown, and only the chosen contribution; the image is written
// once.
__global__ void __launch_bounds__(128)
    frame_compose_kernel(const float4* __restrict__ lit, const float4* __restrict__ shadowed,
                         const int* __restrict__ sinfo, const int* __restrict__ occ,
                         float4* __restrict__ out, int n, int max_depth) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int k = 0; k < max_depth; ++k) {
    const size_t at = (size_t)k * n + i;
    bool shadow = false;
    if (k + 1 < max_depth) {
      const int status = sinfo[at] & 3;
      shadow = status == 1 || (status == 2 && occ[at] != 0);
    }
    const float4 term = shadow ? shadowed[at] : lit[at];
    acc = k == 0 ? term
                 : make_float4(acc.x + term.x, acc.y + term.y, acc.z + term.z, acc.w + term.w);
  }
  out[i] = acc;
}

// The binned order of device queues: nseg segments of cap slots, segment k
// holding count[k] live entries (none where a count passed cap), each with
// a key in [0, nbins). The main entry that filled the queue counted its
// keys (DeviceQueue.hist), so the order takes one launch of a few blocks
// per segment: each block scans its segment's histogram into offsets in
// shared memory once, then takes the segment's live entries a block's
// width at a time, and each entry goes to its key's offset plus a rank that
// a cursor per key hands out (one atomicAdd per key among a warp's lanes,
// __match_any_sync); within a key the order is the atomics'. The last block
// to finish sets the cursors back to zero, so the same queue can be binned
// again. Bytes-bound: the live entries are read once and written once, and
// each block reads its segment's histogram.
struct BinQueue {
  const void* in;    // QueueEntry slots (compact) or int pixel indices (defer)
  void* out;         // the same, binned
  const int* count;  // nseg
  const int* sinfo;  // defer: the status planes, nseg x npix
  // nseg x nbins histogram (the main entry's), nseg x nbins cursors, then
  // the count of finished blocks; the cursors and the count are zero
  // between launches
  int* bins;
  int nseg, cap, npix, nbins;
};

// Compact: the lowest set bit of the dirty mask (32 keys). Defer: defer_key.
template <bool kDefer>
__device__ __forceinline__ int bin_key(const BinQueue& b, int seg, int i) {
  if (kDefer) {
    const int pix = static_cast<const int*>(b.in)[(size_t)seg * b.cap + i];
    return defer_key(pix, b.sinfo[(size_t)seg * b.npix + pix]);
  }
  return static_cast<const QueueEntry*>(b.in)[i].level >> 8;
}

// Threads of a bin block, and the blocks of a launch over all segments.
constexpr int kBinThreads = 1024;
constexpr int kBinBlocks = 128;

// gridDim.x blocks per segment blockIdx.y; nbins ints of dynamic shared
// memory. Block 0 of each segment adds the segment's count to *total
// (where given: a running count of the lanes the binned queues counted,
// across launches).
template <bool kDefer>
__global__ void __launch_bounds__(kBinThreads) queue_bin_kernel(BinQueue b,
                                                                unsigned long long* total) {
  const int seg = blockIdx.y, t = threadIdx.x, n = blockDim.x;
  if (blockIdx.x == 0 && t == 0 && total != nullptr) {
    atomicAdd(total, (unsigned long long)b.count[seg]);
  }
  const int live = overflowed(b.count, b.nseg, b.cap) ? 0 : b.count[seg];
  extern __shared__ float smem[];
  __shared__ int part[kBinThreads];
  __shared__ bool last;
  int* offs = reinterpret_cast<int*>(smem);
  int* cursor = b.bins + (size_t)b.nseg * b.nbins;
  int* done = cursor + (size_t)b.nseg * b.nbins;
  if ((int)(blockIdx.x * n) < live) {
    // The exclusive scan of the segment's histogram: each thread sums a run
    // of bins, the block scans the sums (Hillis-Steele), each thread writes
    // its run's offsets.
    const int* hist = b.bins + (size_t)seg * b.nbins;
    for (int k = t; k < b.nbins; k += n) offs[k] = hist[k];
    __syncthreads();
    const int per = (b.nbins + n - 1) / n;
    const int lo = min(t * per, b.nbins), hi = min(lo + per, b.nbins);
    int sum = 0;
    for (int k = lo; k < hi; ++k) sum += offs[k];
    part[t] = sum;
    __syncthreads();
    for (int off = 1; off < n; off <<= 1) {
      const int v = t >= off ? part[t - off] : 0;
      __syncthreads();
      part[t] += v;
      __syncthreads();
    }
    int run = part[t] - sum;
    for (int k = lo; k < hi; ++k) {
      const int c = offs[k];
      offs[k] = run;
      run += c;
    }
    __syncthreads();
    for (int i = blockIdx.x * n + t; i < live; i += gridDim.x * n) {
      const int key = bin_key<kDefer>(b, seg, i);
      const unsigned group = __match_any_sync(__activemask(), key);
      const int slot = offs[key] + group_append(group, cursor + (size_t)seg * b.nbins + key);
      if (kDefer) {
        static_cast<int*>(b.out)[(size_t)seg * b.cap + slot] =
            static_cast<const int*>(b.in)[(size_t)seg * b.cap + i];
      } else {
        static_cast<QueueEntry*>(b.out)[slot] = static_cast<const QueueEntry*>(b.in)[i];
      }
    }
  }
  // The last block of the launch resets the cursors and the count.
  __syncthreads();
  if (t == 0) {
    __threadfence();
    last = atomicAdd(done, 1) == (int)(gridDim.x * gridDim.y) - 1;
  }
  __syncthreads();
  if (last) {
    for (int k = t; k < b.nseg * b.nbins; k += n) cursor[k] = 0;
    if (t == 0) *done = 0;
  }
}

// The grid of the 16x8 blocks that cover a band of local_height rows of a
// frame width pixels wide.
__host__ __device__ inline dim3 frame_grid(int width, int local_height) {
  return dim3{(unsigned)((width + 15) / 16), (unsigned)((local_height + 7) / 8), 1};
}

// Whether the rows [row_offset, row_offset + local_height) lie in a frame
// of `height` rows.
__host__ __device__ inline bool band_ok(int height, int row_offset, int local_height) {
  return row_offset >= 0 && local_height > 0 && row_offset <= height - local_height;
}

}  // namespace gprt

// frame_gate.cu includes the device code above (GPRT_DEVICE_ONLY) for the
// frame kernel that its gate launches; it has launchers of its own.
#ifndef GPRT_DEVICE_ONLY

// Checks the device and takes the dynamic shared memory `kernel` needs:
// the buffers' bytes where the host put the scene's tables in shared
// memory (`shared`), else none.
template <typename Kernel>
static cudaError_t setup(Kernel kernel, int G, int M, int shared, int device, size_t* shmem) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (GPRT_COUNTING && !shared) return cudaErrorNotSupported;
  *shmem = shared ? gprt::shared_bytes(true, G, M) : 0;
  return gprt::reserve_shared(kernel, *shmem, device);
}

static auto frame_entry(int merged, int shared) {
  return GPRT_PICK2(gprt::frame_kernel, merged, shared);
}

// The band of local_height rows from row_offset of a width x height frame
// into out (local_height, W, 4). ops: a device counter that the counting
// builds add to (-DGPRT_COUNT_OPS: the frame's f32 FLOPs; -DGPRT_COUNT_SIMT:
// 2 x 16 + 1 SIMT counters); the default build ignores it. merged: launch
// the instantiation with merged occlusion marches. shared: the scene's
// tables in shared memory.
extern "C" int gprt_frame_render(const float* params, const int* layout, const float* tri,
                                 float* out, int width, int height, int row_offset,
                                 int local_height, int max_depth, int num_geometries,
                                 int num_materials, int shared, int merged,
                                 unsigned long long* ops, int device, void* stream) {
  if (!gprt::band_ok(height, row_offset, local_height)) return (int)cudaErrorInvalidValue;
  const auto kernel = frame_entry(merged, shared);
  size_t shmem;
  cudaError_t err = setup(kernel, num_geometries, num_materials, shared, device, &shmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<gprt::frame_grid(width, local_height), dim3(16, 8), shmem, (cudaStream_t)stream>>>(
      params, layout, tri, reinterpret_cast<float4*>(out), width, height, row_offset,
      local_height, max_depth, num_geometries, num_materials, ops);
  return (int)cudaGetLastError();
}

// `kernel`'s resident blocks per SM and in all as the launchers launch it
// (a report; nothing is launched).
template <typename Kernel>
static int residency(Kernel kernel, int G, int M, int shared, int device, int* per_sm,
                     int* total) {
  size_t shmem;
  cudaError_t err = setup(kernel, G, M, shared, device, &shmem);
  if (err != cudaSuccess) return (int)err;
  return (int)gprt::resident_blocks(kernel, shmem, device, per_sm, total);
}

// The frame kernel's (dense: the dense entry's) resident blocks per SM and
// in all; merged: the instantiation with merged occlusion marches.
extern "C" int gprt_frame_residency(int num_geometries, int num_materials, int shared, int merged,
                                    int dense, int device, int* per_sm, int* total) {
  if (dense) {
    return residency(GPRT_PICK2(gprt::frame_dense_kernel, merged, shared), num_geometries,
                     num_materials, shared, device, per_sm, total);
  }
  return residency(frame_entry(merged, shared), num_geometries, num_materials, shared, device,
                   per_sm, total);
}

// The int32 words that follow a queue's nseg counts: the histogram of its
// keys (nseg x nbins), the bin entry's cursors (as many) and its count of
// finished blocks (gprt_queue_bin). The main entries zero the counts and
// these words with one memset.
static size_t queue_words(int nseg, int nbins) {
  return (size_t)nseg + 2 * (size_t)nseg * nbins + 1;
}

// The compact form's main pass over a band (as gprt_frame_render): out
// (local_height, W, 4); dirty (local_height, W) int32 or null; the closest
// and occlusion passes' SDF and metaball step caps. queue (may
// be null): `cap` QueueEntry slots (64 bytes each) that the dirty pixels are
// appended to; count one int32 and the queue_words(1, 32) after it, zeroed
// on the stream first, then the count and the histogram of the 32 keys.
extern "C" int gprt_frame_compact(const float* params, const int* layout, const float* tri,
                                  float* out, int* dirty, void* queue, int* count, int cap,
                                  int width, int height, int row_offset, int local_height,
                                  int max_depth, int num_geometries, int num_materials, int shared,
                                  int closest_sdf_cap, int closest_mb_cap, int shadow_sdf_cap,
                                  int shadow_mb_cap, unsigned long long* ops, int device,
                                  void* stream) {
  if (!gprt::band_ok(height, row_offset, local_height)) return (int)cudaErrorInvalidValue;
  const auto kernel = GPRT_PICK1(gprt::frame_compact_kernel, shared);
  size_t shmem;
  cudaError_t err = setup(kernel, num_geometries, num_materials, shared, device, &shmem);
  if (err != cudaSuccess) return (int)err;
  if (count != nullptr) {
    if (queue == nullptr || cap <= 0) return (int)cudaErrorInvalidValue;
    err = cudaMemsetAsync(count, 0, sizeof(int) * queue_words(1, 32), (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<gprt::frame_grid(width, local_height), dim3(16, 8), shmem, (cudaStream_t)stream>>>(
      params, layout, tri, reinterpret_cast<float4*>(out), dirty,
      gprt::DeviceQueue{queue, count, cap, count != nullptr ? count + 1 : nullptr, 32}, width,
      height, row_offset, local_height, max_depth, num_geometries,
      num_materials, gprt::CapSpec{closest_sdf_cap, closest_mb_cap},
      gprt::CapSpec{shadow_sdf_cap, shadow_mb_cap}, ops);
  return (int)cudaGetLastError();
}

// The dense pass over a compact queue (queue, count, cap as
// gprt_frame_compact fills them for the same band) into the band's image
// out (local_height, W, 4), launched over the capacity; merged as for
// gprt_frame_render.
extern "C" int gprt_frame_dense(const float* params, const int* layout, const float* tri,
                                const void* queue, const int* count, float* out, int cap,
                                int width, int height, int row_offset, int local_height,
                                int max_depth, int num_geometries, int num_materials, int shared,
                                int merged, unsigned long long* ops, int device, void* stream) {
  if (cap <= 0 || !gprt::band_ok(height, row_offset, local_height)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto kernel = GPRT_PICK2(gprt::frame_dense_kernel, merged, shared);
  size_t shmem;
  cudaError_t err = setup(kernel, num_geometries, num_materials, shared, device, &shmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(cap + 127) / 128, 128, shmem, (cudaStream_t)stream>>>(
      params, layout, tri,
      gprt::DeviceQueue{const_cast<void*>(queue), const_cast<int*>(count), cap, nullptr, 0},
      reinterpret_cast<float4*>(out), width, height, row_offset, max_depth, num_geometries,
      num_materials, ops);
  return (int)cudaGetLastError();
}

// The defer form's main pass over a band (as gprt_frame_render; h below is
// local_height): lit (D, h, W, 4), shadowed (D-1, h, W, 4), sinfo (D-1, h,
// W) int32, rays (D-1, h, W, 6); the occlusion passes' SDF and metaball step
// caps. queue (may be null): (D-1, cap) int32 band pixel indices of the
// unknown lanes per shadowed level, counted in count (D-1 int32, then the
// queue_words(D-1, nbins) after them, nbins = 32 per 2^15 pixels of the
// band; zeroed on the stream first, then the counts and the histograms of
// the keys), with their march records in march ((D-1, h, W) MarchRecord, 16
// bytes each, written only where the status is unknown).
extern "C" int gprt_frame_defer(const float* params, const int* layout, const float* tri,
                                float* lit, float* shadowed, int* sinfo, float* rays,
                                void* march, int* queue, int* count, int cap, int width,
                                int height, int row_offset, int local_height, int max_depth,
                                int num_geometries, int num_materials,
                                int shared, int shadow_sdf_cap, int shadow_mb_cap,
                                unsigned long long* ops, int device, void* stream) {
  if (max_depth < 2 || !gprt::band_ok(height, row_offset, local_height)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto kernel = GPRT_PICK1(gprt::frame_defer_kernel, shared);
  size_t shmem;
  cudaError_t err = setup(kernel, num_geometries, num_materials, shared, device, &shmem);
  if (err != cudaSuccess) return (int)err;
  const int nsl = max_depth - 1, npix = width * local_height;
  const int nbins = 32 * ((npix + 32767) >> 15);
  if (count != nullptr) {
    if (queue == nullptr || march == nullptr || cap <= 0) return (int)cudaErrorInvalidValue;
    err = cudaMemsetAsync(count, 0, sizeof(int) * queue_words(nsl, nbins), (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  const gprt::DeferOut rec{reinterpret_cast<float4*>(lit), reinterpret_cast<float4*>(shadowed),
                           sinfo, rays, static_cast<gprt::MarchRecord*>(march), npix};
  kernel<<<gprt::frame_grid(width, local_height), dim3(16, 8), shmem, (cudaStream_t)stream>>>(
      params, layout, tri, rec,
      gprt::DeviceQueue{queue, count, cap, count != nullptr ? count + nsl : nullptr, nbins},
      width, height, row_offset, local_height,
      max_depth, num_geometries, num_materials, gprt::CapSpec{shadow_sdf_cap, shadow_mb_cap},
      ops);
  return (int)cudaGetLastError();
}

// The defer form's recomposition of n pixels from lit (D, n, 4), shadowed,
// sinfo and occ ((D-1, n, ...)) into out (n, 4).
extern "C" int gprt_frame_compose(const float* lit, const float* shadowed, const int* sinfo,
                                  const int* occ, float* out, int n, int max_depth, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || max_depth < 2) return (int)cudaErrorInvalidValue;
  gprt::frame_compose_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(lit), reinterpret_cast<const float4*>(shadowed), sinfo, occ,
      reinterpret_cast<float4*>(out), n, max_depth);
  return (int)cudaGetLastError();
}

// The binned order of a compact queue (defer 0: queue, out cap QueueEntry
// slots, count 1 int32) or of the defer queues (defer 1: queue, out nseg x
// cap int32, count nseg int32, sinfo the (nseg, npix) status planes) into
// out; bins: the queue's 2 x nseg x nbins + 1 int32 that follow its counts
// (the histogram its main entry counted, the cursors, the finished blocks;
// nbins: 32, or 32 per 2^15 pixels); total (may be null): a uint64 that the
// counts are added to. One launch of kBinBlocks blocks in all (fewer where
// the capacity needs fewer).
extern "C" int gprt_queue_bin(const void* queue, void* out, const int* count, const int* sinfo,
                              int* bins, unsigned long long* total, int nseg, int cap, int npix,
                              int nbins, int defer, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nseg <= 0 || cap <= 0 || nbins <= 0) return (int)cudaErrorInvalidValue;
  const auto kernel = defer ? gprt::queue_bin_kernel<true> : gprt::queue_bin_kernel<false>;
  const size_t shmem = sizeof(int) * (size_t)nbins;
  err = gprt::reserve_shared(kernel, shmem, device);
  if (err != cudaSuccess) return (int)err;
  const gprt::BinQueue b{queue, out, count, sinfo, bins, nseg, cap, npix, nbins};
  const int per_seg = std::max(1, std::min((cap + gprt::kBinThreads - 1) / gprt::kBinThreads,
                                           gprt::kBinBlocks / nseg));
  kernel<<<dim3(per_seg, nseg), gprt::kBinThreads, shmem, (cudaStream_t)stream>>>(b, total);
  return (int)cudaGetLastError();
}

extern "C" const char* gprt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#endif  // GPRT_DEVICE_ONLY
