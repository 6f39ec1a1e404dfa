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
//   dense     one thread per entry of the dirty queue (px, py; -1 is
//             padding), rendered with the plain form's device code, so a
//             re-rendered pixel is the plain kernel's pixel.
//   defer     the occlusion marches capped, each level with a dirty mask of
//             its own; per level the colour contribution with the light
//             visible and (shadowed levels) in shadow, the status (0 lit, 1
//             shadowed, 2 unknown) | mask << 2, and the shadow ray in BLAS
//             space; a level the pixel never reaches reads zeros.
// The host (kernels/frame_kernel.py) builds the queues and recomposes. On
// Hopper the modes' purpose on the TPU, breaking its tile convoys, does not
// arise (each thread already ends its own march): they are ported for the
// reference's semantics and measured, not for speed.
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
// Inputs: params (f32) and layout (int32) as kernels/frame_kernel.py packs
// them (header, then the reference's pack_frame_params blocks); tri, the
// F x 12 mesh face table (null without meshes); out is an (H, W, 4) f32
// image. Each C entry returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "traverse.cuh"

namespace gprt {

__device__ __forceinline__ void raygen(const Scene& s, int px, int py, int width, int height,
                                       V3* o, V3* d) {
  GPRT_OPS(8 + 16 + 3 + 6 + 13);
  float sx = ((float)px + 0.5f) / (float)width * 2.0f - 1.0f;
  float sy = ((float)py + 0.5f) / (float)height * 2.0f - 1.0f;
  sy = -sy;
  const float* m = s.p2w;
  float w[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) w[c] = sx * m[c] + sy * m[4 + c] + m[12 + c];
  V3 world = v3(w[0] / w[3], w[1] / w[3], w[2] / w[3]);
  V3 cam = v3(s.cvec[0], s.cvec[1], s.cvec[2]);
  *o = v3(world.x * 0.0f + cam.x, world.y * 0.0f + cam.y, world.z * 0.0f + cam.z);
  *d = normalize(sub(world, cam));
}

// Ground-plane rect test (accel/traverse.intersect_plane), t in [0, RAY_TMAX].
__device__ __forceinline__ bool plane_test(const Scene& s, V3 o, V3 d, float* t_out) {
  GPRT_OPS(8);
  const float* po = s.cvec + 20;
  const float* ps = s.cvec + 24;
  float t = -(o.y - po[1]) / d.y;
  float px = o.x + t * d.x;
  float pz = o.z + t * d.z;
  bool inside = px >= po[0] && px <= po[0] + ps[0] && pz >= po[2] && pz <= po[2] + ps[1];
  *t_out = t;
  return inside && d.y < 0.0f && t >= 0.0f && t <= kRayTMax;
}

__device__ __forceinline__ V3 to_blas(const Scene& s, V3 o) {
  GPRT_OPS(3);
  return v3(o.x - s.cvec[16], o.y - s.cvec[17], o.z - s.cvec[18]);
}

// Closest hit over the plane and every procedural geometry; gid -1 on a miss.
// kCaps: the capped traversal (traverse.cuh) with the pixel's dirty mask.
template <bool kCaps>
__device__ Hit closest_hit(const Scene& s, V3 o, V3 d, int level, CapSpec caps,
                           unsigned* dirty) {
  Hit h{kInf, -1, v3(0.0f, 0.0f, 0.0f)};
  float tp;
  if (plane_test(s, o, d, &tp)) {
    h.t = tp;
    h.gid = s.plane_gid;
    h.n = v3(0.0f, 1.0f, 0.0f);
  }
  closest_procedural<kCaps>(s, to_blas(s, o), d, level, true, &h, caps, dirty);
  return h;
}

// Accept-first occlusion over [0, RAY_TMAX] with back-face culling; kMerged:
// the SDF marches merged (traverse.cuh occluded_merged), never capped.
template <bool kCaps, bool kMerged>
__device__ bool occluded(const Scene& s, V3 o, V3 d, int level, CapSpec caps, unsigned* dirty) {
  static_assert(!(kCaps && kMerged), "a capped pass never merges (scene_kernel.py:1653-1655)");
  float tp;
  if (plane_test(s, o, d, &tp)) return true;
  if (kMerged) return occluded_merged(s, to_blas(s, o), d, kRayTMax, level);
  return occluded_procedural<kCaps>(s, to_blas(s, o), d, kRayTMax, level, caps, dirty) >= 0;
}

// AnalyticalCheckersTexture with ray differentials from the neighbour
// pixels' camera rays (render/checkers.py).
__device__ float checkers(const Scene& s, V3 hp, V3 n, int px, int py, int width, int height) {
  GPRT_OPS(2 * 14 + 2 * 6 + 4 + 2 * 19 + 3);
  V3 ox, dx, oy, dy;
  raygen(s, px + 1, py, width, height, &ox, &dx);
  raygen(s, px, py + 1, width, height, &oy, &dy);
  float sx = dot3(sub(ox, hp), n) / dot3(dx, n);
  float sy = dot3(sub(oy, hp), n) / dot3(dy, n);
  V3 pxp = sub(ox, scale(dx, sx));
  V3 pyp = sub(oy, scale(dy, sy));
  float uv[2] = {hp.x, hp.z};
  float ddx[2] = {pxp.x - hp.x, pxp.z - hp.z};
  float ddy[2] = {pyp.x - hp.x, pyp.z - hp.z};
  float i[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    float w = fmaxf(fabsf(ddx[k]), fabsf(ddy[k]));
    float a = uv[k] + 0.5f * w;
    float b = uv[k] - 0.5f * w;
    float fa = floorf(a), fb = floorf(b);
    i[k] = (fa + fminf((a - fa) * 50.0f, 1.0f) - fb - fminf((b - fb) * 50.0f, 1.0f)) / (50.0f * w);
  }
  return (1.0f - i[0]) * (1.0f - i[1]);
}

enum Form { kPlainForm = 0, kCompactForm = 1, kDeferForm = 2 };

// Where the defer form writes: planes of n = W * H pixels, level-major.
struct DeferOut {
  float4* lit;       // D x n
  float4* shadowed;  // (D - 1) x n
  int* sinfo;        // (D - 1) x n
  float* rays;       // (D - 1) x n x 6: BLAS-space origin, direction
  int n;
};

// One pixel: raygen, then per level the closest hit, the material pick,
// the shadow ray, the shading and the bounce; returns the colour (the
// defer form records its planes at `pix` instead and returns zeros).
// kCompactForm: caps as closest_caps / shadow_caps, *dirty the mask.
// kDeferForm: occlusion capped as shadow_caps. kMerged (plain form only):
// the occlusion traversal merges the SDF marches (GPURT_MERGED_SHADOW).
template <int kForm, bool kMerged = false>
__device__ float4 render_pixel(const Scene& s, int px, int py, int width, int height,
                               int max_depth, CapSpec closest_caps, CapSpec shadow_caps,
                               unsigned* dirty, const DeferOut& rec, int pix) {
  const V3 light = v3(s.cvec[4], s.cvec[5], s.cvec[6]);
  const float* amb = s.cvec + 8;
  const float* ldiff = s.cvec + 12;
  const float bg[4] = {F(0.8), F(0.9), F(1.0), F(1.0)};

  V3 o, d;
  raygen(s, px, py, width, height, &o, &d);
  float color[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float tw[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  int reached = 0;

  for (int level = 0; level < max_depth; ++level) {
    GPRT_OPS(6 + 13 + 7 + 22 + 18 + 1 + 3 + 8 + 4 * 9 + 7 + 2 + 5 + 3 * 14 + 11);
    reached = level + 1;
    GPRT_SIMT_BUCKET(2 * level);
    Hit h = closest_hit<kForm == kCompactForm>(s, o, d, level, closest_caps, dirty);
    // compact: a capped pixel is rendered again by the dense pass.
    if (kForm == kCompactForm && *dirty) break;
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
      in_shadow = occluded<kForm != kPlainForm, kMerged>(s, hp, sd, level, shadow_caps,
                                                         kForm == kDeferForm ? &sdirty : dirty);
    }
    if (kForm == kCompactForm && *dirty) break;
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
                 const float* __restrict__ tri, float4* __restrict__ out, int width, int height, int max_depth, int G, int M,
                 unsigned long long* ops) {
  const Scene s = block_scene<kShared>(params, layout, tri, G, M, ops);
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  if (px < width && py < height) {
    out[py * width + px] = render_pixel<kPlainForm, kMerged>(
        s, px, py, width, height, max_depth, CapSpec{}, CapSpec{}, nullptr, DeferOut{}, 0);
  }
  counters_end(ops);
}

template <bool kShared>
__global__ void __launch_bounds__(128)
    frame_compact_kernel(const float* __restrict__ params, const int* __restrict__ layout,
                         const float* __restrict__ tri, float4* __restrict__ out,
                         int* __restrict__ dirty_out, int width, int height, int max_depth, int G,
                         int M, CapSpec closest_caps, CapSpec shadow_caps,
                         unsigned long long* ops) {
  const Scene s = block_scene<kShared>(params, layout, tri, G, M, ops);
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  if (px < width && py < height) {
    unsigned dirty = 0;
    out[py * width + px] = render_pixel<kCompactForm>(s, px, py, width, height, max_depth,
                                                      closest_caps, shadow_caps, &dirty,
                                                      DeferOut{}, 0);
    dirty_out[py * width + px] = (int)dirty;
  }
  counters_end(ops);
}

template <bool kMerged, bool kShared>
__global__ void __launch_bounds__(128)
    frame_dense_kernel(const float* __restrict__ params, const int* __restrict__ layout,
                       const float* __restrict__ tri, const int* __restrict__ qpx,
                       const int* __restrict__ qpy, float4* __restrict__ out, int n, int width,
                       int height, int max_depth, int G, int M, unsigned long long* ops) {
  const Scene s = block_scene<kShared>(params, layout, tri, G, M, ops);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const int px = qpx[i], py = qpy[i];
    out[i] = px < 0 ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                    : render_pixel<kPlainForm, kMerged>(s, px, py, width, height, max_depth,
                                                        CapSpec{}, CapSpec{}, nullptr,
                                                        DeferOut{}, 0);
  }
  counters_end(ops);
}

template <bool kShared>
__global__ void __launch_bounds__(128)
    frame_defer_kernel(const float* __restrict__ params, const int* __restrict__ layout,
                       const float* __restrict__ tri, DeferOut rec, int width, int height,
                       int max_depth, int G, int M, CapSpec shadow_caps,
                       unsigned long long* ops) {
  const Scene s = block_scene<kShared>(params, layout, tri, G, M, ops);
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  if (px < width && py < height) {
    render_pixel<kDeferForm>(s, px, py, width, height, max_depth, CapSpec{}, shadow_caps,
                             nullptr, rec, py * width + px);
  }
  counters_end(ops);
}

}  // namespace gprt

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

// ops: a device counter that the counting builds add to (-DGPRT_COUNT_OPS:
// the frame's f32 FLOPs; -DGPRT_COUNT_SIMT: 2 x 16 + 1 SIMT counters); the
// default build ignores it. merged: launch the instantiation with merged
// occlusion marches. shared: the scene's tables in shared memory.
extern "C" int gprt_frame_render(const float* params, const int* layout, const float* tri,
                                 float* out, int width, int height, int max_depth,
                                 int num_geometries, int num_materials, int shared, int merged,
                                 unsigned long long* ops, int device, void* stream) {
  const auto kernel = frame_entry(merged, shared);
  size_t shmem;
  cudaError_t err = setup(kernel, num_geometries, num_materials, shared, device, &shmem);
  if (err != cudaSuccess) return (int)err;
  dim3 block(16, 8);
  dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  kernel<<<grid, block, shmem, (cudaStream_t)stream>>>(
      params, layout, tri, reinterpret_cast<float4*>(out), width, height, max_depth,
      num_geometries, num_materials, ops);
  return (int)cudaGetLastError();
}

// The frame kernel's resident blocks per SM and in all (a report; nothing is
// launched).
extern "C" int gprt_frame_residency(int num_geometries, int num_materials, int shared, int merged,
                                    int device, int* per_sm, int* total) {
  const auto kernel = frame_entry(merged, shared);
  size_t shmem;
  cudaError_t err = setup(kernel, num_geometries, num_materials, shared, device, &shmem);
  if (err != cudaSuccess) return (int)err;
  return (int)gprt::resident_blocks(kernel, shmem, device, per_sm, total);
}

// The compact form's main pass: out (H, W, 4), dirty (H, W) int32; the
// closest and occlusion passes' SDF and metaball step caps.
extern "C" int gprt_frame_compact(const float* params, const int* layout, const float* tri,
                                  float* out, int* dirty, int width, int height, int max_depth,
                                  int num_geometries, int num_materials, int shared,
                                  int closest_sdf_cap, int closest_mb_cap, int shadow_sdf_cap,
                                  int shadow_mb_cap, unsigned long long* ops, int device,
                                  void* stream) {
  const auto kernel = GPRT_PICK1(gprt::frame_compact_kernel, shared);
  size_t shmem;
  cudaError_t err = setup(kernel, num_geometries, num_materials, shared, device, &shmem);
  if (err != cudaSuccess) return (int)err;
  dim3 block(16, 8);
  dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  kernel<<<grid, block, shmem, (cudaStream_t)stream>>>(
      params, layout, tri, reinterpret_cast<float4*>(out), dirty, width, height, max_depth,
      num_geometries, num_materials, gprt::CapSpec{closest_sdf_cap, closest_mb_cap},
      gprt::CapSpec{shadow_sdf_cap, shadow_mb_cap}, ops);
  return (int)cudaGetLastError();
}

// The dense pass: n queue entries (qpx, qpy; -1 padding) -> out (n, 4);
// merged as for gprt_frame_render.
extern "C" int gprt_frame_dense(const float* params, const int* layout, const float* tri,
                                const int* qpx, const int* qpy, float* out, int n, int width,
                                int height, int max_depth, int num_geometries, int num_materials,
                                int shared, int merged, unsigned long long* ops, int device,
                                void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const auto kernel = GPRT_PICK2(gprt::frame_dense_kernel, merged, shared);
  size_t shmem;
  cudaError_t err = setup(kernel, num_geometries, num_materials, shared, device, &shmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(n + 127) / 128, 128, shmem, (cudaStream_t)stream>>>(
      params, layout, tri, qpx, qpy, reinterpret_cast<float4*>(out), n, width, height, max_depth,
      num_geometries, num_materials, ops);
  return (int)cudaGetLastError();
}

// The defer form's main pass: lit (D, H, W, 4), shadowed (D-1, H, W, 4),
// sinfo (D-1, H, W) int32, rays (D-1, H, W, 6); the occlusion passes' SDF
// and metaball step caps.
extern "C" int gprt_frame_defer(const float* params, const int* layout, const float* tri,
                                float* lit, float* shadowed, int* sinfo, float* rays, int width,
                                int height, int max_depth, int num_geometries, int num_materials,
                                int shared, int shadow_sdf_cap, int shadow_mb_cap,
                                unsigned long long* ops, int device, void* stream) {
  if (max_depth < 2) return (int)cudaErrorInvalidValue;
  const auto kernel = GPRT_PICK1(gprt::frame_defer_kernel, shared);
  size_t shmem;
  cudaError_t err = setup(kernel, num_geometries, num_materials, shared, device, &shmem);
  if (err != cudaSuccess) return (int)err;
  dim3 block(16, 8);
  dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  const gprt::DeferOut rec{reinterpret_cast<float4*>(lit), reinterpret_cast<float4*>(shadowed),
                           sinfo, rays, width * height};
  kernel<<<grid, block, shmem, (cudaStream_t)stream>>>(
      params, layout, tri, rec, width, height, max_depth, num_geometries, num_materials,
      gprt::CapSpec{shadow_sdf_cap, shadow_mb_cap}, ops);
  return (int)cudaGetLastError();
}

extern "C" const char* gprt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
