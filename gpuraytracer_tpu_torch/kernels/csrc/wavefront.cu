// The wavefront's work between its traversal passes: three lane kernels,
// one thread per lane of the band, which with the passes make a frame one
// stream-ordered chain of launches with no host sync.
//
// Replaces: the XLA-fused level body of the reference's trace_radiance
// (gpuraytracer_tpu/render/trace.py:127-199, level_body under lax.scan,
// :205-209, compiled whole by jax.jit): raygen, the plane test and the
// passes' inputs, the merge of the plane and procedural hits, the material
// pick, Phong, checkers, Fresnel, fog, the colour and throughput recurrence,
// the exact kill and the reflected ray, which the port's trace_radiance runs
// as PyTorch ops over the lanes that a torch.nonzero compacts at every level
// (render/trace.py).
//
// The frame keeps every lane of the band, local_height x width in its raster
// order, for the whole frame, each under an active mask, as lax.scan keeps
// the reference's fixed shapes; the host loops over the levels (max_depth is
// static) and launches on the current stream:
//   start   raygen at the band's rows (row_offset, as the frame kernel's
//           raygen), then the plane test and the move to BLAS space: the
//           level-0 closest pass's inputs;
//   hit     after a closest pass: the plane and procedural hits merged
//           (accel/traverse.closest_hit), the surface, the shadow gate, the
//           shadow ray and its plane test: the occlusion pass's inputs
//           (traverse.pass_inputs(occlusion=True));
//   shade   after the occlusion pass (or the last level's closest pass):
//           the same surface, the shadow flag (plane-occluded, or the pass's
//           hit), the shading and the recurrence (the frame kernel's
//           per-level body), the exact kill, the reflected ray and the next
//           level's closest-pass inputs.
// An inactive lane's thread returns at once (hit writes its shadow ray off).
// The lane kernels read the shading blocks of the frame's pack (materials
// through the layout's material slots, so any number of materials; camera,
// light, plane) in place from global memory: a lane reads one material row
// and the warp-uniform constants, which the L1 cache serves, so no table is
// copied to shared memory and a scene of any size launches them.
//
// What bounds them: bytes. Each lane reads its state and a pass's answer
// once and writes its state once (start writes 73 B a lane, hit reads 45 and
// writes 29, shade reads up to 86 and writes 73), with a few dozen FLOPs
// (the checkerboard's two extra raygens on plane hits the most).
//
// Inputs: params (f32) and layout (int32) as kernels/frame_kernel.py packs
// them; the lanes' buffers as kernels/wavefront.py allocates them (f32 (n,
// 3) and (n, 4), bool (n,), int32 (n,)). Each C entry returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "shading.cuh"

namespace gprt {

// A level's shading, as frame_kernel.cu's render_pixel computes it: the same
// expressions in the same order (render/trace._surface, _shadow_ray,
// _shading). A copy, not shared: render_pixel written over these functions
// compiled to other SASS and cost row 1 1.2% (PERF.md §6, row 9), so the frame
// kernel keeps its own body. raygen, the plane test, to_blas and the
// checkerboard are shared (shading.cuh).
//
// What a level's closest hit leaves for the shading (render/trace._surface):
// the hit (gid -1 on a miss, t RAY_TMAX there), the hit position, the
// material row through the layout's material slots (row 0 on a miss), and
// Phong's geometry terms kd and ks, which also decide whether a shadow ray
// can change the pixel (``shadow_needed``).
struct Surface {
  bool hit;
  int gid;
  float t;
  V3 n, hp;
  float albedo[4];
  float refl, diff, spec_c, spec_p;
  float kd, ks;
};

__device__ __forceinline__ Surface surface(const Scene& s, const Hit& h, V3 o, V3 d, V3 light) {
  Surface f;
  f.hit = h.gid >= 0;
  f.gid = h.gid;
  f.t = f.hit ? h.t : kRayTMax;
  f.n = h.n;
  f.hp = along(o, f.t, d);
  const float* mrow = s.mat + 8 * (f.hit ? s.mat_ids[h.gid] : 0);
#pragma unroll
  for (int c = 0; c < 4; ++c) f.albedo[c] = mrow[c];
  f.refl = mrow[4], f.diff = mrow[5], f.spec_c = mrow[6], f.spec_p = mrow[7];
  const V3 incident = normalize(sub(f.hp, light));
  f.kd = saturate(dot3(neg(incident), f.n));
  const V3 refl_l = normalize(reflect(incident, f.n));
  f.ks = powf(saturate(dot3(refl_l, normalize(neg(d)))), f.spec_p);
  return f;
}

// Whether the shadow ray can change the pixel: the shadow factor scales the
// diffuse term (zero where kd == 0) and zeroes the specular term (zero where
// spec * ks == 0), so elsewhere the lit and the shadowed pixel are equal.
__device__ __forceinline__ bool shadow_needed(const Surface& f) {
  return f.hit && (f.kd > 0.0f || f.spec_c * f.ks > 0.0f);
}

// The shading terms of a level that do not depend on the shadow: fake AO's
// weight a, the checkerboard k (plane hits only), the Fresnel power f5, the
// reflectance gate and the fog.
struct Shading {
  float a, k, f5, fog;
  bool reflective;
};

__device__ __forceinline__ Shading shading(const Scene& s, const Surface& f, V3 d, int px, int py,
                                           int width, int height) {
  Shading g;
  g.a = 1.0f - saturate(dot3(f.n, v3(0.0f, -1.0f, 0.0f)));
  g.k = (f.hit && f.gid == s.plane_gid) ? checkers(s, f.hp, f.n, px, py, width, height) : 1.0f;
  // Fresnel-weighted reflection multiplier, gated on reflectance > 0.001.
  const float cosi = saturate(dot3(neg(d), f.n));
  g.f5 = powf(1.0f - cosi, 5.0f);
  g.reflective = f.hit && f.refl > F(0.001);
  g.fog = 1.0f - expf(F(-0.000002) * f.t * f.t * f.t);
  return g;
}

// Channel c of Phong with fake AO, with the shadow factor and specular of
// `shadowed` (render/shade.phong_lighting).
__device__ __forceinline__ float phong(const Scene& s, const Surface& f, const Shading& g,
                                       bool shadowed, int c) {
  const float* amb = s.cvec + 8;
  const float* ldiff = s.cvec + 12;
  const float sf = shadowed ? F(0.35) : 1.0f;
  const float dterm = sf * f.diff * f.kd;
  const float sterm = shadowed ? 0.0f : f.spec_c * f.ks;
  float ambient = f.albedo[c] * ((amb[c] - F(0.1)) + g.a * (amb[c] - (amb[c] - F(0.1))));
  return ambient + dterm * ldiff[c] * f.albedo[c] + sterm;
}

// Channel c of the level's colour before the throughput, base_d =
// (1 - fog) * checkers * phong + fog * BACKGROUND (the background on a miss).
__device__ __forceinline__ float base(const Surface& f, const Shading& g, float ph, int c) {
  const float bg[4] = {F(0.8), F(0.9), F(1.0), F(1.0)};
  return f.hit ? (1.0f - g.fog) * (g.k * ph) + g.fog * bg[c] : bg[c];
}

// Channel c of the reflection multiplier M_d = (1 - fog) * checkers *
// reflectance * float4(fresnel, 1), zero where the reflection is off.
__device__ __forceinline__ float mult(const Surface& f, const Shading& g, int c) {
  float rm = c < 3 ? f.refl * (f.albedo[c] + (1.0f - f.albedo[c]) * g.f5) : f.refl * 1.0f;
  rm = g.reflective ? rm : 0.0f;
  return f.hit ? (1.0f - g.fog) * g.k * rm : 0.0f;
}

// The level's recurrence: color += tw * base, tw *= M. Returns whether the
// outgoing throughput is nonzero on some channel (a lane whose throughput is
// exactly zero on every channel adds +0.0 at every later level).
__device__ __forceinline__ bool accumulate(const Scene& s, const Surface& f, const Shading& g,
                                           bool in_shadow, float color[4], float tw[4]) {
  bool live = false;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float m = mult(f, g, c);
    color[c] = color[c] + tw[c] * base(f, g, phong(s, f, g, in_shadow, c), c);
    tw[c] = tw[c] * m;
    live = live || tw[c] != 0.0f;
  }
  return live;
}

// The lanes' state between the passes (kernels/wavefront.Lanes), n lanes.
struct Lanes {
  float* o;       // n x 3: the ray's world origin
  float* d;       // n x 3: its direction (the closest pass's; BLAS space = world)
  float4* color;  // the colour so far (the band's image at the end)
  float4* tw;     // the throughput
  bool* active;   // live at this level: the closest pass's active mask
  float* ob;      // n x 3: the closest pass's BLAS-space origin
  float* t0;      // its t0: the plane's t where the plane hits, else RAY_TMAX
};

// A closest pass's answer (scene_kernel.cu, megakernel.cu): best_t, the
// world normal, the procedural geometry (-1: none beat t0).
struct Answer {
  const float* t;
  const float* n;
  const int* gid;
};

// The occlusion pass's inputs (kernels/wavefront.ShadowRays).
struct ShadowRays {
  float* ob;     // n x 3: BLAS-space origin
  float* d;      // n x 3: direction to the light
  bool* active;  // shadow needed and the plane does not occlude it
  float* t0;     // 0 where the plane occludes a needed shadow ray, else RAY_TMAX
};

__device__ __forceinline__ V3 load3(const float* p, int i) {
  return v3(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
}

__device__ __forceinline__ void store3(float* p, int i, V3 v) {
  p[3 * i] = v.x, p[3 * i + 1] = v.y, p[3 * i + 2] = v.z;
}

// The closest pass's inputs for lane i's ray (traverse.pass_inputs).
__device__ __forceinline__ void closest_inputs(const Scene& s, const Lanes& L, int i, V3 o, V3 d) {
  float tp;
  const bool plane = plane_test(s, o, d, &tp);
  store3(L.ob, i, to_blas(s, o));
  L.t0[i] = plane ? tp : kRayTMax;
}

// The closest hit of lane i (traverse.closest_hit's merge): the pass's
// procedural hit, else the plane's where it hits, else a miss.
__device__ __forceinline__ Hit merged_hit(const Scene& s, const Answer& a, int i, V3 o, V3 d) {
  Hit h{kInf, a.gid[i], v3(0.0f, 0.0f, 0.0f)};
  float tp;
  if (h.gid >= 0) {
    h.t = a.t[i];
    h.n = load3(a.n, i);
  } else if (plane_test(s, o, d, &tp)) {
    h.t = tp;
    h.gid = s.plane_gid;
    h.n = v3(0.0f, 1.0f, 0.0f);
  }
  return h;
}

__device__ __forceinline__ V3 light_of(const Scene& s) {
  return v3(s.cvec[4], s.cvec[5], s.cvec[6]);
}

// Lane i of the band's raster order: the camera ray of its pixel, colour 0,
// throughput 1, active, and the level-0 closest pass's inputs.
__device__ __forceinline__ void start_lane(const Scene& s, const Lanes& L, int i, int width,
                                           int height, int row_offset) {
  const int px = i % width, py = i / width + row_offset;
  V3 o, d;
  raygen(s, px, py, width, height, &o, &d);
  store3(L.o, i, o);
  store3(L.d, i, d);
  L.color[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  L.tw[i] = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  L.active[i] = true;
  closest_inputs(s, L, i, o, d);
}

// After lane i's closest pass: its shadow ray and the occlusion pass's
// inputs; an inactive lane's shadow ray is off.
__device__ __forceinline__ void hit_lane(const Scene& s, const Lanes& L, const Answer& a,
                                         const ShadowRays& R, int i) {
  if (!L.active[i]) {
    R.active[i] = false;
    R.t0[i] = kRayTMax;
    return;
  }
  const V3 o = load3(L.o, i), d = load3(L.d, i);
  const V3 light = light_of(s);
  const Surface f = surface(s, merged_hit(s, a, i, o, d), o, d, light);
  const V3 sd = normalize(sub(light, f.hp));
  float tp;
  const bool needed = shadow_needed(f);
  const bool plane = needed && plane_test(s, f.hp, sd, &tp);
  store3(R.ob, i, to_blas(s, f.hp));
  store3(R.d, i, sd);
  R.active[i] = needed && !plane;
  R.t0[i] = plane ? 0.0f : kRayTMax;
}

// After lane i's occlusion pass (sgid: its answer; null at the last level,
// which traces no shadow ray): the shading of the level, the recurrence, the
// kill, and where the lane lives on, its reflected ray and the next level's
// closest-pass inputs.
__device__ __forceinline__ void shade_lane(const Scene& s, const Lanes& L, const Answer& a,
                                           const ShadowRays& R, const int* sgid, int i,
                                           int width, int height, int row_offset, int level,
                                           int max_depth) {
  if (!L.active[i]) return;
  const V3 o = load3(L.o, i), d = load3(L.d, i);
  const Surface f = surface(s, merged_hit(s, a, i, o, d), o, d, light_of(s));
  // Shadowed: the plane occludes the needed shadow ray (t0 0), or the pass
  // found an occluder.
  const bool in_shadow = sgid != nullptr && (R.t0[i] == 0.0f || (R.active[i] && sgid[i] >= 0));
  const Shading g = shading(s, f, d, i % width, i / width + row_offset, width, height);
  const float4 c4 = L.color[i], t4 = L.tw[i];
  float color[4] = {c4.x, c4.y, c4.z, c4.w};
  float tw[4] = {t4.x, t4.y, t4.z, t4.w};
  const bool live = accumulate(s, f, g, in_shadow, color, tw);
  L.color[i] = make_float4(color[0], color[1], color[2], color[3]);
  L.tw[i] = make_float4(tw[0], tw[1], tw[2], tw[3]);
  // Exact kills: a non-reflective hit or a throughput that is exactly zero
  // on every channel adds +0.0 at every later level.
  const bool alive = g.reflective && live;
  L.active[i] = alive;
  if (alive && level + 1 < max_depth) {
    const V3 rd = reflect(d, f.n);
    store3(L.o, i, f.hp);
    store3(L.d, i, rd);
    closest_inputs(s, L, i, f.hp, rd);
  }
}

// The scene's shading blocks, read in place (every thread of the block
// calls it: load_scene synchronizes the block).
__device__ __forceinline__ Scene lane_scene(const float* __restrict__ params,
                                            const int* __restrict__ layout, int G, int M) {
  return load_scene<true, false>(params, layout, nullptr, G, M, nullptr);
}

constexpr int kLaneThreads = 256;

__global__ void __launch_bounds__(kLaneThreads)
    wavefront_start_kernel(const float* __restrict__ params, const int* __restrict__ layout,
                           Lanes L, int n, int width, int height, int row_offset, int G, int M) {
  const Scene s = lane_scene(params, layout, G, M);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) start_lane(s, L, i, width, height, row_offset);
}

__global__ void __launch_bounds__(kLaneThreads)
    wavefront_hit_kernel(const float* __restrict__ params, const int* __restrict__ layout,
                         Lanes L, Answer a, ShadowRays R, int n, int G, int M) {
  const Scene s = lane_scene(params, layout, G, M);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) hit_lane(s, L, a, R, i);
}

__global__ void __launch_bounds__(kLaneThreads)
    wavefront_shade_kernel(const float* __restrict__ params, const int* __restrict__ layout,
                           Lanes L, Answer a, ShadowRays R, const int* __restrict__ sgid, int n,
                           int width, int height, int row_offset, int level, int max_depth, int G,
                           int M) {
  const Scene s = lane_scene(params, layout, G, M);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) shade_lane(s, L, a, R, sgid, i, width, height, row_offset, level, max_depth);
}

__host__ inline unsigned lane_blocks(int n) {
  return (unsigned)((n + kLaneThreads - 1) / kLaneThreads);
}

}  // namespace gprt

static gprt::Lanes lanes(float* o, float* d, float* color, float* tw, bool* active, float* ob,
                         float* t0) {
  return gprt::Lanes{o, d, reinterpret_cast<float4*>(color), reinterpret_cast<float4*>(tw),
                     active, ob, t0};
}

// The start kernel over the band of local_height rows from row_offset of a
// width x height frame: n = local_height * width lanes; o, d, ob (n, 3),
// color, tw (n, 4) f32, active (n,) bool, t0 (n,) f32, written.
extern "C" int gprt_wavefront_start(const float* params, const int* layout, float* o, float* d,
                                    float* color, float* tw, bool* active, float* ob, float* t0,
                                    int width, int height, int row_offset, int local_height,
                                    int num_geometries, int num_materials, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (width <= 0 || local_height <= 0 || row_offset < 0 || row_offset + local_height > height) {
    return (int)cudaErrorInvalidValue;
  }
  const int n = width * local_height;
  gprt::wavefront_start_kernel<<<gprt::lane_blocks(n), gprt::kLaneThreads, 0,
                                 (cudaStream_t)stream>>>(
      params, layout, lanes(o, d, color, tw, active, ob, t0), n, width, height, row_offset,
      num_geometries, num_materials);
  return (int)cudaGetLastError();
}

// The hit kernel over n lanes: reads o, d, active and the closest pass's
// answer (best_t, normal, gid); writes the occlusion pass's inputs s_ob,
// s_d (n, 3), s_active (n,) bool, s_t0 (n,).
extern "C" int gprt_wavefront_hit(const float* params, const int* layout, float* o, float* d,
                                  bool* active, const float* best_t, const float* normal,
                                  const int* gid, float* s_ob, float* s_d, bool* s_active,
                                  float* s_t0, int n, int num_geometries, int num_materials,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  gprt::wavefront_hit_kernel<<<gprt::lane_blocks(n), gprt::kLaneThreads, 0,
                               (cudaStream_t)stream>>>(
      params, layout, lanes(o, d, nullptr, nullptr, active, nullptr, nullptr),
      gprt::Answer{best_t, normal, gid}, gprt::ShadowRays{s_ob, s_d, s_active, s_t0}, n,
      num_geometries, num_materials);
  return (int)cudaGetLastError();
}

// The shade kernel at `level` over the n lanes of the band of rows from
// row_offset of a width x height frame: reads the lanes, the closest pass's
// answer and, where s_gid is not null, the occlusion pass's inputs (s_active,
// s_t0) and answer (s_gid); updates color, tw, active and, for a lane that
// lives on below max_depth, o, d, ob, t0.
extern "C" int gprt_wavefront_shade(const float* params, const int* layout, float* o, float* d,
                                    float* color, float* tw, bool* active, float* ob, float* t0,
                                    const float* best_t, const float* normal, const int* gid,
                                    bool* s_active, float* s_t0, const int* s_gid, int width,
                                    int height, int row_offset, int local_height, int level,
                                    int max_depth, int num_geometries, int num_materials,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (width <= 0 || local_height <= 0 || row_offset < 0 || row_offset + local_height > height ||
      level < 0 || level >= max_depth || (s_gid != nullptr && level + 1 >= max_depth)) {
    return (int)cudaErrorInvalidValue;
  }
  const int n = width * local_height;
  gprt::wavefront_shade_kernel<<<gprt::lane_blocks(n), gprt::kLaneThreads, 0,
                                 (cudaStream_t)stream>>>(
      params, layout, lanes(o, d, color, tw, active, ob, t0), gprt::Answer{best_t, normal, gid},
      gprt::ShadowRays{nullptr, nullptr, s_active, s_t0}, s_gid, n, width, height, row_offset,
      level, max_depth, num_geometries, num_materials);
  return (int)cudaGetLastError();
}

extern "C" const char* gprt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
