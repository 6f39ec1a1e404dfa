// The whole frame in one kernel: one thread per pixel, as DXR's DispatchRays.
//
// Replaces: gpuraytracer_tpu/kernels/frame_kernel.py render_frame_tiles /
// _frame_kernel (plain mode), with the scene-kernel device functions that
// Pallas kernel inlines (scene_kernel._traverse_tile, _march_sdf_part,
// _normal_at, _march_metaballs_part, _metaball_normal, _local_ray) and the
// device math of kernels/soa.py (here in frame_math.cuh).
//
// Per thread: raygen; then per level the plane rect test, the closest
// traversal over the procedural instances in definition order (slab gate
// against the shrinking best t, local ray, march or closed form, normal to
// world), the material pick, the exact shadow-necessity gate, the
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
// the image and is not carried over. Register pressure and divergence are
// left to later work.
//
// Inputs: params (f32) and layout (int32) as kernels/frame_kernel.py packs
// them (header, then the reference's pack_frame_params blocks); out is an
// (H, W, 4) f32 image. The C entry returns cudaGetLastError() after the
// launch.

#include <cuda_runtime.h>

#include "frame_math.cuh"

namespace gprt {

constexpr int kFHeader = 8;
constexpr int kIHeader = 8;
constexpr int kGeoStride = 8;
constexpr float kRayTMax = 10000.0f;

enum Kind { kAnalytic = 0, kVolumetric = 1, kSignedDistance = 2 };

struct Scene {
  const float* hdr;     // elapsed, relax_r, relax_s, fail_scale_r, fail_scale_s
  const float* b2l;     // G x 12 (rows 0..2 of blas_to_local)
  const float* l2b;     // G x 9  (rotation of local_to_blas)
  const float* sscale;  // G
  const float* aabb;    // G x 6
  const float* mb;      // 3 x 4
  const float* mat;     // M x 8: albedo rgba, refl, diffuse, specular, power
  const float* p2w;     // 4 x 4 row-vector projection_to_world
  const float* cvec;    // 8 x 4: cam, light, ambient, diffuse, blas, plane o, plane s
  const int* geo;       // G x 8: kind, code, budgets r0 r1 s0 s1, capped s0 s1
  int G, M, plane_gid, has_plane;
};

struct Hit {
  float t;
  int gid;
  V3 n;
};

__device__ __forceinline__ void raygen(const Scene& s, int px, int py, int width, int height,
                                       V3* o, V3* d) {
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
  const float* po = s.cvec + 20;
  const float* ps = s.cvec + 24;
  float t = -(o.y - po[1]) / d.y;
  float px = o.x + t * d.x;
  float pz = o.z + t * d.z;
  bool inside = px >= po[0] && px <= po[0] + ps[0] && pz >= po[2] && pz <= po[2] + ps[1];
  *t_out = t;
  return inside && d.y < 0.0f && t >= 0.0f && t <= kRayTMax;
}

__device__ __forceinline__ void local_ray(const Scene& s, int g, V3 o, V3 d, V3* ol, V3* dl) {
  const float* m = s.b2l + 12 * g;
  *ol = v3(m[0] * o.x + m[1] * o.y + m[2] * o.z + m[3], m[4] * o.x + m[5] * o.y + m[6] * o.z + m[7],
           m[8] * o.x + m[9] * o.y + m[10] * o.z + m[11]);
  *dl = v3(m[0] * d.x + m[1] * d.y + m[2] * d.z, m[4] * d.x + m[5] * d.y + m[6] * d.z,
           m[8] * d.x + m[9] * d.y + m[10] * d.z);
}

// Straight-matrix local -> world normal, normalized by division.
__device__ __forceinline__ V3 normal_to_world(const Scene& s, int g, V3 n) {
  const float* m = s.l2b + 9 * g;
  V3 w = v3(m[0] * n.x + m[1] * n.y + m[2] * n.z, m[3] * n.x + m[4] * n.y + m[5] * n.z,
            m[6] * n.x + m[7] * n.y + m[8] * n.z);
  float l = sqrtf(w.x * w.x + w.y * w.y + w.z * w.z);
  return v3(w.x / l, w.y / l, w.z / l);
}

// Slab gate of geometry g against [0, t_max] in BLAS space.
__device__ __forceinline__ bool gate(const Scene& s, int g, V3 ob, V3 d, float t_max) {
  const float* a = s.aabb + 6 * g;
  Interval iv = slab(ob, d, v3(a[0], a[1], a[2]), v3(a[3], a[4], a[5]));
  return iv.tmax > iv.tmin && iv.tmax >= 0.0f && iv.tmin <= t_max;
}

__device__ __forceinline__ MarchSpec spec(const Scene& s, int g, bool occlusion, int level) {
  const int* q = s.geo + kGeoStride * g;
  MarchSpec m;
  int b = level > 0 ? 1 : 0;
  m.max_steps = occlusion ? q[4 + b] : q[2 + b];
  m.relax = occlusion ? s.hdr[2] : s.hdr[1];
  m.fail_scale = occlusion ? s.hdr[4] : s.hdr[3];
  m.capped_hit = occlusion && q[6 + b] != 0;
  m.cull = true;
  return m;
}

// Closest hit over the plane and every procedural geometry in definition
// order, strict-< reduction; gid -1 on a miss.
__device__ Hit closest_hit(const Scene& s, V3 o, V3 d, int level) {
  Hit h{kInf, -1, v3(0.0f, 0.0f, 0.0f)};
  float tp;
  if (plane_test(s, o, d, &tp)) {
    h.t = tp;
    h.gid = s.plane_gid;
    h.n = v3(0.0f, 1.0f, 0.0f);
  }
  V3 ob = v3(o.x - s.cvec[16], o.y - s.cvec[17], o.z - s.cvec[18]);
  bool deferred_normal = false;
  for (int g = 0; g < s.G; ++g) {
    float running = fminf(h.t, kRayTMax);
    if (!gate(s, g, ob, d, running)) continue;
    V3 ol, dl;
    local_ray(s, g, ob, d, &ol, &dl);
    const int kind = s.geo[kGeoStride * g], code = s.geo[kGeoStride * g + 1];
    float t = kInf;
    V3 nl = v3(0.0f, 0.0f, 0.0f);
    bool hit;
    bool marched = kind != kAnalytic;
    if (kind == kAnalytic) {
      hit = code == 0 ? intersect_hollow_aabb(ol, dl, running, true, &t, &nl)
                      : intersect_spheres(ol, dl, running, true, &t, &nl);
    } else if (kind == kVolumetric) {
      hit = march_metaballs(ol, dl, running, s.mb, true, &t);
    } else {
      hit = march_sdf(code, ol, dl, running, s.sscale[g], spec(s, g, false, level), &t);
    }
    if (hit && t < h.t) {
      h.t = t;
      h.gid = g;
      deferred_normal = marched;
      if (!marched) h.n = normal_to_world(s, g, nl);
    }
  }
  if (deferred_normal) {
    // The winning march's normal, at its own hit, computed once.
    int g = h.gid;
    V3 ol, dl;
    local_ray(s, g, ob, d, &ol, &dl);
    V3 pos = along(ol, h.t, dl);
    V3 nl = s.geo[kGeoStride * g] == kVolumetric ? metaballs_normal(pos, s.mb)
                                                 : sdf_normal(s.geo[kGeoStride * g + 1], pos);
    h.n = normal_to_world(s, g, nl);
  }
  return h;
}

// Accept-first occlusion over [0, RAY_TMAX] with back-face culling.
__device__ bool occluded(const Scene& s, V3 o, V3 d, int level) {
  float tp;
  if (plane_test(s, o, d, &tp)) return true;
  V3 ob = v3(o.x - s.cvec[16], o.y - s.cvec[17], o.z - s.cvec[18]);
  for (int g = 0; g < s.G; ++g) {
    if (!gate(s, g, ob, d, kRayTMax)) continue;
    V3 ol, dl;
    local_ray(s, g, ob, d, &ol, &dl);
    const int kind = s.geo[kGeoStride * g], code = s.geo[kGeoStride * g + 1];
    float t;
    V3 nl;
    bool hit;
    if (kind == kAnalytic) {
      hit = code == 0 ? intersect_hollow_aabb(ol, dl, kRayTMax, true, &t, &nl)
                      : intersect_spheres(ol, dl, kRayTMax, true, &t, &nl);
    } else if (kind == kVolumetric) {
      hit = march_metaballs(ol, dl, kRayTMax, s.mb, true, &t);
    } else {
      hit = march_sdf(code, ol, dl, kRayTMax, s.sscale[g], spec(s, g, true, level), &t);
    }
    if (hit) return true;
  }
  return false;
}

// AnalyticalCheckersTexture with ray differentials from the neighbour
// pixels' camera rays (render/checkers.py).
__device__ float checkers(const Scene& s, V3 hp, V3 n, int px, int py, int width, int height) {
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

__global__ void __launch_bounds__(128)
    frame_kernel(const float* __restrict__ params, const int* __restrict__ layout,
                 float4* __restrict__ out, int width, int height, int max_depth, int G, int M) {
  extern __shared__ float smem[];
  const int nf = kFHeader + G * (12 + 9 + 1 + 6) + 12 + M * 8 + 16 + 32;
  const int ni = kIHeader + kGeoStride * G;
  int* ismem = reinterpret_cast<int*>(smem + nf);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int k = tid; k < nf; k += nthreads) smem[k] = params[k];
  for (int k = tid; k < ni; k += nthreads) ismem[k] = layout[k];
  __syncthreads();

  Scene s;
  s.hdr = smem;
  s.b2l = s.hdr + kFHeader;
  s.l2b = s.b2l + 12 * G;
  s.sscale = s.l2b + 9 * G;
  s.aabb = s.sscale + G;
  s.mb = s.aabb + 6 * G;
  s.mat = s.mb + 12;
  s.p2w = s.mat + 8 * M;
  s.cvec = s.p2w + 16;
  s.geo = ismem + kIHeader;
  s.G = G;
  s.M = M;
  s.plane_gid = ismem[2];
  s.has_plane = ismem[3];

  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  if (px >= width || py >= height) return;

  const V3 light = v3(s.cvec[4], s.cvec[5], s.cvec[6]);
  const float* amb = s.cvec + 8;
  const float* ldiff = s.cvec + 12;
  const float bg[4] = {F(0.8), F(0.9), F(1.0), F(1.0)};

  V3 o, d;
  raygen(s, px, py, width, height, &o, &d);
  float color[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float tw[4] = {1.0f, 1.0f, 1.0f, 1.0f};

  for (int level = 0; level < max_depth; ++level) {
    Hit h = closest_hit(s, o, d, level);
    const bool hit = h.gid >= 0;
    const float t = hit ? h.t : kRayTMax;
    const V3 n = h.n;
    const V3 hp = along(o, t, d);
    const float* mrow = s.mat + 8 * (hit ? h.gid : 0);
    const float albedo[4] = {mrow[0], mrow[1], mrow[2], mrow[3]};
    const float refl = mrow[4], diff = mrow[5], spec_c = mrow[6], spec_p = mrow[7];

    // Phong geometry terms (render/shade.phong_lighting); they also decide
    // whether the shadow ray can change the pixel.
    const V3 incident = normalize(sub(hp, light));
    const float kd = saturate(dot3(neg(incident), n));
    const V3 refl_l = normalize(reflect(incident, n));
    const float ks = powf(saturate(dot3(refl_l, normalize(neg(d)))), spec_p);
    bool in_shadow = false;
    if (level + 1 < max_depth && hit && (kd > 0.0f || spec_c * ks > 0.0f)) {
      in_shadow = occluded(s, hp, normalize(sub(light, hp)), level);
    }
    const float sf = in_shadow ? F(0.35) : 1.0f;
    const float dterm = sf * diff * kd;
    const float sterm = in_shadow ? 0.0f : spec_c * ks;
    const float a = 1.0f - saturate(dot3(n, v3(0.0f, -1.0f, 0.0f)));
    float phong[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float ambient = albedo[c] * ((amb[c] - F(0.1)) + a * (amb[c] - (amb[c] - F(0.1))));
      phong[c] = ambient + dterm * ldiff[c] * albedo[c] + sterm;
    }

    const float k = (hit && h.gid == s.plane_gid) ? checkers(s, hp, n, px, py, width, height) : 1.0f;

    // Fresnel-weighted reflection multiplier, gated on reflectance > 0.001.
    const float cosi = saturate(dot3(neg(d), n));
    const float f5 = powf(1.0f - cosi, 5.0f);
    const bool reflective = hit && refl > F(0.001);
    const float fog = 1.0f - expf(F(-0.000002) * t * t * t);
    bool live = false;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float rm = c < 3 ? refl * (albedo[c] + (1.0f - albedo[c]) * f5) : refl * 1.0f;
      rm = reflective ? rm : 0.0f;
      float base = hit ? (1.0f - fog) * (k * phong[c]) + fog * bg[c] : bg[c];
      float mult = hit ? (1.0f - fog) * k * rm : 0.0f;
      color[c] = color[c] + tw[c] * base;
      tw[c] = tw[c] * mult;
      live = live || tw[c] != 0.0f;
    }
    // Exact kills: a non-reflective hit or a throughput that is exactly
    // zero on every channel adds +0.0 at every later level.
    if (!(reflective && live)) break;
    d = reflect(d, n);
    o = hp;
  }
  out[py * width + px] = make_float4(color[0], color[1], color[2], color[3]);
}

}  // namespace gprt

extern "C" int gprt_frame_render(const float* params, const int* layout, float* out, int width,
                                 int height, int max_depth, int num_geometries, int num_materials,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int G = num_geometries, M = num_materials;
  const size_t nf = gprt::kFHeader + G * (12 + 9 + 1 + 6) + 12 + M * 8 + 16 + 32;
  const size_t ni = gprt::kIHeader + gprt::kGeoStride * G;
  const size_t shmem = (nf + ni) * 4;
  if (shmem > 48 * 1024) return (int)cudaErrorInvalidValue;
  dim3 block(16, 8);
  dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  gprt::frame_kernel<<<grid, block, shmem, (cudaStream_t)stream>>>(
      params, layout, reinterpret_cast<float4*>(out), width, height, max_depth, G, M);
  return (int)cudaGetLastError();
}

extern "C" const char* gprt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
