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
// the image and is not carried over. Register pressure and divergence are
// left to later work.
//
// Inputs: params (f32) and layout (int32) as kernels/frame_kernel.py packs
// them (header, then the reference's pack_frame_params blocks); tri, the
// F x 12 mesh face table (null without meshes); out is an (H, W, 4) f32
// image. The C entry returns cudaGetLastError() after the
// launch.

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
__device__ Hit closest_hit(const Scene& s, V3 o, V3 d, int level) {
  Hit h{kInf, -1, v3(0.0f, 0.0f, 0.0f)};
  float tp;
  if (plane_test(s, o, d, &tp)) {
    h.t = tp;
    h.gid = s.plane_gid;
    h.n = v3(0.0f, 1.0f, 0.0f);
  }
  closest_procedural(s, to_blas(s, o), d, level, true, &h);
  return h;
}

// Accept-first occlusion over [0, RAY_TMAX] with back-face culling.
__device__ bool occluded(const Scene& s, V3 o, V3 d, int level) {
  float tp;
  if (plane_test(s, o, d, &tp)) return true;
  return occluded_procedural(s, to_blas(s, o), d, kRayTMax, level) >= 0;
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

// One pixel: raygen, then per level the closest hit, the material pick,
// the shadow ray, the shading and the bounce; one float4 store.
__device__ void render_pixel(const Scene& s, float4* __restrict__ out, int px, int py, int width,
                             int height, int max_depth) {
  const V3 light = v3(s.cvec[4], s.cvec[5], s.cvec[6]);
  const float* amb = s.cvec + 8;
  const float* ldiff = s.cvec + 12;
  const float bg[4] = {F(0.8), F(0.9), F(1.0), F(1.0)};

  V3 o, d;
  raygen(s, px, py, width, height, &o, &d);
  float color[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float tw[4] = {1.0f, 1.0f, 1.0f, 1.0f};

  for (int level = 0; level < max_depth; ++level) {
    GPRT_OPS(6 + 13 + 7 + 22 + 18 + 1 + 3 + 8 + 4 * 9 + 7 + 2 + 5 + 3 * 14 + 11);
    Hit h = closest_hit(s, o, d, level);
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
    bool in_shadow = false;
    if (level + 1 < max_depth && hit && (kd > 0.0f || spec_c * ks > 0.0f)) {
      GPRT_OPS(13);
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
    GPRT_OPS(12);
    d = reflect(d, n);
    o = hp;
  }
  out[py * width + px] = make_float4(color[0], color[1], color[2], color[3]);
}

__global__ void __launch_bounds__(128)
    frame_kernel(const float* __restrict__ params, const int* __restrict__ layout,
                 const float* __restrict__ tri, float4* __restrict__ out, int width, int height, int max_depth, int G, int M,
                 unsigned long long* ops) {
  extern __shared__ float smem[];
#ifdef GPRT_COUNT_OPS
  if (threadIdx.x == 0 && threadIdx.y == 0) gprt_block_ops = 0;
#endif
  const Scene s = load_scene<true>(params, layout, tri, G, M, smem);
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  if (px < width && py < height) render_pixel(s, out, px, py, width, height, max_depth);
#ifdef GPRT_COUNT_OPS
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) atomicAdd(ops, gprt_block_ops);
#endif
}

}  // namespace gprt

// ops: a device counter that the counting build (-DGPRT_COUNT_OPS) adds
// the frame's f32 FLOPs to; the default build ignores it.
extern "C" int gprt_frame_render(const float* params, const int* layout, const float* tri,
                                 float* out, int width,
                                 int height, int max_depth, int num_geometries, int num_materials,
                                 unsigned long long* ops, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int G = num_geometries, M = num_materials;
  const size_t shmem = gprt::shared_bytes(true, G, M);
  err = gprt::reserve_shared(gprt::frame_kernel, shmem, device);
  if (err != cudaSuccess) return (int)err;
  dim3 block(16, 8);
  dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  gprt::frame_kernel<<<grid, block, shmem, (cudaStream_t)stream>>>(
      params, layout, tri, reinterpret_cast<float4*>(out), width, height, max_depth, G, M, ops);
  return (int)cudaGetLastError();
}

extern "C" const char* gprt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
