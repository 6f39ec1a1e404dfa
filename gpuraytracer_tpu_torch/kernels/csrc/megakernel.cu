// One geometry at a time over flat rays: one thread per ray.
//
// sphere_trace replaces gpuraytracer_tpu/kernels/megakernel.py
// sphere_trace_tiles / _tile_march_kernel: one SDF geometry's march over
// (N,) local rays behind a gate, with a march start (the AABB window's entry
// for the extension codes), a per-ray t_max and the call's march spec
// (budget, relaxation, capped-hit rule, cull, escape bound), then the
// tetrahedral normal at the hit. Out: t_hit (+inf on a miss; 0 where a
// capped march reports a hit, as the reference writes it) and the local
// normal ((0, 0, 0) on a miss, where the reference evaluates the normal at
// the zeroed position and no caller reads it). The march and the normal are
// frame_math.cuh's march_sdf and sdf_normal, the frame and scene kernels'
// own. The TPU schedule ((32, 128) tiles, the pause/check split of the
// march, the unroll) is not behaviour and is not carried over.
//
// trimesh is the one-geometry mesh entry of the same route (the reference
// runs it in XLA as geometry/trimesh.intersect_trimesh's lax.scan): the
// closest face of one mesh's rows of the face table for each gated ray, by
// traverse.cuh's intersect_trimesh.
//
// The route (accel/traverse.per_geometry_route) runs a scene past
// TRI_FACE_TOTAL_CAP faces one geometry at a time: one launch per SDF
// geometry and per mesh in each closest and each occlusion pass.
//
// What bounds it on an H100: the march's divergent per-lane loop (ALU- and
// latency-bound, as in the frame kernel); every ray reads its gate (1 B) and
// writes 16 B, and only a gated ray reads o, d, t_max (and t_start), 28-32
// B. The mesh entry is bound by its face
// loop: every gated ray tests every face, reading the rows through the
// read-only cache (the rows of one mesh are a few KB and stay in L1/L2).
// What the design does about it: rays are read and written once, a ray
// outside its gate returns at once, and every march stops early by the
// reference's result-exact rules.
//
// The C entries return cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "traverse.cuh"

namespace gprt {

__global__ void __launch_bounds__(128)
    sphere_trace(const float* __restrict__ o, const float* __restrict__ d,
                 const bool* __restrict__ gate, const float* __restrict__ t_max,
                 const float* __restrict__ t_start, float* __restrict__ t_hit,
                 float* __restrict__ normal, int n, int code, float step_scale, MarchSpec m,
                 unsigned long long* ops) {
#ifdef GPRT_COUNT_OPS
  if (threadIdx.x == 0) gprt_block_ops = 0;
  __syncthreads();
#endif
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    float t = kInf;
    V3 nl = v3(0.0f, 0.0f, 0.0f);
    if (gate[i]) {
      const V3 ol = v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]);
      const V3 dl = v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]);
      float th = kInf;
      const int r = march_sdf(code, ol, dl, t_start ? t_start[i] : 0.0f, t_max[i], step_scale, m,
                              &th);
      if (march_hit(r, m)) {
        GPRT_OPS(6);
        t = r == kMarchCapped ? 0.0f : th;
        nl = hit_normal(code, along(ol, t, dl));
      }
    }
    t_hit[i] = t;
    normal[3 * i] = nl.x;
    normal[3 * i + 1] = nl.y;
    normal[3 * i + 2] = nl.z;
  }
#ifdef GPRT_COUNT_OPS
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(ops, gprt_block_ops);
#endif
}

__global__ void __launch_bounds__(128)
    trimesh(const float* __restrict__ tri, int count, const float* __restrict__ o,
            const float* __restrict__ d, const bool* __restrict__ gate,
            const float* __restrict__ t_max, float* __restrict__ t_hit,
            float* __restrict__ normal, int n, int cull, unsigned long long* ops) {
#ifdef GPRT_COUNT_OPS
  if (threadIdx.x == 0) gprt_block_ops = 0;
  __syncthreads();
#endif
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    float t = kInf;
    V3 nl = v3(0.0f, 0.0f, 0.0f);
    if (gate[i]) {
      const V3 ol = v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]);
      const V3 dl = v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]);
      float th;
      V3 nh;
      if (intersect_trimesh(tri, count, ol, dl, t_max[i], cull != 0, &th, &nh)) {
        t = th;
        nl = nh;
      }
    }
    t_hit[i] = t;
    normal[3 * i] = nl.x;
    normal[3 * i + 1] = nl.y;
    normal[3 * i + 2] = nl.z;
  }
#ifdef GPRT_COUNT_OPS
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(ops, gprt_block_ops);
#endif
}

}  // namespace gprt

// o, d: (n, 3) f32 local rays; gate (n,) bool; t_max (n,) f32; t_start (n,)
// f32 or null (march from 0); t_hit (n,) and normal (n, 3) f32 out. ops: a
// device counter that the counting build (-DGPRT_COUNT_OPS) adds the call's
// f32 FLOPs to; the default build ignores it.
extern "C" int gprt_sphere_trace(const float* o, const float* d, const bool* gate,
                                 const float* t_max, const float* t_start, float* t_hit,
                                 float* normal, int n, int code, float step_scale, int max_steps,
                                 float relax, float fail_scale, int capped_hit, int cull,
                                 int escape, unsigned long long* ops, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || code < 0 || code > 8 || max_steps < 0) return (int)cudaErrorInvalidValue;
  gprt::MarchSpec m;
  m.max_steps = max_steps;
  m.relax = relax;
  m.fail_scale = fail_scale;
  m.capped_hit = capped_hit != 0;
  m.cull = cull != 0;
  m.escape = escape != 0;
  gprt::sphere_trace<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      o, d, gate, t_max, t_start, t_hit, normal, n, code, step_scale, m, ops);
  return (int)cudaGetLastError();
}

// tri: one mesh's `count` rows of the face table (F x 12 f32: v0, e1, e2, n).
extern "C" int gprt_trimesh(const float* tri, int count, const float* o, const float* d,
                            const bool* gate, const float* t_max, float* t_hit, float* normal,
                            int n, int cull, unsigned long long* ops, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || count < 0) return (int)cudaErrorInvalidValue;
  gprt::trimesh<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(tri, count, o, d, gate, t_max,
                                                                    t_hit, normal, n, cull, ops);
  return (int)cudaGetLastError();
}

extern "C" const char* gprt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
