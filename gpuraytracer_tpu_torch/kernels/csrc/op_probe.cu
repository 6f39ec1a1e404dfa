// Op-cost probe: one thread per element runs `iters` dependent iterations of
// an op mix on its value, in f32 or bf16.
//
// Replaces: tools/profile_vpu.py make_kernel (a Pallas kernel over a (256,
// 256) tile in VMEM, fori_loop(0, iters, body, x)), which priced the op
// classes a distance function is made of on the TPU's vector unit and asked
// whether a bf16 occlusion march would pay. The five mixes are the
// reference's, op for op: fma (eight dependent multiply-adds and a
// blend), minmax (max, min and selects), sqrt, rsqrt, cos.
//
// What bounds it on an H100: each iteration depends on the last, so a
// thread issues one mix per op latency; with the reference's 65,536
// elements (512 blocks of 128 threads, under a quarter of the card's
// resident threads) the probe reads the latency of the chain and the SFU
// (sqrt, rsqrt, cos), not the card's peak throughput, and its bytes (one
// read and one write per element) are nothing. That is what it measures:
// ns per element-iteration at the reference's shape. The loop is kept
// from being folded or hoisted by the dependent chain and `#pragma unroll
// 1`; bf16 uses cuda_bf16.h arithmetic (one bf16 rounding per op, as the
// reference's bf16 arrays round).
//
// Inputs: x (n,) f32 or bf16; out (n,) of the same type. The C entry
// returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gprt {

enum ProbeOp { kFma = 0, kMinMax = 1, kSqrt = 2, kRsqrt = 3, kCos = 4 };

__device__ __forceinline__ float probe_one(float) { return 1.0000001f; }
__device__ __forceinline__ __nv_bfloat16 probe_one(__nv_bfloat16) {
  return __float2bfloat16(1.0000001f);
}
__device__ __forceinline__ float probe_half(float) { return 0.5f; }
__device__ __forceinline__ __nv_bfloat16 probe_half(__nv_bfloat16) {
  return __float2bfloat16(0.5f);
}
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ __nv_bfloat16 vmax(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __hmax(a, b);
}
__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ __nv_bfloat16 vmin(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __hmin(a, b);
}
__device__ __forceinline__ float vsqrt(float a) { return sqrtf(a); }
__device__ __forceinline__ __nv_bfloat16 vsqrt(__nv_bfloat16 a) { return hsqrt(a); }
__device__ __forceinline__ float vrsqrt(float a) { return rsqrtf(a); }
__device__ __forceinline__ __nv_bfloat16 vrsqrt(__nv_bfloat16 a) { return hrsqrt(a); }
__device__ __forceinline__ float vcos(float a) { return cosf(a); }
__device__ __forceinline__ __nv_bfloat16 vcos(__nv_bfloat16 a) { return hcos(a); }

// One iteration of op mix kOp (tools/profile_vpu.py make_kernel's body).
template <int kOp, typename T>
__device__ __forceinline__ T probe_body(T v) {
  const T one = probe_one(v), half = probe_half(v);
  if (kOp == kFma) {
    // Both operands vary, so the chain cannot fold into one affine map.
    T a = v * v + half;
    T b = v * a + one;
    a = a * b + half;
    b = b * a + one;
    a = a * b + half;
    b = b * a + one;
    a = a * b + half;
    b = b * a + one;
    return a * half + b * half;
  }
  if (kOp == kMinMax) {
    T a = vmax(v, half);
    T b = vmin(v, one);
    T c = a > b ? a * half : b;
    a = vmax(c, half);
    b = vmin(c, one);
    return (a > b ? a * half : b) * one;
  }
  if (kOp == kSqrt) return vsqrt(v * v + one);
  if (kOp == kRsqrt) return vrsqrt(v * v + one);
  return vcos(v) + half;
}

template <int kOp, typename T>
__global__ void __launch_bounds__(128)
    op_probe_kernel(const T* __restrict__ x, T* __restrict__ out, int n, int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T v = x[i];
#pragma unroll 1
  for (int it = 0; it < iters; ++it) v = probe_body<kOp>(v);
  out[i] = v;
}

template <typename T>
static cudaError_t launch(int op, const void* x, void* out, int n, int iters,
                          cudaStream_t stream) {
  const T* xs = static_cast<const T*>(x);
  T* os = static_cast<T*>(out);
  const int grid = (n + 127) / 128;
  switch (op) {
    case kFma: op_probe_kernel<kFma, T><<<grid, 128, 0, stream>>>(xs, os, n, iters); break;
    case kMinMax: op_probe_kernel<kMinMax, T><<<grid, 128, 0, stream>>>(xs, os, n, iters); break;
    case kSqrt: op_probe_kernel<kSqrt, T><<<grid, 128, 0, stream>>>(xs, os, n, iters); break;
    case kRsqrt: op_probe_kernel<kRsqrt, T><<<grid, 128, 0, stream>>>(xs, os, n, iters); break;
    default: op_probe_kernel<kCos, T><<<grid, 128, 0, stream>>>(xs, os, n, iters); break;
  }
  return cudaGetLastError();
}

}  // namespace gprt

// op: 0 fma, 1 minmax, 2 sqrt, 3 rsqrt, 4 cos; bf16: 0 for f32 tensors, 1
// for bf16 ones.
extern "C" int gprt_op_probe(int op, int bf16, const void* x, void* out, int n, int iters,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || iters < 0 || op < 0 || op > 4) return (int)cudaErrorInvalidValue;
  err = bf16 ? gprt::launch<__nv_bfloat16>(op, x, out, n, iters, (cudaStream_t)stream)
             : gprt::launch<float>(op, x, out, n, iters, (cudaStream_t)stream);
  return (int)err;
}

extern "C" const char* gprt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
