// Host stand-ins for the CUDA keywords, built-ins, intrinsics and runtime
// calls that the kernel sources use, so that g++ compiles a kernel source's
// device code (the part before its host launchers) for a rehearsal on the
// CPU: tests/test_torch_csrc_rehearsal.py builds frame_kernel.cu,
// scene_kernel.cu and megakernel.cu against it with -ffp-contract=off, which
// repeats the plain versions' arithmetic, and runs every block with one
// thread.
//
// A block of one thread is a warp of one lane: __activemask() and
// __match_any_sync() are that lane, a ballot, a vote (__any_sync,
// __syncthreads_or) is its predicate, a shuffle its own value; atomics are plain
// read-modify-writes; __syncthreads() has nothing to wait for. The rounded
// intrinsics (__fmul_rn, ...) are the plain operators, which this build
// never contracts. Dynamic shared memory (`extern __shared__ float smem[]`)
// is gprt::smem, which the rehearsal defines.
#pragma once

#include <math.h>

#include <algorithm>
#include <cstddef>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __constant__
#define __shared__
#define __launch_bounds__(...)

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
};
inline dim3 threadIdx, blockIdx, blockDim, gridDim;

struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) { return float4{x, y, z, w}; }

using std::max;
using std::min;

// Out of line, so that a build that contracts (-ffp-contract=fast) cannot
// fuse them into an FMA either, as nvcc never does.
__attribute__((noinline)) inline float __fmul_rn(float a, float b) { return a * b; }
__attribute__((noinline)) inline float __fadd_rn(float a, float b) { return a + b; }
__attribute__((noinline)) inline float __fsub_rn(float a, float b) { return a - b; }
template <typename T>
inline T __ldg(const T* p) { return *p; }

inline void __syncthreads() {}
inline int __syncthreads_or(int pred) { return pred != 0; }
inline unsigned __activemask() { return 1u; }
inline int __any_sync(unsigned, int pred) { return pred != 0; }
inline unsigned __ballot_sync(unsigned, int pred) { return pred ? 1u : 0u; }
inline unsigned __match_any_sync(unsigned, int) { return 1u; }
template <typename T>
inline T __shfl_sync(unsigned, T v, int) { return v; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
template <typename T>
inline T atomicAdd(T* p, T v) {
  const T old = *p;
  *p = old + v;
  return old;
}

enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9,
  cudaErrorNotSupported = 801
};
enum cudaDeviceAttr { cudaDevAttrMaxSharedMemoryPerBlockOptin, cudaDevAttrMultiProcessorCount };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = 0;
  return cudaSuccess;
}
template <typename Kernel>
inline cudaError_t cudaFuncSetAttribute(Kernel, cudaFuncAttribute, int) {
  return cudaSuccess;
}
