// Host stand-ins for the CUDA keywords, built-ins, intrinsics and runtime
// calls that the kernel sources use, so that g++ compiles a kernel source's
// device code (the part before its host launchers) for a rehearsal on the
// CPU: tests/test_torch_csrc_rehearsal.py builds frame_kernel.cu,
// scene_kernel.cu, scene_finish.cu, frame_gate.cu and megakernel.cu against
// it with -ffp-contract=off, which repeats the plain versions' arithmetic,
// and runs every block with one thread. A launch from device code is
// recorded, not made (GPRT_TAIL_LAUNCH below).
//
// A block of one thread is a warp of one lane: __activemask() and
// __match_any_sync() are that lane, a ballot, a vote (__any_sync,
// __syncthreads_or) is its predicate, a shuffle its own value; atomics are plain
// read-modify-writes; __syncthreads() and __threadfence() have nothing to
// order. The rounded intrinsics (__fmul_rn, ...) are the plain operators,
// which this build never contracts. Dynamic shared memory (`extern __shared__ float smem[]`)
// is gprt::smem, which the rehearsal defines.
//
// rh::run_warp runs a device function on a warp of emulated lanes instead:
// each lane a fiber with its own stack, switched on one thread, its
// threadIdx.x its lane. A lane runs until it reaches a warp vote
// (__ballot_sync, __any_sync, __shfl_sync), which waits for every lane of
// its mask; __activemask() is the group of lanes that the
// caller let enter together. A vote whose mask names a lane that has left,
// or that waits at another intrinsic or with another mask, is a fault of
// the device code (on the card it hangs or is undefined): the run stops
// and reports it.
#pragma once

#include <math.h>

#include <algorithm>
#include <cstddef>
#include <cstdlib>
#include <cstring>
#include <memory>

#include <ucontext.h>

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
__attribute__((noinline)) inline float __fdiv_rn(float a, float b) { return a / b; }
template <typename T>
inline T __ldg(const T* p) { return *p; }

inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }

namespace rh {

enum Vote { kBallot = 1, kShfl };

constexpr size_t kStackBytes = 1 << 18;

struct Lane {
  std::unique_ptr<char[]> stack;  // uninitialised: only the pages used are touched
  ucontext_t ctx;
  unsigned group = 0;  // its __activemask()
  bool live = false, waiting = false;
  int vote = 0, src = 0;
  unsigned mask = 0;
  long long value = 0, result = 0;
};

struct Warp {
  Lane lane[32];
  ucontext_t sched;
  int current = -1;
  void (*fn)(int lane, void* arg) = nullptr;
  void* arg = nullptr;
};

inline Warp* warp = nullptr;  // the warp being run, else one-lane blocks

inline void to_scheduler() {
  swapcontext(&warp->lane[warp->current].ctx, &warp->sched);
}

inline void lane_main() {
  const int l = warp->current;
  warp->fn(l, warp->arg);
  warp->lane[l].live = false;
  to_scheduler();  // never resumed
}

inline void to_lane(int l) {
  warp->current = l;
  threadIdx = dim3{(unsigned)l, 0, 0};
  swapcontext(&warp->sched, &warp->lane[l].ctx);
}

inline long long vote(int kind, unsigned mask, long long value, int src = 0) {
  Lane& me = warp->lane[warp->current];
  me.vote = kind, me.mask = mask, me.value = value, me.src = src, me.waiting = true;
  to_scheduler();
  return me.result;
}

// Runs fn(lane, arg) on the lanes of `groups`, masks of disjoint lanes that
// enter together (each lane's __activemask()), to the end; returns false
// where the lanes broke the rules of a vote (see the header).
inline bool run_warp(const unsigned* groups, int ngroups, void (*fn)(int, void*), void* arg) {
  Warp w;
  w.fn = fn;
  w.arg = arg;
  warp = &w;
  for (int k = 0; k < ngroups; ++k) {
    for (int l = 0; l < 32; ++l) {
      if (!(groups[k] >> l & 1u)) continue;
      Lane& ln = w.lane[l];
      ln.group = groups[k];
      ln.live = true;
      ln.stack.reset(new char[kStackBytes]);
      getcontext(&ln.ctx);
      ln.ctx.uc_stack.ss_sp = ln.stack.get();
      ln.ctx.uc_stack.ss_size = kStackBytes;
      ln.ctx.uc_link = nullptr;
      makecontext(&ln.ctx, lane_main, 0);
    }
  }
  bool ok = true;
  for (;;) {
    for (int l = 0; l < 32; ++l) {
      if (w.lane[l].live && !w.lane[l].waiting) to_lane(l);
    }
    int first = -1;
    for (int l = 0; l < 32 && first < 0; ++l) {
      if (w.lane[l].live) first = l;
    }
    if (first < 0) break;
    const Lane& f = w.lane[first];
    long long ballot = 0;
    for (int l = 0; l < 32 && ok; ++l) {
      if (!(f.mask >> l & 1u)) continue;
      const Lane& ln = w.lane[l];
      ok = ln.live && ln.waiting && ln.vote == f.vote && ln.mask == f.mask;
      if (ln.value != 0) ballot |= 1ll << l;
    }
    if (!ok || !(f.mask >> first & 1u)) {
      ok = false;
      break;
    }
    for (int l = 0; l < 32 && ok; ++l) {
      if (!(f.mask >> l & 1u)) continue;
      Lane& ln = w.lane[l];
      if (ln.vote == kBallot) ln.result = ballot;
      if (ln.vote == kShfl) {
        ok = ln.src >= 0 && ln.src < 32 && (f.mask >> ln.src & 1u);
        ln.result = ok ? w.lane[ln.src].value : 0;
      }
    }
    for (int l = 0; l < 32; ++l) {
      if (f.mask >> l & 1u) w.lane[l].waiting = false;
    }
    if (!ok) break;
  }
  warp = nullptr;
  threadIdx = dim3{0, 0, 0};
  return ok;
}

}  // namespace rh

// A launch from device code into the tail of its grid (frame_gate.cu
// GPRT_TAIL_LAUNCH): the rehearsal cannot launch from device code, so it
// records the launch's grid and block (and counts it) and drops the call;
// the rehearsal's entry then runs the child's body over the recorded grid.
// Written `kernel GPRT_TAIL_LAUNCH(grid, block, shmem)(args);` inside
// braces, it expands to three statements there.
namespace rh {

struct TailLaunch {
  dim3 grid, block;
};
inline TailLaunch tail;
inline int tail_launches = 0;

inline void record_tail(dim3 grid, dim3 block) {
  tail = TailLaunch{grid, block};
  ++tail_launches;
}

}  // namespace rh

#define GPRT_TAIL_LAUNCH(grid, block, shmem) \
  ;                                          \
  rh::record_tail(grid, block);              \
  (void)

inline void __syncthreads() {}
inline void __threadfence() {}
inline int __syncthreads_or(int pred) { return pred != 0; }
inline unsigned __activemask() { return rh::warp ? rh::warp->lane[rh::warp->current].group : 1u; }
inline unsigned __ballot_sync(unsigned mask, int pred) {
  return rh::warp ? (unsigned)rh::vote(rh::kBallot, mask, pred != 0) : (pred ? 1u : 0u);
}
inline int __any_sync(unsigned mask, int pred) { return __ballot_sync(mask, pred) != 0; }
// One-lane blocks only (rh::run_warp runs no code that calls it).
inline unsigned __match_any_sync(unsigned, int) {
  if (rh::warp) std::abort();
  return 1u;
}
template <typename T>
inline T __shfl_sync(unsigned mask, T v, int src) {
  static_assert(sizeof(T) <= sizeof(long long), "a shuffle moves one word");
  if (!rh::warp) return v;
  long long bits = 0;
  std::memcpy(&bits, &v, sizeof v);
  bits = rh::vote(rh::kShfl, mask, bits, src);
  T out;
  std::memcpy(&out, &bits, sizeof out);
  return out;
}
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
