// Op-cost probe: one thread runs `iters` dependent iterations of an op mix on
// its value, in f32 (one element a thread) or bf16 (two elements a thread,
// as one packed pair).
//
// Replaces: tools/profile_vpu.py make_kernel (a Pallas kernel over a (256,
// 256) tile in VMEM, fori_loop(0, iters, body, x)), which priced the op
// classes a distance function is made of on the TPU's vector unit and asked
// whether a bf16 occlusion march would pay. The five mixes are the
// reference's, op for op: fma (eight dependent multiply-adds and a
// blend), minmax (max, min and selects), sqrt, rsqrt, cos.
//
// What bounds it on an H100: each iteration depends on the last, so a
// thread issues one mix per chain latency; with the reference's 65,536
// elements (512 blocks of 128 threads in f32, 256 in bf16: under a quarter
// of the card's resident threads) the probe reads the latency of the chain
// and the MUFU (sqrt, rsqrt, cos), not the card's peak throughput, and its
// bytes (one read and one write per element) are nothing. That is what it
// measures: ns per element-iteration at the reference's shape
// (apps/op_probe.py also prices each variant's SASS by pipe).
//
// bf16 rounds once per op, as the reference's bf16 arrays and PyTorch's
// bf16 tensors round: a product and a sum each rounded to nearest
// (mul.rn / add.rn, which no compiler contracts into one fma), min, max and
// selects exact, and sqrt, rsqrt and cos computed by the f32 variants'
// functions and rounded once. The card's bf16 rate is a rate of packed
// pairs (HFMA2, HMUL2, HADD2, HMNMX2), so each thread computes two elements
// as one __nv_bfloat162 and issues one instruction for both wherever the
// pair has one; sqrt, rsqrt and cos have none and run per element on the
// MUFU. The -DGPRT_PROBE_BF16_SCALAR build computes one element a thread
// (the parent's form) with the same per-element rounding: the packed build
// equals it element for element, for checks. The loop is kept from being
// folded or hoisted by the dependent chain and `#pragma unroll 1`.
//
// The latency chains (latency_kernel) are the instrument that prices a
// probe's dependent chain: one thread runs kChainLength dependent
// instructions of one SASS class, `iters` times, between two reads of the
// SM's clock, and writes the cycles. The operands come from kernel
// arguments and each instruction takes the last one's result, so that the
// assembler can neither fold the chain nor overlap it; apps/op_probe.py
// reads each class's cycles an instruction (its SASS counted from the
// built library) and prices the probe loops' SASS with them. Seeded from
// the thread's index, so that no link runs on the uniform datapath.
//
// Inputs: x (n,) f32 or bf16; out (n,) of the same type (bf16: 4-byte
// aligned in the packed build). The C entries return cudaGetLastError()
// after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace gprt {

enum ProbeOp { kFma = 0, kMinMax = 1, kSqrt = 2, kRsqrt = 3, kCos = 4 };

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf16x2;

__device__ __forceinline__ unsigned short bits(bf16 a) { return __bfloat16_as_ushort(a); }
__device__ __forceinline__ bf16 from_bits(unsigned short b) { return __ushort_as_bfloat16(b); }
__device__ __forceinline__ unsigned bits(bf16x2 a) { return *reinterpret_cast<unsigned*>(&a); }
__device__ __forceinline__ bf16x2 from_bits(unsigned b) { return *reinterpret_cast<bf16x2*>(&b); }

// The f32 variants' values of the constants: 1.0000001 and 0.5.
__device__ __forceinline__ float probe_one(float) { return 1.0000001f; }
__device__ __forceinline__ bf16 probe_one(bf16) { return __float2bfloat16_rn(1.0000001f); }
__device__ __forceinline__ bf16x2 probe_one(bf16x2) {
  return __float2bfloat162_rn(1.0000001f);
}
__device__ __forceinline__ float probe_half(float) { return 0.5f; }
__device__ __forceinline__ bf16 probe_half(bf16) { return __float2bfloat16_rn(0.5f); }
__device__ __forceinline__ bf16x2 probe_half(bf16x2) { return __float2bfloat162_rn(0.5f); }

// a * b and a + b: f32 as written (the build's contraction applies); bf16
// rounded to nearest at each op.
__device__ __forceinline__ float vmul(float a, float b) { return a * b; }
__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ bf16 vmul(bf16 a, bf16 b) {
  unsigned short r;
  asm("mul.rn.bf16 %0, %1, %2;" : "=h"(r) : "h"(bits(a)), "h"(bits(b)));
  return from_bits(r);
}
__device__ __forceinline__ bf16 vadd(bf16 a, bf16 b) {
  unsigned short r;
  asm("add.rn.bf16 %0, %1, %2;" : "=h"(r) : "h"(bits(a)), "h"(bits(b)));
  return from_bits(r);
}
__device__ __forceinline__ bf16x2 vmul(bf16x2 a, bf16x2 b) {
  unsigned r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(bits(a)), "r"(bits(b)));
  return from_bits(r);
}
__device__ __forceinline__ bf16x2 vadd(bf16x2 a, bf16x2 b) {
  unsigned r;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(bits(a)), "r"(bits(b)));
  return from_bits(r);
}

__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ bf16 vmax(bf16 a, bf16 b) { return __hmax(a, b); }
__device__ __forceinline__ bf16x2 vmax(bf16x2 a, bf16x2 b) { return __hmax2(a, b); }
__device__ __forceinline__ float vmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ bf16 vmin(bf16 a, bf16 b) { return __hmin(a, b); }
__device__ __forceinline__ bf16x2 vmin(bf16x2 a, bf16x2 b) { return __hmin2(a, b); }

// a > b ? x : y, per element.
__device__ __forceinline__ float vsel_gt(float a, float b, float x, float y) {
  return a > b ? x : y;
}
__device__ __forceinline__ bf16 vsel_gt(bf16 a, bf16 b, bf16 x, bf16 y) {
  return __hgt(a, b) ? x : y;
}
__device__ __forceinline__ bf16x2 vsel_gt(bf16x2 a, bf16x2 b, bf16x2 x, bf16x2 y) {
  // __hgt2 gives 1.0 (0x3f80) or 0 in each half: bit 13 of a half is set
  // only for 1.0, and stretches to that half's mask.
  const unsigned m = ((bits(__hgt2(a, b)) >> 13) & 0x00010001u) * 0xffffu;
  return from_bits((bits(x) & m) | (bits(y) & ~m));
}

// f(a) in f32, rounded once to bf16 (each half of a pair on its own).
template <typename Fn>
__device__ __forceinline__ float vmap(float a, Fn f) { return f(a); }
template <typename Fn>
__device__ __forceinline__ bf16 vmap(bf16 a, Fn f) {
  return __float2bfloat16_rn(f(__bfloat162float(a)));
}
template <typename Fn>
__device__ __forceinline__ bf16x2 vmap(bf16x2 a, Fn f) {
  return __floats2bfloat162_rn(f(__low2float(a)), f(__high2float(a)));
}

struct Sqrt {
  __device__ float operator()(float a) const { return sqrtf(a); }
};
struct Rsqrt {
  __device__ float operator()(float a) const { return rsqrtf(a); }
};
struct Cos {
  __device__ float operator()(float a) const { return cosf(a); }
};

// One iteration of op mix kOp (tools/profile_vpu.py make_kernel's body).
template <int kOp, typename T>
__device__ __forceinline__ T probe_body(T v) {
  const T one = probe_one(v), half = probe_half(v);
  if (kOp == kFma) {
    // Both operands vary, so the chain cannot fold into one affine map.
    T a = vadd(vmul(v, v), half);
    T b = vadd(vmul(v, a), one);
    a = vadd(vmul(a, b), half);
    b = vadd(vmul(b, a), one);
    a = vadd(vmul(a, b), half);
    b = vadd(vmul(b, a), one);
    a = vadd(vmul(a, b), half);
    b = vadd(vmul(b, a), one);
    return vadd(vmul(a, half), vmul(b, half));
  }
  if (kOp == kMinMax) {
    T a = vmax(v, half);
    T b = vmin(v, one);
    T c = vsel_gt(a, b, vmul(a, half), b);
    a = vmax(c, half);
    b = vmin(c, one);
    return vmul(vsel_gt(a, b, vmul(a, half), b), one);
  }
  if (kOp == kSqrt) return vmap(vadd(vmul(v, v), one), Sqrt());
  if (kOp == kRsqrt) return vmap(vadd(vmul(v, v), one), Rsqrt());
  return vadd(vmap(v, Cos()), half);
}

// One element a thread.
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

// Two bf16 elements a thread, as one pair (an odd n's last thread carries
// its element twice and stores one).
template <int kOp>
__global__ void __launch_bounds__(128)
    op_probe_pair_kernel(const bf16* __restrict__ x, bf16* __restrict__ out, int n, int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (2 * i >= n) return;
  const bool whole = 2 * i + 1 < n;
  bf16x2 v = whole ? reinterpret_cast<const bf16x2*>(x)[i] : __bfloat162bfloat162(x[2 * i]);
#pragma unroll 1
  for (int it = 0; it < iters; ++it) v = probe_body<kOp>(v);
  if (whole) {
    reinterpret_cast<bf16x2*>(out)[i] = v;
  } else {
    out[2 * i] = __low2bfloat16(v);
  }
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

#ifndef GPRT_PROBE_BF16_SCALAR
static cudaError_t launch_pairs(int op, const void* x, void* out, int n, int iters,
                                cudaStream_t stream) {
  const bf16* xs = static_cast<const bf16*>(x);
  bf16* os = static_cast<bf16*>(out);
  const int grid = ((n + 1) / 2 + 127) / 128;
  switch (op) {
    case kFma: op_probe_pair_kernel<kFma><<<grid, 128, 0, stream>>>(xs, os, n, iters); break;
    case kMinMax: op_probe_pair_kernel<kMinMax><<<grid, 128, 0, stream>>>(xs, os, n, iters); break;
    case kSqrt: op_probe_pair_kernel<kSqrt><<<grid, 128, 0, stream>>>(xs, os, n, iters); break;
    case kRsqrt: op_probe_pair_kernel<kRsqrt><<<grid, 128, 0, stream>>>(xs, os, n, iters); break;
    default: op_probe_pair_kernel<kCos><<<grid, 128, 0, stream>>>(xs, os, n, iters); break;
  }
  return cudaGetLastError();
}
#endif

// The latency chains' classes (apps/op_probe.LATENCY_CLASSES names them):
// FFMA, FADD, IMAD (the FMA pipe), FMNMX (the ALU), HFMA2, HMUL2, HADD2
// (the packed pair pipe), HMNMX2, MUFU.RSQ, and F2I then I2F (the
// conversions, a pair of instructions a link).
enum LatencyClass {
  kLatFfma = 0, kLatFadd, kLatImad, kLatFmnmx, kLatHfma2, kLatHmul2, kLatHadd2, kLatHmnmx2,
  kLatRsq, kLatCvt, kLatClasses
};
constexpr int kChainLength = 64;

// One link of class kClass's chain on the carried values (x, y); a and b
// are kernel arguments, unknown to the assembler.
template <int kClass>
__device__ __forceinline__ void chain_link(float& x, unsigned& y, float a, float b, unsigned ua,
                                           unsigned ub) {
  if constexpr (kClass == kLatFfma) {
    asm volatile("fma.rn.f32 %0, %0, %1, %2;" : "+f"(x) : "f"(a), "f"(b));
  } else if constexpr (kClass == kLatFadd) {
    asm volatile("add.rn.f32 %0, %0, %1;" : "+f"(x) : "f"(a));
  } else if constexpr (kClass == kLatImad) {
    asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(y) : "r"(ua), "r"(ub));
  } else if constexpr (kClass == kLatFmnmx) {
    // min then max against two arguments: a clamp the assembler cannot
    // fold without their order.
    asm volatile("min.f32 %0, %0, %1;" : "+f"(x) : "f"(a));
    asm volatile("max.f32 %0, %0, %1;" : "+f"(x) : "f"(b));
  } else if constexpr (kClass == kLatHfma2) {
    asm volatile("fma.rn.bf16x2 %0, %0, %1, %2;" : "+r"(y) : "r"(ua), "r"(ub));
  } else if constexpr (kClass == kLatHmul2) {
    asm volatile("mul.rn.bf16x2 %0, %0, %1;" : "+r"(y) : "r"(ua));
  } else if constexpr (kClass == kLatHadd2) {
    asm volatile("add.rn.bf16x2 %0, %0, %1;" : "+r"(y) : "r"(ua));
  } else if constexpr (kClass == kLatHmnmx2) {
    asm volatile("min.bf16x2 %0, %0, %1;" : "+r"(y) : "r"(ua));
    asm volatile("max.bf16x2 %0, %0, %1;" : "+r"(y) : "r"(ub));
  } else if constexpr (kClass == kLatRsq) {
    asm volatile("rsqrt.approx.ftz.f32 %0, %0;" : "+f"(x));
  } else {
    int k;
    asm volatile("cvt.rzi.s32.f32 %0, %1;" : "=r"(k) : "f"(x));
    asm volatile("cvt.rn.f32.s32 %0, %1;" : "=f"(x) : "r"(k));
  }
}

// One thread: `iters` rounds of kChainLength links of class kClass between
// two clock reads; cycles[0] gets the clocks, sink[0] the chain's value.
template <int kClass>
__global__ void latency_kernel(float a, float b, unsigned ua, unsigned ub, int iters,
                               long long* __restrict__ cycles, float* __restrict__ sink) {
  // Seeded from the thread's index (0 here), so that no link runs on the
  // uniform datapath (UIMAD) as the assembler would run one on values that
  // every thread shares.
  float x = a + (float)threadIdx.x;
  unsigned y = ub ^ threadIdx.x;
  const long long start = clock64();
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < kChainLength; ++k) chain_link<kClass>(x, y, a, b, ua, ub);
  }
  const long long stop = clock64();
  cycles[0] = stop - start;
  sink[0] = x + __uint_as_float(y);
}

template <int kClass>
static cudaError_t launch_latency(float a, float b, unsigned ua, unsigned ub, int iters,
                                  long long* cycles, float* sink, cudaStream_t s) {
  latency_kernel<kClass><<<1, 1, 0, s>>>(a, b, ua, ub, iters, cycles, sink);
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
  const cudaStream_t s = (cudaStream_t)stream;
  if (!bf16) return (int)gprt::launch<float>(op, x, out, n, iters, s);
#ifdef GPRT_PROBE_BF16_SCALAR
  return (int)gprt::launch<gprt::bf16>(op, x, out, n, iters, s);
#else
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 3)
    return (int)cudaErrorMisalignedAddress;
  return (int)gprt::launch_pairs(op, x, out, n, iters, s);
#endif
}

// Elements of a bf16 tensor that one thread of this build computes: 2 in
// the packed build, 1 in the -DGPRT_PROBE_BF16_SCALAR build.
extern "C" int gprt_op_probe_bf16_per_thread() {
#ifdef GPRT_PROBE_BF16_SCALAR
  return 1;
#else
  return 2;
#endif
}

// The latency chain of class `klass` (LatencyClass): one thread, `iters`
// rounds of kChainLength links; cycles (1 int64) gets the SM clocks between
// its two reads, sink (1 f32) the chain's value.
extern "C" int gprt_op_latency(int klass, int iters, void* cycles, void* sink, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (iters < 1 || klass < 0 || klass >= gprt::kLatClasses) return (int)cudaErrorInvalidValue;
  long long* c = static_cast<long long*>(cycles);
  float* k = static_cast<float*>(sink);
  const cudaStream_t s = (cudaStream_t)stream;
  // Operands that keep every chain finite and off denormals: x in [0.5,
  // 1.5], the bf16 pairs 1.0 and 0.99609375 (0x3f80, 0x3f7f in each half).
  const float a = 0.75f, b = 1.25f;
  const unsigned ua = 0x3f7f3f7fu, ub = 0x3f803f80u;
  typedef cudaError_t (*Launch)(float, float, unsigned, unsigned, int, long long*, float*,
                                cudaStream_t);
  static const Launch kLaunch[gprt::kLatClasses] = {
      gprt::launch_latency<0>, gprt::launch_latency<1>, gprt::launch_latency<2>,
      gprt::launch_latency<3>, gprt::launch_latency<4>, gprt::launch_latency<5>,
      gprt::launch_latency<6>, gprt::launch_latency<7>, gprt::launch_latency<8>,
      gprt::launch_latency<9>};
  return (int)kLaunch[klass](a, b, ua, ub, iters, c, k, s);
}

extern "C" const char* gprt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
