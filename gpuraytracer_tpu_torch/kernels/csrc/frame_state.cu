// Row 10: the per-frame state of an animated frame, written in place into
// the frame's packed parameter buffer (kernels/frame_kernel.py pack_static).
//
// Replaces no Pallas kernel: the reference computes this state inside its
// jitted frame program, where XLA fuses it (models/builtin.py:306-318
// build_instance_transforms and models/builder.py:260-275 _transforms, the
// metaball keyframes of geometry/metaballs.py animated_metaballs, then
// kernels/frame_kernel.py pack_frame_params). The port replays each frame
// as a captured CUDA graph (render/program.py), and this one launch takes
// the place of the 40-50 torch ops the same state costs eagerly
// (builtin.animate_arrays or SceneBuilder.animator(), then
// frame_kernel.frame_fields and write_frame_fields), which would be as
// many graph nodes a frame.
//
// From the animation time t = times[index] (device memory: a program's time
// buffer), one thread per instance g < G writes
//   b2l_rows[g] = [A^-1 | -(A^-1 c)] (3 x 4) and l2b_rot[g] = A (3 x 3),
//   A = R_y(rate * t) diag(scale) where the instance rotates, else
//   diag(scale); A^-1 = diag(1/scale) R^T; c the instance's centre,
// and thread G writes the header's time and the three metaball centres,
// the keyframes lerped by the smoothstepped triangle wave of
// fmod(t, cycle) / cycle (hlsl.calculate_animation_interpolant), beside
// their radii.
//
// Every value equals the plain version's on the card bit for bit: the
// library is built without contraction (build.NO_FMAD), each product and
// sum rounds once as the separate torch kernels round it, the translation
// column is summed in the plain version's order, and the division of the
// time by the cycle is the multiplication by its f32 reciprocal that
// PyTorch's CUDA division by a Python scalar performs (passed in as
// `inv_cycle`). cosf and sinf are the CUDA math library's, as torch.cos and
// torch.sin call them.
//
// What bounds it on an H100: nothing of the card. It reads (G + 1) x 8 + 23
// floats and writes 21 G + 13, a few hundred operations in all; one block
// of 128 threads for up to 127 instances. Its cost is a launch.
//
// Inputs: params (the pack's f32 buffer: header F_HEADER = 12 floats, then
// b2l_rows at 12, l2b_rot at 12 + 12 G, and the metaball block at
// 12 + 28 G), table (G, kStateStride) f32 rows (rate, rotates, scale xyz,
// centre xyz), mb (kMbFloats,) f32 (keyframe centres at t0 and t1, 3 x 3
// each, the radii, the cycle and its reciprocal), times (n,) f32. The C
// entry returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace gprt {

constexpr int kStateStride = 8;
constexpr int kMbFloats = 23;
constexpr int kStateHeader = 12;
constexpr int kStateBlock = 128;

// The per-frame fields' offsets in the parameter buffer, in floats
// (frame_kernel.param_offsets).
__host__ __device__ constexpr int b2l_offset(int) { return kStateHeader; }
__host__ __device__ constexpr int l2b_offset(int G) { return kStateHeader + 12 * G; }
__host__ __device__ constexpr int mb_offset(int G) { return kStateHeader + 28 * G; }

// torch.clamp(x, 0, 1) as PyTorch's CUDA kernel computes it.
__device__ __forceinline__ float saturate_like_torch(float x) {
  return isnan(x) ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ void instance_state(float* __restrict__ params,
                                               const float* __restrict__ row, float t, int g,
                                               int G) {
  const float rate = row[0];
  const bool rotates = row[1] != 0.0f;
  const float scale[3] = {row[2], row[3], row[4]};
  const float centre[3] = {row[5], row[6], row[7]};
  float r[3][3] = {{1.0f, 0.0f, 0.0f}, {0.0f, 1.0f, 0.0f}, {0.0f, 0.0f, 1.0f}};
  if (rotates) {
    // Column-convention XMMatrixRotationY: x' = c x + s z, z' = -s x + c z.
    const float theta = __fmul_rn(rate, t);
    const float c = cosf(theta), s = sinf(theta);
    r[0][0] = c;
    r[0][2] = s;
    r[2][0] = -s;
    r[2][2] = c;
  }
  float* b2l = params + b2l_offset(G) + 12 * g;
  float* l2b = params + l2b_offset(G) + 9 * g;
  for (int i = 0; i < 3; ++i) {
    float inv[3];
    for (int k = 0; k < 3; ++k) {
      l2b[3 * i + k] = __fmul_rn(r[i][k], scale[k]);  // R diag(scale)
      inv[k] = __fdiv_rn(r[k][i], scale[i]);          // diag(1/scale) R^T
      b2l[4 * i + k] = inv[k];
    }
    b2l[4 * i + 3] = -__fadd_rn(__fadd_rn(__fmul_rn(inv[0], centre[0]),
                                          __fmul_rn(inv[1], centre[1])),
                                __fmul_rn(inv[2], centre[2]));
  }
}

__device__ __forceinline__ void metaball_state(float* __restrict__ params,
                                               const float* __restrict__ mb, float t, int G) {
  params[0] = t;
  const float* c0 = mb;
  const float* c1 = mb + 9;
  const float* radii = mb + 18;
  // hlsl.calculate_animation_interpolant: the triangle wave, smoothstepped.
  float u = __fmul_rn(fmodf(t, mb[21]), mb[22]);
  u = u <= 0.5f ? __fmul_rn(2.0f, u) : __fsub_rn(1.0f, __fmul_rn(2.0f, __fsub_rn(u, 0.5f)));
  u = saturate_like_torch(u);
  const float w = __fmul_rn(__fmul_rn(u, u), __fsub_rn(3.0f, __fmul_rn(2.0f, u)));
  float* out = params + mb_offset(G);
  for (int j = 0; j < 3; ++j) {
    for (int k = 0; k < 3; ++k) {
      // hlsl.lerp: a + t * (b - a)
      const float a = c0[3 * j + k];
      out[4 * j + k] = __fadd_rn(a, __fmul_rn(w, __fsub_rn(c1[3 * j + k], a)));
    }
    out[4 * j + 3] = radii[j];
  }
}

__global__ void __launch_bounds__(kStateBlock)
    frame_state_kernel(float* __restrict__ params, const float* __restrict__ table,
                       const float* __restrict__ mb, const float* __restrict__ times, int index,
                       int G) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g > G) return;
  const float t = times[index];
  if (g < G) {
    instance_state(params, table + kStateStride * g, t, g, G);
  } else {
    metaball_state(params, mb, t, G);
  }
}

}  // namespace gprt

extern "C" int gprt_frame_state(void* params, const void* table, const void* mb,
                                const void* times, int index, int G, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G <= 0 || index < 0) return (int)cudaErrorInvalidValue;
  const int grid = (G + 1 + gprt::kStateBlock - 1) / gprt::kStateBlock;
  gprt::frame_state_kernel<<<grid, gprt::kStateBlock, 0, (cudaStream_t)stream>>>(
      static_cast<float*>(params), static_cast<const float*>(table),
      static_cast<const float*>(mb), static_cast<const float*>(times), index, G);
  return (int)cudaGetLastError();
}

extern "C" const char* gprt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
