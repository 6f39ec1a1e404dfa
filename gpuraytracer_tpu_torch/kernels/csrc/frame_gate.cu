// The compacted frame modes' overflow gate: the plain frame only where a
// queue overflowed.
//
// Replaces: the lax.cond of gpuraytracer_tpu/kernels/frame_kernel.py's
// render_frame_compact (:1004) and render_frame_deferred (:1311), whose
// false branch renders the frame with the plain kernel (:994, :1299) when a
// queue holds more lanes than its capacity (the rule at :924-929). The
// port's chains decide it on the device, so that the host reads no count.
//
// What bounds it on an H100: without an overflow (every frame of the
// builtin scene: 96,011 queued pixels against a capacity of 259,200) only
// the launch and the read of the counts, a few bytes; with one, the plain
// frame kernel. The parent launched the whole frame's 16,200 blocks of 16x8
// and each block read the counts and returned (0.012 ms a frame on the
// card for nothing). What the design does about it: the gate is one block
// of one warp, whose lanes read the counts; where one passed the capacity,
// lane 0 launches frame_kernel.cu's plain frame kernel over the band's grid
// into the tail of the gate's grid (GPRT_TAIL_LAUNCH below, CUDA dynamic
// parallelism), so that it starts when the gate has exited and the work
// after the gate on the stream (the consumer of the image) waits for it.
//
// The device-side launch needs the device runtime: build.py compiles this
// source on its own as extensible whole-program code (-ewp) with the
// runtime linked in (-lcudadevrt), so that no other kernel's build
// changes. It includes frame_kernel.cu's device code (GPRT_DEVICE_ONLY)
// for the frame kernel it launches, which is that file's plain frame
// kernel in another build: bit for bit the same frame, but ptxas gives it
// 128 registers (118 in frame_kernel.cu's whole-program build; 156 with
// -rdc=true), and on an overflow it ran 18% slower than the plain kernel
// on an H100 (PERF.md). A grid of one block per resident slot
// walking the frame's tiles, in frame_kernel.cu's own build, read 80%
// slower there and was not shipped.
//
// Inputs: params, layout, tri as for frame_kernel.cu; out, the band's
// (local_height, W, 4) f32 image; count, the n queue counts. The C entry
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <algorithm>

#define GPRT_DEVICE_ONLY
#include "frame_kernel.cu"

// A launch from device code into the tail of the launching grid (CUDA
// dynamic parallelism): `kernel GPRT_TAIL_LAUNCH(grid, block, shmem)(args)`
// starts once every block of the launching grid has exited, and the work
// after that grid on its stream waits for it. The g++ rehearsal
// (host_rehearsal.h) records the launch instead.
#ifndef GPRT_TAIL_LAUNCH
#define GPRT_TAIL_LAUNCH(grid, block, shmem) <<<(grid), (block), (shmem), cudaStreamTailLaunch>>>
#endif

namespace gprt {

// Where one of the n counts passed cap, the plain frame's band (the grid
// frame_grid gives it, shmem bytes of dynamic shared memory a block) into
// out, launched from lane 0 into the tail of this grid; else nothing.
// kMerged, kShared: the frame kernel's instantiation.
template <bool kMerged, bool kShared>
__global__ void __launch_bounds__(32)
    frame_gate_kernel(const float* __restrict__ params, const int* __restrict__ layout,
                      const float* __restrict__ tri, float4* __restrict__ out,
                      const int* __restrict__ count, int n, int cap, dim3 grid,
                      unsigned shmem, int width, int height, int row_offset, int local_height,
                      int max_depth, int G, int M, unsigned long long* ops) {
  bool over = false;
  for (int k = threadIdx.x; k < n; k += blockDim.x) over = over || count[k] > cap;
  if (__any_sync(__activemask(), over) && threadIdx.x == 0) {
    frame_kernel<kMerged, kShared> GPRT_TAIL_LAUNCH(grid, (dim3{16, 8, 1}), shmem)(
        params, layout, tri, out, width, height, row_offset, local_height, max_depth, G, M, ops);
  }
}

}  // namespace gprt

// The plain frame's band into out (local_height, W, 4) if any of the n
// counts passed cap; the band, merged, shared and ops as for
// frame_kernel.cu's gprt_frame_render.
extern "C" int gprt_frame_gated(const float* params, const int* layout, const float* tri,
                                float* out, const int* count, int n, int cap, int width,
                                int height, int row_offset, int local_height, int max_depth,
                                int num_geometries, int num_materials, int shared, int merged,
                                unsigned long long* ops, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || !gprt::band_ok(height, row_offset, local_height)) {
    return (int)cudaErrorInvalidValue;
  }
  if (GPRT_COUNTING && !shared) return (int)cudaErrorNotSupported;
  const auto frame = GPRT_PICK2(gprt::frame_kernel, merged, shared);
  const auto gate = GPRT_PICK2(gprt::frame_gate_kernel, merged, shared);
  const size_t shmem = shared ? gprt::shared_bytes(true, num_geometries, num_materials) : 0;
  err = gprt::reserve_shared(frame, shmem, device);
  if (err != cudaSuccess) return (int)err;
  gate<<<1, 32, 0, (cudaStream_t)stream>>>(
      params, layout, tri, reinterpret_cast<float4*>(out), count, n, cap,
      gprt::frame_grid(width, local_height), (unsigned)shmem, width, height, row_offset,
      local_height, max_depth, num_geometries, num_materials, ops);
  return (int)cudaGetLastError();
}

extern "C" const char* gprt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
