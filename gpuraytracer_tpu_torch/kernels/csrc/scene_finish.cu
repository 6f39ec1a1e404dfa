// The two-phase scene pass's finisher over a device-compacted queue of the
// dirty rays.
//
// Replaces: gpuraytracer_tpu/kernels/scene_kernel.py scene_closest_tiles,
// phase "finish" (:2017, _finish_tile at :1028): after the main pass
// (scene_kernel.cu scene_kernel<true>, every SDF and metaball march capped
// at PHASE_BUDGET = 64 steps), each ray whose dirty word is not 0 marches
// the geometries of its dirty bits again at the level-0 plain budgets, and
// the main pass's best_t, normal and gid are updated in place
// (traverse.cuh finish_procedural).
//
// What bounds it on an H100: the dirty rays are few (4.2% of the builtin
// 1080p level-0 closest pass, 3.4% of its shadow pass) and scattered (9-10%
// of the warps hold one), and a warp pays for its slowest lane's march. One
// thread per ray (the parent's form) marched in 2.2-3.1x as many warps as
// the dirty rays fill, each with a few live lanes, most of them on
// different geometries. What the design does about it: a compaction of the
// dirty plane (two launches, no host sync) into an int queue of ray
// indices ordered by the first geometry each ray marches again (the
// lowest set bit of its word, 32 keys): the append entry reads each ray's
// word and appends the dirty ones with one atomicAdd per group of lanes
// (group_append), counting the keys as it goes (group_count); the bin entry
// ranks each queued ray through per-key cursors into its key's run of the
// ordered queue. The finisher then runs one thread per queued ray, so its
// warps are full and march one geometry, and it gathers the ray's inputs
// and scatters its outputs. It is launched over the queue's capacity (one
// block per 128 rays of the pass) and reads the live count on the device:
// a block past it returns before loading the scene, so the host reads
// nothing back. Each ray's answer depends on its own inputs only, so the
// order changes which lanes share a warp and nothing else: the outputs are
// the per-ray finisher's bit for bit. The -DGPRT_FINISH_PER_RAY build keeps
// that parent form (one thread per ray over every ray, no queue), for
// checks.
//
// Tried on an H100 and not shipped (PERF.md): the finisher sized by
// the live count on the device, launched by the bin into the tail of its
// grid (CUDA dynamic parallelism, -rdc=true or -ewp with cudadevrt): the
// device-side launch itself took 14 us, and the finisher it launched ran
// about a third slower than the same kernel launched from the host, so the
// step lost to the capacity grid, whose blocks past the count cost next to
// nothing; in the -rdc=true build the finisher also took 100 registers
// instead of 80. Within a key the order is the bin's atomics'; a stable
// (raster) order within a key read the same.
//
// Inputs: params, layout as kernels/frame_kernel.py pack_frame builds them;
// tri, the face table (null without meshes); o, d (N, 3) f32 BLAS-space
// rays; dirty (N,) int32, the main pass's words; best_t (N,), normal (N, 3)
// f32 and gid (N,) int32, the main pass's outputs, updated in place. Each
// C entry returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>

#include <algorithm>

#include "traverse.cuh"

namespace gprt {

// Keys of the queue's order: the lowest set bit of a dirty word.
constexpr int kFinishKeys = 32;
// The int32 words beside a queue: its count, the keys' histogram and the
// bin's cursors.
constexpr int kFinishWords = 1 + 2 * kFinishKeys;
// Threads of a bin block, and at most this many blocks a launch.
constexpr int kFinishBinThreads = 1024;
constexpr int kFinishBinBlocks = 128;

// The finisher on ray i (traverse.cuh finish_procedural): the main pass's
// answer in, the finished answer out, in place.
__device__ __forceinline__ void finish_ray(const Scene& s, int i, const float* __restrict__ o,
                                           const float* __restrict__ d, unsigned bits,
                                           bool accept_first, bool cull,
                                           float* __restrict__ best_t,
                                           float* __restrict__ normal, int* __restrict__ gid) {
  Hit h{best_t[i], gid[i], v3(normal[3 * i], normal[3 * i + 1], normal[3 * i + 2])};
  finish_procedural(s, v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]),
                    v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]), bits, accept_first, cull, &h);
  best_t[i] = h.t;
  normal[3 * i] = h.n.x;
  normal[3 * i + 1] = h.n.y;
  normal[3 * i + 2] = h.n.z;
  gid[i] = h.gid;
}

// The compaction's first launch: each dirty ray's index appended to
// `queue` (n slots: it cannot overflow) and counted into words[0], and its
// key into the histogram words[1 ...].
__global__ void __launch_bounds__(128)
    finish_append_kernel(const int* __restrict__ dirty, int n, int* __restrict__ queue,
                         int* __restrict__ words) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned bits = i < n ? (unsigned)dirty[i] : 0u;
  if (bits != 0) {
    const unsigned group = __activemask();
    queue[group_append(group, words)] = i;
    group_count(group, words + 1, __ffs((int)bits) - 1);
  }
}

// The finisher over the ordered queue, launched over its capacity: one
// thread per live slot (the live count read from *count; a block past it
// returns before loading the scene). kShared: the traversal's tables in
// shared memory.
template <bool kShared>
__global__ void __launch_bounds__(128)
    finish_queue_kernel(const float* __restrict__ params, const int* __restrict__ layout,
                        const float* __restrict__ tri, const float* __restrict__ o,
                        const float* __restrict__ d, const int* __restrict__ dirty,
                        const int* __restrict__ queue, const int* __restrict__ count,
                        float* __restrict__ best_t, float* __restrict__ normal,
                        int* __restrict__ gid, int G, int M, int accept_first, int cull,
                        unsigned long long* ops) {
  const int live = *count;
  if ((int)(blockIdx.x * blockDim.x) >= live) return;
  extern __shared__ float smem[];
  counters_begin(ops);
  const Scene s = load_scene<false, kShared>(params, layout, tri, G, M, smem);
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot < live) {
    const int i = queue[slot];
    finish_ray(s, i, o, d, (unsigned)dirty[i], accept_first != 0, cull != 0, best_t, normal,
               gid);
  }
  counters_end(ops);
}

// The compaction's second launch: block-wide offsets of the keys from the
// histogram, then each queued ray (in, words[0] of them) to its key's
// offset plus a rank from the key's cursor (one atomicAdd per key among a
// warp's lanes) in out.
__global__ void __launch_bounds__(kFinishBinThreads)
    finish_bin_kernel(const int* __restrict__ dirty, const int* __restrict__ in,
                      int* __restrict__ out, int* __restrict__ words) {
  __shared__ int offs[kFinishKeys];
  const int live = words[0];
  if (threadIdx.x == 0) {
    int run = 0;
    for (int k = 0; k < kFinishKeys; ++k) {
      offs[k] = run;
      run += words[1 + k];
    }
  }
  __syncthreads();
  int* cursor = words + 1 + kFinishKeys;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < live; i += gridDim.x * blockDim.x) {
    const int ray = in[i];
    const int key = __ffs(dirty[ray]) - 1;
    const unsigned group = __match_any_sync(__activemask(), key);
    out[offs[key] + group_append(group, cursor + key)] = ray;
  }
}

#ifdef GPRT_FINISH_PER_RAY
// The parent's finisher: one thread per ray over all n; a ray with a zero
// dirty word exits at once.
template <bool kShared>
__global__ void __launch_bounds__(128)
    finish_ray_kernel(const float* __restrict__ params, const int* __restrict__ layout,
                      const float* __restrict__ tri, const float* __restrict__ o,
                      const float* __restrict__ d, const int* __restrict__ dirty,
                      float* __restrict__ best_t, float* __restrict__ normal,
                      int* __restrict__ gid, int n, int G, int M, int accept_first, int cull,
                      unsigned long long* ops) {
  extern __shared__ float smem[];
  counters_begin(ops);
  const Scene s = load_scene<false, kShared>(params, layout, tri, G, M, smem);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned bits = i < n ? (unsigned)dirty[i] : 0u;
  if (bits != 0) {
    finish_ray(s, i, o, d, bits, accept_first != 0, cull != 0, best_t, normal, gid);
  }
  counters_end(ops);
}
#endif

}  // namespace gprt

// The compaction (the append and the bin) into queue (2n int32: the append
// order, then the ordered queue) with words (kFinishWords int32, zeroed
// here first): the ordered queue's live slots are queue[n ...
// n + words[0]).
static cudaError_t compact(const int* dirty, int* queue, int* words, int n, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(words, 0, sizeof(int) * gprt::kFinishWords, stream);
  if (err != cudaSuccess) return err;
  gprt::finish_append_kernel<<<(n + 127) / 128, 128, 0, stream>>>(dirty, n, queue, words);
  const int blocks = std::min((n + gprt::kFinishBinThreads - 1) / gprt::kFinishBinThreads,
                              gprt::kFinishBinBlocks);
  gprt::finish_bin_kernel<<<blocks, gprt::kFinishBinThreads, 0, stream>>>(dirty, queue, queue + n,
                                                                          words);
  return cudaGetLastError();
}

// The compaction alone: queue and words as compact fills them.
extern "C" int gprt_finish_queue(const int* dirty, int* queue, int* words, int n, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  return (int)compact(dirty, queue, words, n, (cudaStream_t)stream);
}

// Whether this build's finisher runs over the compacted queue (else the
// -DGPRT_FINISH_PER_RAY build: one thread per ray, queue and words unused).
extern "C" int gprt_finish_compacts() {
#ifdef GPRT_FINISH_PER_RAY
  return 0;
#else
  return 1;
#endif
}

// The finisher over the main pass's outputs (updated in place): the
// compaction into queue and words (as gprt_finish_queue), then the
// finisher over the queue's n slots. ops: a device counter that the
// counting build adds the finisher's f32 FLOPs to; shared: the traversal's
// tables in shared memory.
extern "C" int gprt_scene_finish(const float* params, const int* layout, const float* tri,
                                 const float* o, const float* d, const int* dirty, int* queue,
                                 int* words, float* best_t, float* normal, int* gid, int n,
                                 int num_geometries, int num_materials, int shared,
                                 int accept_first, int cull, unsigned long long* ops, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  if (GPRT_COUNTING && !shared) return (int)cudaErrorNotSupported;
  const size_t shmem = shared ? gprt::shared_bytes(false, num_geometries, num_materials) : 0;
  const cudaStream_t s = (cudaStream_t)stream;
#ifdef GPRT_FINISH_PER_RAY
  const auto kernel = GPRT_PICK1(gprt::finish_ray_kernel, shared);
  err = gprt::reserve_shared(kernel, shmem, device);
  if (err != cudaSuccess) return (int)err;
  (void)queue;
  (void)words;
  kernel<<<(n + 127) / 128, 128, shmem, s>>>(params, layout, tri, o, d, dirty, best_t, normal,
                                             gid, n, num_geometries, num_materials, accept_first,
                                             cull, ops);
#else
  const auto kernel = GPRT_PICK1(gprt::finish_queue_kernel, shared);
  err = gprt::reserve_shared(kernel, shmem, device);
  if (err != cudaSuccess) return (int)err;
  err = compact(dirty, queue, words, n, s);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(n + 127) / 128, 128, shmem, s>>>(params, layout, tri, o, d, dirty, queue + n, words,
                                             best_t, normal, gid, num_geometries, num_materials,
                                             accept_first, cull, ops);
#endif
  return (int)cudaGetLastError();
}

extern "C" const char* gprt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
