// The per-geometry route (accel/traverse.per_geometry_route) of a scene past
// TRI_FACE_TOTAL_CAP mesh faces: one thread per ray.
//
// route_pass is the route's pass entry: one launch per closest or
// occlusion pass. It replaces the reference's schedule on this route, one
// Pallas march per SDF geometry (gpuraytracer_tpu/kernels/megakernel.py
// sphere_trace_tiles, pallas_call at :160) and one XLA lax.scan per mesh
// (geometry/trimesh.py:135, :177), each over every ray of the pass with
// the planes in device memory between them (the TPU kernels hold at most
// 512 faces in scalar memory, traverse.py:196-207). Here each thread runs
// the route's whole loop for its ray: traverse.cuh's closest_procedural /
// occluded_procedural at level 0 (the route marches every level at the
// level-0 budget with the level-0 occluded-on-cap rule), so the slab gate
// against the running best t, the local ray, the AABB window, the marches,
// the closed forms and the metaballs are the scene kernel's own; the mesh
// body is the staged face loop below. Out: best_t, the world normal and the
// geometry id, each written once.
//
// The face loop (StagedFaces): a block in which any live lane passes a
// mesh's gate against t0 (a superset of the running gate) copies the gated
// meshes' rows into dynamic shared memory once, with one bulk copy
// (cp.async.bulk, completed on an mbarrier), and builds a record for each
// chunk of kChunk consecutive faces (chunk_record). A warp then walks the
// chunks in face order and skips a chunk that none of its lanes needs
// (chunk_needed: the lane's ray, over [0, its best t], misses the chunk's
// padded box, and the ray is not grazing any of its faces). A skipped chunk
// holds no face that could win, so the loop gives intersect_trimesh's
// answer bit for bit (its face test, in face order, strict <). The staging
// area holds the scene's largest mesh: a block stages the face range of the
// meshes it gates where that fits. Rows that are not staged (a range past
// the area; no area: a largest mesh that would pass the device's shared
// memory beside the scene tables, or halve the blocks resident per SM,
// stage_area) are read from global memory, as rows 1 and 5 read them. A
// build with -DGPRT_FACE_LOOP_GLOBAL stages nothing and runs every mesh with
// intersect_trimesh on the global rows: the unculled loop that the checks
// hold the shipped one to, never the shipped build.
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
// frame_math.cuh's (march_sdf's loop, specialized below, and sdf_normal),
// the frame and scene kernels' own. The TPU schedule ((32, 128) tiles, the
// pause/check split of the march, the unroll) is not behaviour and is not
// carried over. trimesh is
// the one-mesh entry (the reference's intersect_trimesh), with the staged
// face loop. These two keep the reference's one-geometry API; no render path
// launches them.
//
// The march is instantiated per distance code: its loop calls that code's
// distance alone each sample (frame_math.cuh march_sdf_code), where
// march_sdf switches over every code. Every ray runs the same operations
// as with march_sdf, so the outputs are the generic march's bit for bit:
// the -DGPRT_SPHERE_MARCH_GENERIC build (megakernel.GENERIC_DEFINES) keeps
// it, for checks. On an H100 the specialized march took 3.5-3.7% off the two
// 1080p march calls of the 544-face scene's level-0 closest pass, where a
// device queue of the gated rays (3.6-4.6% of them) gained nothing over
// one thread per ray (PERF.md).
//
// What bounds it on an H100: the marches' divergent per-lane loops (ALU-
// and latency-bound, as in the frame kernel) and the face loop's
// Möller–Trumbore tests; a pass entry's ray reads 29 B (o, d, active, t0)
// and writes 20 B. What the design does about it: one launch per pass, so
// no plane goes to device memory between geometries and the card holds
// every geometry's work of a pass at once; the faces sit in shared memory
// for the blocks that need them; whole chunks of faces are skipped.
//
// The C entries return cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "traverse.cuh"

// Faces per chunk of the face loop's skip (a -D flag for trying others).
#ifndef GPRT_FACE_CHUNK
#define GPRT_FACE_CHUNK 16
#endif

namespace gprt {

constexpr int kChunk = GPRT_FACE_CHUNK;
#ifdef GPRT_FACE_LOOP_GLOBAL
constexpr bool kStageFaces = false;
#else
constexpr bool kStageFaces = true;
#endif
// A chunk record: box lo (3), hi (3), centre (3), half-diagonal, pad
// factor, longest edge, what the skip may do (ChunkRule), 3 unused.
constexpr int kChunkFloats = 16;
enum ChunkRule { kChunkNever = 0, kChunkTest = 1, kChunkAlways = 2 };
// A ray grazes a face where |sin| of its angle to the face's plane is below
// this; the skip never passes over a chunk with a face that the ray grazes.
constexpr float kGraze = 1.0f / 256;

// Floats of dynamic shared memory that staging `faces` rows takes past the
// scene tables: alignment slack and the mbarrier (4 + 4), the rows, their
// unit normals (3 a face) and their chunk records.
__host__ __device__ constexpr int stage_floats(int faces) {
  return 8 + (kFaceStride + 3) * faces + kChunkFloats * ((faces + kChunk - 1) / kChunk);
}

__device__ __forceinline__ float* align16(float* p) {
  return reinterpret_cast<float*>((reinterpret_cast<uintptr_t>(p) + 15) & ~uintptr_t(15));
}

// Copies `bytes` (a multiple of 16; both ends 16-byte aligned) from global
// memory to the block's shared memory with one bulk copy that completes on
// the mbarrier at *bar; every thread of the block calls it and returns once
// the rows have landed. The rehearsal (no __CUDA_ARCH__) copies them.
__device__ __forceinline__ void stage_copy(float* dst, const float* src, unsigned bytes,
                                           unsigned long long* bar) {
#ifdef __CUDA_ARCH__
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src), "r"(bytes), "r"(b)
        : "memory");
  }
  __syncthreads();  // the barrier is initialised before any thread waits on it
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(0u)
        : "memory");
  }
#else
  memcpy(dst, src, bytes);
  (void)bar;
#endif
}

__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}

// The record of the chunk of n face rows at `rows` (kChunkFloats floats at
// c) and the faces' unit normals (3 floats a face at nrm), what
// chunk_needed reads. Why a chunk it passes over holds no winner, for a ray
// that grazes none of its faces (|d.n| >= kGraze |d| for each face's unit
// normal n = e1 x e2 / |e1 x e2|, so |det| = |d.(e1 x e2)| >= kGraze |d|
// |e1 x e2|):
// - Möller–Trumbore's det and the numerators of u, v and t are dot products
//   of cross products, each within 64 u (u = 2^-24) of the sum of its
//   terms' magnitudes, with or without contraction: |eps_det| <= 32 u |e1|
//   |d| |e2|, |eps_u| <= 64 u |o - v0| |d| |e2| (v and t alike).
// - For a valid hit's computed (u_c, v_c, t_c), the exact line-plane
//   parameters x* satisfy x* - x_c = (x_c eps_det - eps_num) / det. So the
//   point P = v0 + u_c e1 + v_c e2, in the triangle and so in the chunk's
//   box, is within rho <= 2^-17 kappa (E + |o - v0|) / kGraze of the line's
//   point at t*, and |t* - t_c| <= 2^-18 kappa (t_c + |o - v0| / |d|) /
//   kGraze, where kappa = |e1| |e2| / |e1 x e2| (1 / the sine of the corner
//   at v0) and E is the longest edge.
// - The record's pad factor k = 2^-16 kappa / kGraze (twice that, kappa the
//   chunk's largest) pads the box by k (E + |o - v0|) plus 2^-16 of the
//   coordinates' magnitude (the box test's own rounding) and the line's
//   range to [-reach, bound (1 + k) + reach], reach = k |o - v0| / |d|: a
//   line that misses that box over that range has no valid hit with t_c <=
//   bound in the chunk. |o - v0| is bounded by |o - centre| + half-diagonal.
// A face with e1 or e2 exactly (0, 0, 0) has det exactly 0 and never hits;
// it is left out of the box, with a zero normal (which every ray grazes).
// A face with kappa past 2^10, or a non-finite value, makes every ray need
// the chunk; a chunk of faces that never hit is never needed.
__device__ void chunk_record(const float* rows, int n, float* nrm, float* c) {
  float lo[3] = {kInf, kInf, kInf}, hi[3] = {-kInf, -kInf, -kInf};
  float kappa = 0.0f, edge = 0.0f;
  bool any = false, thin = false;
  for (int f = 0; f < n; ++f) {
    GPRT_OPS(60);
    const float* r = rows + kFaceStride * f;
    const V3 v0 = v3(r[0], r[1], r[2]), e1 = v3(r[3], r[4], r[5]), e2 = v3(r[6], r[7], r[8]);
    nrm[3 * f] = nrm[3 * f + 1] = nrm[3 * f + 2] = 0.0f;
    if ((e1.x == 0.0f && e1.y == 0.0f && e1.z == 0.0f) ||
        (e2.x == 0.0f && e2.y == 0.0f && e2.z == 0.0f))
      continue;
    const V3 nv = cross3(e1, e2);
    const float l1 = len3(e1), l2 = len3(e2), ln = len3(nv);
    const float k = l1 * l2 / ln;
    thin = thin || !(k <= 1024.0f);
    kappa = fmaxf(kappa, k);
    edge = fmaxf(edge, fmaxf(l1, l2));
    if (ln > 0.0f) {
      nrm[3 * f] = nv.x / ln;
      nrm[3 * f + 1] = nv.y / ln;
      nrm[3 * f + 2] = nv.z / ln;
    }
    const V3 vs[3] = {v0, add(v0, e1), add(v0, e2)};
    for (int j = 0; j < 3; ++j) {
      const float p[3] = {vs[j].x, vs[j].y, vs[j].z};
      for (int a = 0; a < 3; ++a) {
        lo[a] = fminf(lo[a], p[a]);
        hi[a] = fmaxf(hi[a], p[a]);
      }
    }
    any = true;
  }
  bool finite = isfinite(edge);
  for (int a = 0; a < 3; ++a) {
    finite = finite && isfinite(lo[a]) && isfinite(hi[a]);
    c[a] = lo[a];
    c[3 + a] = hi[a];
    c[6 + a] = 0.5f * (lo[a] + hi[a]);
  }
  const V3 half = v3(0.5f * (hi[0] - lo[0]), 0.5f * (hi[1] - lo[1]), 0.5f * (hi[2] - lo[2]));
  c[9] = len3(half);
  c[10] = F(1.0 / 65536) / kGraze * kappa;
  c[11] = edge;
  c[12] = !any ? kChunkNever : (thin || !finite ? kChunkAlways : kChunkTest);
  c[13] = c[14] = c[15] = 0.0f;
}

// Whether the local ray (o, d; dlen = |d|) needs its n faces (unit normals
// at nrm) of the chunk of record c for a hit with t <= bound (the lane's best t
// so far, at most its t_max): chunk_record says why a chunk it does not
// need holds no winner. The box test first; a ray that misses the box still
// needs the chunk where it grazes one of its faces (|d.n| < kGraze |d|,
// tested with 2^-12 to spare for the normals' rounding).
__device__ __forceinline__ bool chunk_needed(const float* c, const float* nrm, int n, V3 o, V3 d,
                                             float dlen, float bound) {
  GPRT_OPS(45);
  if (c[12] != kChunkTest) return c[12] == kChunkAlways;
  const V3 oc = v3(o.x - c[6], o.y - c[7], o.z - c[8]);
  const float tv = len3(oc) + c[9];
  const float k = c[10];
  const float mag = fmaxf(fmaxf(fabsf(c[6]), fabsf(c[7])), fabsf(c[8])) + c[9];
  const float pad = k * (c[11] + tv) + F(1.0 / 65536) * (tv + mag);
  const float reach = k * tv / dlen;
  const float t_hi = bound + k * bound + reach;
  if (!(t_hi < F(1e30))) return true;
  const float oa[3] = {o.x, o.y, o.z}, da[3] = {d.x, d.y, d.z};
  float tn = -kInf, tf = kInf;
  bool miss = false;
  for (int a = 0; a < 3; ++a) {
    const float lo = c[a] - pad, hi = c[3 + a] + pad;
    if (da[a] == 0.0f) {
      miss = miss || oa[a] < lo || oa[a] > hi;
      continue;
    }
    const float inv = 1.0f / da[a];
    if (!isfinite(inv)) return true;
    const float t0 = (lo - oa[a]) * inv, t1 = (hi - oa[a]) * inv;
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
  }
  if (!miss && tn <= tf && tf >= -reach && tn <= t_hi) return true;
  const float graze = (kGraze + F(1.0 / 4096)) * dlen;
  for (int f = 0; f < n; ++f) {
    GPRT_OPS(7);
    if (!(fabsf(d.x * nrm[3 * f] + d.y * nrm[3 * f + 1] + d.z * nrm[3 * f + 2]) >= graze))
      return true;
  }
  return false;
}

// Möller–Trumbore of one staged face row r (v0, e1, e2, n) against the
// local ray over [0, t_max]: the body of traverse.cuh's intersect_trimesh
// loop, operation for operation (rows 1 and 5 keep that loop as it is; the
// rehearsal and the chip's checks hold the two loops bit-equal). True where
// the face is a valid hit strictly closer than best, with its t in *t_out.
__device__ __forceinline__ bool mt_face(const float* __restrict__ r, V3 o, V3 d, float t_max,
                                        bool cull, float best, float* t_out) {
  const float eps = F(1e-12);
  GPRT_OPS(cull ? 14 : 15);
  const float e1x = r[3], e1y = r[4], e1z = r[5];
  const float e2x = r[6], e2y = r[7], e2z = r[8];
  const float pvx = d.y * e2z - d.z * e2y;
  const float pvy = d.z * e2x - d.x * e2z;
  const float pvz = d.x * e2y - d.y * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  if (!(cull ? det > eps : fabsf(det) > eps)) return false;
  GPRT_OPS(32);
  const float inv = 1.0f / det;
  const float tvx = o.x - r[0], tvy = o.y - r[1], tvz = o.z - r[2];
  const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float v = (d.x * qvx + d.y * qvy + d.z * qvz) * inv;
  const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv;
  if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= 0.0f && t <= t_max && t < best) {
    *t_out = t;
    return true;
  }
  return false;
}

// The face loop over faces [a, a + count) of the staged rows (their unit
// normals at nrm, their chunk records at `chunks`, chunk j covering staged
// faces [j kChunk, (j + 1) kChunk)): mt_face in face order with a strict
// <, as intersect_trimesh, the rows read from shared memory; a warp passes
// over a chunk that none of its lanes needs. query: the pass's SIMT bucket
// (0 closest, 1 occlusion); a counting build (-DGPRT_COUNT_SIMT) counts each
// face test in bucket query + 2 for a lane that needs the chunk and query +
// 4 for one that does not.
__device__ __noinline__ bool staged_trimesh(const float* __restrict__ rows,
                                            const float* __restrict__ nrm,
                                            const float* __restrict__ chunks, int a, int count,
                                            int query, V3 o, V3 d, float t_max, bool cull,
                                            float* t_out, V3* nl) {
  const unsigned warp = __activemask();
  const float dlen = len3(d);
  float best = kInf;
  int win = -1;
  const int b = a + count;
  for (int j = a / kChunk; j * kChunk < b; ++j) {
    const int f0 = max(j * kChunk, a), f1 = min((j + 1) * kChunk, b);
    const bool need = chunk_needed(chunks + kChunkFloats * j, nrm + 3 * f0, f1 - f0, o, d, dlen,
                                   fminf(best, t_max));
    if (!__any_sync(warp, need)) continue;
    GPRT_SIMT_BUCKET(query + (need ? 2 : 4));
    for (int f = f0; f < f1; ++f) {
      GPRT_SIMT_SAMPLE();
      float t;
      if (mt_face(rows + kFaceStride * f, o, d, t_max, cull, best, &t)) {
        best = t;
        win = f;
      }
    }
  }
  GPRT_SIMT_BUCKET(query);
  if (win < 0) return false;
  const float* r = rows + kFaceStride * win;
  *t_out = best;
  *nl = v3(r[9], r[10], r[11]);
  return true;
}

// The mesh body of the pass entry (traverse.cuh's Mesh parameter) and of the
// mesh entry: face rows [lo, hi) of the face table staged at `rows` (null:
// nothing staged) with their chunk records; a mesh inside that range runs
// staged_trimesh, any other intersect_trimesh on the global rows.
struct StagedFaces {
  const float* rows;
  const float* nrm;
  const float* chunks;
  int lo, hi;
  int query;

  __device__ __forceinline__ bool faces(const float* tri, int start, int count, V3 ol, V3 dl,
                                        float t_max, bool cull, float* t, V3* nl) const {
    if (rows == nullptr || start < lo || start + count > hi)
      return intersect_trimesh(tri + kFaceStride * start, count, ol, dl, t_max, cull, t, nl);
    return staged_trimesh(rows, nrm, chunks, start - lo, count, query, ol, dl, t_max, cull, t, nl);
  }

  __device__ __forceinline__ bool operator()(const Scene& s, int g, V3 ol, V3 dl, float t_max,
                                             bool cull, float* t, V3* nl) const {
    const int* q = s.geo + kGeoStride * g;
    return faces(s.tri, q[kGeoFaceStart], q[kGeoFaceCount], ol, dl, t_max, cull, t, nl);
  }
};

// Stages face rows [lo, hi) of tri into `area` (area_floats floats of the
// block's dynamic shared memory) and builds their chunk records; every
// thread of the block calls it with the same arguments. Nothing is staged
// (rows null: the global loop) in the -DGPRT_FACE_LOOP_GLOBAL build, for an
// empty range, or for a range that does not fit.
__device__ StagedFaces stage_faces(const float* __restrict__ tri, int lo, int hi, float* area,
                                   int area_floats, int query) {
  StagedFaces sf{nullptr, nullptr, nullptr, 0, 0, query};
  if (!kStageFaces || hi <= lo || stage_floats(hi - lo) - 4 > area_floats) return sf;
  const int n = hi - lo, nchunks = (n + kChunk - 1) / kChunk;
  float* rows = area + 4;
  float* nrm = rows + kFaceStride * n;
  float* chunks = nrm + 3 * n;
  stage_copy(rows, tri + kFaceStride * lo, 4u * kFaceStride * n,
             reinterpret_cast<unsigned long long*>(area));
  const int nthreads = blockDim.x * blockDim.y * blockDim.z;
  for (int j = threadIdx.x; j < nchunks; j += nthreads) {
    chunk_record(rows + kFaceStride * kChunk * j, min(kChunk, n - kChunk * j), nrm + 3 * kChunk * j,
                 chunks + kChunkFloats * j);
  }
  __syncthreads();
  sf.rows = rows;
  sf.nrm = nrm;
  sf.chunks = chunks;
  sf.lo = lo;
  sf.hi = hi;
  return sf;
}

// The march of sphere_trace: specialized on its code (kCode 0..8: a call
// of that code's distance alone a sample, frame_math.cuh
// sdf_distance_code) unless kCode < 0 (march_sdf, the parent's, which calls
// sdf_distance's switch of every code a sample), which the
// -DGPRT_SPHERE_MARCH_GENERIC build launches, for checks.
#ifdef GPRT_SPHERE_MARCH_GENERIC
constexpr bool kSphereCoded = false;
#else
constexpr bool kSphereCoded = true;
#endif

// One thread per ray: a gated ray marches and takes its normal at the hit,
// an ungated ray writes its miss. The SIMT build (-DGPRT_COUNT_SIMT) also
// keeps the launch's longest march: each thread's samples, maxed into the
// counter past the SIMT counters.
template <int kCode>
__global__ void __launch_bounds__(128)
    sphere_trace(const float* __restrict__ o, const float* __restrict__ d,
                 const bool* __restrict__ gate, const float* __restrict__ t_max,
                 const float* __restrict__ t_start, float* __restrict__ t_hit,
                 float* __restrict__ normal, int n, int code, float step_scale, MarchSpec m,
                 unsigned long long* ops) {
  counters_begin(ops);
#if GPRT_COUNTING
  __syncthreads();
#endif
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    float t = kInf;
    V3 nl = v3(0.0f, 0.0f, 0.0f);
    if (gate[i]) {
      const V3 ol = v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]);
      const V3 dl = v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]);
      const float ts = t_start ? t_start[i] : 0.0f;
      float th = kInf;
#ifdef GPRT_COUNT_SIMT
      int samples = 0;
      const int r = kCode < 0
                        ? march_sdf(code, ol, dl, ts, t_max[i], step_scale, m, &th)
                        : march_sdf_code<kCode>(ol, dl, ts, t_max[i], step_scale, m, &th, &samples);
      atomicMax(ops + 2 * kSimtBuckets + 1, (unsigned long long)samples);
#else
      const int r = kCode < 0 ? march_sdf(code, ol, dl, ts, t_max[i], step_scale, m, &th)
                              : march_sdf_code<kCode>(ol, dl, ts, t_max[i], step_scale, m, &th);
#endif
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
  counters_end(ops);
}

// The march kernel for `code`: its specialized instantiation, or the
// generic one (kSphereCoded false).
template <typename Fn>
__host__ auto sphere_kernel(int code, Fn pick) {
  if constexpr (!kSphereCoded) {
    (void)code;
    return pick(sphere_trace<-1>);
  } else {
    switch (code) {
      case 0: return pick(sphere_trace<0>);
      case 1: return pick(sphere_trace<1>);
      case 2: return pick(sphere_trace<2>);
      case 3: return pick(sphere_trace<3>);
      case 4: return pick(sphere_trace<4>);
      case 5: return pick(sphere_trace<5>);
      case 6: return pick(sphere_trace<6>);
      case 7: return pick(sphere_trace<7>);
      default: return pick(sphere_trace<8>);
    }
  }
}

// The mesh entry: one mesh's `count` rows at tri (16-byte aligned) for each
// gated ray; a block with a gated ray stages them.
__global__ void __launch_bounds__(128)
    trimesh(const float* __restrict__ tri, int count, const float* __restrict__ o,
            const float* __restrict__ d, const bool* __restrict__ gate,
            const float* __restrict__ t_max, float* __restrict__ t_hit,
            float* __restrict__ normal, int n, int cull, int area_floats,
            unsigned long long* ops) {
  extern __shared__ float smem[];
  counters_begin(ops);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n && gate[i];
  StagedFaces sf{nullptr, nullptr, nullptr, 0, 0, 0};
  // (The vote is also the barrier that publishes a counting build's resets.)
  if (__syncthreads_or(live)) sf = stage_faces(tri, 0, count, align16(smem), area_floats, 0);
  if (i < n) {
    float t = kInf;
    V3 nl = v3(0.0f, 0.0f, 0.0f);
    if (live) {
      const V3 ol = v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]);
      const V3 dl = v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]);
      float th;
      V3 nh;
      if (sf.faces(tri, 0, count, ol, dl, t_max[i], cull != 0, &th, &nh)) {
        t = th;
        nl = nh;
      }
    }
    t_hit[i] = t;
    normal[3 * i] = nl.x;
    normal[3 * i + 1] = nl.y;
    normal[3 * i + 2] = nl.z;
  }
  counters_end(ops);
}

// The pass entry (see the top of this file): BLAS-space rays o, d (N, 3),
// active (N,), t0 (N,) (a closest pass's plane t or RAY_TMAX; an occlusion
// pass's RAY_TMAX, 0 for plane-occluded lanes, which come in inactive) over
// the pack_frame buffers; best_t, normal and gid out as the scene kernel
// writes them. kShared: the traversal's tables in shared memory (else read
// in place); the staged rows follow them, area_floats floats (the largest
// mesh's stage_floats, less 4).
template <bool kShared>
__global__ void __launch_bounds__(128)
    route_pass(const float* __restrict__ params, const int* __restrict__ layout,
               const float* __restrict__ tri, const float* __restrict__ o,
               const float* __restrict__ d, const bool* __restrict__ active,
               const float* __restrict__ t0, float* __restrict__ best_t,
               float* __restrict__ normal, int* __restrict__ gid, int n, int G, int M,
               int accept_first, int cull, int area_floats, unsigned long long* ops) {
  extern __shared__ float smem[];
  counters_begin(ops);
  const Scene s = load_scene<false, kShared>(params, layout, tri, G, M, smem);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n && active[i];
  V3 ob = v3(0.0f, 0.0f, 0.0f), dir = v3(0.0f, 0.0f, 0.0f);
  float tb = 0.0f;
  if (i < n) {
    ob = v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]);
    dir = v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]);
    tb = t0[i];
  }
  // The face rows of the meshes that some live lane of the block gates
  // against t0: one range, staged once where it fits the area. (Staging the
  // largest of them where the range does not fit cost the 544-face scene's
  // closest pass 2.3% in registers on an H100, PERF.md; no scene of the repo
  // has such a block.)
  int lo = 0x7fffffff, hi = 0;
  if (kStageFaces) {
    for (int g = 0; g < G; ++g) {
      const int* q = s.geo + kGeoStride * g;
      if (q[0] != kTriangle || q[kGeoFaceCount] <= 0) continue;
      if (__syncthreads_or(live && gate(s, g, ob, dir, tb))) {
        lo = min(lo, q[kGeoFaceStart]);
        hi = max(hi, q[kGeoFaceStart] + q[kGeoFaceCount]);
      }
    }
  }
  float* area = align16(smem + (kShared ? traversal_floats(G) + traversal_ints(G) : 0));
  const StagedFaces sf = stage_faces(tri, lo, hi, area, area_floats, accept_first != 0);
  if (i < n) {
    Hit h{tb, -1, v3(0.0f, 0.0f, 0.0f)};
    if (live) {
      GPRT_SIMT_BUCKET(accept_first != 0);
      if (accept_first) {
        h.gid = occluded_procedural<false, true, StagedFaces>(s, ob, dir, h.t, 0, CapSpec{},
                                                              nullptr, sf);
        if (h.gid >= 0) h.t = 0.0f;
      } else {
        closest_procedural<false, true, StagedFaces>(s, ob, dir, 0, cull != 0, &h, CapSpec{},
                                                     nullptr, sf);
      }
    }
    best_t[i] = h.t;
    normal[3 * i] = h.n.x;
    normal[3 * i + 1] = h.n.y;
    normal[3 * i + 2] = h.n.z;
    gid[i] = h.gid;
  }
  counters_end(ops);
}

}  // namespace gprt

// o, d: (n, 3) f32 local rays; gate (n,) bool; t_max (n,) f32; t_start (n,)
// f32 or null (march from 0); t_hit (n,) and normal (n, 3) f32 out. ops: a
// device counter that the counting build (-DGPRT_COUNT_OPS) adds the
// call's f32 FLOPs to (-DGPRT_COUNT_SIMT: 2 x 16 + 2 counters, the SIMT
// counters and the longest march's samples); the default build ignores it.
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
  gprt::sphere_kernel(code, [&](auto kernel) {
    kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        o, d, gate, t_max, t_start, t_hit, normal, n, code, step_scale, m, ops);
    return 0;
  });
  return (int)cudaGetLastError();
}

// The march kernel's resident blocks per SM and in all for distance code
// `code`; a report, nothing is launched.
extern "C" int gprt_sphere_residency(int code, int device, int* per_sm, int* total) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (code < 0 || code > 8) return (int)cudaErrorInvalidValue;
  return (int)gprt::sphere_kernel(
      code, [&](auto kernel) { return gprt::resident_blocks(kernel, 0, device, per_sm, total); });
}

// Floats of staging area a launch of `kernel` takes past `table` floats of
// tables for `faces` rows (the largest mesh). None in the
// -DGPRT_FACE_LOOP_GLOBAL build, where the area would pass the device's
// shared memory per block, or where it would leave the kernel fewer than
// half the blocks per SM that it keeps resident without it: on an H100 the
// pass entry staging a 1,152-face mesh at 3 blocks per SM ran 3% faster
// than the unculled loop at 5, and a 3,200-face mesh at 1 block per SM 68%
// slower (PERF.md).
template <typename Kernel>
static cudaError_t stage_area(Kernel kernel, int faces, int table, int device, int* area) {
  *area = 0;
  if (!gprt::kStageFaces || faces <= 0) return cudaSuccess;
  int cap = 0;
  cudaError_t err = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const long long floats = gprt::stage_floats(faces);
  if (4 * (table + floats) + 1024 > cap) return cudaSuccess;
  const size_t bare = 4 * (size_t)table, staged = 4 * (size_t)(table + floats);
  int without = 0, with = 0;
  err = gprt::reserve_shared(kernel, staged, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&without, kernel, 128, bare);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&with, kernel, 128, staged);
  if (err != cudaSuccess) return err;
  if (2 * with >= without) *area = (int)floats;
  return cudaSuccess;
}

// tri: one mesh's `count` rows of the face table (F x 12 f32: v0, e1, e2,
// n), 16-byte aligned.
extern "C" int gprt_trimesh(const float* tri, int count, const float* o, const float* d,
                            const bool* gate, const float* t_max, float* t_hit, float* normal,
                            int n, int cull, unsigned long long* ops, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || count < 0 || (reinterpret_cast<uintptr_t>(tri) & 15))
    return (int)cudaErrorInvalidValue;
  int area = 0;
  err = stage_area(gprt::trimesh, count, 0, device, &area);
  if (err != cudaSuccess) return (int)err;
  const size_t shmem = 4 * (size_t)area;
  err = gprt::reserve_shared(gprt::trimesh, shmem, device);
  if (err != cudaSuccess) return (int)err;
  gprt::trimesh<<<(n + 127) / 128, 128, shmem, (cudaStream_t)stream>>>(
      tri, count, o, d, gate, t_max, t_hit, normal, n, cull, area - 4, ops);
  return (int)cudaGetLastError();
}

// The pass entry over params / layout (pack_frame) and the face table tri
// (16-byte aligned; null without meshes; `faces`: the rows of its largest
// mesh); o, d (n, 3), active (n,), t0 (n,) in; best_t (n,), normal (n, 3),
// gid (n,) out. shared: the tables in shared memory; ops as for
// gprt_sphere_trace (-DGPRT_COUNT_SIMT: 2 x 16 + 1 counters, buckets 0/1
// marches of a closest / occlusion pass, 2/3 face tests of lanes that need
// their chunk, 4/5 of lanes carried along).
extern "C" int gprt_route_pass(const float* params, const int* layout, const float* tri,
                               const float* o, const float* d, const bool* active, const float* t0,
                               float* best_t, float* normal, int* gid, int n, int num_geometries,
                               int num_materials, int faces, int shared, int accept_first,
                               int cull, unsigned long long* ops, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || (reinterpret_cast<uintptr_t>(tri) & 15)) return (int)cudaErrorInvalidValue;
  if (GPRT_COUNTING && !shared) return (int)cudaErrorNotSupported;
  const auto kernel = GPRT_PICK1(gprt::route_pass, shared);
  const int table =
      shared ? gprt::traversal_floats(num_geometries) + gprt::traversal_ints(num_geometries) : 0;
  int area = 0;
  err = stage_area(kernel, faces, table, device, &area);
  if (err != cudaSuccess) return (int)err;
  const size_t shmem = 4 * (size_t)(table + area);
  err = gprt::reserve_shared(kernel, shmem, device);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(n + 127) / 128, 128, shmem, (cudaStream_t)stream>>>(
      params, layout, tri, o, d, active, t0, best_t, normal, gid, n, num_geometries,
      num_materials, accept_first, cull, area - 4, ops);
  return (int)cudaGetLastError();
}

// The pass entry's resident blocks per SM and in all, as gprt_route_pass
// launches it; a report, nothing is launched.
extern "C" int gprt_route_residency(int num_geometries, int num_materials, int faces, int shared,
                                    int device, int* per_sm, int* total) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (GPRT_COUNTING && !shared) return (int)cudaErrorNotSupported;
  const auto kernel = GPRT_PICK1(gprt::route_pass, shared);
  const int table =
      shared ? gprt::traversal_floats(num_geometries) + gprt::traversal_ints(num_geometries) : 0;
  int area = 0;
  err = stage_area(kernel, faces, table, device, &area);
  if (err != cudaSuccess) return (int)err;
  const size_t shmem = 4 * (size_t)(table + area);
  err = gprt::reserve_shared(kernel, shmem, device);
  if (err != cudaSuccess) return (int)err;
  return (int)gprt::resident_blocks(kernel, shmem, device, per_sm, total);
}

extern "C" const char* gprt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
