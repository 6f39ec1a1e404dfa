"""The CUDA kernels' device code rehearsed on the CPU with g++.

csrc/frame_kernel.cu and csrc/scene_kernel.cu are compiled, up to their
host launchers, against csrc/host_rehearsal.h (host stand-ins for the CUDA
keywords, intrinsics and runtime calls) with -ffp-contract=off, which
repeats the plain versions' arithmetic, into
build/gpuraytracer_tpu_torch/rehearsal/, and every block runs on one
thread: one pixel (one ray) per block.

This is the CPU check of the kernels' own logic, in both layouts of the
scene tables (copied to shared memory, or read in place from global memory
as for a scene past a block's shared memory): the frame kernel must give
its plain version (kernels/frame_kernel.render_frame_plain) and the scene
kernel its plain version (kernels/scene_kernel.scene_closest_plain) on
every pixel and ray. The two sides compute the same float32 operations in
the same order, but sqrt, pow, exp, log and the trigonometric functions
come from different libraries (glibc here, PyTorch's kernels there), which
may differ in the last ulp. So: every pixel within 1e-5 of the plain
version (max channel), and every ray's geometry id equal and its t within
1e-5; normals within 1e-3, because the tetrahedral normal divides its
distance differences by the offset (5.8e-5), which turns a last-ulp
difference of one distance into about 1e-4 (one ray of the builtin pass,
on a twisted or cog SDF). Skips without g++.

The Julia set's normal (SDF code 8) is also built the way the shipped CUDA
build compiles, with multiply-adds contracted into FMAs (-mfma
-ffp-contract=fast, on a CPU that has them): its 11 chaotic iterations
amplify a contracted product's last bit, so csrc/frame_math.cuh
(julia_normal, which hit_normal calls for code 8) rounds each of its
products and sums (__fmul_rn, __fadd_rn), which no compiler fuses. Contracted, the normals at points within 0.02 of the set agree
with the plain version (geometry/sdf.calculate_normal) bit for bit on
about 77% of them and differ by up to 1.3e-3; rounded op by op, on >= 99%
and by at most 1e-4 (the rest is the libraries' log and sqrt).

csrc/megakernel.cu's pass entry (the per-geometry route's one launch per
pass) is held to the route's plain version (megakernel.route_pass_plain)
on the 544-face scene: 48x27 camera rays, their level-1 reflections and
the shadow rays off the camera rays' hits, in both table layouts and in
both builds of the face loop (the shipped one, rows staged with the chunk
skip, and the -DGPRT_FACE_LOOP_GLOBAL build, every face from global
memory; the two bit-equal): equal geometry ids, t and normals within 1e-6
(the scene's marches end at the same samples on both sides, and the
libraries' last-ulp differences did not reach them). So is a scene of
several meshes (mesh_octahedra's), whose staging area holds only the
largest mesh, so that a block gating two meshes stages nothing and reads
their rows from global memory. Its face loop alone (the mesh entry) with
staging and the chunk skip equals the unculled loop bit for bit on the
heightfield's faces and seeded rays, a third of them grazing a face (det
between 1e-12 and 1e-6), and the skip passes over most chunks of the rays
that do not graze.

csrc/scene_finish.cu's two-phase compaction queues every dirty ray once
in key order, and the finisher over the queue gives the per-ray
finisher's outputs (the -DGPRT_FINISH_PER_RAY build) bit for bit and the
plain finisher's within the tolerances above. csrc/frame_gate.cu
launches the frame kernel from device code (GPRT_TAIL_LAUNCH), which the
rehearsal records instead (host_rehearsal.h rh::tail) and its entry runs
over the recorded grid: the gate launches nothing and leaves the image as
it was without an overflow, and with one launches the frame kernel over
the band, the rehearsed frame kernel's pixels bit for bit.

csrc/wavefront.cu's lane kernels (the wavefront's device form between its
passes) are held to their plain versions (kernels/wavefront.start_plain,
hit_plain, shade_plain) on lanes drawn from a numpy seed: the start kernel
over a band of the builtin frame, the hit and shade kernels on 600 lanes
of the builtin and the fractal scene aimed at every geometry and past
them (plane hits, misses, metaball and fractal hits, a fifth of the lanes
inactive), shade at level 0 with the occlusion pass's answer and at the
last level without one: floats within 1e-5, relative past 1 (positions
and t reach 10^4), the shadow and kill flags equal.

csrc/frame_state.cu (row 10) writes the per-frame fields of the builtin
scene, the five bench scenes and the three mesh scenes at times drawn from
a seed into pack_static's buffer as its plain version
(kernels/frame_state.advance_plain) writes them: the header's time and
every instance that does not rotate bit for bit, the rotating instances'
fields within 4 ulps of max(|value|, 8) (glibc's cosf and sinf against
PyTorch's cos and sin; the translation column sums products of centres up
to 6) and the metaball centres within 4 ulps of 1 (the kernel multiplies
the time by the cycle's f32 reciprocal, as PyTorch's CUDA division by a
Python scalar does, where the CPU's plain version divides); everything
else in the buffer untouched.
"""

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile

import numpy as np
import pytest
import torch
from test_torch_megakernel import seeded_face_rays
from test_torch_two_phase import GOLDEN, port_scene_cached
from test_torch_two_phase import inputs as two_phase_inputs

from gpuraytracer_tpu_torch.accel import traverse
from gpuraytracer_tpu_torch.core import camera as cam
from gpuraytracer_tpu_torch.core import hlsl
from gpuraytracer_tpu_torch.geometry import analytic, sdf
from gpuraytracer_tpu_torch.kernels import frame_kernel, frame_state, megakernel, scene_kernel
from gpuraytracer_tpu_torch.models import builtin, meshes, scenes
from gpuraytracer_tpu_torch.render import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "gpuraytracer_tpu_torch", "kernels", "csrc")
BUILD = os.path.join(ROOT, "build", "gpuraytracer_tpu_torch", "rehearsal")
W, H = 24, 14
T_ANIM = 0.7
TOL = 1e-5
NORMAL_TOL = 1e-3

# Runs every block of a launch on one thread, after the kernel source.
ENTRIES = {
    "frame_math": r"""
#include <cuda_runtime.h>
#include "frame_math.cuh"

extern "C" void rh_normal(int code, const float* p, float* out, int n) {
  for (int i = 0; i < n; ++i) {
    const gprt::V3 v = gprt::hit_normal(code, gprt::v3(p[3 * i], p[3 * i + 1], p[3 * i + 2]));
    out[3 * i] = v.x;
    out[3 * i + 1] = v.y;
    out[3 * i + 2] = v.z;
  }
}
""",
    "frame_kernel": r"""
namespace gprt { float smem[1 << 16]; }

// The frame kernel over the band of local_height rows from row_offset, one
// pixel per one-thread block; returns the pixels.
extern "C" int rh_frame(const float* params, const int* layout, const float* tri, float* out,
                        int width, int height, int row_offset, int local_height, int max_depth,
                        int G, int M, int shared) {
  blockDim = dim3{1, 1, 1};
  gridDim = dim3{(unsigned)width, (unsigned)local_height, 1};
  threadIdx = dim3{0, 0, 0};
  const auto kernel = shared ? gprt::frame_kernel<false, true> : gprt::frame_kernel<false, false>;
  for (int y = 0; y < local_height; ++y) {
    for (int x = 0; x < width; ++x) {
      blockIdx = dim3{(unsigned)x, (unsigned)y, 0};
      kernel(params, layout, tri, reinterpret_cast<float4*>(out), width, height, row_offset,
             local_height, max_depth, G, M, nullptr);
    }
  }
  return width * local_height;
}

// The compact entry over a band with a queue of `cap` slots (every SDF march capped at
// `steps`, metaballs uncapped), counting its 32 keys into bins (2 x 32 + 1
// int32, zeroed here as the launcher's memset does: the histogram, the bin
// entry's cursors and its count of finished blocks); returns the queue's
// count.
extern "C" int rh_compact(const float* params, const int* layout, const float* tri, float* out,
                          void* queue, int* bins, int cap, int width, int height, int row_offset,
                          int local_height, int max_depth, int G, int M, int steps) {
  int count = 0;
  blockDim = dim3{1, 1, 1};
  threadIdx = dim3{0, 0, 0};
  const gprt::CapSpec caps{steps, gprt::kMetaballSteps};
  for (int k = 0; k < 2 * 32 + 1; ++k) bins[k] = 0;
  for (int y = 0; y < local_height; ++y) {
    for (int x = 0; x < width; ++x) {
      blockIdx = dim3{(unsigned)x, (unsigned)y, 0};
      gprt::frame_compact_kernel<true>(params, layout, tri, reinterpret_cast<float4*>(out), nullptr,
                                       gprt::DeviceQueue{queue, &count, cap, bins, 32}, width,
                                       height, row_offset, local_height, max_depth, G, M, caps,
                                       caps, nullptr);
    }
  }
  return count;
}

// The dense entry over a band's compact queue with `count` entries counted.
extern "C" void rh_dense(const float* params, const int* layout, const float* tri, void* queue,
                          int count, int cap, float* out, int width, int height, int row_offset,
                          int max_depth, int G, int M) {
  blockDim = dim3{1, 1, 1};
  threadIdx = dim3{0, 0, 0};
  for (int i = 0; i < cap; ++i) {
    blockIdx = dim3{(unsigned)i, 0, 0};
    gprt::frame_dense_kernel<false, true>(params, layout, tri,
                                           gprt::DeviceQueue{queue, &count, cap, nullptr, 0},
                                           reinterpret_cast<float4*>(out), width, height,
                                           row_offset, max_depth, G, M, nullptr);
  }
}

// The defer entry over a band with per-level queues of `cap` slots
// (occlusion capped at `steps`), the march records of the unknown lanes in
// march ((max_depth - 1) x width x local_height MarchRecords; may be null)
// and the keys counted into
// bins (2 x (max_depth - 1) x nbins + 1 int32, zeroed here as the
// launcher's memset does: the histograms, the bin entry's cursors and its
// count of finished blocks); counts (max_depth - 1) out.
extern "C" void rh_defer(const float* params, const int* layout, const float* tri, float* lit,
                         float* shadowed, int* sinfo, float* rays, void* march, int* queue,
                         int* counts, int* bins, int cap, int width, int height, int row_offset,
                         int local_height, int max_depth, int G, int M, int steps) {
  blockDim = dim3{1, 1, 1};
  threadIdx = dim3{0, 0, 0};
  const int nsl = max_depth - 1, npix = width * local_height;
  const int nbins = 32 * ((npix + 32767) >> 15);
  const gprt::DeferOut rec{reinterpret_cast<float4*>(lit), reinterpret_cast<float4*>(shadowed),
                           sinfo, rays, static_cast<gprt::MarchRecord*>(march), npix};
  for (int k = 0; k < nsl; ++k) counts[k] = 0;
  for (int k = 0; k < 2 * nsl * nbins + 1; ++k) bins[k] = 0;
  for (int y = 0; y < local_height; ++y) {
    for (int x = 0; x < width; ++x) {
      blockIdx = dim3{(unsigned)x, (unsigned)y, 0};
      gprt::frame_defer_kernel<true>(params, layout, tri, rec,
                                     gprt::DeviceQueue{queue, counts, cap, bins, nbins}, width,
                                     height, row_offset, local_height, max_depth, G, M,
                                     gprt::CapSpec{steps, gprt::kMetaballSteps}, nullptr);
    }
  }
}

// The bin entry over nseg segments of cap slots (defer: int pixel indices
// with the status planes; else compact QueueEntry slots) with bins as the
// main entry left it (its histograms, zero cursors and count); the counts
// are added to *total.
extern "C" void rh_bin(const void* queue, void* out, const int* count, const int* sinfo, int* bins,
                       int nseg, int cap, int npix, int nbins, int defer,
                       unsigned long long* total) {
  blockDim = dim3{1, 1, 1};
  gridDim = dim3{(unsigned)cap, (unsigned)nseg, 1};
  threadIdx = dim3{0, 0, 0};
  const gprt::BinQueue b{queue, out, count, sinfo, bins, nseg, cap, npix, nbins};
  const auto kernel = defer ? gprt::queue_bin_kernel<true> : gprt::queue_bin_kernel<false>;
  for (int k = 0; k < nseg; ++k) {
    for (int i = 0; i < cap; ++i) {
      blockIdx = dim3{(unsigned)i, (unsigned)k, 0};
      kernel(b, total);
    }
  }
}

// The compose entry over n pixels.
extern "C" void rh_compose(const float* lit, const float* shadowed, const int* sinfo,
                           const int* occ, float* out, int n, int max_depth) {
  blockDim = dim3{1, 1, 1};
  threadIdx = dim3{0, 0, 0};
  for (int i = 0; i < n; ++i) {
    blockIdx = dim3{(unsigned)i, 0, 0};
    gprt::frame_compose_kernel(reinterpret_cast<const float4*>(lit),
                               reinterpret_cast<const float4*>(shadowed), sinfo, occ,
                               reinterpret_cast<float4*>(out), n, max_depth);
  }
}
""",
    "scene_kernel": r"""
#include <random>

namespace gprt { float smem[1 << 16]; }

// The scene pass, one ray per one-thread block; returns the rays.
extern "C" int rh_scene(const float* params, const int* layout, const float* tri, const float* o,
                        const float* d, const bool* active, const float* t0, float* best_t,
                        float* normal, int* gid, int n, int G, int M, int shared, int level,
                        int accept_first, int cull) {
  blockDim = dim3{1, 1, 1};
  gridDim = dim3{(unsigned)n, 1, 1};
  threadIdx = dim3{0, 0, 0};
  const auto kernel = shared ? gprt::scene_kernel<false, true> : gprt::scene_kernel<false, false>;
  for (int i = 0; i < n; ++i) {
    blockIdx = dim3{(unsigned)i, 0, 0};
    kernel(params, layout, tri, o, d, active, t0, best_t, normal, gid, nullptr, n, G, M, level,
           accept_first, cull, gprt::CapSpec{0, 0}, nullptr);
  }
  return n;
}

namespace {

// One warp of the merged occlusion march: lane l marches ray ray_of[l],
// resumed from its march record where recs is given.
struct MergedWarp {
  const gprt::Scene* s;
  const float* rays;
  const gprt::MarchRecord* recs;
  const int* ray_of;
  int* occ;
  int level;
};

void merged_lane(int lane, void* arg) {
  const MergedWarp* w = static_cast<const MergedWarp*>(arg);
  const int i = w->ray_of[lane];
  const float* r = w->rays + 6 * i;
  const gprt::V3 ob = gprt::v3(r[0], r[1], r[2]), d = gprt::v3(r[3], r[4], r[5]);
  w->occ[i] = (w->recs != nullptr
                   ? gprt::occluded_resumed<true>(*w->s, ob, d, gprt::kRayTMax, w->level, w->recs[i])
                   : gprt::occluded_merged(*w->s, ob, d, gprt::kRayTMax, w->level))
                  ? 1
                  : 0;
}

}  // namespace

// The accept-first occlusion (1 or 0 in occ) of n BLAS-space shadow rays
// (n x 6) at `level`: merged, the merged march on warps of emulated lanes
// under the turn schedule `seed` (each warp takes 1-32 rays on lanes drawn
// at random, and its lanes enter in one to three groups, so that the lane
// that leads each turn, and with it the order of turns, follows the seed),
// resumed from the rays' march records where rec is given (the merged
// repair); else the sequential traversal (occluded_procedural), a ray at a
// time. Returns the warps whose lanes broke the rules of a vote.
extern "C" int rh_occluded(const float* params, const int* layout, const float* tri,
                           const float* rays, const void* rec, int* occ, int n, int G, int M,
                           int shared, int level, int merged, unsigned seed) {
  blockDim = dim3{1, 1, 1};
  blockIdx = dim3{0, 0, 0};
  threadIdx = dim3{0, 0, 0};
  const gprt::Scene s = shared ? gprt::load_scene<false, true>(params, layout, tri, G, M, gprt::smem)
                               : gprt::load_scene<false, false>(params, layout, tri, G, M, gprt::smem);
  if (!merged) {
    for (int i = 0; i < n; ++i) {
      const float* r = rays + 6 * i;
      occ[i] = gprt::occluded_procedural(s, gprt::v3(r[0], r[1], r[2]),
                                         gprt::v3(r[3], r[4], r[5]), gprt::kRayTMax, level) >= 0;
    }
    return 0;
  }
  blockDim = dim3{32, 1, 1};
  std::mt19937 rng(seed);
  int faults = 0;
  for (int i = 0; i < n;) {
    int lanes[32];
    for (int l = 0; l < 32; ++l) lanes[l] = l;
    std::shuffle(lanes, lanes + 32, rng);
    const int c = std::min(n - i, 1 + (int)(rng() % 32));
    const int split = 1 + (int)(rng() % 3);
    int ray_of[32];
    unsigned groups[3] = {0u, 0u, 0u};
    for (int j = 0; j < c; ++j) {
      ray_of[lanes[j]] = i + j;
      groups[rng() % split] |= 1u << lanes[j];
    }
    unsigned* end = std::remove(groups, groups + split, 0u);
    MergedWarp w{&s, rays, static_cast<const gprt::MarchRecord*>(rec), ray_of, occ, level};
    faults += !rh::run_warp(groups, (int)(end - groups), merged_lane, &w);
    i += c;
  }
  blockDim = dim3{1, 1, 1};
  return faults;
}

// The repair over device queues: nsl levels of cap slots (idx and count
// null: every pixel, cap = npix, with the active mask); with march (the
// defer entry's records) the queue form that resumes from them, else the
// whole traversal (the flat form, and the queue form of the
// -DGPRT_REPAIR_FULL build).
extern "C" void rh_queue_planes(const float* params, const int* layout, const float* tri,
                                const float* rays, const int* idx, const int* count,
                                const bool* active, const void* march, int* occ, int npix, int nsl,
                                int cap, int G, int M) {
  blockDim = dim3{1, 1, 1};
  threadIdx = dim3{0, 0, 0};
  const auto* rec = static_cast<const gprt::MarchRecord*>(march);
  const auto kernel = rec != nullptr ? gprt::shadow_queue_kernel<false, true, true>
                                     : gprt::shadow_queue_kernel<false, true, false>;
  for (int k = 0; k < nsl; ++k) {
    for (int i = 0; i < cap; ++i) {
      blockIdx = dim3{(unsigned)i, (unsigned)k, 0};
      kernel(params, layout, tri, rays, idx, count, active, rec, occ, npix, nsl, cap, G, M,
             nullptr);
    }
  }
}

// The defer entry's capped occlusion search on n BLAS-space shadow rays (n
// x 6) at `level`, occlusion marches capped at `steps` (metaballs at
// mb_steps), as the defer form runs it after the plane test: status[i] 1
// occluded, 2 unknown (the cap stopped a march), 0 lit, and at an unknown
// ray its march record in rec[i]. Then the repair's query on every unknown
// ray, resumed from its record (resumed[i]) and whole from geometry 0
// (whole[i]); -1 on the others. At an unknown ray also the capped
// geometry's march at the level's full budget, resumed and whole: how each
// ended (march[2 * i], march[2 * i + 1]: MarchResult, kMarchHit where it
// occludes) and its t (t[2 * i], t[2 * i + 1]; NaN where it missed).
// shared: the tables' layout.
extern "C" void rh_resume(const float* params, const int* layout, const float* tri,
                          const float* rays, int* status, void* rec, int* resumed, int* whole,
                          int* march, float* t, int n, int G, int M, int shared, int level,
                          int steps, int mb_steps) {
  blockDim = dim3{1, 1, 1};
  blockIdx = dim3{0, 0, 0};
  threadIdx = dim3{0, 0, 0};
  const gprt::Scene s = shared ? gprt::load_scene<false, true>(params, layout, tri, G, M, gprt::smem)
                               : gprt::load_scene<false, false>(params, layout, tri, G, M, gprt::smem);
  auto* recs = static_cast<gprt::MarchRecord*>(rec);
  for (int i = 0; i < n; ++i) {
    const float* r = rays + 6 * i;
    const gprt::V3 ob = gprt::v3(r[0], r[1], r[2]), d = gprt::v3(r[3], r[4], r[5]);
    unsigned dirty = 0;
    const bool hit = gprt::occluded_procedural<true, true, gprt::GlobalMesh, true>(
                         s, ob, d, gprt::kRayTMax, level, gprt::CapSpec{steps, mb_steps}, &dirty,
                         gprt::GlobalMesh{}, recs + i) >= 0;
    status[i] = hit ? 1 : (dirty != 0 ? 2 : 0);
    resumed[i] = whole[i] = -1;
    if (status[i] != 2) continue;
    resumed[i] = gprt::occluded_resumed<false>(s, ob, d, gprt::kRayTMax, level, recs[i]);
    whole[i] = gprt::occluded_procedural(s, ob, d, gprt::kRayTMax, level) >= 0;
    // The capped geometry's march, resumed, and whole from its start as
    // intersect runs it.
    float tk[2] = {NAN, NAN};
    march[2 * i] = gprt::resumed_march(s, ob, d, gprt::kRayTMax, level, recs[i], tk);
    const int g = recs[i].g, *q = s.geo + gprt::kGeoStride * g;
    gprt::V3 ol, dl;
    gprt::local_ray(s, g, ob, d, &ol, &dl);
    if (q[0] == gprt::kVolumetric) {
      march[2 * i + 1] = gprt::march_metaballs(ol, dl, gprt::kRayTMax, s.mb, true,
                                               gprt::kMetaballSteps, tk + 1);
    } else {
      float t_lo = 0.0f, t_hi = gprt::kRayTMax;
      const bool windowed = q[gprt::kGeoWindowed] != 0;
      if (windowed) gprt::unit_box_window(ol, dl, gprt::kRayTMax, &t_lo, &t_hi);
      const gprt::MarchSpec m = gprt::spec(s, g, true, level, true, windowed);
      const int r = gprt::march_sdf(q[1], ol, dl, t_lo, t_hi, s.sscale[g], m, tk + 1);
      march[2 * i + 1] = gprt::march_hit(r, m) ? gprt::kMarchHit : r;
    }
    for (int k = 0; k < 2; ++k) t[2 * i + k] = march[2 * i + k] == gprt::kMarchMiss ? NAN : tk[k];
  }
}
""",
    "megakernel": r"""
namespace gprt { float smem[1 << 16]; }

// The pass entry, one ray per one-thread block, with a staging area for
// `faces` rows (the launcher's: the largest mesh); returns the rays.
extern "C" int rh_route(const float* params, const int* layout, const float* tri, const float* o,
                        const float* d, const bool* active, const float* t0, float* best_t,
                        float* normal, int* gid, int n, int G, int M, int faces, int shared,
                        int accept_first) {
  blockDim = dim3{1, 1, 1};
  gridDim = dim3{(unsigned)n, 1, 1};
  threadIdx = dim3{0, 0, 0};
  const auto kernel = shared ? gprt::route_pass<true> : gprt::route_pass<false>;
  const int area = faces <= 0 ? 0 : gprt::stage_floats(faces);
  for (int i = 0; i < n; ++i) {
    blockIdx = dim3{(unsigned)i, 0, 0};
    kernel(params, layout, tri, o, d, active, t0, best_t, normal, gid, n, G, M, accept_first, 1,
           area - 4, nullptr);
  }
  return n;
}

// The mesh entry over n rays; returns how many (ray, chunk) pairs the skip
// passed over.
extern "C" int rh_trimesh(const float* tri, int count, const float* o, const float* d,
                          const bool* gate, const float* t_max, float* t_hit, float* normal,
                          int n) {
  blockDim = dim3{1, 1, 1};
  threadIdx = dim3{0, 0, 0};
  const int area = gprt::stage_floats(count);
  for (int i = 0; i < n; ++i) {
    blockIdx = dim3{(unsigned)i, 0, 0};
    gprt::trimesh(tri, count, o, d, gate, t_max, t_hit, normal, n, 1, area - 4, nullptr);
  }
  // The skip's decisions, with the rows' chunk records.
  const int nchunks = (count + gprt::kChunk - 1) / gprt::kChunk;
  float* nrm = gprt::smem;
  float* rec = nrm + 3 * count;
  for (int j = 0; j < nchunks; ++j) {
    gprt::chunk_record(tri + gprt::kFaceStride * gprt::kChunk * j,
                       std::min(gprt::kChunk, count - gprt::kChunk * j), nrm + 3 * gprt::kChunk * j,
                       rec + gprt::kChunkFloats * j);
  }
  int skipped = 0;
  for (int i = 0; i < n; ++i) {
    const gprt::V3 oi = gprt::v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]);
    const gprt::V3 di = gprt::v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]);
    for (int j = 0; j < nchunks; ++j) {
      skipped += !gprt::chunk_needed(rec + gprt::kChunkFloats * j, nrm + 3 * gprt::kChunk * j,
                                     std::min(gprt::kChunk, count - gprt::kChunk * j), oi, di,
                                     gprt::len3(di), t_max[i]);
    }
  }
  return skipped;
}

// The one-geometry march over n rays, one-thread blocks: the march entry
// for the code (specialized on it) over every ray.
extern "C" void rh_sphere_trace(const float* o, const float* d, const bool* gate,
                                const float* t_max, const float* t_start, float* t_hit,
                                float* normal, int n, int code, float step_scale, int max_steps,
                                float relax, float fail_scale, int capped_hit, int cull,
                                int escape) {
  blockDim = dim3{1, 1, 1};
  gridDim = dim3{(unsigned)n, 1, 1};
  threadIdx = dim3{0, 0, 0};
  gprt::MarchSpec m;
  m.max_steps = max_steps;
  m.relax = relax;
  m.fail_scale = fail_scale;
  m.capped_hit = capped_hit != 0;
  m.cull = cull != 0;
  m.escape = escape != 0;
  gprt::sphere_kernel(code, [&](auto kernel) {
    for (int i = 0; i < n; ++i) {
      blockIdx = dim3{(unsigned)i, 0, 0};
      kernel(o, d, gate, t_max, t_start, t_hit, normal, n, code, step_scale, m, nullptr);
    }
    return 0;
  });
}
""",
    "scene_finish": r"""
namespace gprt { float smem[1 << 16]; }

// The two-phase finisher over n rays' main-pass outputs (best_t, normal,
// gid, updated in place) and dirty words, one-thread blocks. The queued
// build: the compaction's append and bin entries into queue (2n int32: the
// append order, then the ordered queue) with words (kFinishWords int32),
// then the finisher over the queue's n slots. The -DGPRT_FINISH_PER_RAY
// build: one block per ray over all n.
extern "C" void rh_finish(const float* params, const int* layout, const float* tri,
                          const float* o, const float* d, const int* dirty, int* queue, int* words,
                          float* best_t, float* normal, int* gid, int n, int G, int M, int shared,
                          int accept_first, int cull) {
  blockDim = dim3{1, 1, 1};
  threadIdx = dim3{0, 0, 0};
  gridDim = dim3{(unsigned)n, 1, 1};
#ifdef GPRT_FINISH_PER_RAY
  const auto kernel = shared ? gprt::finish_ray_kernel<true> : gprt::finish_ray_kernel<false>;
  for (int i = 0; i < n; ++i) {
    blockIdx = dim3{(unsigned)i, 0, 0};
    kernel(params, layout, tri, o, d, dirty, best_t, normal, gid, n, G, M, accept_first, cull,
           nullptr);
  }
#else
  for (int k = 0; k < gprt::kFinishWords; ++k) words[k] = 0;
  for (int i = 0; i < n; ++i) {
    blockIdx = dim3{(unsigned)i, 0, 0};
    gprt::finish_append_kernel(dirty, n, queue, words);
  }
  for (int b = 0; b < n; ++b) {
    blockIdx = dim3{(unsigned)b, 0, 0};
    gprt::finish_bin_kernel(dirty, queue, queue + n, words);
  }
  const auto kernel = shared ? gprt::finish_queue_kernel<true> : gprt::finish_queue_kernel<false>;
  for (int i = 0; i < n; ++i) {
    blockIdx = dim3{(unsigned)i, 0, 0};
    kernel(params, layout, tri, o, d, dirty, queue + n, words, best_t, normal, gid, G, M,
           accept_first, cull, nullptr);
  }
#endif
}
""",
    "frame_gate": r"""
namespace gprt { float smem[1 << 16]; }

// The overflow gate (one block; one-thread warps) over n counts against
// cap, then, where it launched the frame kernel into the tail of its grid,
// that frame kernel over the recorded grid, each pixel of its 16x8 blocks
// as a one-thread block, into the band's image out; returns the gate's
// tail launches.
extern "C" int rh_gate(const float* params, const int* layout, const float* tri, float* out,
                       const int* count, int n, int cap, int width, int height, int row_offset,
                       int local_height, int max_depth, int G, int M, int shared) {
  blockDim = gridDim = dim3{1, 1, 1};
  blockIdx = threadIdx = dim3{0, 0, 0};
  rh::tail_launches = 0;
  const auto gate = shared ? gprt::frame_gate_kernel<false, true>
                           : gprt::frame_gate_kernel<false, false>;
  gate(params, layout, tri, reinterpret_cast<float4*>(out), count, n, cap,
       gprt::frame_grid(width, local_height), 0u, width, height, row_offset, local_height,
       max_depth, G, M, nullptr);
  if (rh::tail_launches == 0) return 0;
  const auto kernel = shared ? gprt::frame_kernel<false, true> : gprt::frame_kernel<false, false>;
  const dim3 g = rh::tail.grid, b = rh::tail.block;
  gridDim = dim3{g.x * b.x, g.y * b.y, 1};
  for (unsigned y = 0; y < g.y * b.y; ++y) {
    for (unsigned x = 0; x < g.x * b.x; ++x) {
      blockIdx = dim3{x, y, 0};
      kernel(params, layout, tri, reinterpret_cast<float4*>(out), width, height, row_offset,
             local_height, max_depth, G, M, nullptr);
    }
  }
  return rh::tail_launches;
}
""",
    "wavefront": r"""
namespace gprt { float smem[1 << 16]; }

// One of the lane kernels (kernel 0 start, 1 hit, 2 shade) over n lanes,
// one lane per one-thread block.
extern "C" void rh_wave(int kernel, const float* params, const int* layout, float* o, float* d,
                        float* color, float* tw, bool* active, float* ob, float* t0,
                        const float* best_t, const float* normal, const int* gid, float* s_ob,
                        float* s_d, bool* s_active, float* s_t0, const int* s_gid, int n,
                        int width, int height, int row_offset, int level, int max_depth, int G,
                        int M) {
  blockDim = dim3{1, 1, 1};
  gridDim = dim3{(unsigned)n, 1, 1};
  threadIdx = dim3{0, 0, 0};
  const gprt::Lanes L{o, d, reinterpret_cast<float4*>(color), reinterpret_cast<float4*>(tw),
                      active, ob, t0};
  const gprt::Answer a{best_t, normal, gid};
  const gprt::ShadowRays R{s_ob, s_d, s_active, s_t0};
  for (int i = 0; i < n; ++i) {
    blockIdx = dim3{(unsigned)i, 0, 0};
    if (kernel == 0) {
      gprt::wavefront_start_kernel(params, layout, L, n, width, height, row_offset, G, M);
    } else if (kernel == 1) {
      gprt::wavefront_hit_kernel(params, layout, L, a, R, n, G, M);
    } else {
      gprt::wavefront_shade_kernel(params, layout, L, a, R, s_gid, n, width, height, row_offset,
                                   level, max_depth, G, M);
    }
  }
}
""",
    "frame_state": r"""
// Row 10 over its G + 1 threads, one thread per one-thread block.
extern "C" void rh_frame_state(float* params, const float* table, const float* mb,
                               const float* times, int index, int G) {
  blockDim = dim3{1, 1, 1};
  gridDim = dim3{(unsigned)(G + 1), 1, 1};
  threadIdx = dim3{0, 0, 0};
  for (int g = 0; g <= G; ++g) {
    blockIdx = dim3{(unsigned)g, 0, 0};
    gprt::frame_state_kernel(params, table, mb, times, index, G);
  }
}
""",
}


# Builds of a source with a macro defined: (source, macro).
DEFINES = {"megakernel_global": ("megakernel", "GPRT_FACE_LOOP_GLOBAL"),
           "scene_kernel_fma": ("scene_kernel", None),
           "scene_finish_per_ray": ("scene_finish", "GPRT_FINISH_PER_RAY")}
ENTRIES["megakernel_global"] = ENTRIES["megakernel"]
ENTRIES["scene_kernel_fma"] = ENTRIES["scene_kernel"]
ENTRIES["scene_finish_per_ray"] = ENTRIES["scene_finish"]
# Builds that contract multiply-adds into FMAs as the shipped CUDA build
# does (-mfma -ffp-contract=fast; made only on a CPU with FMA instructions);
# the rest repeat the plain arithmetic.
CONTRACTED = ("frame_math", "scene_kernel_fma")


def _device_part(name):
    """csrc/<name>.cu up to the end of its device code (namespace gprt),
    after its macro (DEFINES); nothing for the header-only frame_math
    build."""
    if name == "frame_math":
        return ""
    source, macro = DEFINES.get(name, (name, None))
    with open(os.path.join(CSRC, f"{source}.cu")) as f:
        src = f.read()
    end = src.rindex("}  // namespace gprt")
    return (f"#define {macro}\n" if macro else "") + src[:end] + "}  // namespace gprt\n"


@pytest.fixture(scope="module")
def libs():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to rehearse the CUDA sources")
    fma = _has_fma()
    os.makedirs(os.path.join(BUILD, "include"), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".h", dir=os.path.join(BUILD, "include"))
    with os.fdopen(fd, "w") as f:
        f.write('#pragma once\n#include "host_rehearsal.h"\n')
    os.replace(tmp, os.path.join(BUILD, "include", "cuda_runtime.h"))
    # frame_gate.cu includes frame_kernel.cu.
    headers = b"".join(open(os.path.join(CSRC, h), "rb").read()
                       for h in ("frame_math.cuh", "traverse.cuh", "shading.cuh",
                                 "host_rehearsal.h", "frame_kernel.cu"))
    procs, paths = {}, {}
    for name, entry in ENTRIES.items():
        if name in CONTRACTED and not fma:
            continue
        text = _device_part(name) + entry
        # The contracted builds contract as the shipped CUDA build does; the
        # others repeat the plain arithmetic. -fno-thread-jumps: g++ would
        # otherwise thread the first pass of a loop whose carries start as
        # constants into a copy of its own and contract that copy apart (a
        # march started from a record would then take other roundings than
        # the march from its start); NVVM's jump threading does not cross a
        # loop header.
        fp = (["-O2", "-mfma", "-ffp-contract=fast", "-fno-thread-jumps"] if name in CONTRACTED
              else ["-O1", "-ffp-contract=off"])
        tag = hashlib.sha256(headers + text.encode() + " ".join(fp).encode()).hexdigest()[:16]
        paths[name] = os.path.join(BUILD, f"{name}_{tag}.so")
        if os.path.exists(paths[name]):
            continue
        # Unique temporary names: processes that build at once do not clash.
        fd, cpp = tempfile.mkstemp(suffix=".cpp", dir=BUILD)
        with os.fdopen(fd, "w") as f:
            f.write(text)
        cmd = [gxx, "-std=c++17", *fp, "-fPIC", "-shared", "-w", "-I",
               os.path.join(BUILD, "include"), "-I", CSRC, "-o", cpp[:-4] + ".so", cpp]
        procs[name] = (subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True), cpp)
    for name, (proc, cpp) in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"g++ failed for {name}.cu:\n{err[-4000:]}"
        os.replace(cpp[:-4] + ".so", paths[name])
        os.unlink(cpp)
    return {name: ctypes.CDLL(path) for name, path in paths.items()}


def _has_fma():
    """Whether this CPU runs FMA instructions (x86-64 with the fma flag)."""
    if platform.machine() not in ("x86_64", "AMD64"):
        return False
    try:
        with open("/proc/cpuinfo") as f:
            return " fma " in f.read()
    except OSError:
        return False


def _p(a):
    return ctypes.c_void_p(a.ctypes.data)


def _np(t):
    return np.ascontiguousarray(t.detach().cpu().numpy())


def _scene(name):
    if name == "builtin":
        return builtin.build_scene(aspect=W / H, elapsed_time=T_ANIM, device="cpu")
    return scenes.get_config(name).build(W / H, T_ANIM, device="cpu")


def _tri(pack):
    # A mesh-free scene's face table is empty; the kernel never reads it.
    return _np(pack.tri) if pack.tri.numel() else np.zeros((1, 12), np.float32)


@pytest.mark.parametrize("name, shared", [("builtin", 1), ("sdf_primitives_720p", 0)],
                         ids=["builtin_shared", "sdf_primitives_global"])
def test_frame_kernel_matches_plain(libs, name, shared):
    # shared: the scene tables in shared memory (as every bench scene on
    # the card), or read in place (a scene past SHARED_BYTES_MAX).
    depth = 3 if name == "builtin" else scenes.get_config(name).max_depth
    pack = frame_kernel.pack_frame(_scene(name))
    out = np.full((H, W, 4), np.nan, np.float32)
    params, layout, tri = _np(pack.params), _np(pack.layout), _tri(pack)
    lib = libs["frame_kernel"]
    lib.rh_frame.restype = ctypes.c_int
    handed = lib.rh_frame(_p(params), _p(layout), _p(tri), _p(out), W, H, 0, H, depth,
                          pack.num_geometries, pack.num_materials, shared)
    assert handed == W * H
    plain = _np(frame_kernel.render_frame_plain(pack, width=W, height=H, max_depth=depth))
    assert np.isfinite(out).all()
    diff = np.abs(out - plain).max(axis=-1)
    assert diff.max() <= TOL, f"{int((diff > TOL).sum())} pixels differ, max {diff.max():.3g}"


def _pass_inputs(scene, kind):
    """The builtin W x H frame's level-0 closest pass (camera rays) or
    shadow pass (from the closest hits toward the light) as the wavefront
    builds them: (o, d, active, t0, accept_first)."""
    px, py = cam.pixel_grid(W, H, "cpu")
    c = scene.arrays.constants
    o, d = cam.generate_camera_rays(px, py, W, H, c.camera_position, c.projection_to_world)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    hit_p, ob, db, act, t0 = traverse.pass_inputs(o, d, scene)
    if kind == "closest":
        return ob, db, act, t0, False
    st, _, sg = scene_kernel.scene_closest_plain(scene, ob, db, act, t0)
    t_hit = torch.where(sg >= 0, st, t0)
    hp = o + t_hit[:, None] * d
    sd = hlsl.normalize(c.light_position[:3] - hp)
    _, obs, dbs, acts, t0s = traverse.pass_inputs(hp, sd, scene, active=(sg >= 0) | hit_p,
                                                  occlusion=True)
    return obs, dbs, acts, t0s, True


@pytest.mark.parametrize("kind, shared", [("closest", 1), ("shadow", 0)],
                         ids=["closest_shared", "shadow_global"])
def test_scene_pass_matches_plain(libs, kind, shared):
    scene = _scene("builtin")
    pack = frame_kernel.pack_frame(scene)
    o, d, act, t0, accept_first = _pass_inputs(scene, kind)
    n = o.shape[0]
    best_t = np.full(n, np.nan, np.float32)
    normal = np.full((n, 3), np.nan, np.float32)
    gid = np.full(n, -7, np.int32)
    arrays = [_np(x) for x in (pack.params, pack.layout)] + [_tri(pack)] + [
        _np(x) for x in (o, d, act, t0)]
    lib = libs["scene_kernel"]
    lib.rh_scene.restype = ctypes.c_int
    handed = lib.rh_scene(*(_p(a) for a in arrays), _p(best_t), _p(normal), _p(gid), n,
                          pack.num_geometries, pack.num_materials, shared, 0, int(accept_first), 1)
    assert handed == n
    pt, pn, pg = (_np(x) for x in scene_kernel.scene_closest_plain(
        scene, o, d, act, t0, level=0, accept_first=accept_first))
    assert (gid == pg).all(), f"{int((gid != pg).sum())} of {n} rays differ in gid"
    assert (pg >= 0).any() and (pg < 0).any()
    assert np.abs(best_t - pt).max() <= TOL
    assert np.abs(normal - pn).max() <= NORMAL_TOL


def test_julia_normal_is_exact_under_contraction(libs):
    if "frame_math" not in libs:
        pytest.skip("needs a CPU with FMA instructions to contract as the CUDA build does")
    rng = np.random.default_rng(5)
    pts = (rng.random((20000, 3)) * 2.2 - 1.1).astype(np.float32)
    code = 8
    dist = sdf.DISTANCE_FUNCTIONS[code](torch.from_numpy(pts)).numpy()
    near = np.ascontiguousarray(pts[np.abs(dist) < 0.02])
    assert len(near) > 1000
    out = np.zeros_like(near)
    libs["frame_math"].rh_normal(code, _p(near), _p(out), len(near))
    plain = sdf.calculate_normal(torch.from_numpy(near), sdf.DISTANCE_FUNCTIONS[code]).numpy()
    dn = np.abs(out - plain).max(axis=-1)
    assert (dn == 0).mean() >= 0.99, f"bit-equal on {(dn == 0).mean():.4f}"
    assert dn.max() <= 1e-4, f"max |diff| {dn.max():.3g}"


# ---------------------------------------------------------------------------
# The compacted modes' device queues, resumed dense pass and recomposition
# ---------------------------------------------------------------------------

MODE_W, MODE_H, MODE_CAP_STEPS = 48, 27, 8


def _assert_bar(img, ref):
    """The image bar of tests/test_frame_kernel.py."""
    diff = np.abs(img - ref).max(axis=-1)
    flipped = diff > 1e-3
    assert flipped.mean() < 0.02, f"{int(flipped.sum())} pixels flipped"
    assert diff[~flipped].max() <= 1e-3 and (diff[~flipped] < 1e-5).mean() > 0.75


def _mode_inputs():
    pack = frame_kernel.pack_frame(builtin.build_scene(aspect=MODE_W / MODE_H,
                                                       elapsed_time=T_ANIM, device="cpu"))
    return pack, _np(pack.params), _np(pack.layout), _tri(pack)


def test_compact_queue_and_resume_match_plain(libs):
    # The compact entry's queue holds the plain builder's pixels with their
    # saved levels and states; the dense entry then gives the rehearsed
    # frame kernel's pixels bit for bit (the same compiler and arithmetic),
    # and so the plain frame within the image bar (at 48x27 a last-ulp
    # library difference moves a march crossing on a few pixels).
    pack, params, layout, tri = _mode_inputs()
    g, m = pack.num_geometries, pack.num_materials
    cap = frame_kernel.queue_capacity(MODE_W, MODE_H)
    lib = libs["frame_kernel"]
    lib.rh_compact.restype = ctypes.c_int
    img = np.full((MODE_H, MODE_W, 4), np.nan, np.float32)
    entries = np.full((cap, frame_kernel.QUEUE_ENTRY_WORDS), -7, np.int32)
    bins = np.full(2 * 32 + 1, -7, np.int32)
    count = lib.rh_compact(_p(params), _p(layout), _p(tri), _p(img), _p(entries), _p(bins), cap,
                           MODE_W, MODE_H, 0, MODE_H, 3, g, m, MODE_CAP_STEPS)
    p_img, p_queue = frame_kernel.render_frame_compact_main_plain(
        pack, width=MODE_W, height=MODE_H, budget_cap=MODE_CAP_STEPS, cap=cap)
    assert 0 < count == int(p_queue.count[0]) <= cap
    got = torch.from_numpy(entries[:count])
    got = got[torch.argsort(got[:, 0])]
    want = p_queue.entries[:count]
    assert torch.equal(got[:, :2], want[:, :2])
    g_state = got[:, 2:].contiguous().view(torch.float32)
    w_state = want[:, 2:].contiguous().view(torch.float32)
    assert float((g_state - w_state).abs().max()) <= TOL
    # The compact entry counted the entries' keys (the histogram the bin
    # entry scans); the rest of the words are zero.
    assert np.array_equal(bins[:32], np.bincount(entries[:count, 1] >> 8, minlength=32))
    assert not bins[32:].any()
    # The bin entry keeps the entries, orders them by key, adds the count to
    # the running total and leaves its cursors at zero, so that binning the
    # queue again gives the same order.
    counts = np.array([count], np.int32)
    total = np.array([5], np.uint64)
    binned = np.full_like(entries, -7)
    for rep in range(2):
        again = np.full_like(entries, -7)
        lib.rh_bin(_p(entries), _p(again), _p(counts), None, _p(bins), 1, cap, 0, 32, 0,
                   _p(total))
        assert not bins[32:].any()
        assert rep == 0 or np.array_equal(again, binned)
        binned = again
    assert int(total[0]) == 5 + 2 * count
    keys = binned[:count, 1] >> 8
    assert (np.diff(keys) >= 0).all()
    assert np.array_equal(binned[:count][np.argsort(binned[:count, 0])], got.numpy())
    entries = binned
    ref = np.full((MODE_H, MODE_W, 4), np.nan, np.float32)
    lib.rh_frame(_p(params), _p(layout), _p(tri), _p(ref), MODE_W, MODE_H, 0, MODE_H, 3, g, m, 1)
    lib.rh_dense(_p(params), _p(layout), _p(tri), _p(entries), count, cap, _p(img), MODE_W,
                  MODE_H, 0, 3, g, m)
    assert np.array_equal(img, ref)
    _assert_bar(img, _np(frame_kernel.render_frame_plain(pack, width=MODE_W, height=MODE_H)))
    # Entries at level -1 start from the camera ray (render_frame_dense).
    entries[:count, 1] = -1
    img[:] = np.nan
    lib.rh_dense(_p(params), _p(layout), _p(tri), _p(entries), count, cap, _p(img), MODE_W,
                 MODE_H, 0, 3, g, m)
    pix = entries[:count, 0]
    assert np.array_equal(img.reshape(-1, 4)[pix], ref.reshape(-1, 4)[pix])


def _defer_planes(nsl, h, w, nbins, guard=0):
    """Zeroed lit, shadowed, sinfo, rays planes of the defer entry, its march
    records (-7), and its queue words (-3, with ``guard`` words of -3 on each
    side)."""
    return (np.zeros((nsl + 1, h, w, 4), np.float32), np.zeros((nsl, h, w, 4), np.float32),
            np.zeros((nsl, h, w), np.int32), np.zeros((nsl, h, w, 6), np.float32),
            np.full((nsl, h, w, frame_kernel.MARCH_RECORD_WORDS), -7, np.int32),
            np.full(2 * nsl * nbins + 1 + 2 * guard, -3, np.int32))


def test_defer_queues_repair_and_compose_match_plain(libs):
    # The defer entry's per-level queues hold the plain builder's pixels and
    # it counts their keys; the repair over them, resumed from the entry's
    # march records, gives the plain repair's answers (the whole traversal)
    # on every unknown pixel; the compose entry is its plain version bit for
    # bit on the same planes, and the frame passes the image bar against the
    # plain frame.
    pack, params, layout, tri = _mode_inputs()
    g, m = pack.num_geometries, pack.num_materials
    depth, nsl, npix = 3, 2, MODE_W * MODE_H
    cap = frame_kernel.queue_capacity(MODE_W, MODE_H)
    nbins = frame_kernel.defer_bins(npix)
    lit, shadowed, sinfo, rays, march, bins = _defer_planes(nsl, MODE_H, MODE_W, nbins)
    queue = np.full((nsl, cap), -7, np.int32)
    counts = np.zeros(nsl, np.int32)
    libs["frame_kernel"].rh_defer(_p(params), _p(layout), _p(tri), _p(lit), _p(shadowed),
                                  _p(sinfo), _p(rays), _p(march), _p(queue), _p(counts), _p(bins),
                                  cap, MODE_W, MODE_H, 0, MODE_H, depth, g, m, MODE_CAP_STEPS)
    p_planes, p_queue = frame_kernel.render_frame_deferred_queue_plain(
        pack, width=MODE_W, height=MODE_H, shadow_cap=MODE_CAP_STEPS, cap=cap)
    assert np.array_equal(counts, p_queue.count.numpy()) and counts.min() > 0
    unknown = (sinfo & 3) == 2
    for k in range(nsl):
        assert np.array_equal(np.sort(queue[k, :counts[k]]), p_queue.idx[k, :counts[k]].numpy())
    # A record at every unknown lane, naming the capped geometry whose bit
    # the status word holds, and nowhere else.
    rec_g = march[..., 0]
    assert (rec_g[~unknown] == -7).all()
    assert np.array_equal(1 << rec_g[unknown], (sinfo[unknown] >> 2) & 0x3FFFFFFF)
    # The entry counted each level's keys.
    keys_in = frame_kernel.bin_keys(frame_kernel.DeferQueue(torch.from_numpy(queue),
                                                            torch.from_numpy(counts)),
                                    torch.from_numpy(sinfo)).numpy()
    for k in range(nsl):
        assert np.array_equal(bins[k * nbins:(k + 1) * nbins],
                              np.bincount(keys_in[k, :counts[k]], minlength=nbins))
    # The bin entry keeps each level's pixels and orders them by block, then
    # capped geometry.
    binned = np.full_like(queue, -7)
    total = np.zeros(1, np.uint64)
    libs["frame_kernel"].rh_bin(_p(queue), _p(binned), _p(counts), _p(sinfo), _p(bins), nsl, cap,
                                npix, nbins, 1, _p(total))
    assert int(total[0]) == counts.sum()
    keys = frame_kernel.bin_keys(frame_kernel.DeferQueue(torch.from_numpy(binned),
                                                         torch.from_numpy(counts)),
                                 torch.from_numpy(sinfo)).numpy()
    for k in range(nsl):
        assert (np.diff(keys[k, :counts[k]]) >= 0).all()
        assert np.array_equal(np.sort(binned[k, :counts[k]]), np.sort(queue[k, :counts[k]]))
    queue = binned
    occ = np.full((nsl, MODE_H, MODE_W), -7, np.int32)
    libs["scene_kernel"].rh_queue_planes(_p(params), _p(layout), _p(tri), _p(rays), _p(queue),
                                         _p(counts), None, _p(march), _p(occ), npix, nsl, cap, g,
                                         m)
    planes = trace.DeferPlanes(*(torch.from_numpy(x) for x in (lit, shadowed, sinfo, rays)))
    p_occ = scene_kernel.shadow_queue_planes_plain(pack, planes.rays, torch.from_numpy(queue),
                                                   torch.from_numpy(counts))
    assert np.array_equal(occ[unknown], p_occ.numpy()[unknown])
    assert (occ[~unknown] == -7).all()
    out = np.full((MODE_H, MODE_W, 4), np.nan, np.float32)
    libs["frame_kernel"].rh_compose(_p(lit), _p(shadowed), _p(sinfo), _p(occ), _p(out), npix,
                                    depth)
    assert np.array_equal(out, _np(frame_kernel.frame_compose_plain(planes,
                                                                    torch.from_numpy(occ))))
    _assert_bar(out, _np(frame_kernel.render_frame_plain(pack, width=MODE_W, height=MODE_H)))


def test_defer_bins_of_geometries_past_29_and_the_flat_repair_match_plain(libs):
    # The padded sdf_primitives scene puts its marches at geometries 28-34,
    # so most unknown lanes have no capped-geometry bit in the status word
    # (bits 0-29): their key is 30 of their block, and the bin entry's
    # counters and scatter stay inside their buffers (guards on both sides).
    # Then the repair without a queue (scene_kernel.shadow_queue: every
    # pixel of each level, an active mask) against its plain version.
    pack = frame_kernel.pack_frame(scenes.padded_sdf_showcase(28).build(
        MODE_W / MODE_H, T_ANIM, device="cpu"))
    params, layout, tri = _np(pack.params), _np(pack.layout), _tri(pack)
    g, m = pack.num_geometries, pack.num_materials
    depth, nsl, npix = 3, 2, MODE_W * MODE_H
    cap = frame_kernel.queue_capacity(MODE_W, MODE_H)
    nbins = frame_kernel.defer_bins(npix)
    guard = 64
    lit, shadowed, sinfo, rays, march, bins = _defer_planes(nsl, MODE_H, MODE_W, nbins, guard)
    words = 2 * nsl * nbins + 1
    queue = np.full((nsl, cap), -7, np.int32)
    counts = np.zeros(nsl, np.int32)
    libs["frame_kernel"].rh_defer(_p(params), _p(layout), _p(tri), _p(lit), _p(shadowed),
                                  _p(sinfo), _p(rays), _p(march), _p(queue), _p(counts),
                                  _p(bins[guard:]), cap, MODE_W, MODE_H, 0, MODE_H, depth, g,
                                  m, MODE_CAP_STEPS)
    unknown = (sinfo & 3) == 2
    assert counts.min() > 0 and (unknown & (((sinfo >> 2) & 0x3FFFFFFF) == 0)).any()
    # The records name the capped geometries past 29 that the status word
    # cannot hold.
    assert (march[..., 0][unknown] >= 30).any()
    flat = np.full(nsl * cap + 2 * guard, -9, np.int32)
    out = flat[guard:guard + nsl * cap]
    total = np.zeros(1, np.uint64)
    libs["frame_kernel"].rh_bin(_p(queue), _p(out), _p(counts), _p(sinfo), _p(bins[guard:]), nsl,
                                cap, npix, nbins, 1, _p(total))
    assert int(total[0]) == counts.sum()
    assert (bins[:guard] == -3).all() and (bins[guard + words:] == -3).all()
    assert not bins[guard + nsl * nbins:guard + words].any()
    assert (flat[:guard] == -9).all() and (flat[guard + nsl * cap:] == -9).all()
    out = out.reshape(nsl, cap)
    keys = frame_kernel.bin_keys(frame_kernel.DeferQueue(torch.from_numpy(out.copy()),
                                                         torch.from_numpy(counts)),
                                 torch.from_numpy(sinfo)).numpy()
    for k in range(nsl):
        n = counts[k]
        assert ((keys[k, :n] >= 0) & (keys[k, :n] < nbins)).all()
        assert (keys[k, :n] % 32 == 30).any() and (np.diff(keys[k, :n]) >= 0).all()
        assert np.array_equal(np.sort(out[k, :n]), np.sort(queue[k, :n]))
    # The repair without a queue: every other pixel of each level active.
    active = np.zeros((nsl, npix), bool)
    active[:, ::2] = True
    occ = np.full((nsl, MODE_H, MODE_W), -7, np.int32)
    libs["scene_kernel"].rh_queue_planes(_p(params), _p(layout), _p(tri), _p(rays), None, None,
                                         _p(active), None, _p(occ), npix, nsl, npix, g, m)
    p_occ = scene_kernel.shadow_queue_plain(pack, torch.from_numpy(rays.reshape(-1, 6)),
                                            torch.from_numpy(active.reshape(-1)), npix)
    assert np.array_equal(occ.reshape(-1), p_occ.numpy())
    assert occ.reshape(nsl, -1)[active].any() and not occ.reshape(nsl, -1)[~active].any()


# ---------------------------------------------------------------------------
# Bands (row-band sharding): each entry over a band of rows
# ---------------------------------------------------------------------------

BAND_W, BAND_H, BANDS = 32, 18, 3


def _defer_band(libs, inputs, row_offset, local_height, depth=3):
    """The defer entry over the band of local_height rows from row_offset,
    then the resumed repair over its queues and the compose entry: (planes
    (lit, shadowed, sinfo, rays), queue, counts, composed image)."""
    pack, params, layout, tri = inputs
    g, m, nsl, npix = pack.num_geometries, pack.num_materials, depth - 1, BAND_W * local_height
    cap = frame_kernel.queue_capacity(BAND_W, local_height)
    nbins = frame_kernel.defer_bins(npix)
    lit, shadowed, sinfo, rays, march, bins = _defer_planes(nsl, local_height, BAND_W, nbins)
    queue = np.full((nsl, cap), -7, np.int32)
    counts = np.zeros(nsl, np.int32)
    libs["frame_kernel"].rh_defer(_p(params), _p(layout), _p(tri), _p(lit), _p(shadowed),
                                  _p(sinfo), _p(rays), _p(march), _p(queue), _p(counts), _p(bins),
                                  cap, BAND_W, BAND_H, row_offset, local_height, depth, g, m,
                                  MODE_CAP_STEPS)
    occ = np.zeros((nsl, local_height, BAND_W), np.int32)
    libs["scene_kernel"].rh_queue_planes(_p(params), _p(layout), _p(tri), _p(rays), _p(queue),
                                         _p(counts), None, _p(march), _p(occ), npix, nsl, cap, g,
                                         m)
    out = np.full((local_height, BAND_W, 4), np.nan, np.float32)
    libs["frame_kernel"].rh_compose(_p(lit), _p(shadowed), _p(sinfo), _p(occ), _p(out), npix,
                                    depth)
    return (lit, shadowed, sinfo, rays), queue, counts, out


def test_band_entries_equal_the_whole_frame(libs):
    # The plain, compact + dense and defer entries over 3 bands of 6 rows of
    # a 32x18 frame (the band's row offset and height as launch arguments):
    # each band is the whole frame's rows bit for bit; the queues hold the
    # band's own raster indices, the whole frame's shifted by the band's
    # first pixel.
    scene = builtin.build_scene(aspect=BAND_W / BAND_H, elapsed_time=T_ANIM, device="cpu")
    pack = frame_kernel.pack_frame(scene)
    inputs = (pack, _np(pack.params), _np(pack.layout), _tri(pack))
    _, params, layout, tri = inputs
    g, m, lh = pack.num_geometries, pack.num_materials, BAND_H // BANDS
    lib = libs["frame_kernel"]
    lib.rh_frame.restype = lib.rh_compact.restype = ctypes.c_int
    whole = np.full((BAND_H, BAND_W, 4), np.nan, np.float32)
    lib.rh_frame(_p(params), _p(layout), _p(tri), _p(whole), BAND_W, BAND_H, 0, BAND_H, 3, g, m, 1)
    cap_w = frame_kernel.queue_capacity(BAND_W, BAND_H)
    w_entries = np.full((cap_w, frame_kernel.QUEUE_ENTRY_WORDS), -7, np.int32)
    w_img, bins = np.zeros_like(whole), np.zeros(2 * 32 + 1, np.int32)
    w_count = lib.rh_compact(_p(params), _p(layout), _p(tri), _p(w_img), _p(w_entries), _p(bins),
                             cap_w, BAND_W, BAND_H, 0, BAND_H, 3, g, m, MODE_CAP_STEPS)
    w_pix = np.sort(w_entries[:w_count, 0])
    (w_lit, w_shadowed, w_sinfo, w_rays), w_queue, w_counts, w_out = _defer_band(libs, inputs, 0,
                                                                                 BAND_H)
    plain, compact = np.full_like(whole, np.nan), np.full_like(whole, np.nan)
    defer = np.full_like(whole, np.nan)
    queued = []
    for k in range(BANDS):
        rows = slice(k * lh, (k + 1) * lh)
        assert lib.rh_frame(_p(params), _p(layout), _p(tri), _p(plain[rows]), BAND_W, BAND_H,
                            k * lh, lh, 3, g, m, 1) == BAND_W * lh
        cap = frame_kernel.queue_capacity(BAND_W, lh)
        entries = np.full((cap, frame_kernel.QUEUE_ENTRY_WORDS), -7, np.int32)
        count = lib.rh_compact(_p(params), _p(layout), _p(tri), _p(compact[rows]), _p(entries),
                               _p(bins), cap, BAND_W, BAND_H, k * lh, lh, 3, g, m, MODE_CAP_STEPS)
        assert count <= cap and (entries[:count, 0] < BAND_W * lh).all()
        queued.append(entries[:count, 0] + k * lh * BAND_W)
        lib.rh_dense(_p(params), _p(layout), _p(tri), _p(entries), count, cap, _p(compact[rows]),
                     BAND_W, BAND_H, k * lh, 3, g, m)
        planes, queue, counts, defer[rows] = _defer_band(libs, inputs, k * lh, lh)
        for band_plane, whole_plane in zip(planes, (w_lit, w_shadowed, w_sinfo, w_rays)):
            assert np.array_equal(band_plane, whole_plane[:, rows])
        for s in range(len(counts)):
            w_level = w_queue[s, :w_counts[s]]
            w_level = w_level[(w_level >= k * lh * BAND_W) & (w_level < (k + 1) * lh * BAND_W)]
            assert np.array_equal(np.sort(queue[s, :counts[s]]), np.sort(w_level) - k * lh * BAND_W)
    assert w_count > 0 and w_counts.min() > 0
    assert np.array_equal(np.sort(np.concatenate(queued)), w_pix)
    assert np.isfinite(whole).all()
    assert np.array_equal(plain, whole)
    assert np.array_equal(compact, whole)
    assert np.array_equal(defer, w_out)


# ---------------------------------------------------------------------------
# The two-phase finisher over its queue, and the overflow gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind, shared", [("closest", 1), ("shadow", 0)],
                         ids=["closest_shared", "shadow_global"])
def test_finish_queue_and_queued_finisher_equal_the_per_ray_finisher(libs, kind, shared):
    # On the builtin scene's 1024 seeded level-0 rays of
    # tests/golden_torch_two_phase.npz, after the plain main pass: the
    # compaction queues every dirty ray once, in key order; the finisher over
    # the queue's capacity gives the per-ray finisher's outputs (the
    # -DGPRT_FINISH_PER_RAY build) bit for bit, and the plain finisher's
    # within the file's tolerances.
    scene = port_scene_cached("builtin")
    with np.load(GOLDEN) as z:
        ob, db, a, t0 = two_phase_inputs(z, "builtin", kind, 0)
    af = kind == "shadow"
    *main, dirty = scene_kernel.scene_main_plain(scene, ob, db, a, t0, accept_first=af)
    pack = frame_kernel.pack_frame(scene)
    n = ob.shape[0]
    arrays = [_np(x) for x in (pack.params, pack.layout)] + [_tri(pack)] + [
        _np(x) for x in (ob, db, dirty)]
    out = {}
    for name in ("scene_finish", "scene_finish_per_ray"):
        queue, words = np.full(2 * n, -7, np.int32), np.zeros(scene_kernel.FINISH_WORDS, np.int32)
        res = [_np(x).copy() for x in main]
        lib = libs[name]
        lib.rh_finish.restype = ctypes.c_int
        lib.rh_finish(*(_p(x) for x in arrays), _p(queue), _p(words), *(_p(x) for x in res), n,
                      pack.num_geometries, pack.num_materials, shared, int(af), 1)
        out[name] = res, queue, words
    res, queue, words = out["scene_finish"]
    live = _np(dirty) != 0
    assert words[0] == live.sum() > 0
    ordered = queue[n:n + words[0]]
    assert np.array_equal(np.sort(ordered), np.flatnonzero(live))
    keys = _np(scene_kernel.finish_key(dirty))[ordered]
    assert (np.diff(keys) >= 0).all()
    assert np.array_equal(words[1:33], np.bincount(keys, minlength=32))
    for got, want in zip(res, out["scene_finish_per_ray"][0]):
        assert np.array_equal(got, want)
    pt, pn, pg = (_np(x) for x in scene_kernel.scene_finish_plain(
        scene, ob, db, dirty, *main, accept_first=af))
    t, nrm, g = res
    assert (g == pg).all() and np.abs(t - pt).max() <= TOL
    assert np.abs(nrm - pn).max() <= NORMAL_TOL


def test_gate_writes_nothing_without_overflow_and_the_plain_frame_with_it(libs):
    # The gate over two counts: at and below the capacity it launches
    # nothing and the image keeps what it held; with one count past it, it
    # launches the frame kernel over the band, whose pixels are the
    # rehearsed frame kernel's bit for bit, for the whole frame and a band.
    scene = builtin.build_scene(aspect=BAND_W / BAND_H, elapsed_time=T_ANIM, device="cpu")
    pack = frame_kernel.pack_frame(scene)
    params, layout, tri = _np(pack.params), _np(pack.layout), _tri(pack)
    g, m, cap = pack.num_geometries, pack.num_materials, 100
    gate, frame = libs["frame_gate"], libs["frame_kernel"]
    gate.rh_gate.restype = ctypes.c_int
    whole = np.full((BAND_H, BAND_W, 4), np.nan, np.float32)
    frame.rh_frame(_p(params), _p(layout), _p(tri), _p(whole), BAND_W, BAND_H, 0, BAND_H, 3, g,
                   m, 1)
    assert np.isfinite(whole).all()
    for row_offset, lh in ((0, BAND_H), (4, 6)):
        for counts, over in (((cap, cap - 1), False), ((1, cap + 1), True)):
            img = np.full((lh, BAND_W, 4), -7.0, np.float32)
            count = np.array(counts, np.int32)
            launches = gate.rh_gate(_p(params), _p(layout), _p(tri), _p(img), _p(count), 2, cap,
                                    BAND_W, BAND_H, row_offset, lh, 3, g, m, 1)
            assert launches == int(over)
            if over:
                assert np.array_equal(img, whole[row_offset:row_offset + lh])
            else:
                assert (img == -7.0).all()


# ---------------------------------------------------------------------------
# The merged occlusion march (GPURT_MERGED_SHADOW) on warps of emulated lanes
# ---------------------------------------------------------------------------

MERGE_SEEDS = tuple(range(1, 9))


def _merge_scene(name):
    if name == "padded_sdf_showcase":
        return scenes.padded_sdf_showcase(28).build(W / H, T_ANIM, device="cpu")
    return _scene(name)


def _shadow_rays(libs, pack, depth=4):
    """The W x H frame's BLAS-space shadow rays at levels 0 to depth - 2, as
    the defer entry records them: [(n, 6) f32 per level], the pixels that
    reach each level."""
    nsl, npix = depth - 1, W * H
    rays = np.zeros((nsl, npix, 6), np.float32)
    bufs = [_np(pack.params), _np(pack.layout), _tri(pack), np.zeros((depth, npix, 4), np.float32),
            np.zeros((nsl, npix, 4), np.float32), np.zeros((nsl, npix), np.int32), rays,
            np.zeros((nsl, npix, frame_kernel.MARCH_RECORD_WORDS), np.int32),
            np.zeros((nsl, npix), np.int32), np.zeros(nsl, np.int32),
            np.zeros(2 * nsl * frame_kernel.defer_bins(npix) + 1, np.int32)]
    libs["frame_kernel"].rh_defer(*(_p(b) for b in bufs), npix, W, H, 0, H, depth,
                                  pack.num_geometries, pack.num_materials, 1 << 20)
    return [np.ascontiguousarray(r[np.abs(r[:, 3:]).sum(-1) > 0]) for r in rays]


@pytest.mark.parametrize("name", ["builtin", "fractal_mandelbulb_julia_1080p",
                                  "padded_sdf_showcase"])
def test_merged_march_matches_sequential_in_any_turn_order(libs, name):
    # The merged march on warps of emulated lanes (csrc/host_rehearsal.h
    # rh::run_warp) under seeded turn schedules equals the sequential
    # traversal on every shadow ray, at levels 0-2 (the level-0 and bounce
    # budgets), in both table layouts, built as the plain arithmetic and
    # contracted as the shipped CUDA build (where the CPU has FMA), and no
    # warp breaks the rules of its votes. padded_sdf_showcase(28): closed
    # forms first, its marches at geometries 28-34, so a warp's lanes hold
    # different sets of SDF geometries.
    pack = frame_kernel.pack_frame(_merge_scene(name))
    g, m = pack.num_geometries, pack.num_materials
    levels = _shadow_rays(libs, pack)
    params, layout, tri = _np(pack.params), _np(pack.layout), _tri(pack)
    builds = [b for b in ("scene_kernel", "scene_kernel_fma") if b in libs]
    occluded = 0
    for level, rays in enumerate(levels):
        n = rays.shape[0]
        if n == 0:
            continue
        for b in builds:
            for shared in (1, 0):
                seq = np.full(n, -7, np.int32)
                libs[b].rh_occluded(_p(params), _p(layout), _p(tri), _p(rays), None, _p(seq), n, g,
                                    m, shared, level, 0, 0)
                assert set(np.unique(seq)) <= {0, 1}
                occluded += int(seq.sum())
                for seed in MERGE_SEEDS:
                    got = np.full(n, -7, np.int32)
                    faults = libs[b].rh_occluded(_p(params), _p(layout), _p(tri), _p(rays), None,
                                                 _p(got), n, g, m, shared, level, 1, seed)
                    assert faults == 0, f"{b} level {level} seed {seed}: {faults} warps faulted"
                    differ = int((got != seq).sum())
                    assert differ == 0, (f"{b} shared={shared} level {level} seed {seed}: "
                                         f"{differ} of {n} rays differ")
    assert levels[0].shape[0] > 0 and levels[1].shape[0] > 0
    assert 0 < occluded


# The caps of the resumed repair's cases: (SDF, metaball) samples.
RESUME_CAPS = ((MODE_CAP_STEPS, 128), (MODE_CAP_STEPS, MODE_CAP_STEPS))


@pytest.mark.parametrize("name", ["builtin", "fractal_mandelbulb_julia_1080p",
                                  "padded_sdf_showcase"])
def test_resumed_repair_equals_the_whole_traversal(libs, name):
    # The defer entry's capped occlusion search (rh_resume: the search of
    # the defer form after the plane test, SDF marches capped at 8 samples,
    # metaballs uncapped or capped at 8) leaves an unknown status and a
    # march record on the rays whose march it stopped; the repair resumed
    # from the record gives the whole traversal's answer on every such ray,
    # at levels 0 and 1 (the level-0 and bounce budgets), in both table
    # layouts, built as the plain arithmetic and contracted as the shipped
    # CUDA build (where the CPU has FMA); so does the merged repair on warps
    # of emulated lanes under seeded turn schedules, with no fault in a
    # vote. padded_sdf_showcase(28): the capped geometries lie at 28-34, past
    # the status word's mask, and the record names them exactly.
    pack = frame_kernel.pack_frame(_merge_scene(name))
    g, m = pack.num_geometries, pack.num_materials
    levels = _shadow_rays(libs, pack)[:2]
    params, layout, tri = _np(pack.params), _np(pack.layout), _tri(pack)
    builds = [b for b in ("scene_kernel", "scene_kernel_fma") if b in libs]
    unknown = occluded = capped = 0
    for level, rays in enumerate(levels):
        n = rays.shape[0]
        for b in builds:
            for shared in (1, 0):
                for sdf_cap, mb_cap in RESUME_CAPS:
                    status, resumed, whole = (np.full(n, -7, np.int32) for _ in range(3))
                    rec = np.full((n, frame_kernel.MARCH_RECORD_WORDS), -7, np.int32)
                    march = np.full((n, 2), -7, np.int32)
                    t = np.full((n, 2), -7.0, np.float32)
                    libs[b].rh_resume(_p(params), _p(layout), _p(tri), _p(rays), _p(status),
                                      _p(rec), _p(resumed), _p(whole), _p(march), _p(t), n, g, m,
                                      shared, level, sdf_cap, mb_cap)
                    u = status == 2
                    where = f"{b} shared={shared} level {level} caps {sdf_cap}/{mb_cap}"
                    differ = int((resumed[u] != whole[u]).sum())
                    assert differ == 0, f"{where}: {differ} of {int(u.sum())} rays differ"
                    # The capped geometry's march, resumed, ends as the whole
                    # march does, at the same t bit for bit.
                    ends = march[u]
                    assert np.array_equal(ends[:, 0], ends[:, 1]), f"{where}: march ends differ"
                    tu = t[u]
                    assert np.array_equal(tu[:, 0], tu[:, 1], equal_nan=True), f"{where}: t differs"
                    capped += int((ends[:, 1] == 2).sum())
                    assert set(np.unique(whole[u])) <= {0, 1}
                    unknown += int(u.sum())
                    occluded += int(whole[u].sum())
                    if name == "padded_sdf_showcase":
                        assert (rec[u, 0] >= 30).any(), where
                    ru = np.ascontiguousarray(rays[u])
                    rec_u = np.ascontiguousarray(rec[u])
                    for seed in MERGE_SEEDS[:2]:
                        got = np.full(ru.shape[0], -7, np.int32)
                        faults = libs[b].rh_occluded(_p(params), _p(layout), _p(tri), _p(ru),
                                                     _p(rec_u), _p(got), ru.shape[0], g, m,
                                                     shared, level, 1, seed)
                        assert faults == 0, f"{where} seed {seed}: {faults} warps faulted"
                        assert np.array_equal(got, whole[u]), f"{where} seed {seed}: merged"
    # Marches that spend the full budget (where a sample more or less in a
    # record would show) occur in the builtin and fractal scenes' cases.
    assert 0 < occluded < unknown and (capped > 0 or name == "padded_sdf_showcase")


# ---------------------------------------------------------------------------
# The per-geometry route's pass entry and its face loop (csrc/megakernel.cu)
# ---------------------------------------------------------------------------

ROUTE_W, ROUTE_H = 48, 27


def _route_passes(name="mesh_heightfield_sdf", w=ROUTE_W, h=ROUTE_H):
    """A scene's (default the 544-face one's) w x h passes as the wavefront
    builds them: (scene, [(label, o, d, active, t0, accept_first)]) of the
    camera rays' closest pass, their level-1 reflections' closest pass and
    the shadow rays off the camera rays' hits."""
    scene = meshes.get_config(name).build(w / h, T_ANIM, device="cpu")
    px, py = cam.pixel_grid(w, h, "cpu")
    c = scene.arrays.constants
    o, d = cam.generate_camera_rays(px, py, w, h, c.camera_position, c.projection_to_world)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    hit = traverse.closest_hit(o, d, scene, level=0, plain=True)
    hp = o + hit.t[:, None] * d
    refl = hlsl.normalize(hlsl.reflect(d, hit.normal))
    shadow = hlsl.normalize(c.light_position[:3] - hp)
    out = []
    for label, ro, rd, act, occ in (("camera", o, d, None, False), ("reflection", hp, refl, hit.hit,
                                                                      False),
                                    ("shadow", hp, shadow, hit.hit, True)):
        _, ob, db, a, t0 = traverse.pass_inputs(ro, rd, scene, active=act, occlusion=occ)
        out.append((label, ob, db, a, t0, occ))
    return scene, out


def _rehearse_route(libs, scene, passes):
    """Each pass through the pass entry's two builds (shipped first, the
    unculled loop second; both table layouts in turn), held bit-equal to
    each other and to the route's plain version: equal ids, t and normals
    within 1e-6."""
    pack = frame_kernel.pack_frame(scene)
    g, m = pack.num_geometries, pack.num_materials
    largest = max(c for _, c in pack.tri_offsets)
    for k, (label, o, d, act, t0, occ) in enumerate(passes):
        n, shared = o.shape[0], int(k % 2 == 0)
        pt, pn, pg = (_np(x) for x in megakernel.route_pass_plain(scene, o, d, act, t0,
                                                                   level=1, accept_first=occ))
        assert (pg >= 0).any() and (pg < 0).any()
        outs = []
        for name in ("megakernel", "megakernel_global"):
            best_t = np.full(n, np.nan, np.float32)
            normal = np.full((n, 3), np.nan, np.float32)
            gid = np.full(n, -7, np.int32)
            arrays = [_np(x) for x in (pack.params, pack.layout, pack.tri, o, d, act, t0)]
            libs[name].rh_route(*(_p(a) for a in arrays), _p(best_t), _p(normal), _p(gid), n, g,
                                m, largest, shared, int(occ))
            outs.append((best_t, normal, gid))
        assert all(np.array_equal(x, y) for x, y in zip(*outs)), label
        best_t, normal, gid = outs[0]
        assert (gid == pg).all(), f"{label}: {int((gid != pg).sum())} of {n} rays differ in gid"
        assert np.abs(best_t - pt).max() <= 1e-6, label
        assert np.abs(normal - pn).max() <= 1e-6, label


@pytest.mark.parametrize("code, occlusion", [(0, False), (5, True), (7, False)])
def test_specialized_march_matches_plain(libs, code, occlusion):
    """Row 7's march (csrc/megakernel.cu sphere_trace<code>, the march
    specialized on its code): every ungated ray is a miss with a zero
    normal, and the gated rays' answers are sphere_trace_plain's (equal
    hits, t within TOL, normals within NORMAL_TOL but at a capped hit,
    t = 0, whose normal no caller reads)."""
    rng = np.random.default_rng(19 + code)
    n = 256
    o = rng.uniform(-3.0, 3.0, size=(n, 3)).astype(np.float32)
    aim = rng.uniform(-0.6, 0.6, size=(n, 3)).astype(np.float32)
    d = ((aim - o) / np.linalg.norm(aim - o, axis=-1, keepdims=True)).astype(np.float32)
    gate = rng.random(n) < 0.4
    t_max = np.full(n, 10.0, np.float32)
    t_start = None
    if code in sdf.AABB_WINDOWED_CODES:
        lo, hi = (x.numpy() for x in analytic.aabb_interval(
            torch.from_numpy(o), torch.from_numpy(d), torch.full((3,), -1.0),
            torch.full((3,), 1.0)))
        t_start = np.maximum(lo, 0.0).astype(np.float32)
        t_max = np.minimum(t_max, hi).astype(np.float32)
        gate &= (hi > lo) & (t_max > t_start)
    steps, capped = sdf.march_budget(512, occlusion=occlusion, level=0)
    relax = sdf.relax_for_code(code, occlusion=occlusion)
    cull = code not in sdf.AABB_WINDOWED_CODES
    t_hit = np.full(n, np.nan, np.float32)
    normal = np.full((n, 3), np.nan, np.float32)
    f = libs["megakernel"].rh_sphere_trace
    f.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                          ctypes.c_int, ctypes.c_float, ctypes.c_float] + \
        [ctypes.c_int] * 3
    f.restype = None
    f(_p(o), _p(d), _p(gate), _p(t_max), None if t_start is None else _p(t_start), _p(t_hit),
      _p(normal), n, code, 0.9, steps, relax, (1.0 - relax) * relax, int(capped), int(cull),
      int(code in sdf.ESCAPE_SAFE_CODES))
    assert gate.any() and not gate.all()
    assert np.isinf(t_hit[~gate]).all() and (normal[~gate] == 0.0).all()
    p_hit, p_t, p_n = (_np(x) for x in megakernel.sphere_trace_plain(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(gate),
        torch.from_numpy(t_max), 0.9, prim_code=code, cull_backface=cull, max_steps=steps,
        t_start=None if t_start is None else torch.from_numpy(t_start), relax=relax,
        capped_hit=capped))
    hit = np.isfinite(t_hit)
    np.testing.assert_array_equal(hit, p_hit)
    assert hit.any()
    np.testing.assert_allclose(t_hit[hit], p_t[hit], rtol=0.0, atol=TOL)
    valid = hit & (p_t > 0.0)
    np.testing.assert_allclose(normal[valid], p_n[valid], rtol=0.0, atol=NORMAL_TOL)


def test_route_pass_matches_plain(libs):
    scene, passes = _route_passes()
    assert traverse._total_mesh_faces(scene) > traverse.TRI_FACE_TOTAL_CAP
    _rehearse_route(libs, scene, passes)


def test_route_pass_with_a_staging_area_for_one_mesh_of_several(libs):
    # Eight meshes; the staging area holds one, so a ray that gates two
    # stages nothing and reads both from global memory.
    scene, passes = _route_passes("mesh_octahedra", 24, 14)
    offsets = frame_kernel.pack_frame(scene).tri_offsets
    assert len(offsets) > 2
    _rehearse_route(libs, scene, passes)


def test_staged_face_loop_with_skip_equals_unculled(libs):
    scene = meshes.get_config("mesh_heightfield_sdf").build(1.0, T_ANIM, device="cpu")
    rows = _np(scene.arrays.meshes[0].rows())
    o, d, t_max = seeded_face_rays(rows, 3000, seed=11)
    graze = np.arange(o.shape[0]) % 3 == 0
    # The grazing rays' det on their own face, as the face loop computes it.
    f_det = []
    for i in np.nonzero(graze)[0]:
        e1, e2 = rows[:, 3:6], rows[:, 6:9]
        f_det.append(np.abs((e1 * np.cross(d[i], e2)).sum(-1)).min())
    assert (np.array(f_det) < 1e-6).mean() > 0.9
    gate = np.ones(o.shape[0], bool)
    outs, skipped = [], []
    for name in ("megakernel", "megakernel_global"):
        t_hit = np.full(o.shape[0], np.nan, np.float32)
        normal = np.full((o.shape[0], 3), np.nan, np.float32)
        skipped.append(libs[name].rh_trimesh(_p(rows), rows.shape[0], _p(o), _p(d), _p(gate),
                                             _p(t_max), _p(t_hit), _p(normal), o.shape[0]))
        outs.append((t_hit, normal))
    assert all(np.array_equal(x, y, equal_nan=True) for x, y in zip(*outs))
    skipped = skipped[0]
    hits = np.isfinite(outs[0][0])
    assert hits[~graze].mean() > 0.3 and hits[graze].any()  # half the rays meet back faces
    nchunks = -(-rows.shape[0] // megakernel.FACE_CHUNK)
    print("skipped", skipped, "of", nchunks * o.shape[0], "hits graze", hits[graze].sum())
    assert skipped > 0.5 * nchunks * int((~graze).sum())


# ---------------------------------------------------------------------------
# The wavefront's lane kernels (csrc/wavefront.cu)
# ---------------------------------------------------------------------------

WAVE_SEED = 15


def _rel_close(got, want, tol=TOL):
    """Whether every value is within tol of its plain value, relative past
    1 (positions and t reach 10^4)."""
    return bool((np.abs(got - want) <= tol * np.maximum(1.0, np.abs(want))).all())


def _seeded_lanes(scene, n, seed):
    """n lanes of a level from a numpy seed: origins near the camera, three
    quarters aimed into a random geometry's world AABB (every kind gets
    hits), the rest into a box around the scene (plane hits, misses); a
    fifth of the lanes inactive; colour and throughput drawn in [0, 1)."""
    rng = np.random.default_rng(seed)
    arrays = scene.arrays
    lo = _np(arrays.aabb_min + arrays.blas_offset)
    hi = _np(arrays.aabb_max + arrays.blas_offset)
    o = _np(arrays.constants.camera_position[:3]) + rng.uniform(-1.0, 1.0, (n, 3))
    g = rng.integers(0, lo.shape[0], n)
    target = lo[g] + rng.uniform(0.0, 1.0, (n, 3)) * (hi[g] - lo[g])
    wide = rng.random(n) < 0.25
    target[wide] = rng.uniform([-10.0, -2.0, -10.0], [10.0, 6.0, 10.0], (int(wide.sum()), 3))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = torch.from_numpy(o.astype(np.float32)), torch.from_numpy(d.astype(np.float32))
    _, ob, _, _, t0 = traverse.pass_inputs(o, d, scene)
    color = torch.from_numpy(rng.random((n, 4), dtype=np.float32))
    tw = torch.from_numpy(rng.random((n, 4), dtype=np.float32))
    active = torch.from_numpy(rng.random(n) >= 0.2)
    from gpuraytracer_tpu_torch.kernels import wavefront
    return wavefront.Lanes(o, d, color, tw, active, ob, t0)


def _rh_wave(libs, kernel, pack, lanes, answer=None, shadow=None, shadow_gid=None, *, width=1,
             height=1, row_offset=0, level=0, max_depth=3):
    """The rehearsed lane kernel over numpy copies of the lanes (updated in
    place and returned) and, for the hit kernel, the shadow rays it
    writes."""
    n = lanes.o.shape[0]
    ln = [_np(x).copy() for x in lanes]
    ans = [_np(x) for x in answer] if answer is not None else [
        np.zeros(n, np.float32), np.zeros((n, 3), np.float32), np.zeros(n, np.int32)]
    sh = ([_np(x).copy() for x in shadow] if shadow is not None else
          [np.full((n, 3), np.nan, np.float32), np.full((n, 3), np.nan, np.float32),
           np.zeros(n, bool), np.full(n, np.nan, np.float32)])
    sg = _np(shadow_gid) if shadow_gid is not None else None
    libs["wavefront"].rh_wave(kernel, _p(_np(pack.params)), _p(_np(pack.layout)),
                              *(_p(a) for a in ln), *(_p(a) for a in ans), *(_p(a) for a in sh),
                              _p(sg) if sg is not None else None, n, width, height, row_offset,
                              level, max_depth, pack.num_geometries, pack.num_materials)
    return ln, sh


def test_wavefront_start_matches_plain(libs):
    # A band of 8 rows from row 1 of the W x H builtin frame (its row 1 sees
    # no plane).
    from gpuraytracer_tpu_torch.kernels import wavefront

    scene = _scene("builtin")
    pack = frame_kernel.pack_frame(scene)
    want = wavefront.start_plain(scene, width=W, height=H, row_offset=1, local_height=8)
    blank = wavefront.Lanes(*(torch.full_like(x, float("nan")) if x.is_floating_point()
                              else torch.zeros_like(x) for x in want))
    got, _ = _rh_wave(libs, 0, pack, blank, width=W, height=H, row_offset=1)
    for name, g_, w_ in zip(wavefront.Lanes._fields, got, want):
        w_ = _np(w_)
        assert np.array_equal(g_, w_) if w_.dtype == bool else _rel_close(g_, w_), name
    assert (_np(want.t0) < 1e4).any() and (_np(want.t0) == 1e4).any()  # plane hits and misses


@pytest.mark.parametrize("name", ["builtin", "fractal_mandelbulb_julia_1080p"])
def test_wavefront_hit_and_shade_match_plain(libs, name):
    # Seeded lanes (plane hits, misses, metaball and fractal hits, inactive
    # lanes): the hit kernel against hit_plain at level 0, the shade kernel
    # against shade_plain at level 0 of 3 (with the occlusion pass's answer)
    # and at the last level (none); within 1e-5 (relative past 1), booleans
    # equal: both sides take the same float32 operations, and only the
    # libraries' sqrt, pow and exp may differ in the last ulp.
    from gpuraytracer_tpu_torch.kernels import wavefront

    scene = _scene(name)
    pack = frame_kernel.pack_frame(scene)
    lanes = _seeded_lanes(scene, 600, WAVE_SEED)
    answer = scene_kernel.scene_closest_plain(scene, lanes.ob, lanes.d, lanes.active, lanes.t0)
    _, _, _, hit = wavefront._active_hits(scene, lanes, answer)
    kinds = [int(k) for k in scene.layout.kinds]
    gids = _np(hit.geometry_id)
    hit_kinds = {kinds[g] for g in gids if 0 <= g < len(kinds)}
    assert (gids == scene.layout.plane_geometry_id).any() and (gids < 0).any()
    assert (1 if name == "builtin" else 2) in hit_kinds  # metaballs / fractals
    assert not _np(lanes.active).all()

    want = wavefront.hit_plain(scene, lanes, answer)
    _, got = _rh_wave(libs, 1, pack, lanes, answer)
    act = _np(want.active)
    assert np.array_equal(got[2], act) and np.array_equal(got[3], _np(want.t0))
    live = _np(lanes.active)
    assert act.any() and (live & ~act).any()  # active lanes with and without a shadow ray
    for g_, w_ in zip(got[:2], want[:2]):
        assert _rel_close(g_[live], _np(w_)[live])

    _, _, sgid = scene_kernel.scene_closest_plain(scene, want.ob, want.d, want.active, want.t0,
                                                  accept_first=True)
    for level, shadow, gid in ((0, want, sgid), (2, None, None)):
        kw = dict(width=W, height=H, row_offset=0, level=level, max_depth=3)
        got, _ = _rh_wave(libs, 2, pack, lanes, answer, shadow, gid, **kw)
        plain = wavefront.shade_plain(scene, lanes._replace(**{
            k: getattr(lanes, k).clone() for k in wavefront.Lanes._fields}), answer, shadow, gid,
            **kw)
        on = _np(plain.active)
        assert np.array_equal(got[4], on), f"level {level}: the kill differs"
        assert _rel_close(got[2], _np(plain.color)) and _rel_close(got[3], _np(plain.tw))
        if level == 0:
            assert on.any() and (live & ~on).any()  # lanes live on and lanes killed
            for k in (0, 1, 5, 6):  # o, d, ob, t0 of the lanes that live on
                assert _rel_close(got[k][on], _np(plain[k])[on]), wavefront.Lanes._fields[k]


STATE_SEED = 17


@pytest.mark.parametrize("name", ["builtin"] + [c.name for c in scenes.BENCH_CONFIGS]
                         + [c.name for c in meshes.MESH_CONFIGS])
def test_frame_state_matches_plain(libs, name):
    if name == "builtin":
        scene, animate = builtin.build_scene(aspect=W / H, device="cpu"), builtin.animate_arrays
    else:
        cfg = (meshes.get_config(name) if name.startswith("mesh_") else scenes.get_config(name))
        b = cfg.builder()
        scene, animate = b.build(W / H, 0.0, device="cpu"), b.animator()
    rng = np.random.default_rng(STATE_SEED)
    times = np.concatenate([[0.0, 6.0], rng.uniform(0.0, 40.0, 6)]).astype(np.float32)
    table = np.asarray(animate.table, dtype=np.float32)
    mb = np.asarray(frame_state.METABALL_TABLE, dtype=np.float32)
    g = scene.layout.num_procedural
    off = frame_kernel.param_offsets(g, scene.arrays.materials.albedo.shape[0])
    rotates = np.repeat(table[:, 1] != 0, 12).reshape(g, 12)
    for i in range(times.shape[0]):
        plain = frame_kernel.pack_static(scene)
        frame_state.advance_plain(plain, animate, scene.arrays, torch.from_numpy(times), i)
        want = _np(plain.params)
        got = _np(frame_kernel.pack_static(scene).params)
        libs["frame_state"].rh_frame_state(_p(got), _p(table), _p(mb), _p(times),
                                           ctypes.c_int(i), ctypes.c_int(g))
        fields = {"b2l": 12 * g, "l2b": 9 * g, "mb": 12}
        frame = np.zeros(got.shape, dtype=bool)
        frame[0] = True
        for key, n in fields.items():
            frame[off[key]: off[key] + n] = True
        assert np.array_equal(got[~frame], want[~frame]), (name, i)
        assert got[0] == want[0] == times[i]
        b2l = slice(off["b2l"], off["b2l"] + 12 * g)
        l2b = slice(off["l2b"], off["l2b"] + 9 * g)
        mbs = slice(off["mb"], off["mb"] + 12)
        fixed = ~rotates.reshape(-1)
        assert np.array_equal(got[b2l][fixed], want[b2l][fixed]), (name, i)
        assert np.array_equal(got[l2b][~rotates[:, :9].reshape(-1)],
                              want[l2b][~rotates[:, :9].reshape(-1)]), (name, i)
        for sl, scale in ((b2l, 8.0), (l2b, 1.0), (mbs, 1.0)):
            bound = 4 * np.spacing(np.maximum(np.abs(want[sl]), np.float32(scale)))
            assert (np.abs(got[sl] - want[sl]) <= bound).all(), (name, i, sl)
