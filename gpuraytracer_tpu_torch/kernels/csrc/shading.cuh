// The per-pixel work around the traversal that the frame kernel
// (frame_kernel.cu render_pixel) and the wavefront's lane kernels
// (wavefront.cu) share: raygen, the ground plane's rect test, the ray's
// move into BLAS space, and the analytic checkerboard with ray
// differentials (render/checkers.py). Moved here whole from frame_kernel.cu,
// so the frame kernel's code does not change (its SASS is the same).
#pragma once

#include "traverse.cuh"

namespace gprt {

__device__ __forceinline__ void raygen(const Scene& s, int px, int py, int width, int height,
                                       V3* o, V3* d) {
  GPRT_OPS(8 + 16 + 3 + 6 + 13);
  float sx = ((float)px + 0.5f) / (float)width * 2.0f - 1.0f;
  float sy = ((float)py + 0.5f) / (float)height * 2.0f - 1.0f;
  sy = -sy;
  const float* m = s.p2w;
  float w[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) w[c] = sx * m[c] + sy * m[4 + c] + m[12 + c];
  V3 world = v3(w[0] / w[3], w[1] / w[3], w[2] / w[3]);
  V3 cam = v3(s.cvec[0], s.cvec[1], s.cvec[2]);
  *o = v3(world.x * 0.0f + cam.x, world.y * 0.0f + cam.y, world.z * 0.0f + cam.z);
  *d = normalize(sub(world, cam));
}

// Ground-plane rect test (accel/traverse.intersect_plane), t in [0, RAY_TMAX].
__device__ __forceinline__ bool plane_test(const Scene& s, V3 o, V3 d, float* t_out) {
  GPRT_OPS(8);
  const float* po = s.cvec + 20;
  const float* ps = s.cvec + 24;
  float t = -(o.y - po[1]) / d.y;
  float px = o.x + t * d.x;
  float pz = o.z + t * d.z;
  bool inside = px >= po[0] && px <= po[0] + ps[0] && pz >= po[2] && pz <= po[2] + ps[1];
  *t_out = t;
  return inside && d.y < 0.0f && t >= 0.0f && t <= kRayTMax;
}

__device__ __forceinline__ V3 to_blas(const Scene& s, V3 o) {
  GPRT_OPS(3);
  return v3(o.x - s.cvec[16], o.y - s.cvec[17], o.z - s.cvec[18]);
}

// AnalyticalCheckersTexture with ray differentials from the neighbour
// pixels' camera rays (render/checkers.py).
__device__ float checkers(const Scene& s, V3 hp, V3 n, int px, int py, int width, int height) {
  GPRT_OPS(2 * 14 + 2 * 6 + 4 + 2 * 19 + 3);
  V3 ox, dx, oy, dy;
  raygen(s, px + 1, py, width, height, &ox, &dx);
  raygen(s, px, py + 1, width, height, &oy, &dy);
  float sx = dot3(sub(ox, hp), n) / dot3(dx, n);
  float sy = dot3(sub(oy, hp), n) / dot3(dy, n);
  V3 pxp = sub(ox, scale(dx, sx));
  V3 pyp = sub(oy, scale(dy, sy));
  float uv[2] = {hp.x, hp.z};
  float ddx[2] = {pxp.x - hp.x, pxp.z - hp.z};
  float ddy[2] = {pyp.x - hp.x, pyp.z - hp.z};
  float i[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    float w = fmaxf(fabsf(ddx[k]), fabsf(ddy[k]));
    float a = uv[k] + 0.5f * w;
    float b = uv[k] - 0.5f * w;
    float fa = floorf(a), fb = floorf(b);
    i[k] = (fa + fminf((a - fa) * 50.0f, 1.0f) - fb - fminf((b - fb) * 50.0f, 1.0f)) / (50.0f * w);
  }
  return (1.0f - i[0]) * (1.0f - i[1]);
}

}  // namespace gprt
