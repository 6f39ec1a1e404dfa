// Per-ray device math of the frame and scene kernels: vectors, the seven
// reference distance functions, the Mandelbulb and quaternion Julia
// extension fractals and their normal, the analytic intersectors, the
// metaball field, and the two marchers.
//
// Replaces the device math of the reference's Pallas kernels
// (gpuraytracer_tpu/kernels/soa.py; scene_kernel.py _march_sdf_part,
// _normal_at, _march_metaballs_part, _metaball_normal, _local_ray) and of
// geometry/fractal.py. Where the Pallas forms and the reference's XLA path
// (geometry/*.py, which rendered every committed golden) differ, this
// follows the XLA path: atan2f for the Cog's polar angle, powf(., 1/8) for
// the torus82 length, division-form normalize, the XLA tetrahedral-normal
// association, and fractal.py's Mandelbulb and Julia (not soa.py's).
// Every float constant is written as the double the reference package
// holds, converted to float, so both round it the same way.
//
// Built with -DGPRT_COUNT_OPS, every function adds the f32 floating-point
// operations it performs to a per-block counter that the kernel adds to a
// global total; the default build compiles the counting away. They are
// counted by hand from this source as FLOPs, the unit of the published f32
// peak: each +, -, * and / is one, so a multiply-add (one FMA once
// contracted) is two; each min, max, abs, sqrt, floor, fmod and
// transcendental call is one; comparisons, selects, negations and
// arithmetic on constants alone (folded by the compiler) are not counted.
// Only the operation bound of a measurement reads it.
//
// Built with -DGPRT_COUNT_SIMT, every march sample (an SDF distance or a
// metaball field evaluation of a march step) counts how full its warp was:
// the lanes marching together are grouped by the bucket their thread set
// (GPRT_SIMT_BUCKET: level * 2 + 1 for an occlusion query, level * 2 for a
// closest one); each group adds its lane count to its bucket's lane-samples
// and its share of the warp-sample (lanes of the group over active lanes,
// in units of 2^-20) to its bucket's warp-samples, and the warp's lowest
// active lane adds one to the total warp-samples. SIMT efficiency is
// lane-samples / (32 x warp-samples). The kernel's ops pointer then holds
// 2 x kSimtBuckets + 1 counters; the default build compiles it away.
#pragma once

#include <math.h>

#include <limits>

#define F(x) ((float)(x))

#ifdef GPRT_COUNT_OPS
__shared__ unsigned long long gprt_block_ops;
#define GPRT_OPS(n) atomicAdd(&gprt_block_ops, (unsigned long long)(n))
#else
#define GPRT_OPS(n) ((void)0)
#endif

namespace gprt {

constexpr int kSimtBuckets = 16;  // 8 levels x (closest, occlusion)
constexpr int kSimtShift = 20;    // fixed-point unit of a warp-sample share

}  // namespace gprt

#ifdef GPRT_COUNT_SIMT
__shared__ unsigned long long* gprt_simt_out;
__shared__ int gprt_simt_bucket[128];  // one slot per thread of a 128-thread block

__device__ __forceinline__ int gprt_thread() {
  return (threadIdx.z * blockDim.y + threadIdx.y) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ void gprt_simt_sample() {
  const unsigned active = __activemask();
  const unsigned lane = gprt_thread() & 31;
  const int b = gprt_simt_bucket[gprt_thread()];
  const unsigned group = __match_any_sync(active, b);
  if (lane == (unsigned)(__ffs(group) - 1)) {
    atomicAdd(gprt_simt_out + 2 * b, (unsigned long long)__popc(group));
    atomicAdd(gprt_simt_out + 2 * b + 1,
              ((unsigned long long)__popc(group) << gprt::kSimtShift) / __popc(active));
  }
  if (lane == (unsigned)(__ffs(active) - 1)) atomicAdd(gprt_simt_out + 2 * gprt::kSimtBuckets, 1ull);
}
#define GPRT_SIMT_SAMPLE() gprt_simt_sample()
#define GPRT_SIMT_BUCKET(b) (gprt_simt_bucket[gprt_thread()] = (b))
#else
#define GPRT_SIMT_SAMPLE() ((void)0)
#define GPRT_SIMT_BUCKET(b) ((void)0)
#endif

namespace gprt {

constexpr float kInf = std::numeric_limits<float>::infinity();

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ V3 scale(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
// o + t*d, component-wise, in the reference's association.
__device__ __forceinline__ V3 along(V3 o, float t, V3 d) {
  return v3(o.x + t * d.x, o.y + t * d.y, o.z + t * d.z);
}
// (x + y) + z, the order of the reference's reductions.
__device__ __forceinline__ float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ float len3(V3 a) { return sqrtf(dot3(a, a)); }
__device__ __forceinline__ float len2(float a, float b) { return sqrtf(a * a + b * b); }
// HLSL normalize in division form with the exact-zero guard.
__device__ __forceinline__ V3 normalize(V3 v) {
  float l = fmaxf(len3(v), 1e-20f);
  return v3(v.x / l, v.y / l, v.z / l);
}
// i - (2*dot(i, n))*n
__device__ __forceinline__ V3 reflect(V3 i, V3 n) {
  float k = 2.0f * dot3(i, n);
  return v3(i.x - k * n.x, i.y - k * n.y, i.z - k * n.z);
}
__device__ __forceinline__ float saturate(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }
// NaN-propagating max/min, as the reference's slab reductions behave.
__device__ __forceinline__ float nmax(float a, float b) { return (a != a || b != b) ? a + b : fmaxf(a, b); }
__device__ __forceinline__ float nmin(float a, float b) { return (a != a || b != b) ? a + b : fminf(a, b); }

// ---------------------------------------------------------------------------
// Distance functions (geometry/sdf.py; hlsli anchors there)
// ---------------------------------------------------------------------------

__device__ __forceinline__ V3 op_rep(V3 p, float cx, float cy, float cz) {
  return v3(fmodf(p.x, cx) - 0.5f * cx, fmodf(p.y, cy) - 0.5f * cy, fmodf(p.z, cz) - 0.5f * cz);
}

__device__ __forceinline__ float sd_box(V3 p, float b) {
  V3 d = v3(fabsf(p.x) - b, fabsf(p.y) - b, fabsf(p.z) - b);
  float inside = fminf(fmaxf(fmaxf(d.x, d.y), d.z), 0.0f);
  return inside + len3(v3(fmaxf(d.x, 0.0f), fmaxf(d.y, 0.0f), fmaxf(d.z, 0.0f)));
}

__device__ __forceinline__ float len_xz(V3 p) { return sqrtf(p.x * p.x + p.z * p.z); }

__device__ __forceinline__ float len_pow8(float a, float b) {
  float qa = a * a;
  qa = qa * qa;
  qa = qa * qa;
  float qb = b * b;
  qb = qb * qb;
  qb = qb * qb;
  return powf(qa + qb, 0.125f);
}

__device__ __forceinline__ float sd_torus82(V3 p, float t0, float t1) {
  return len_pow8(len_xz(p) - t0, p.y) - t1;
}

__device__ __forceinline__ float sd_cylinder(V3 p, float h0, float h1) {
  float dx = fabsf(len_xz(p)) - h0;
  float dy = fabsf(p.y) - h1;
  return fminf(fmaxf(dx, dy), 0.0f) + len2(fmaxf(dx, 0.0f), fmaxf(dy, 0.0f));
}

__device__ __forceinline__ float distance_mini_spheres(V3 p) {
  V3 q = op_rep(v3(p.x + 1.0f, p.y + 1.0f, p.z + 1.0f), F(2.0 / 4.0), F(2.0 / 4.0), F(2.0 / 4.0));
  return fmaxf(len3(q) - F(0.65 / 4.0), sd_box(p, 1.0f));
}

__device__ __forceinline__ float distance_round_cube(V3 p) {
  V3 d = v3(fmaxf(fabsf(p.x) - F(0.75), 0.0f), fmaxf(fabsf(p.y) - F(0.75), 0.0f),
            fmaxf(fabsf(p.z) - F(0.75), 0.0f));
  float rb = len3(d) - F(0.2);
  float l = len3(p);
  return fmaxf(fmaxf(rb, -(l - F(1.20))), l - F(1.32));
}

__device__ __forceinline__ float distance_twisted_torus(V3 p) {
  float c = cosf(3.0f * p.y);
  float s = sinf(3.0f * p.y);
  // op_twist -> (c x - s z, s x + c z, y); the torus reads xz = (c x - s z, y).
  float tx = c * p.x - s * p.z;
  float ty = s * p.x + c * p.z;
  return len2(len2(tx, p.y) - F(0.6), ty) - F(0.2);
}

__device__ __forceinline__ float distance_cog(V3 p) {
  float ang = atan2f(p.z, p.x) / F(6.2831);
  V3 polar = v3(ang + 1.0f, 1.0f + 1.0f, (F(0.015) + 0.25f * len3(p)) + 1.0f);
  float teeth = sd_cylinder(op_rep(polar, F(0.05), 1.0f, F(0.075)), F(0.02), F(0.8));
  return fmaxf(sd_torus82(p, F(0.60), F(0.3)), -teeth);
}

__device__ __forceinline__ float distance_cylinder(V3 p) {
  V3 q = v3(p.x + 1.0f, p.y + 1.0f, p.z + 1.0f);
  return fmaxf(sd_cylinder(op_rep(q, 1.0f, 2.0f, 1.0f), F(0.3), 2.0f), sd_box(q, 2.0f));
}

__device__ __forceinline__ float distance_fractal_pyramid(V3 p) {
  // sd_fractal_pyramid(p + (0,1,0), h = (0.894, 0.447, 2.0), scale 2, 4 folds)
  const float a = F(2.0 * 0.447 / 0.894);
  const float vx[5] = {0.0f, -a, a, a, -a};
  const float vy[5] = {2.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const float vz[5] = {0.0f, a, -a, a, -a};
  V3 q = v3(p.x + 0.0f, p.y + 1.0f, p.z + 0.0f);
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    V3 e = sub(q, v3(vx[0], vy[0], vz[0]));
    float best = dot3(e, e);
    int bi = 0;
#pragma unroll
    for (int k = 1; k < 5; ++k) {
      V3 f = sub(q, v3(vx[k], vy[k], vz[k]));
      float dk = dot3(f, f);
      if (dk < best) {
        best = dk;
        bi = k;
      }
    }
    q = v3(2.0f * q.x - vx[bi] * 1.0f, 2.0f * q.y - vy[bi] * 1.0f, 2.0f * q.z - vz[bi] * 1.0f);
  }
  float oct = fmaxf(fabsf(q.x), fabsf(q.z)) * F(0.894) + fabsf(q.y) * F(0.447);
  oct = oct - F(0.447 * 2.0);
  return fmaxf(oct, -q.y) * F(0.0625);
}

// Power-8 triplex Mandelbulb (geometry/fractal.distance_mandelbulb): a
// lane past the bailout keeps its state, so the loop may stop there.
__device__ __forceinline__ float distance_mandelbulb(V3 p) {
  const float scale = F(1.2);
  const float px = p.x * scale, py = p.y * scale, pz = p.z * scale;
  float x = px, y = py, z = pz, dz = 1.0f;
  float m = px * px + py * py + pz * pz;
  int it = 0;
  for (; it < 8 && !(m > 4.0f); ++it) {
    float m2 = m * m;
    float m4 = m2 * m2;
    dz = 8.0f * sqrtf(m4 * m2 * m) * dz + 1.0f;
    float x2 = x * x, y2 = y * y, z2 = z * z;
    float x4 = x2 * x2, y4 = y2 * y2, z4 = z2 * z2;
    float k3 = x2 + z2;
    float k3_7 = k3 * k3 * k3 * k3 * k3 * k3 * k3;
    float k2 = 1.0f / sqrtf(fmaxf(k3_7, F(1e-30)));
    float k1 = x4 + y4 + z4 - 6.0f * y2 * z2 - 6.0f * x2 * y2 + 2.0f * z2 * x2;
    float k4 = x2 - y2 + z2;
    float nx = px + 64.0f * x * y * z * (x2 - z2) * k4 * (x4 - 6.0f * x2 * z2 + z4) * k1 * k2;
    float ny = py + -16.0f * y2 * k3 * k4 * k4 + k1 * k1;
    float nz = pz + -8.0f * y * k4 *
                        (x4 * x4 - 28.0f * x4 * x2 * z2 + 70.0f * x4 * z4 - 28.0f * x2 * z2 * z4 +
                         z4 * z4) *
                        k1 * k2;
    x = nx;
    y = ny;
    z = nz;
    m = x * x + y * y + z * z;
  }
  GPRT_OPS(8 + 83 * it + 7);
  m = fmaxf(m, F(1e-18));
  float de = 0.25f * logf(m) * sqrtf(m) / dz;
  return de / scale;
}

// Quaternion Julia z <- z^2 + c on the w = 0 slice
// (geometry/fractal.distance_julia_quaternion); (w, x, y, z) components,
// escape tested before each update, "just inside" (-1e-3) if it never
// escapes.
__device__ __forceinline__ float distance_julia(V3 p) {
  const float scale = F(1.1);
  const float cw = F(-0.2), cx = F(0.6), cy = F(0.2), cz = F(0.2);
  float zw = p.x * scale, zx = p.y * scale, zy = p.z * scale, zz = 0.0f;
  float dw = 1.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  bool escaped = false;
  int it = 0;
  for (; it < 11; ++it) {
    float m2 = zw * zw + zx * zx + zy * zy + zz * zz;
    if (m2 > 16.0f) {
      escaped = true;
      break;
    }
    float ew = zw * dw - zx * dx - zy * dy - zz * dz;
    float ex = zw * dx + zx * dw + zy * dz - zz * dy;
    float ey = zw * dy - zx * dz + zy * dw + zz * dx;
    float ez = zw * dz + zx * dy - zy * dx + zz * dw;
    float qw = zw * zw - zx * zx - zy * zy - zz * zz;
    float qx = zw * zx + zx * zw + zy * zz - zz * zy;
    float qy = zw * zy - zx * zz + zy * zw + zz * zx;
    float qz = zw * zz + zx * zy - zy * zx + zz * zw;
    dw = 2.0f * ew;
    dx = 2.0f * ex;
    dy = 2.0f * ey;
    dz = 2.0f * ez;
    zw = qw + cw;
    zx = qx + cx;
    zy = qy + cy;
    zz = qz + cz;
  }
  GPRT_OPS(3 + 71 * it + (escaped ? 7 : 0) + 23);
  float mz = fmaxf(sqrtf(zw * zw + zx * zx + zy * zy + zz * zz), F(1e-9));
  float mdz = fmaxf(sqrtf(dw * dw + dx * dx + dy * dy + dz * dz), F(1e-6));
  float de = 0.5f * mz * logf(mz) / mdz;
  return (escaped ? de : F(-1e-3)) / scale;
}

// FLOPs of one call of each reference distance function.
__constant__ int kDistanceOps[7] = {36, 26, 14, 19, 45, 46, 209};

// Codes 0..6 in the reference's SignedDistancePrimitive order, then the
// extension fractals 7 (Mandelbulb) and 8 (quaternion Julia).
__device__ __noinline__ float sdf_distance(int code, V3 p) {
  if (code < 7) GPRT_OPS(kDistanceOps[code]);
  switch (code) {
    case 0: return distance_mini_spheres(p);
    case 1: return distance_round_cube(p);
    case 2: return sd_torus82(p, F(0.75), F(0.15));
    case 3: return distance_twisted_torus(p);
    case 4: return distance_cog(p);
    case 5: return distance_cylinder(p);
    case 6: return distance_fractal_pyramid(p);
    case 7: return distance_mandelbulb(p);
    default: return distance_julia(p);
  }
}

// The distance of code kCode alone, for a march specialized on its code
// (megakernel.cu's one-geometry march): sdf_distance's case of the code,
// without the switch, and a call that saves only the registers this one
// distance uses. Still a call, so that the distance's operations are
// compiled on their own, as in sdf_distance.
template <int kCode>
__device__ __noinline__ float sdf_distance_code(V3 p) {
  if (kCode < 7) GPRT_OPS(kDistanceOps[kCode]);
  switch (kCode) {
    case 0: return distance_mini_spheres(p);
    case 1: return distance_round_cube(p);
    case 2: return sd_torus82(p, F(0.75), F(0.15));
    case 3: return distance_twisted_torus(p);
    case 4: return distance_cog(p);
    case 5: return distance_cylinder(p);
    case 6: return distance_fractal_pyramid(p);
    case 7: return distance_mandelbulb(p);
    default: return distance_julia(p);
  }
}

// The march loop's distance: sdf_distance_code<kCode>, or for kCode < 0
// sdf_distance with the code read at run time.
template <int kCode>
__device__ __forceinline__ float sdf_distance_of(int code, V3 p) {
  if constexpr (kCode < 0) {
    return sdf_distance(code, p);
  } else {
    return sdf_distance_code<kCode>(p);
  }
}

// Tetrahedral-offset normal (geometry/sdf.calculate_normal): n is the sum
// of offset_k * f(p + offset_k), k = xyy, yyx, yxy, xxx, then normalized.
__device__ __noinline__ V3 sdf_normal(int code, V3 p) {
  GPRT_OPS(12 + 21 + 10);
  const float e = F(0.5773 * 0.0001);
  float d0 = sdf_distance(code, v3(p.x + e, p.y + -e, p.z + -e));
  float d1 = sdf_distance(code, v3(p.x + -e, p.y + -e, p.z + e));
  float d2 = sdf_distance(code, v3(p.x + -e, p.y + e, p.z + -e));
  float d3 = sdf_distance(code, v3(p.x + e, p.y + e, p.z + e));
  V3 n = v3(e * d0 + -e * d1 + -e * d2 + e * d3,
            -e * d0 + -e * d1 + e * d2 + e * d3,
            -e * d0 + e * d1 + -e * d2 + e * d3);
  return normalize(n);
}

// distance_julia with every product and sum rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn, which nvcc never contracts into an
// FMA, whatever --fmad says), in the same association.
__device__ __forceinline__ float distance_julia_exact(V3 p) {
  auto mul = [](float a, float b) { return __fmul_rn(a, b); };
  // a*b + c*d + e*f + g*h left to right, the second to fourth terms added
  // (true) or subtracted (false).
  auto sum4 = [](float ab, float cd, float ef, float gh, bool p2, bool p3, bool p4) {
    float r = p2 ? __fadd_rn(ab, cd) : __fsub_rn(ab, cd);
    r = p3 ? __fadd_rn(r, ef) : __fsub_rn(r, ef);
    return p4 ? __fadd_rn(r, gh) : __fsub_rn(r, gh);
  };
  const float scale = F(1.1);
  const float cw = F(-0.2), cx = F(0.6), cy = F(0.2), cz = F(0.2);
  float zw = mul(p.x, scale), zx = mul(p.y, scale), zy = mul(p.z, scale), zz = 0.0f;
  float dw = 1.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  bool escaped = false;
  int it = 0;
  for (; it < 11; ++it) {
    const float m2 = sum4(mul(zw, zw), mul(zx, zx), mul(zy, zy), mul(zz, zz), true, true, true);
    if (m2 > 16.0f) {
      escaped = true;
      break;
    }
    const float ew = sum4(mul(zw, dw), mul(zx, dx), mul(zy, dy), mul(zz, dz), false, false, false);
    const float ex = sum4(mul(zw, dx), mul(zx, dw), mul(zy, dz), mul(zz, dy), true, true, false);
    const float ey = sum4(mul(zw, dy), mul(zx, dz), mul(zy, dw), mul(zz, dx), false, true, true);
    const float ez = sum4(mul(zw, dz), mul(zx, dy), mul(zy, dx), mul(zz, dw), true, false, true);
    const float qw = sum4(mul(zw, zw), mul(zx, zx), mul(zy, zy), mul(zz, zz), false, false, false);
    const float qx = sum4(mul(zw, zx), mul(zx, zw), mul(zy, zz), mul(zz, zy), true, true, false);
    const float qy = sum4(mul(zw, zy), mul(zx, zz), mul(zy, zw), mul(zz, zx), false, true, true);
    const float qz = sum4(mul(zw, zz), mul(zx, zy), mul(zy, zx), mul(zz, zw), true, false, true);
    dw = mul(2.0f, ew);
    dx = mul(2.0f, ex);
    dy = mul(2.0f, ey);
    dz = mul(2.0f, ez);
    zw = __fadd_rn(qw, cw);
    zx = __fadd_rn(qx, cx);
    zy = __fadd_rn(qy, cy);
    zz = __fadd_rn(qz, cz);
  }
  GPRT_OPS(3 + 71 * it + (escaped ? 7 : 0) + 23);
  const float mz = fmaxf(
      sqrtf(sum4(mul(zw, zw), mul(zx, zx), mul(zy, zy), mul(zz, zz), true, true, true)), F(1e-9));
  const float mdz = fmaxf(
      sqrtf(sum4(mul(dw, dw), mul(dx, dx), mul(dy, dy), mul(dz, dz), true, true, true)), F(1e-6));
  const float de = mul(mul(0.5f, mz), logf(mz)) / mdz;
  return (escaped ? de : F(-1e-3)) / scale;
}

// Code 8's (the Julia set's) normal, as sdf_normal but with every product
// and sum rounded on its own: its 11 chaotic iterations amplify a
// contracted multiply-add's last bit, and the division by the offset
// (5.8e-5) turns that into a different normal; rounded op by op it is the
// plain version's (PERF.md). A function of its own, called only at a
// code-8 hit (hit_normal): written into sdf_normal, which the marches'
// back-face test calls, it raised the kernels' registers and cost the
// frame, merged, defer and scene kernels 2-10% in same-call A/Bs on an H100.
__device__ __noinline__ V3 julia_normal(V3 p) {
  GPRT_OPS(12 + 21 + 10);
  const float e = F(0.5773 * 0.0001);
  const float d0 = distance_julia_exact(v3(p.x + e, p.y + -e, p.z + -e));
  const float d1 = distance_julia_exact(v3(p.x + -e, p.y + -e, p.z + e));
  const float d2 = distance_julia_exact(v3(p.x + -e, p.y + e, p.z + -e));
  const float d3 = distance_julia_exact(v3(p.x + e, p.y + e, p.z + e));
  auto term = [e](float a, float b, float c, float d, float x0, float x1, float x2, float x3) {
    return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x0, a), __fmul_rn(x1, b)), __fmul_rn(x2, c)),
                     __fmul_rn(x3, d));
  };
  const V3 n = v3(term(d0, d1, d2, d3, e, -e, -e, e), term(d0, d1, d2, d3, -e, -e, e, e),
                  term(d0, d1, d2, d3, -e, e, -e, e));
  const float l = fmaxf(
      sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(n.x, n.x), __fmul_rn(n.y, n.y)), __fmul_rn(n.z, n.z))),
      1e-20f);
  return v3(n.x / l, n.y / l, n.z / l);
}

// The normal at a hit of SDF code `code`: sdf_normal, code 8's julia_normal.
__device__ __forceinline__ V3 hit_normal(int code, V3 p) {
  return code == 8 ? julia_normal(p) : sdf_normal(code, p);
}

// ---------------------------------------------------------------------------
// Analytic primitives (geometry/analytic.py)
// ---------------------------------------------------------------------------

struct Roots {
  bool has;
  float t0, t1;
};

// Stable quadratic for |o + t d - c| = r; rr is r*r as the caller's
// reference computes it.
__device__ __forceinline__ Roots solve_sphere(V3 o, V3 d, V3 c, float rr) {
  V3 L = sub(o, c);
  float a = dot3(d, d);
  float b = 2.0f * dot3(d, L);
  float cc = dot3(L, L) - rr;
  float discr = b * b - 4.0f * a * cc;
  float sq = sqrtf(fmaxf(discr, 0.0f));
  float q = b > 0.0f ? -0.5f * (b + sq) : -0.5f * (b - sq);
  float x0 = q / a;
  float x1 = cc / q;
  float t0 = fminf(x0, x1);
  float t1 = fmaxf(x0, x1);
  if (discr == 0.0f) {
    float mid = -0.5f * b / a;
    t0 = mid;
    t1 = mid;
  }
  return Roots{discr >= 0.0f, t0, t1};
}

// RaySpheresIntersectionTest: three hollow spheres, closest valid hit wins.
__device__ bool intersect_spheres(V3 o, V3 d, float t_max, bool cull, float* t_out, V3* n_out) {
  GPRT_OPS(3 * (70 + (cull ? 10 : 0)));
  const float cx[3] = {F(-0.3), F(0.1), F(0.35)};
  const float cy[3] = {F(-0.3), F(0.1), F(0.35)};
  const float cz[3] = {F(-0.3), F(0.4), F(0.0)};
  const float rr[3] = {F(0.6 * 0.6), F(0.3 * 0.3), F(0.15 * 0.15)};
  float best_t = t_max;
  bool found = false;
  for (int s = 0; s < 3; ++s) {
    V3 c = v3(cx[s], cy[s], cz[s]);
    Roots r = solve_sphere(o, d, c, rr[s]);
    V3 n0 = normalize(sub(along(o, r.t0, d), c));
    V3 n1 = normalize(sub(along(o, r.t1, d), c));
    bool v0 = r.t0 >= 0.0f && r.t0 <= t_max && (!cull || dot3(d, n0) <= 0.0f);
    bool v1 = r.t1 >= 0.0f && r.t1 <= t_max && (!cull || dot3(d, n1) <= 0.0f);
    bool use_a = r.t0 < 0.0f;
    bool hit_a = !(r.t1 < 0.0f) && v1;
    bool hit_b1 = !v0 && v1;
    bool hit = r.has && (use_a ? hit_a : (v0 || hit_b1));
    bool use_t1 = use_a || hit_b1;
    float t = use_t1 ? r.t1 : r.t0;
    if (hit && t < best_t) {
      best_t = t;
      *n_out = use_t1 ? n1 : n0;
      found = true;
    }
  }
  *t_out = best_t;
  return found;
}

struct Interval {
  float tmin, tmax;
};

// Slab interval with the reference's inf handling for axis-parallel rays.
__device__ __forceinline__ Interval slab(V3 o, V3 d, V3 mn, V3 mx) {
  float oc[3] = {o.x, o.y, o.z}, dc[3] = {d.x, d.y, d.z};
  float lo[3] = {mn.x, mn.y, mn.z}, hi[3] = {mx.x, mx.y, mx.z};
  float t0[3], t1[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float inv = dc[k] != 0.0f ? 1.0f / dc[k] : (dc[k] > 0.0f ? kInf : -kInf);
    float near = dc[k] > 0.0f ? lo[k] : hi[k];
    float far = dc[k] > 0.0f ? hi[k] : lo[k];
    t0[k] = (near - oc[k]) * inv;
    t1[k] = (far - oc[k]) * inv;
  }
  return Interval{nmax(nmax(t0[0], t0[1]), t0[2]), nmin(nmin(t1[0], t1[1]), t1[2])};
}

// Hollow unit AABB with priority-ordered face normals.
__device__ bool intersect_hollow_aabb(V3 o, V3 d, float t_max, bool cull, float* t_out, V3* n_out) {
  GPRT_OPS(19 + 6 + 12 + (cull ? 5 : 0));
  Interval iv = slab(o, d, v3(-1.0f, -1.0f, -1.0f), v3(1.0f, 1.0f, 1.0f));
  bool interval_ok = iv.tmax > iv.tmin && iv.tmax >= 0.0f && iv.tmin <= t_max;
  bool entry_ok = iv.tmin >= 0.0f && iv.tmin <= t_max;
  float t = iv.tmin;
  V3 pos = along(o, t, d);
  const float eps = F(0.0001);
  V3 n = v3(0.0f, 0.0f, 0.0f);
  if (fabsf(-1.0f - pos.x) < eps) n = v3(-1.0f, 0.0f, 0.0f);
  else if (fabsf(-1.0f - pos.y) < eps) n = v3(0.0f, -1.0f, 0.0f);
  else if (fabsf(-1.0f - pos.z) < eps) n = v3(0.0f, 0.0f, -1.0f);
  else if (fabsf(1.0f - pos.x) < eps) n = v3(1.0f, 0.0f, 0.0f);
  else if (fabsf(1.0f - pos.y) < eps) n = v3(0.0f, 1.0f, 0.0f);
  else if (fabsf(1.0f - pos.z) < eps) n = v3(0.0f, 0.0f, 1.0f);
  bool hit = interval_ok && entry_ok && (!cull || dot3(d, n) <= 0.0f);
  *t_out = t;
  *n_out = n;
  return hit;
}

// ---------------------------------------------------------------------------
// Metaballs (geometry/metaballs.py); mb = 3 x (cx, cy, cz, r)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float metaball_potential(V3 p, const float* b) {
  float dist = len3(v3(p.x - b[0], p.y - b[1], p.z - b[2]));
  float dr = (b[3] - dist) / b[3];
  float d2 = dr * dr;
  float d4 = d2 * d2;
  float val = 6.0f * (dr * d4) - 15.0f * d4 + 10.0f * (dr * d2);
  return dist <= b[3] ? val : 0.0f;
}

__device__ __forceinline__ float metaballs_potential(V3 p, const float* mb) {
  GPRT_OPS(3 * 20 + 2);
  return metaball_potential(p, mb) + metaball_potential(p, mb + 4) + metaball_potential(p, mb + 8);
}

__device__ __noinline__ V3 metaballs_normal(V3 p, const float* mb) {
  GPRT_OPS(6 + 3 + 10);
  const float e = F(0.5773 * 0.00001);
  V3 n = v3(metaballs_potential(v3(p.x - e, p.y, p.z), mb) - metaballs_potential(v3(p.x + e, p.y, p.z), mb),
            metaballs_potential(v3(p.x, p.y - e, p.z), mb) - metaballs_potential(v3(p.x, p.y + e, p.z), mb),
            metaballs_potential(v3(p.x, p.y, p.z - e), mb) - metaballs_potential(v3(p.x, p.y, p.z + e), mb));
  return normalize(n);
}

// What a march ended in: no crossing, a valid crossing, or a spent budget
// (the budget ran out with no valid crossing).
enum MarchResult { kMarchMiss = 0, kMarchHit = 1, kMarchCapped = 2 };

// A capped occlusion march's record: what the deferred-shadow mode's main
// pass (the defer entry) keeps of the march that its cap stopped, so that
// the occlusion repair continues that march where it stopped instead of
// running it, and the geometries before it, again. g is the geometry; steps
// the samples taken, with kRecordOon (an SDF march still in its
// over-relaxed phase) and kRecordEscaped (its last sample passed the escape
// bound, so the full march misses), or kRecordRetired (the march retired a
// repeating step, so the full march spends its budget too); t the march's t
// at the cap; carry the last distance of an over-relaxed SDF march (rprev),
// or the previous t of a plain one (t_prev). A metaball march keeps its
// steps and t.
struct alignas(16) MarchRecord {
  int g;
  int steps;
  float t;
  float carry;
};
constexpr int kRecordSteps = 0x00FFFFFF;    // the sample count's bits
constexpr int kRecordRetired = 0x00FFFFFF;  // past every budget
constexpr int kRecordOon = 1 << 24;
constexpr int kRecordEscaped = 1 << 25;

// A march's form: the plain one; the one that writes its record where its
// budget runs out (kCarrySave); the one that continues from a record at a
// larger budget (kCarryResume). The step stays the same, so a capped march
// is a strict prefix of the full one, and the resumed march takes the full
// march's samples after the cap.
enum MarchCarry { kCarryNone = 0, kCarrySave = 1, kCarryResume = 2 };

// Fixed-step march over the union of the balls' bounding-sphere intervals
// clipped to [0, t_max], in 128 steps of the interval over 128; a crossing
// that fails the validity check steps on like any other sample.
// max_steps < 128 caps it (a compacted frame mode's main pass): the step
// stays the same, so a capped march is a strict prefix of the full one
// (scene_kernel._march_metaballs_part's step_div). kMarchCapped: every
// sample taken, none a valid crossing. kCarry, rec: as march_sdf_loop's.
template <int kCarry = kCarryNone>
__device__ int march_metaballs(V3 o, V3 d, float t_max, const float* mb, bool cull, int max_steps,
                               float* t_out, MarchRecord* rec = nullptr) {
  GPRT_OPS(3 * 37 + 4);
  float tmin = kInf, tmax = -kInf;
  for (int j = 0; j < 3; ++j) {
    const float* b = mb + 4 * j;
    Roots r = solve_sphere(o, d, v3(b[0], b[1], b[2]), b[3] * b[3]);
    if (r.has) {
      tmin = fminf(fmaxf(r.t0, 0.0f), tmin);
      tmax = fmaxf(fminf(r.t1, t_max), tmax);
    }
  }
  tmin = fmaxf(tmin, 0.0f);
  tmax = fminf(tmax, t_max);
  if (!(tmax >= tmin)) return kMarchMiss;
  float step = (tmax - tmin) / 128.0f;
  float t = kCarry == kCarryResume ? rec->t : tmin;
  for (int s = kCarry == kCarryResume ? rec->steps : 0; s < max_steps; ++s) {
    GPRT_OPS(7);
    GPRT_SIMT_SAMPLE();
    V3 pos = along(o, t, d);
    if (metaballs_potential(pos, mb) >= F(0.25)) {
      bool ok = t >= 0.0f && t <= t_max;
      if (ok && cull) {
        GPRT_OPS(5);
        ok = dot3(d, metaballs_normal(pos, mb)) <= 0.0f;
      }
      if (ok) {
        *t_out = t;
        return kMarchHit;
      }
    }
    t = t + step;
  }
  if (kCarry == kCarrySave && rec != nullptr) {
    rec->steps = max_steps;
    rec->t = t;
  }
  return kMarchCapped;
}

// ---------------------------------------------------------------------------
// Sphere tracer (geometry/sdf.sphere_trace)
// ---------------------------------------------------------------------------

struct MarchSpec {
  int max_steps;
  float relax;       // > 1: over-relaxed (occlusion by default)
  float fail_scale;  // (1 - relax) * relax, rounded from double
  bool capped_hit;   // budget exhaustion reports a hit (occlusion)
  bool cull;
  bool escape;       // retire past the escape bound (reference codes only)
};

// Whether a march that ended in r hits under spec m: a valid crossing, or
// a spent budget where the spec's capped_hit rule reports one.
__device__ __forceinline__ bool march_hit(int r, const MarchSpec& m) {
  return r == kMarchHit || (r == kMarchCapped && m.capped_hit);
}

// The escape bound of a march over [., t_max] (t_max where the spec takes
// none).
__device__ __forceinline__ float escape_bound(V3 o, V3 d, float t_max, const MarchSpec& m) {
  GPRT_OPS(14 + (m.escape ? 3 : 0));
  float o_norm = len3(o), d_norm = len3(d);
  float denom = fmaxf(d_norm - F(2.5 * 0.0001), 1e-6f);
  return m.escape ? fminf(t_max, (o_norm + 12.0f) / denom) : t_max;
}

// March from t_start to t_max (the AABB window of an extension fractal, or
// 0 and the running best t) with the carries of the reference's loop (the
// running t, the samples taken, the over-relaxation's rprev and oon, the
// cycle retirement's t_prev) in registers. Returns how the march ended
// (kMarchCapped: the budget spent, the reference's capped lane,
// scene_kernel.py:459-463); *t_out is the crossing's t, or the final t of a
// capped march. kCarrySave: a march that ends capped writes its carries to
// *rec (a MarchRecord; rec->g is the caller's; none where rec is null);
// kCarryResume: the march
// starts from the carries in *rec instead of t_start, and misses at once
// where the record says that the full march missed. samples (non-null):
// counts the samples taken.
template <int kCarry, int kCode = -1>
__device__ __forceinline__ int march_sdf_loop(int code, V3 o, V3 d, float t_start, float t_max,
                                              float step_scale, const MarchSpec& m, float* t_out,
                                              MarchRecord* rec, int* samples = nullptr) {
  const float t_esc = escape_bound(o, d, t_max, m);
  float t = t_start, rprev = 0.0f, t_prev = -1.0f;
  bool oon = true, escaped_last = false;
  int steps = 0;
  const bool relaxed = m.relax > 1.0f;
  if (kCarry == kCarryResume) {
    if (rec->steps & kRecordEscaped) return kMarchMiss;
    t = rec->t;
    steps = rec->steps & kRecordSteps;
    oon = (rec->steps & kRecordOon) != 0;
    rprev = rec->carry;
    t_prev = rec->carry;
  }
  while (steps < m.max_steps) {
    GPRT_OPS(relaxed ? 13 : 9);
    GPRT_SIMT_SAMPLE();
    if (samples != nullptr) ++*samples;
    V3 pos = along(o, t, d);
    float dist = sdf_distance_of<kCode>(code, pos);
    ++steps;
    bool fail = relaxed && oon && (dist + rprev < m.relax * rprev);
    bool crossed = dist <= F(0.0001) * t && !fail;
    if (crossed) {
      bool ok = t >= t_start && t <= t_max;
      if (ok && m.cull) {
        GPRT_OPS(5);
        ok = dot3(d, sdf_normal(code, pos)) <= 0.0f;
      }
      if (ok) {
        *t_out = t;
        return kMarchHit;
      }
    }
    float plain = step_scale * dist;
    if (relaxed) {
      float stepv = fail ? m.fail_scale * (step_scale * rprev)
                         : ((oon && !crossed) ? m.relax * plain : plain);
      bool escaped = !fail && (t + plain > t_esc);
      oon = oon && !fail && !crossed;
      rprev = dist;
      t = t + stepv;
      if (escaped) {
        escaped_last = kCarry == kCarrySave;
        break;
      }
    } else {
      float t_new = t + plain;
      // A step that leaves t unchanged or returns to the previous t repeats
      // forever: the lane would spend its whole budget, so spend it now.
      if (t_new == t || t_new == t_prev) {
        steps = kCarry == kCarrySave ? kRecordRetired : m.max_steps;
        break;
      }
      t_prev = t;
      t = t_new;
      if (t > t_esc) {
        escaped_last = kCarry == kCarrySave;
        break;
      }
    }
  }
  if (steps >= m.max_steps) {
    *t_out = t;
    if (kCarry == kCarrySave && rec != nullptr) {
      rec->steps = steps | (oon ? kRecordOon : 0) | (escaped_last ? kRecordEscaped : 0);
      rec->t = t;
      rec->carry = relaxed ? rprev : t_prev;
    }
    return kMarchCapped;
  }
  return kMarchMiss;
}

// The march, march_sdf_loop's plain form. Not inlined: one out-of-line copy
// serves the closest and the occlusion traversals, which keeps the frame
// kernel within 128 registers without spills (inlined into both, it spilled
// once the extension fractals joined the distance switch; ptxas -v). The
// loop is written out: a one-sample function called from a loop took 122
// registers where this takes 118, and cost the frame kernel 5% in a
// same-call A/B on an H100 (PERF.md).
__device__ __noinline__ int march_sdf(int code, V3 o, V3 d, float t_start, float t_max,
                                      float step_scale, const MarchSpec& m, float* t_out) {
  return march_sdf_loop<kCarryNone>(code, o, d, t_start, t_max, step_scale, m, t_out, nullptr);
}

// march_sdf specialized on its code kCode (sdf_distance_code a sample),
// for a kernel instantiated per code: the same operations in the same
// order as march_sdf's. Not inlined, as march_sdf is not: inlined into its
// kernel, the compiler split the loop on the relaxation (a kernel
// parameter there) and contracted the plain step into an FMA, which moved
// the crossings of the unrelaxed marches by an ulp on an H100. The SIMT
// build (-DGPRT_COUNT_SIMT) also writes the samples it took to *samples.
#ifdef GPRT_COUNT_SIMT
template <int kCode>
__device__ __noinline__ int march_sdf_code(V3 o, V3 d, float t_start, float t_max,
                                           float step_scale, const MarchSpec& m, float* t_out,
                                           int* samples) {
  int taken = 0;
  const int r = march_sdf_loop<kCarryNone, kCode>(kCode, o, d, t_start, t_max, step_scale, m,
                                                  t_out, nullptr, &taken);
  *samples = taken;
  return r;
}
#else
template <int kCode>
__device__ __noinline__ int march_sdf_code(V3 o, V3 d, float t_start, float t_max,
                                           float step_scale, const MarchSpec& m, float* t_out) {
  return march_sdf_loop<kCarryNone, kCode>(kCode, o, d, t_start, t_max, step_scale, m, t_out,
                                           nullptr);
}
#endif

// The march that writes its record where its budget runs out, and the
// march that continues from a record (the occlusion repair):
// march_sdf_loop's other forms, each its own copy, so that the plain march
// keeps its code. The defer entry runs every march as march_sdf_saved (its
// closest marches with no record), so that it holds one copy of the loop:
// with march_sdf beside it, the entry read 12% slower on an H100 (PERF.md).
__device__ __noinline__ int march_sdf_saved(int code, V3 o, V3 d, float t_start, float t_max,
                                            float step_scale, const MarchSpec& m, float* t_out,
                                            MarchRecord* rec) {
  return march_sdf_loop<kCarrySave>(code, o, d, t_start, t_max, step_scale, m, t_out, rec);
}
__device__ __noinline__ int march_sdf_resumed(int code, V3 o, V3 d, float t_start, float t_max,
                                              float step_scale, const MarchSpec& m, float* t_out,
                                              MarchRecord rec) {
  return march_sdf_loop<kCarryResume>(code, o, d, t_start, t_max, step_scale, m, t_out, &rec);
}

}  // namespace gprt
