// The (ray, row) test over the precomputed-quantities ("q") triangle table
// and the launch around it, shared by intersect_q.cu (B1, B2) and
// intersect_sweep.cu (B11a, B11b, B11c), so that the sweep measures the
// arithmetic the renderer runs: the same rounding, FMA contraction
// included, in every kernel that includes it. The launch:
// blocks of kBlock threads, one ray a thread, loop over tiles of kBlock
// rays in a grid of at most kWaves waves of resident blocks
// (launch.cuh's grid_for);
// the table sits in shared memory as float4 rows, staged once a block
// when it fits in kChunk rows, else kChunk rows at a time for every tile
// (stage).
//
// Math: Moller-Trumbore re-associated around per-triangle constants (rows
// of pack_tri_q: e1, e2, m1 = a0 x e1, m2 = a0 x e2, n2 = e1 x e2,
// k = a0 . n2, with a0 = p0 - anchor), ray origins taken relative to the
// scene anchor:
//   det = -d.n2,  u*det = (o x d).e2 + d.m2,  v*det = -[(o x d).e1 + d.m1],
//   t*det = o.n2 - k.
// An infinite maxt becomes 3.4e38, as in the TPU wrapper.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

#include "launch.cuh"  // grid_for

namespace {

constexpr unsigned kSign = 0x80000000u;
constexpr int kBlock = 256;  // threads a block, rays a tile
constexpr int kChunk = 512;  // rows a shared-memory stage (32 KB)
constexpr int kWaves = 4;    // resident grids a launch's grid holds at most

struct QRay {
  float ox, oy, oz, dx, dy, dz, cx, cy, cz, tmax;
};

__device__ __forceinline__ QRay load_ray(const float* __restrict__ o,
                                         const float* __restrict__ d,
                                         const float* __restrict__ maxt,
                                         const float* __restrict__ anchor,
                                         int i) {
  QRay r;
  r.ox = o[3 * i + 0] - anchor[0];
  r.oy = o[3 * i + 1] - anchor[1];
  r.oz = o[3 * i + 2] - anchor[2];
  r.dx = d[3 * i + 0];
  r.dy = d[3 * i + 1];
  r.dz = d[3 * i + 2];
  r.cx = r.oy * r.dz - r.oz * r.dy;
  r.cy = r.oz * r.dx - r.ox * r.dz;
  r.cz = r.ox * r.dy - r.oy * r.dx;
  const float mt = maxt[i];
  r.tmax = isfinite(mt) ? mt : 3.4e38f;
  return r;
}

// x with its sign bit flipped where `sign` has its own set
__device__ __forceinline__ float flip(float x, unsigned sign) {
  return __uint_as_float(__float_as_uint(x) ^ (sign & kSign));
}

struct QTerms {
  float ad, us, vs, ts;  // |det|, u|det|, v|det|, t|det|
};

// The terms of one (ray, row) test; a, b, c, e: the row's floats 0-3, 4-7,
// 8-11, 12-15. The sign of det folds into u, v, t by its sign bit: det =
// -dn, so where det's sign bit is set (det < 0, or det = -0, which never
// hits) us = -up, vs = -vp = vn, ts = -tp.
__device__ __forceinline__ QTerms q_terms(const float4& a, const float4& b,
                                          const float4& c, const float4& e,
                                          const QRay& r) {
  const float dn = r.dx * e.x + r.dy * e.y + r.dz * e.z;
  const float up = r.cx * a.w + r.cy * b.x + r.cz * b.y +
                   r.dx * c.y + r.dy * c.z + r.dz * c.w;
  const float vn = r.cx * a.x + r.cy * a.y + r.cz * a.z +
                   r.dx * b.z + r.dy * b.w + r.dz * c.x;
  const float tp = r.ox * e.x + r.oy * e.y + r.oz * e.z - e.w;
  const unsigned neg = ~__float_as_uint(dn);  // det's sign bit
  return {fabsf(dn), flip(up, neg), flip(vn, ~neg), flip(tp, neg)};
}

// inside the triangle and in front of the origin; comparisons written out
// so that a NaN term fails the test, as jnp.minimum(...) >= 0 does, and
// joined by & (no short circuit: the flags stay predicates)
__device__ __forceinline__ bool q_inside(const QTerms& q) {
  return (q.ad > 1e-12f) & (q.us >= 0.f) & (q.vs >= 0.f) &
         ((q.ad - q.us - q.vs) >= 0.f) & (q.ts > 0.f);
}

// Stages rows [base, base + cnt) of the table into s_tri, then zero rows
// up to the next multiple of STEP (a zero row has det = 0 and never hits).
template <int STEP>
__device__ __forceinline__ void stage(float4* s_tri,
                                      const float* __restrict__ tri_q,
                                      int base, int cnt) {
  float* s = reinterpret_cast<float*>(s_tri);
  const int padded = (cnt + STEP - 1) / STEP * STEP;
  for (int k = threadIdx.x; k < padded * 16; k += kBlock)
    s[k] = k < cnt * 16 ? tri_q[base * 16 + k] : 0.f;
}

}  // namespace
