// Closest-hit and any-hit ray/triangle tests over the precomputed-quantities
// ("q") triangle table, one thread per ray.
//
// Replaces: mitsuba3_plt_tpu/ops/intersect_pallas.py::pallas_intersect_q
// (Pallas body _q_kernel) and ::pallas_occluded_q (body _q_anyhit_kernel).
//
// Math: Moller-Trumbore re-associated around per-triangle constants
// (rows of pack_tri_q: e1, e2, m1 = a0 x e1, m2 = a0 x e2, n2 = e1 x e2,
// k = a0 . n2, with a0 = p0 - anchor), ray origins taken relative to the
// scene anchor:
//   det = -d.n2,  u*det = (o x d).e2 + d.m2,  v*det = -[(o x d).e1 + d.m1],
//   t*det = o.n2 - k.
// The closest hit keeps the pair (t*|det|, |det|), compares pairs by cross
// multiplication (so ties resolve as in the TPU kernel: the first row wins)
// and divides once per ray at the end. An infinite maxt becomes 3.4e38, as
// in the TPU wrapper; t * ad_b < ts_b * ad may overflow to inf on both sides
// exactly as it does there.
//
// What bounds it on the H100: memory. Each ray reads 28 bytes and writes 16
// (closest) or 1 (any hit); a small scene's table is a few hundred bytes, so
// the ~40 flops per (ray, triangle) are far below the 67 TFLOP/s fp32 rate.
// Design: the table is staged into shared memory in chunks of kChunk rows
// (every thread reads the same row: a broadcast), the ray stays in
// registers, and the any-hit loop leaves at its first hit.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlock = 256;
constexpr int kChunk = 256;  // triangle rows per shared-memory stage (16 KB)

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

struct QTerms {
  float ad, us, vs, ts;  // |det|, u|det|, v|det|, t|det|
};

__device__ __forceinline__ QTerms q_terms(const float* tr, const QRay& r) {
  const float det = -(r.dx * tr[12] + r.dy * tr[13] + r.dz * tr[14]);
  const float up = r.cx * tr[3] + r.cy * tr[4] + r.cz * tr[5] +
                   r.dx * tr[9] + r.dy * tr[10] + r.dz * tr[11];
  const float vp = -(r.cx * tr[0] + r.cy * tr[1] + r.cz * tr[2] +
                     r.dx * tr[6] + r.dy * tr[7] + r.dz * tr[8]);
  const float tp = r.ox * tr[12] + r.oy * tr[13] + r.oz * tr[14] - tr[15];
  const float s = det >= 0.f ? 1.f : -1.f;
  return {det * s, up * s, vp * s, tp * s};
}

// inside the triangle and in front of the origin; comparisons written out
// so that a NaN term fails the test, as jnp.minimum(...) >= 0 does
__device__ __forceinline__ bool q_inside(const QTerms& q) {
  return q.ad > 1e-12f && q.us >= 0.f && q.vs >= 0.f &&
         (q.ad - q.us - q.vs) >= 0.f && q.ts > 0.f;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
    q_kernel(const float* __restrict__ tri_q, int n_tris,
             const float* __restrict__ anchor, const float* __restrict__ o,
             const float* __restrict__ d, const float* __restrict__ maxt,
             int n, float* __restrict__ t_out, int* __restrict__ prim_out,
             float* __restrict__ u_out, float* __restrict__ v_out,
             bool* __restrict__ occ_out) {
  __shared__ float s_tri[kChunk * 16];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n;
  QRay r = {};
  if (live) r = load_ray(o, d, maxt, anchor, i);

  float ts_b = r.tmax, ad_b = 1.f, us_b = 0.f, vs_b = 0.f;
  int prim = -1;
  bool occ = false;
  for (int base = 0; base < n_tris; base += kChunk) {
    const int cnt = min(kChunk, n_tris - base);
    __syncthreads();
    for (int k = threadIdx.x; k < cnt * 16; k += kBlock)
      s_tri[k] = tri_q[base * 16 + k];
    __syncthreads();
    if (!live || occ) continue;
    for (int j = 0; j < cnt; ++j) {
      const QTerms q = q_terms(s_tri + 16 * j, r);
      if (kAnyHit) {
        if (q_inside(q) && q.ts < r.tmax * q.ad) {
          occ = true;
          break;
        }
      } else if (q_inside(q) && q.ts * ad_b < ts_b * q.ad) {
        ts_b = q.ts;
        ad_b = q.ad;
        us_b = q.us;
        vs_b = q.vs;
        prim = base + j;
      }
    }
  }
  if (!live) return;
  if (kAnyHit) {
    occ_out[i] = occ;
    return;
  }
  const float inv = 1.f / ad_b;
  prim_out[i] = prim;
  t_out[i] = prim >= 0 ? ts_b * inv : INFINITY;
  u_out[i] = us_b * inv;
  v_out[i] = vs_b * inv;
}

}  // namespace

extern "C" int plt_intersect_q(const float* tri_q, int n_tris,
                               const float* anchor, const float* o,
                               const float* d, const float* maxt, int n,
                               float* t, int* prim, float* u, float* v,
                               void* stream) {
  if (n > 0) {
    const int grid = (n + kBlock - 1) / kBlock;
    q_kernel<false><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        tri_q, n_tris, anchor, o, d, maxt, n, t, prim, u, v, nullptr);
  }
  return (int)cudaGetLastError();
}

extern "C" int plt_occluded_q(const float* tri_q, int n_tris,
                              const float* anchor, const float* o,
                              const float* d, const float* maxt, int n,
                              bool* occ, void* stream) {
  if (n > 0) {
    const int grid = (n + kBlock - 1) / kBlock;
    q_kernel<true><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        tri_q, n_tris, anchor, o, d, maxt, n, nullptr, nullptr, nullptr,
        nullptr, occ);
  }
  return (int)cudaGetLastError();
}
