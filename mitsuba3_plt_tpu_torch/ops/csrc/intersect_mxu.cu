// Closest hit with Moller-Trumbore's four quantities as dot products of a
// per-ray feature vector with per-triangle weight rows, one thread per ray.
//
// Replaces: mitsuba3_plt_tpu/ops/intersect_pallas.py::pallas_intersect_mxu
// (Pallas body _mxu_kernel), whose table comes from pack_tri_mxu.
//
// Math: det, u' = u det, v' = v det and t' = t det are affine in the ray
// features phi = (d, o, dx o, dy o, dz o, 1) (16 terms), so a triangle is
// four rows of W [4 T_pad, 16], grouped [det | u' | v' | t'] with T_pad
// rows each (zero rows pad T_pad to a multiple of 128: det = 0, never a
// hit; the loop runs the first n_tris rows of each group and skips them).
// The TPU kernel takes the whole soup as one f32 product on the MXU,
// U = W phi^T [4 T_pad, B], then the sign logic and an argmin; here each
// thread builds its phi and takes the four 16-term dot products of each
// triangle in FP32 FMAs, in term order:
//   sd = sign(det) (+1 at 0), us, vs, ts = sd (u', v', t'),
//   inv = [|det| > 1e-12] / |det|, t = ts inv,
//   hit = ok & us >= 0 & vs >= 0 & us + vs <= |det| & ts > 0 & t < maxt,
// keeping the smallest t with the lowest triangle index on ties (argmin's
// rule), and u = us inv, v = vs inv of that triangle. A lane with no hit
// gives t = inf, prim = -1, u = v = 0; an infinite maxt is carried as
// 3.4e38. Not equal to the bit to anything: the MXU's HIGHEST precision,
// cuBLAS and these FMAs each round the product their own way.
//
// What bounds it on the H100: operations, 64 FMAs and ~20 other operations
// per (ray, triangle) against 28 bytes of ray in and 16 out. Design: W is
// staged through shared memory kTile triangles (4 kTile rows) at a time,
// every thread reading the same row (a broadcast); phi, the running best
// and its u, v stay in registers. No tensor cores: that is a later design
// (3xTF32 wgmma).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlock = 128;
constexpr int kTile = 64;  // triangles per shared-memory stage (16 KB)

__device__ __forceinline__ float dot16(const float* __restrict__ w,
                                       const float (&phi)[16]) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 16; ++k) acc = fmaf(w[k], phi[k], acc);
  return acc;
}

__global__ void __launch_bounds__(kBlock)
    mxu_kernel(const float* __restrict__ w, int t_pad, int n_tris,
               const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ maxt, int n,
               float* __restrict__ t_out, int* __restrict__ prim_out,
               float* __restrict__ u_out, float* __restrict__ v_out) {
  __shared__ float s_w[4 * kTile * 16];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n;
  float phi[16] = {};
  float t_max = 0.f;
  if (live) {
    const float dx = d[3 * i + 0], dy = d[3 * i + 1], dz = d[3 * i + 2];
    const float ox = o[3 * i + 0], oy = o[3 * i + 1], oz = o[3 * i + 2];
    const float dd[3] = {dx, dy, dz};
    phi[0] = dx;
    phi[1] = dy;
    phi[2] = dz;
    phi[3] = ox;
    phi[4] = oy;
    phi[5] = oz;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      phi[6 + 3 * a + 0] = __fmul_rn(dd[a], ox);
      phi[6 + 3 * a + 1] = __fmul_rn(dd[a], oy);
      phi[6 + 3 * a + 2] = __fmul_rn(dd[a], oz);
    }
    phi[15] = 1.f;
    const float mt = maxt[i];
    t_max = isfinite(mt) ? mt : 3.4e38f;
  }
  // a hit has t < t_max <= 3.4e38, so the first hit always replaces this
  float t_best = 3.4e38f, u_best = 0.f, v_best = 0.f;
  int best = -1;
  for (int base = 0; base < n_tris; base += kTile) {
    const int cnt = min(kTile, n_tris - base);
    __syncthreads();
    // s_w[(g * kTile + j) * 16 + k] = W[g * t_pad + base + j, k]
    for (int k = threadIdx.x; k < 4 * cnt * 16; k += kBlock) {
      const int g = k / (cnt * 16), r = k % (cnt * 16);
      s_w[g * kTile * 16 + r] = w[(g * t_pad + base) * 16 + r];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < cnt; ++j) {
      const float det = dot16(s_w + (0 * kTile + j) * 16, phi);
      const float up = dot16(s_w + (1 * kTile + j) * 16, phi);
      const float vp = dot16(s_w + (2 * kTile + j) * 16, phi);
      const float tp = dot16(s_w + (3 * kTile + j) * 16, phi);
      const bool ok = fabsf(det) > 1e-12f;
      const float sd = det >= 0.f ? 1.f : -1.f;
      const float adet = fabsf(det);
      const float us = up * sd, vs = vp * sd, ts = tp * sd;
      const float inv = (ok ? 1.f : 0.f) / (ok ? adet : 1.f);
      const float t = __fmul_rn(ts, inv);
      // written out so that a NaN term fails
      const bool hit = ok && us >= 0.f && vs >= 0.f &&
                       __fadd_rn(us, vs) <= adet && ts > 0.f && t < t_max;
      if (hit && t < t_best) {
        t_best = t;
        best = base + j;
        u_best = __fmul_rn(us, inv);
        v_best = __fmul_rn(vs, inv);
      }
    }
  }
  if (!live) return;
  const bool found = best >= 0;
  prim_out[i] = found ? best : -1;
  t_out[i] = found ? t_best : INFINITY;
  u_out[i] = u_best;
  v_out[i] = v_best;
}

}  // namespace

extern "C" int plt_intersect_mxu(const float* w, int t_pad, int n_tris,
                                 const float* o, const float* d,
                                 const float* maxt, int n,
                                 float* t, int* prim, float* u, float* v,
                                 void* stream) {
  if (n > 0) {
    const int grid = (n + kBlock - 1) / kBlock;
    mxu_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        w, t_pad, n_tris, o, d, maxt, n, t, prim, u, v);
  }
  return (int)cudaGetLastError();
}
