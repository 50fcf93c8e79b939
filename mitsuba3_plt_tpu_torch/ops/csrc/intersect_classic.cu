// Closest-hit and any-hit by classic Moller-Trumbore over the (p0, e1, e2)
// triangle soup (`tri_isect`), one thread per ray.
//
// Replaces: mitsuba3_plt_tpu/ops/intersect_pallas.py::pallas_intersect
// (Pallas body _kernel) and ::pallas_occluded (body _anyhit_kernel).
//
// Table: tri [T_pad, 9] float32, rows p0(3) e1(3) e2(3), zero rows padding
// T to a multiple of 64 (det = 0: never a hit). Per triangle, in the TPU
// kernel's order: pvec = d x e2, det = e1 . pvec, ok = |det| > 1e-12,
// inv_det = [ok] / (ok ? det : 1), tvec = o - p0, u = (tvec . pvec) inv_det,
// qvec = tvec x e1, v = (d . qvec) inv_det, t = (e2 . qvec) inv_det,
// hit = ok & u >= 0 & v >= 0 & u + v <= 1 & t > 0 & t < best. Every product
// and sum is rounded on its own, left to right (no FMA contraction), so a
// lane equals the plain PyTorch version bit for bit. Closest hit: strict
// t < best with rows in order, so the first of two equal hits wins; any hit
// compares against maxt and the thread stops at its first hit. An infinite
// maxt is carried as 3.4e38; a miss gives t = inf, prim = -1, u = v = 0.
//
// What bounds it on the H100: operations. A (ray, triangle) test is ~64
// operations against 28 bytes of ray in and 16 out per ray, so from a few
// triangles on the fp32 rate, not the memory, is the limit. Design: the rows
// are staged into shared memory in chunks of kChunk (every thread of the
// block reads the same row: a broadcast), the ray and its best hit stay in
// registers, and the any-hit loop leaves at its first hit.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlock = 256;
constexpr int kChunk = 512;  // triangle rows per shared-memory stage (18 KB)

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
// ((ax bx + ay by) + az bz)
__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
  return __fadd_rn(__fadd_rn(mul(ax, bx), mul(ay, by)), mul(az, bz));
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
    classic_kernel(const float* __restrict__ tri, int n_tris,
                   const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ maxt, int n,
                   float* __restrict__ t_out, int* __restrict__ prim_out,
                   float* __restrict__ u_out, float* __restrict__ v_out,
                   bool* __restrict__ occ_out) {
  __shared__ float s_tri[kChunk * 9];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float t_b = 0.f;
  if (live) {
    ox = o[3 * i + 0];
    oy = o[3 * i + 1];
    oz = o[3 * i + 2];
    dx = d[3 * i + 0];
    dy = d[3 * i + 1];
    dz = d[3 * i + 2];
    const float mt = maxt[i];
    t_b = isfinite(mt) ? mt : 3.4e38f;
  }
  // the any-hit loop keeps t_b at maxt
  float u_b = 0.f, v_b = 0.f;
  int prim = -1;
  bool occ = false;
  for (int base = 0; base < n_tris; base += kChunk) {
    const int cnt = min(kChunk, n_tris - base);
    __syncthreads();
    for (int k = threadIdx.x; k < cnt * 9; k += kBlock)
      s_tri[k] = tri[base * 9 + k];
    __syncthreads();
    if (!live || occ) continue;
    for (int j = 0; j < cnt; ++j) {
      const float* r = s_tri + 9 * j;
      const float e1x = r[3], e1y = r[4], e1z = r[5];
      const float e2x = r[6], e2y = r[7], e2z = r[8];
      const float pvx = sub(mul(dy, e2z), mul(dz, e2y));
      const float pvy = sub(mul(dz, e2x), mul(dx, e2z));
      const float pvz = sub(mul(dx, e2y), mul(dy, e2x));
      const float det = dot3(e1x, e1y, e1z, pvx, pvy, pvz);
      const bool ok = fabsf(det) > 1e-12f;
      const float inv_det = (ok ? 1.f : 0.f) / (ok ? det : 1.f);
      const float tvx = sub(ox, r[0]), tvy = sub(oy, r[1]),
                  tvz = sub(oz, r[2]);
      const float u = mul(dot3(tvx, tvy, tvz, pvx, pvy, pvz), inv_det);
      const float qvx = sub(mul(tvy, e1z), mul(tvz, e1y));
      const float qvy = sub(mul(tvz, e1x), mul(tvx, e1z));
      const float qvz = sub(mul(tvx, e1y), mul(tvy, e1x));
      const float v = mul(dot3(dx, dy, dz, qvx, qvy, qvz), inv_det);
      const float t = mul(dot3(e2x, e2y, e2z, qvx, qvy, qvz), inv_det);
      // written out so that a NaN term fails
      const bool hit = ok && u >= 0.f && v >= 0.f &&
                       __fadd_rn(u, v) <= 1.f && t > 0.f && t < t_b;
      if (hit) {
        if (kAnyHit) {
          occ = true;
          break;
        }
        t_b = t;
        u_b = u;
        v_b = v;
        prim = base + j;
      }
    }
  }
  if (!live) return;
  if (kAnyHit) {
    occ_out[i] = occ;
    return;
  }
  prim_out[i] = prim;
  t_out[i] = prim >= 0 ? t_b : INFINITY;
  u_out[i] = u_b;
  v_out[i] = v_b;
}

}  // namespace

extern "C" int plt_intersect_classic(const float* tri, int n_tris,
                                     const float* o, const float* d,
                                     const float* maxt, int n, float* t,
                                     int* prim, float* u, float* v,
                                     void* stream) {
  if (n > 0) {
    const int grid = (n + kBlock - 1) / kBlock;
    classic_kernel<false><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        tri, n_tris, o, d, maxt, n, t, prim, u, v, nullptr);
  }
  return (int)cudaGetLastError();
}

extern "C" int plt_occluded_classic(const float* tri, int n_tris,
                                    const float* o, const float* d,
                                    const float* maxt, int n, bool* occ,
                                    void* stream) {
  if (n > 0) {
    const int grid = (n + kBlock - 1) / kBlock;
    classic_kernel<true><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        tri, n_tris, o, d, maxt, n, nullptr, nullptr, nullptr, nullptr, occ);
  }
  return (int)cudaGetLastError();
}
