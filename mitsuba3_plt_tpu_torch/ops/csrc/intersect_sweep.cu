// The q brute force of the unroll sweep and of the multi-accumulator
// experiment: closest hit (t, prim, and with UV u and v) and any hit over
// the precomputed-quantities triangle table, with the row loop unrolled
// UNROLL deep and, for the closest hit, NACC accumulator groups. One thread
// per ray.
//
// Replaces: tools/experiments/isect_unroll_sweep.py::q_variant (Pallas
// body make_q_kernel(unroll, dual)) and its a_variant (body
// make_a_kernel(unroll)), tuning variants of intersect_q.cu's two kernels,
// and tools/experiments/isect_q_multiacc.py::intersect_macc (body
// _q_kernel_macc, UNROLL 16, nacc 2, 4 or 8).
//
// Function: the rows [0, n_rows) of pack_tri_q's table (n_rows is the
// caller's face count rounded up to a multiple of UNROLL within the table:
// ops/intersect.py::q_variant_rows), ray origins relative to the anchor.
// Closest hit: row r updates group r % NACC, which keeps the pair
// (t|det|, |det|) of its nearest row by the strict cross-multiplied
// compare (the first of two tied rows wins) with u|det| and v|det|; the
// groups then merge in order 1..NACC-1 into group 0, group g taken where it
// hit and group 0 missed or ts_g |det|0 < ts0 |det|g (an exact tie across
// groups goes to the lower group, which can pick another prim than
// intersect_q.cu: it is the function). The sweep's two accumulators
// (dual) are NACC = 2: its merge, ts2 |det|1 < ts1 |det|2, is this one
// wherever no group's best hit lies within rounding of maxt (a rounded
// compare is not transitive: a group's best, reached through two updates,
// can fail ts < maxt |det| against a group that missed). t, u and v
// are the pairs times 1/|det|. An infinite maxt is 3.4e38 for the closest
// hit; the any hit takes it as -1, so such a lane is never occluded (the
// JAX tool's rule, where intersect_q.cu takes 3.4e38). Every product and
// sum is rounded on its own in the plain version's order (no FMA
// contraction), so the kernel equals ops/intersect.py's plain versions to
// the bit.
//
// What bounds it on the H100: operations from ~14 rows up (53 operations a
// row against 28 bytes of ray in and 8 or 16 out: the Cornell box's 36
// rows and a 5,120-face mesh's ~270,000 operations a ray). Design: as
// intersect_q.cu, the table staged into shared memory kChunk rows at a
// time (every thread reads the same row: a broadcast), the ray and its
// NACC best hits in registers (5 each with UV: 40 at NACC 8). On this card
// "unroll" is `#pragma unroll` of a thread's row loop, the depth the sweep
// measures; the groups break the chain of dependent selects that the JAX
// tool breaks on the TPU. The any-hit thread leaves after the UNROLL-row
// group that holds its first hit.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlock = 256;
constexpr int kChunk = 256;  // triangle rows per shared-memory stage (16 KB)

struct QRay {
  float ox, oy, oz, dx, dy, dz, cx, cy, cz;
};

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
// acc + ax bx + ay by + az bz, left to right
__device__ __forceinline__ float add(float acc, float ax, float ay, float az,
                                     float bx, float by, float bz) {
  return __fadd_rn(__fadd_rn(__fadd_rn(acc, mul(ax, bx)), mul(ay, by)),
                   mul(az, bz));
}

__device__ __forceinline__ QRay load_ray(const float* __restrict__ o,
                                         const float* __restrict__ d,
                                         const float* __restrict__ anchor,
                                         int i) {
  QRay r;
  r.ox = o[3 * i + 0] - anchor[0];
  r.oy = o[3 * i + 1] - anchor[1];
  r.oz = o[3 * i + 2] - anchor[2];
  r.dx = d[3 * i + 0];
  r.dy = d[3 * i + 1];
  r.dz = d[3 * i + 2];
  r.cx = sub(mul(r.oy, r.dz), mul(r.oz, r.dy));
  r.cy = sub(mul(r.oz, r.dx), mul(r.ox, r.dz));
  r.cz = sub(mul(r.ox, r.dy), mul(r.oy, r.dx));
  return r;
}

// (|det|, t|det|, u|det|, v|det|) of row tr and whether the ray hits it
// in front of its origin
__device__ __forceinline__ bool q_test(const float* tr, const QRay& r,
                                       float& ad, float& ts, float& us,
                                       float& vs) {
  const float det = -dot3(r.dx, r.dy, r.dz, tr[12], tr[13], tr[14]);
  const float up = add(dot3(r.cx, r.cy, r.cz, tr[3], tr[4], tr[5]),
                       r.dx, r.dy, r.dz, tr[9], tr[10], tr[11]);
  const float vp = -add(dot3(r.cx, r.cy, r.cz, tr[0], tr[1], tr[2]),
                        r.dx, r.dy, r.dz, tr[6], tr[7], tr[8]);
  const float tp = sub(dot3(r.ox, r.oy, r.oz, tr[12], tr[13], tr[14]),
                       tr[15]);
  const float sg = det >= 0.f ? 1.f : -1.f;
  ad = det * sg;
  ts = tp * sg;
  us = up * sg;
  vs = vp * sg;
  // written out so that a NaN term fails, as jnp.minimum(...) >= 0
  return ad > 1e-12f && us >= 0.f && vs >= 0.f &&
         sub(sub(ad, us), vs) >= 0.f && ts > 0.f;
}

struct Best {
  float ts, ad, us, vs;
  int prim;
};

template <bool UV>
__device__ __forceinline__ void take(Best& b, const float* tr, const QRay& r,
                                     int row) {
  float ad, ts, us, vs;
  if (q_test(tr, r, ad, ts, us, vs) && mul(ts, b.ad) < mul(b.ts, ad)) {
    b.ts = ts;
    b.ad = ad;
    if (UV) {
      b.us = us;
      b.vs = vs;
    }
    b.prim = row;
  }
}

template <int UNROLL, int NACC, bool UV>
__global__ void __launch_bounds__(kBlock)
    sweep_q_kernel(const float* __restrict__ tri_q, int n_rows,
                   const float* __restrict__ anchor,
                   const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ maxt, int n,
                   float* __restrict__ t_out, int* __restrict__ prim_out,
                   float* __restrict__ u_out, float* __restrict__ v_out) {
  // row base + j + u lies in group u % NACC: base and j are multiples of
  // UNROLL, which NACC divides
  static_assert(kChunk % UNROLL == 0 && UNROLL % NACC == 0, "unroll");
  __shared__ float s_tri[kChunk * 16];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n;
  QRay r = {};
  float tmax = 3.4e38f;
  if (live) {
    r = load_ray(o, d, anchor, i);
    const float mt = maxt[i];
    tmax = isfinite(mt) ? mt : 3.4e38f;
  }
  Best acc[NACC];
#pragma unroll
  for (int g = 0; g < NACC; ++g) acc[g] = {tmax, 1.f, 0.f, 0.f, -1};
  for (int base = 0; base < n_rows; base += kChunk) {
    const int cnt = min(kChunk, n_rows - base);  // a multiple of UNROLL
    __syncthreads();
    for (int k = threadIdx.x; k < cnt * 16; k += kBlock)
      s_tri[k] = tri_q[base * 16 + k];
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < cnt; j += UNROLL) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        take<UV>(acc[u % NACC], s_tri + 16 * (j + u), r, base + j + u);
    }
  }
  if (!live) return;
  Best a = acc[0];
#pragma unroll
  for (int g = 1; g < NACC; ++g) {
    const Best& b = acc[g];
    if (b.prim >= 0 && (a.prim < 0 || mul(b.ts, a.ad) < mul(a.ts, b.ad)))
      a = b;
  }
  const float inv = __frcp_rn(a.ad);
  prim_out[i] = a.prim;
  t_out[i] = a.prim >= 0 ? mul(a.ts, inv) : INFINITY;
  if (UV) {
    u_out[i] = mul(a.us, inv);
    v_out[i] = mul(a.vs, inv);
  }
}

template <int UNROLL>
__global__ void __launch_bounds__(kBlock)
    sweep_a_kernel(const float* __restrict__ tri_q, int n_rows,
                   const float* __restrict__ anchor,
                   const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ maxt, int n,
                   bool* __restrict__ occ_out) {
  static_assert(kChunk % UNROLL == 0, "unroll");
  __shared__ float s_tri[kChunk * 16];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n;
  QRay r = {};
  float tmax = -1.f;
  if (live) {
    r = load_ray(o, d, anchor, i);
    const float mt = maxt[i];
    tmax = isfinite(mt) ? mt : -1.f;
  }
  bool occ = false;
  for (int base = 0; base < n_rows; base += kChunk) {
    const int cnt = min(kChunk, n_rows - base);
    __syncthreads();
    for (int k = threadIdx.x; k < cnt * 16; k += kBlock)
      s_tri[k] = tri_q[base * 16 + k];
    __syncthreads();
    if (!live || occ) continue;
    for (int j = 0; j < cnt && !occ; j += UNROLL) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float ad, ts, us, vs;
        occ = occ || (q_test(s_tri + 16 * (j + u), r, ad, ts, us, vs) &&
                      ts < mul(tmax, ad));
      }
    }
  }
  if (live) occ_out[i] = occ;
}

template <int UNROLL, int NACC, bool UV>
void launch_closest(int grid, cudaStream_t s, const float* tri_q, int n_rows,
                    const float* anchor, const float* o, const float* d,
                    const float* maxt, int n, float* t, int* prim, float* u,
                    float* v) {
  sweep_q_kernel<UNROLL, NACC, UV><<<grid, kBlock, 0, s>>>(
      tri_q, n_rows, anchor, o, d, maxt, n, t, prim, u, v);
}

// the sweep's closest hit: one accumulator, or two (dual), without u, v
template <int UNROLL>
void launch_variant(bool dual, int grid, cudaStream_t s, const float* tri_q,
                    int n_rows, const float* anchor, const float* o,
                    const float* d, const float* maxt, int n, float* t,
                    int* prim) {
  if (dual)
    launch_closest<UNROLL, 2, false>(grid, s, tri_q, n_rows, anchor, o, d,
                                     maxt, n, t, prim, nullptr, nullptr);
  else
    launch_closest<UNROLL, 1, false>(grid, s, tri_q, n_rows, anchor, o, d,
                                     maxt, n, t, prim, nullptr, nullptr);
}

}  // namespace

// unroll must be 2, 8, 16 or 32 and n_rows a multiple of it
extern "C" int plt_intersect_q_variant(const float* tri_q, int n_rows,
                                       const float* anchor, const float* o,
                                       const float* d, const float* maxt,
                                       int n, float* t, int* prim, int unroll,
                                       int dual, void* stream) {
  if (n_rows % unroll) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int grid = (n + kBlock - 1) / kBlock;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (unroll) {
      case 2:
        launch_variant<2>(dual, grid, s, tri_q, n_rows, anchor, o, d, maxt,
                          n, t, prim);
        break;
      case 8:
        launch_variant<8>(dual, grid, s, tri_q, n_rows, anchor, o, d, maxt,
                          n, t, prim);
        break;
      case 16:
        launch_variant<16>(dual, grid, s, tri_q, n_rows, anchor, o, d, maxt,
                           n, t, prim);
        break;
      case 32:
        launch_variant<32>(dual, grid, s, tri_q, n_rows, anchor, o, d, maxt,
                           n, t, prim);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

// the multi-accumulator closest hit at unroll 16: nacc must be 2, 4 or 8
// and n_rows a multiple of 16
extern "C" int plt_intersect_q_macc(const float* tri_q, int n_rows,
                                    const float* anchor, const float* o,
                                    const float* d, const float* maxt, int n,
                                    float* t, int* prim, float* u, float* v,
                                    int nacc, void* stream) {
  if (n_rows % 16) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int grid = (n + kBlock - 1) / kBlock;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (nacc) {
      case 2:
        launch_closest<16, 2, true>(grid, s, tri_q, n_rows, anchor, o, d,
                                    maxt, n, t, prim, u, v);
        break;
      case 4:
        launch_closest<16, 4, true>(grid, s, tri_q, n_rows, anchor, o, d,
                                    maxt, n, t, prim, u, v);
        break;
      case 8:
        launch_closest<16, 8, true>(grid, s, tri_q, n_rows, anchor, o, d,
                                    maxt, n, t, prim, u, v);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int plt_occluded_q_variant(const float* tri_q, int n_rows,
                                      const float* anchor, const float* o,
                                      const float* d, const float* maxt,
                                      int n, bool* occ, int unroll,
                                      void* stream) {
  if (n_rows % unroll) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int grid = (n + kBlock - 1) / kBlock;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (unroll) {
      case 2:
        sweep_a_kernel<2><<<grid, kBlock, 0, s>>>(tri_q, n_rows, anchor, o,
                                                  d, maxt, n, occ);
        break;
      case 8:
        sweep_a_kernel<8><<<grid, kBlock, 0, s>>>(tri_q, n_rows, anchor, o,
                                                  d, maxt, n, occ);
        break;
      case 16:
        sweep_a_kernel<16><<<grid, kBlock, 0, s>>>(tri_q, n_rows, anchor, o,
                                                   d, maxt, n, occ);
        break;
      case 32:
        sweep_a_kernel<32><<<grid, kBlock, 0, s>>>(tri_q, n_rows, anchor, o,
                                                   d, maxt, n, occ);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
