// The q brute force of the unroll sweep and of the multi-accumulator
// experiment: closest hit (t, prim, and with UV u and v) and any hit over
// the precomputed-quantities triangle table, with the row loop unrolled
// UNROLL deep and, for the closest hit, NACC accumulator groups.
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
// JAX tool's rule, where intersect_q.cu takes 3.4e38).
//
// Rounding: both run B1's and B2's own row test (q_row.cuh, with nvcc's
// FMA contraction). So each closest-hit group's best hit is
// intersect_q.cu's closest hit over the group's rows to the bit (the same
// test in the same row order; the rows past the scene's are zero and
// never hit), at NACC 1 over all of them, and the any hit is
// intersect_q.cu's any hit with an infinite maxt taken as -1, to the bit:
// occluded_q_variant(o, d, maxt) == occluded_q(o, d, where(isfinite(maxt),
// maxt, -1)) over the same rows. Both differ from the unfused plain
// versions as B1 and B2 do.
//
// What bounds it on the H100: issued instructions from ~14 rows up (a
// closest-hit test is 53 operations and an any-hit test 47, 14 of them
// FMAs, against 28 bytes of ray in and 8, 16 or 1 out: a 5,120-face
// mesh's ~240,000-270,000 operations a ray). Design, on intersect_q.cu's
// launch (q_row.cuh's stage, launch.cuh's grid_for), for fewer
// instructions a (ray, row) test (SASS, `ops/mfu.py::count_sass`: the
// closest hit ~61-64 -> 39.6 without u, v and 40.6-41.6 with them; the
// any hit had ~61, from its times): the table in shared memory as float4 rows (four LDS.128
// broadcast reads a row), staged once a block when it fits (n_rows <=
// kChunk), else kChunk rows at a time for every tile (256-row chunks ran
// 0.4-0.7% slower); blocks loop over tiles of kBlock rays, the grid at
// most kWaves waves of resident blocks; the sign fold a sign-bit XOR, the
// flags predicates joined by &, each group's update a select on a
// predicate; a trip's row indices its base plus a constant. A thread runs
// one ray: two share a row's loads (37.5-40.4 instructions a test) but ran
// 1-5% slower on the 5,120-face icosphere and 2-8% on the Cornell box
// (PERF.md, B11a/B11c findings). "unroll" is the `#pragma unroll` depth of
// a thread's row loop, the depth the sweep measures, and n_rows a multiple
// of it (no tail); the NACC groups (5 registers each with UV) break the
// chain of dependent selects that the JAX tool breaks on the TPU. The
// any-hit thread leaves the row loop after the UNROLL-row trip that holds
// its first hit, as B2's does after its 4-row trip; a lane whose maxt is
// not above 0 (an infinite one included) is never occluded and skips the
// rows.
#include <cuda_runtime.h>
#include <math.h>

#include "q_row.cuh"  // B1's row test, stage, grid_for, kBlock, kChunk

namespace {

// blocks an SM the registers must allow: 4 (64 registers a thread)
// without u, v; with u, v, whose groups keep 5 registers each, 3 (80) up
// to NACC 4 and 2 (128) at NACC 8 (at 64, NACC 2, 4 and 8 spilled 20, 96
// and 136 bytes; at 80, NACC 8 spilled 184 and ran 4% slower)
constexpr int min_blocks(int nacc, bool uv) {
  return !uv ? 4 : nacc <= 4 ? 3 : 2;
}

struct Best {
  float ts, ad, us, vs;
  int prim;
};

// b takes row `row` where the ray hits it nearer than b's pair (the strict
// cross-multiplied compare: the first of two tied rows wins), by selects
template <bool UV>
__device__ __forceinline__ void take(Best& b, const QTerms& q, int row) {
  const bool win = q_inside(q) & (q.ts * b.ad < b.ts * q.ad);
  b.ts = win ? q.ts : b.ts;
  b.ad = win ? q.ad : b.ad;
  if (UV) {
    b.us = win ? q.us : b.us;
    b.vs = win ? q.vs : b.vs;
  }
  b.prim = win ? row : b.prim;
}

template <int UNROLL, int NACC, bool UV>
__global__ void __launch_bounds__(kBlock, min_blocks(NACC, UV))
    sweep_q_kernel(const float* __restrict__ tri_q, int n_rows,
                   const float* __restrict__ anchor,
                   const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ maxt, int n,
                   float* __restrict__ t_out, int* __restrict__ prim_out,
                   float* __restrict__ u_out, float* __restrict__ v_out) {
  // row row0 + j lies in group j % NACC: row0 is a multiple of UNROLL,
  // which NACC divides
  static_assert(kChunk % UNROLL == 0 && UNROLL % NACC == 0, "unroll");
  __shared__ float4 s_tri[kChunk * 4];
  const bool resident = n_rows <= kChunk;
  if (resident) {
    stage<1>(s_tri, tri_q, 0, n_rows);  // rows a multiple of UNROLL: no pad
    __syncthreads();
  }
  const int n_tiles = (n + kBlock - 1) / kBlock;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int i = tile * kBlock + threadIdx.x;
    // a lane past n runs a zero ray (d = 0: never hits)
    const QRay r = i < n ? load_ray(o, d, maxt, anchor, i) : QRay{};
    Best acc[NACC];
#pragma unroll
    for (int g = 0; g < NACC; ++g) acc[g] = {r.tmax, 1.f, 0.f, 0.f, -1};
    for (int base = 0; base < n_rows; base += kChunk) {
      const int cnt = min(kChunk, n_rows - base);  // a multiple of UNROLL
      if (!resident) {
        __syncthreads();
        stage<1>(s_tri, tri_q, base, cnt);
        __syncthreads();
      }
#pragma unroll 1
      for (int s = 0; s < cnt; s += UNROLL) {
        const float4* rows = s_tri + 4 * s;
        const int row0 = base + s;
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) {
          const float4* row = rows + 4 * j;
          take<UV>(acc[j % NACC], q_terms(row[0], row[1], row[2], row[3], r),
                   row0 + j);
        }
      }
    }
    if (i >= n) continue;
    Best best = acc[0];
#pragma unroll
    for (int g = 1; g < NACC; ++g) {
      const Best& b = acc[g];
      if (b.prim >= 0 && (best.prim < 0 || b.ts * best.ad < best.ts * b.ad))
        best = b;
    }
    const float inv = 1.f / best.ad;
    prim_out[i] = best.prim;
    t_out[i] = best.prim >= 0 ? best.ts * inv : INFINITY;
    if (UV) {
      u_out[i] = best.us * inv;
      v_out[i] = best.vs * inv;
    }
  }
}

template <int UNROLL>
__global__ void __launch_bounds__(kBlock, 4)
    sweep_a_kernel(const float* __restrict__ tri_q, int n_rows,
                   const float* __restrict__ anchor,
                   const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ maxt, int n,
                   bool* __restrict__ occ_out) {
  static_assert(kChunk % UNROLL == 0, "unroll");
  __shared__ float4 s_tri[kChunk * 4];
  const bool resident = n_rows <= kChunk;
  if (resident) {
    stage<1>(s_tri, tri_q, 0, n_rows);  // rows a multiple of UNROLL: no pad
    __syncthreads();
  }
  const int n_tiles = (n + kBlock - 1) / kBlock;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int i = tile * kBlock + threadIdx.x;
    QRay r = i < n ? load_ray(o, d, maxt, anchor, i) : QRay{};
    // the tool's rule: an infinite maxt is -1, never occluded
    if (i < n && !isfinite(maxt[i])) r.tmax = -1.f;
    // a lane past n, or whose maxt is not above 0, is never occluded: it
    // starts done and skips the rows (an int: a hit sets it by one move)
    int occ = !(r.tmax > 0.f);
    for (int base = 0; base < n_rows; base += kChunk) {
      const int cnt = min(kChunk, n_rows - base);  // a multiple of UNROLL
      if (!resident) {
        __syncthreads();
        stage<1>(s_tri, tri_q, base, cnt);
        __syncthreads();
      }
#pragma unroll 1
      for (int s = 0; s < cnt; s += UNROLL) {
        if (occ) break;
        const float4* rows = s_tri + 4 * s;
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) {
          const float4* row = rows + 4 * j;
          const QTerms q = q_terms(row[0], row[1], row[2], row[3], r);
          if (q_inside(q) & (q.ts < r.tmax * q.ad)) occ = 1;
        }
      }
    }
    if (i < n) occ_out[i] = occ != 0 && r.tmax > 0.f;
  }
}

template <int UNROLL, int NACC, bool UV>
void launch_closest(cudaStream_t s, const float* tri_q, int n_rows,
                    const float* anchor, const float* o, const float* d,
                    const float* maxt, int n, float* t, int* prim, float* u,
                    float* v) {
  sweep_q_kernel<UNROLL, NACC, UV>
      <<<grid_for<sweep_q_kernel<UNROLL, NACC, UV>, kBlock, kWaves>(n),
         kBlock, 0, s>>>(tri_q, n_rows, anchor, o, d, maxt, n, t, prim, u,
                         v);
}

// the sweep's closest hit: one accumulator, or two (dual), without u, v
template <int UNROLL>
void launch_variant(bool dual, cudaStream_t s, const float* tri_q,
                    int n_rows, const float* anchor, const float* o,
                    const float* d, const float* maxt, int n, float* t,
                    int* prim) {
  if (dual)
    launch_closest<UNROLL, 2, false>(s, tri_q, n_rows, anchor, o, d, maxt, n,
                                     t, prim, nullptr, nullptr);
  else
    launch_closest<UNROLL, 1, false>(s, tri_q, n_rows, anchor, o, d, maxt, n,
                                     t, prim, nullptr, nullptr);
}

template <int UNROLL>
void launch_any(cudaStream_t s, const float* tri_q, int n_rows,
                const float* anchor, const float* o, const float* d,
                const float* maxt, int n, bool* occ) {
  sweep_a_kernel<UNROLL>
      <<<grid_for<sweep_a_kernel<UNROLL>, kBlock, kWaves>(n), kBlock, 0,
         s>>>(tri_q, n_rows, anchor, o, d, maxt, n, occ);
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
    const cudaStream_t s = (cudaStream_t)stream;
    switch (unroll) {
      case 2:
        launch_variant<2>(dual, s, tri_q, n_rows, anchor, o, d, maxt, n,
                          t, prim);
        break;
      case 8:
        launch_variant<8>(dual, s, tri_q, n_rows, anchor, o, d, maxt, n,
                          t, prim);
        break;
      case 16:
        launch_variant<16>(dual, s, tri_q, n_rows, anchor, o, d, maxt, n,
                           t, prim);
        break;
      case 32:
        launch_variant<32>(dual, s, tri_q, n_rows, anchor, o, d, maxt, n,
                           t, prim);
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
    const cudaStream_t s = (cudaStream_t)stream;
    switch (nacc) {
      case 2:
        launch_closest<16, 2, true>(s, tri_q, n_rows, anchor, o, d, maxt,
                                    n, t, prim, u, v);
        break;
      case 4:
        launch_closest<16, 4, true>(s, tri_q, n_rows, anchor, o, d, maxt,
                                    n, t, prim, u, v);
        break;
      case 8:
        launch_closest<16, 8, true>(s, tri_q, n_rows, anchor, o, d, maxt,
                                    n, t, prim, u, v);
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
    const cudaStream_t s = (cudaStream_t)stream;
    switch (unroll) {
      case 2:
        launch_any<2>(s, tri_q, n_rows, anchor, o, d, maxt, n, occ);
        break;
      case 8:
        launch_any<8>(s, tri_q, n_rows, anchor, o, d, maxt, n, occ);
        break;
      case 16:
        launch_any<16>(s, tri_q, n_rows, anchor, o, d, maxt, n, occ);
        break;
      case 32:
        launch_any<32>(s, tri_q, n_rows, anchor, o, d, maxt, n, occ);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
