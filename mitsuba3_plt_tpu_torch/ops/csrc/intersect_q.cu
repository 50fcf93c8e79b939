// Closest-hit and any-hit ray/triangle tests over the precomputed-quantities
// ("q") triangle table: one ray a thread, the table staged once a block in
// shared memory, blocks looping over tiles of rays.
//
// Replaces: mitsuba3_plt_tpu/ops/intersect_pallas.py::pallas_intersect_q
// (Pallas body _q_kernel) and ::pallas_occluded_q (body _q_anyhit_kernel).
//
// Math: the row test of q_row.cuh (Moller-Trumbore re-associated around
// per-triangle constants), which the sweep's closest hit shares.
// The closest hit keeps the pair (t*|det|, |det|), compares pairs by cross
// multiplication (so ties resolve as in the TPU kernel: the first row wins)
// and divides once per ray at the end. An infinite maxt becomes 3.4e38, as
// in the TPU wrapper; t * ad_b < ts_b * ad may overflow to inf on both sides
// exactly as it does there. nvcc contracts the dot products into FMAs.
//
// What bounds it on the H100: bytes on a scene of a few triangles (each
// ray reads 28 bytes and writes 16 or 1), issued instructions on the
// Cornell box's 36 (a test is ~40 operations, 14 of them FMAs: far below
// the FP32 rate in FLOP, not in instructions). Design, for fewer
// instructions a (ray, row) test (SASS, `ops/mfu.py::count_sass`: 53 ->
// 41 closest, 49 -> 38 any hit):
//   - the table sits in shared memory as float4 rows (four LDS.128
//     broadcast reads a row), staged once per block when it fits (n_tris
//     <= kChunk); the grid holds at most kWaves waves of resident blocks,
//     each looping over tiles of kBlock rays (one wave lost 3-5% on the
//     any hit, whose tiles differ in cost; a block a tile lost 3-10% on
//     the grating); a larger table is staged chunk by chunk for every
//     tile;
//   - the row loop runs kStep rows a trip with no tail: a stage pads its
//     rows with zero rows up to a multiple of kStep in shared memory (a
//     zero row has det = 0 and never hits), so nothing past n_tris is read;
//   - the sign fold is a sign-bit XOR (one LOP3 a term) rather than a
//     select and four multiplies, and the flags stay predicates;
//   - the any hit leaves the row loop after the trip of its first hit;
//   - registers are capped at 64 (kMinBlocks blocks an SM): the grating's
//     bytes-bound launch needs the warps in flight. For the same reason
//     a thread runs one ray: 2 or 4 rays a thread share a row's loads (39
//     and 37 instructions a test) but were no faster on the Cornell box
//     and 6-36% slower on the grating (PERF.md, B1/B2 findings).
#include <cuda_runtime.h>
#include <math.h>

#include "q_row.cuh"  // the row test, stage, and launch.cuh's grid_for

namespace {

constexpr int kMinBlocks = 4;  // blocks an SM the registers must allow
constexpr int kStep = 4;       // rows a trip of the row loop

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    q_kernel(const float* __restrict__ tri_q, int n_tris,
             const float* __restrict__ anchor, const float* __restrict__ o,
             const float* __restrict__ d, const float* __restrict__ maxt,
             int n, float* __restrict__ t_out, int* __restrict__ prim_out,
             float* __restrict__ u_out, float* __restrict__ v_out,
             bool* __restrict__ occ_out) {
  __shared__ float4 s_tri[kChunk * 4];
  const bool resident = n_tris <= kChunk;
  if (resident) {
    stage<kStep>(s_tri, tri_q, 0, n_tris);
    __syncthreads();
  }
  const int n_tiles = (n + kBlock - 1) / kBlock;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int i = tile * kBlock + threadIdx.x;
    // a lane past n runs a zero ray (d = 0: never hits) and is done
    const QRay r = i < n ? load_ray(o, d, maxt, anchor, i) : QRay{};
    float ts_b = r.tmax, ad_b = 1.f, us_b = 0.f, vs_b = 0.f;
    int prim = -1;
    int occ = i >= n;  // an int, not a bool: a hit sets it by one move
    for (int base = 0; base < n_tris; base += kChunk) {
      const int cnt = min(kChunk, n_tris - base);
      if (!resident) {
        __syncthreads();
        stage<kStep>(s_tri, tri_q, base, cnt);
        __syncthreads();
      }
      const int trips = (cnt + kStep - 1) / kStep;
#pragma unroll 1
      for (int s = 0; s < trips; ++s) {
        if (kAnyHit && occ) break;
#pragma unroll
        for (int j = 0; j < kStep; ++j) {
          const float4* row = s_tri + 4 * (s * kStep + j);
          const QTerms q = q_terms(row[0], row[1], row[2], row[3], r);
          if (kAnyHit) {
            if (q_inside(q) & (q.ts < r.tmax * q.ad)) occ = 1;
          } else if (q_inside(q) & (q.ts * ad_b < ts_b * q.ad)) {
            ts_b = q.ts;
            ad_b = q.ad;
            us_b = q.us;
            vs_b = q.vs;
            prim = base + s * kStep + j;
          }
        }
      }
    }
    if (i >= n) continue;
    if (kAnyHit) {
      occ_out[i] = occ != 0;
      continue;
    }
    const float inv = 1.f / ad_b;
    prim_out[i] = prim;
    t_out[i] = prim >= 0 ? ts_b * inv : INFINITY;
    u_out[i] = us_b * inv;
    v_out[i] = vs_b * inv;
  }
}

}  // namespace

extern "C" int plt_intersect_q(const float* tri_q, int n_tris,
                               const float* anchor, const float* o,
                               const float* d, const float* maxt, int n,
                               float* t, int* prim, float* u, float* v,
                               void* stream) {
  if (n > 0) {
    q_kernel<false>
        <<<grid_for<q_kernel<false>, kBlock, kWaves>(n), kBlock, 0,
           (cudaStream_t)stream>>>(tri_q, n_tris, anchor, o, d, maxt, n, t,
                                   prim, u, v, nullptr);
  }
  return (int)cudaGetLastError();
}

extern "C" int plt_occluded_q(const float* tri_q, int n_tris,
                              const float* anchor, const float* o,
                              const float* d, const float* maxt, int n,
                              bool* occ, void* stream) {
  if (n > 0) {
    q_kernel<true>
        <<<grid_for<q_kernel<true>, kBlock, kWaves>(n), kBlock, 0,
           (cudaStream_t)stream>>>(tri_q, n_tris, anchor, o, d, maxt, n,
                                   nullptr, nullptr, nullptr, nullptr, occ);
  }
  return (int)cudaGetLastError();
}
