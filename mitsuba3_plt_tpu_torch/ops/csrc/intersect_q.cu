// Closest-hit and any-hit ray/triangle tests over the precomputed-quantities
// ("q") triangle table: one ray a thread, the table staged once a block in
// shared memory, blocks looping over tiles of rays.
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

#include <algorithm>

namespace {

constexpr int kBlock = 256;
constexpr int kMinBlocks = 4;  // blocks an SM the registers must allow
constexpr int kStep = 4;       // rows a trip of the row loop
constexpr int kChunk = 512;    // rows a shared-memory stage (32 KB)
constexpr int kWaves = 4;      // resident grids a launch's grid holds at most
constexpr unsigned kSign = 0x80000000u;

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
// up to the next multiple of kStep.
__device__ __forceinline__ void stage(float4* s_tri,
                                      const float* __restrict__ tri_q,
                                      int base, int cnt) {
  float* s = reinterpret_cast<float*>(s_tri);
  const int padded = (cnt + kStep - 1) / kStep * kStep;
  for (int k = threadIdx.x; k < padded * 16; k += kBlock)
    s[k] = k < cnt * 16 ? tri_q[base * 16 + k] : 0.f;
}

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
    stage(s_tri, tri_q, 0, n_tris);
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
        stage(s_tri, tri_q, base, cnt);
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

// Blocks a launch of q_kernel<kAnyHit> runs for n rays: every tile, or at
// most kWaves grids of the blocks the card holds at once (per device, read
// once).
template <bool kAnyHit>
int grid_for(int n) {
  static int resident[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  int& cap = resident[dev & 63];
  if (cap == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, q_kernel<kAnyHit>,
                                                  kBlock, 0);
    cap = std::max(1, sms * per_sm);
  }
  const int tiles = (n + kBlock - 1) / kBlock;
  return std::min(tiles, kWaves * cap);
}

}  // namespace

extern "C" int plt_intersect_q(const float* tri_q, int n_tris,
                               const float* anchor, const float* o,
                               const float* d, const float* maxt, int n,
                               float* t, int* prim, float* u, float* v,
                               void* stream) {
  if (n > 0) {
    q_kernel<false><<<grid_for<false>(n), kBlock, 0, (cudaStream_t)stream>>>(
        tri_q, n_tris, anchor, o, d, maxt, n, t, prim, u, v, nullptr);
  }
  return (int)cudaGetLastError();
}

extern "C" int plt_occluded_q(const float* tri_q, int n_tris,
                              const float* anchor, const float* o,
                              const float* d, const float* maxt, int n,
                              bool* occ, void* stream) {
  if (n > 0) {
    q_kernel<true><<<grid_for<true>(n), kBlock, 0, (cudaStream_t)stream>>>(
        tri_q, n_tris, anchor, o, d, maxt, n, nullptr, nullptr, nullptr,
        nullptr, occ);
  }
  return (int)cudaGetLastError();
}
