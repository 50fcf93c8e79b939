// Closest-hit and any-hit by classic Moller-Trumbore over the (p0, e1, e2)
// triangle soup (`tri_isect`).
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
// compares against maxt. An infinite maxt is carried as 3.4e38; a miss
// gives t = inf, prim = -1, u = v = 0.
//
// What bounds them on the H100: operations. A (ray, triangle) test is ~64
// operations against 28 bytes of ray in and 16 out per ray, so from a few
// triangles on the fp32 rate, not the memory, is the limit.
//
// Closest hit (classic_kernel). The first port ran the whole test on every
// pair, one thread a ray, the rows staged in 9-float chunks: 9 scalar LDS
// and, behind every pair, an IEEE division (a reciprocal, its refinement
// and a slow-path check) and the three products after it, ~87 issued
// instructions a test, though an icosphere ray hits ~2 of its 5,120 rows.
// Design:
//   - rows as three float4 (p0, e1, e2; w unused) in shared memory, three
//     LDS.128 broadcast reads a row: staged once a block when the table
//     fits in kChunk rows (the Cornell box's 36), else kChunk rows at a
//     time for every tile (the icosphere's 5,120 rows take 245,760 bytes,
//     above the 232,448 a block may have); blocks loop over tiles of kBlock
//     rays in a grid of at most kWaves waves of resident blocks
//     (launch.cuh's grid_for); zero rows pad a stage to whole trips of
//     kStep rows (det = 0: never a candidate);
//   - every pair computes det and the numerators of u, v and t with the
//     plain version's rounded operations (classic_terms: the same bits the
//     exact test then uses), folds det's sign into them by its sign bit and
//     keeps the pair only where the exact test could pass (`candidate`,
//     whose note gives the argument); the flags stay predicates;
//   - the candidates of a trip (a warp's vote) run the exact test as the
//     plain version writes it, in row order with the strict t < best, the
//     warp's lanes each taking their next candidate together (`take`);
//     the guarded division is written as a reciprocal ([ok] / det as 1 /
//     (ok ? det : 1) where ok, else 0: the same bits, and no zero
//     numerator sent down the division's slow path);
//   - a table of at most kDenseRows rows (the Cornell box's 36) runs the
//     exact test on every pair instead (kDense): there about 1 ray in 30
//     hits a row, so the candidates of 42% of a warp's trips on its
//     incoherent rays cost more than the division saves (3% slower than
//     the first port; every pair, 11% faster), while above it a ray's
//     candidates are a few among thousands of rows. Taking the candidates
//     from a queue only where a chunk ends, from registers, or all of a
//     trip's rows predicated, and 4 or 6 blocks an SM, were slower
//     (PERF.md section 6).
// The same template with kAudit runs every pair through the exact test and
// counts the candidates and the hits the filter would have dropped: the
// checks' reference (plt_intersect_classic_audit), which intersect_classic
// never calls.
//
// Any hit. The work the function needs is each ray's tests in table order
// up to its first hit. The first port ran one thread a ray over the staged
// chunks and left at the first hit, but a warp ran until its last lane hit
// (on the icosphere's incoherent rays nearly every warp holds a ray that
// misses and tests all 5,120 rows: 2.09x the measured bound) and a block
// staged every chunk while any of its rays was live; on the Cornell box one
// ray in a warp leaving through the open front made the warp test all 36
// rows (5.2x). The answer is an OR over rows, so any split of the rows
// among lanes gives the same bits. Design (anyhit_resident_kernel): the
// whole table resident in shared memory (up to ~6,400 rows in the 227 KB a
// block may take), staged once by one block of 1,024 threads an SM that
// stays there, and lanes that take a new ray when theirs ends (Aila and
// Laine's ray replacement, "Understanding the Efficiency of Ray Traversal
// on GPUs", HPG 2009): a tile of kLanes lanes a ray tests rows row + lane
// + s kLanes (s < kSteps), row += kLanes kSteps, and when its ray hits or
// runs out of rows it takes the block's next ray (a shared counter over
// the block's span of rays) and restarts at row 0. A lane's work then
// tends to its own rays' first-hit counts. Two widths, by the table's
// size: up to kLaneRows rows a lane a ray (its lanes read different rows,
// whose 9-float strides fall on distinct banks up to 32 rows and two to a
// bank up to 64; a warp a ray wasted most of a 32-row step on the Cornell
// box's few tests a ray, 3-6x slower), above that a warp a ray (32
// consecutive rows a step, conflict-free; a lane a ray read 32 scattered
// rows, bank conflicts that made it 1.1x slower on the icosphere). The
// table takes one block an SM, 32 warps, too few to hide a test's chain of
// dependent operations one row at a time: each lane tests kSteps rows
// between votes, written without branches so that the tests overlap (2, 4
// and 8 rows a vote: 12.3, 11.3 and 10.6 ms on the icosphere's incoherent
// rays; PERF.md section 6). Rows tested past a ray's first hit, at most
// kLanes kSteps - 1, are the kernel's cost; on the Cornell box's coherent
// rays, whose lanes in a warp hit at nearly the same row within a few
// tests, the first port had nothing to lose, and the rays' fetches and
// those rows make this kernel ~28% slower there. Tables above the
// resident size (anyhit_chunked_kernel): a warp a ray over chunks of
// kChunk rows staged by a block of 8 rays, a vote after each step of 32
// rows, and a block-wide vote that ends the chunk loop once every ray of
// the block is occluded.
#include <cuda_runtime.h>
#include <math.h>

#include "launch.cuh"  // grid_for

namespace {

constexpr int kBlock = 256;
constexpr int kChunk = 512;  // triangle rows per shared-memory stage
// the closest hit: rows a trip of its row loop, resident grids a launch's
// grid holds at most, blocks an SM the registers must allow (48 a thread;
// 4 and 6 were 2-3% slower), the largest table whose every pair takes the
// exact test
constexpr int kStep = 4, kWaves = 4, kMinBlocks = 5, kDenseRows = 64;
// The closest hit's filter (`candidate`; tests/test_torch_classic_filter.py
// reads these three): the slack on u + v <= 1 and t < best (1 + 2^-20),
// the share of |det| under which a numerator of the wrong sign may still
// give -0 (2^-148), and the best below which the bound on t is not kept
// (2^-60)
constexpr float kSlack = 0x1.00001p+0f;
constexpr float kUnderflow = 0x1p-148f;
constexpr float kTinyBest = 0x1p-60f;
constexpr float kDetEps = 1e-12f;
constexpr unsigned kSign = 0x80000000u;
constexpr int kAnyBlock = 1024;  // resident any hit: 32 warps a block
constexpr int kLaneRows = 64;    // tables up to this many rows: a lane a ray
// rows a lane tests between votes: a lane a ray, a warp a ray
constexpr int kLaneSteps = 4, kWarpSteps = 8;
constexpr unsigned kFull = 0xffffffffu;

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

struct ClassicRay {
  float ox, oy, oz, dx, dy, dz, mt;
};

__device__ __forceinline__ ClassicRay load_ray(const float* __restrict__ o,
                                               const float* __restrict__ d,
                                               const float* __restrict__ maxt,
                                               int i) {
  ClassicRay r;
  r.ox = o[3 * i + 0];
  r.oy = o[3 * i + 1];
  r.oz = o[3 * i + 2];
  r.dx = d[3 * i + 0];
  r.dy = d[3 * i + 1];
  r.dz = d[3 * i + 2];
  const float mt = maxt[i];
  r.mt = isfinite(mt) ? mt : 3.4e38f;
  return r;
}

// Moller-Trumbore on the row at p (9 floats): (t, u, v), and whether the
// ray meets the triangle at 0 < t (the bound on t is the caller's): the
// any hit's test. The closest hit's classic_terms and take run the same
// rounded operations on its float4 rows.
__device__ __forceinline__ bool triangle(const float* p, const ClassicRay& r,
                                         float& t, float& u, float& v) {
  const float e1x = p[3], e1y = p[4], e1z = p[5];
  const float e2x = p[6], e2y = p[7], e2z = p[8];
  const float pvx = sub(mul(r.dy, e2z), mul(r.dz, e2y));
  const float pvy = sub(mul(r.dz, e2x), mul(r.dx, e2z));
  const float pvz = sub(mul(r.dx, e2y), mul(r.dy, e2x));
  const float det = dot3(e1x, e1y, e1z, pvx, pvy, pvz);
  const bool ok = fabsf(det) > 1e-12f;
  const float inv_det = (ok ? 1.f : 0.f) / (ok ? det : 1.f);
  const float tvx = sub(r.ox, p[0]), tvy = sub(r.oy, p[1]),
              tvz = sub(r.oz, p[2]);
  u = mul(dot3(tvx, tvy, tvz, pvx, pvy, pvz), inv_det);
  const float qvx = sub(mul(tvy, e1z), mul(tvz, e1y));
  const float qvy = sub(mul(tvz, e1x), mul(tvx, e1z));
  const float qvz = sub(mul(tvx, e1y), mul(tvy, e1x));
  v = mul(dot3(r.dx, r.dy, r.dz, qvx, qvy, qvz), inv_det);
  t = mul(dot3(e2x, e2y, e2z, qvx, qvy, qvz), inv_det);
  // written out so that a NaN term fails
  return ok && u >= 0.f && v >= 0.f && __fadd_rn(u, v) <= 1.f && t > 0.f;
}

__device__ __forceinline__ bool occludes(const float* p,
                                         const ClassicRay& r) {
  float t, u, v;
  return triangle(p, r, t, u, v) && t < r.mt;
}

// det and the numerators of u, v and t of one (ray, row) pair
struct ClassicTerms {
  float det, un, vn, tn;
};

// The plain version's terms of the row (p0, e1, e2), every product and sum
// rounded on its own in its order: u = un / det, v = vn / det, t = tn / det.
__device__ __forceinline__ ClassicTerms classic_terms(const float4& p0,
                                                      const float4& e1,
                                                      const float4& e2,
                                                      const ClassicRay& r) {
  const float pvx = sub(mul(r.dy, e2.z), mul(r.dz, e2.y));
  const float pvy = sub(mul(r.dz, e2.x), mul(r.dx, e2.z));
  const float pvz = sub(mul(r.dx, e2.y), mul(r.dy, e2.x));
  const float tvx = sub(r.ox, p0.x), tvy = sub(r.oy, p0.y),
              tvz = sub(r.oz, p0.z);
  const float qvx = sub(mul(tvy, e1.z), mul(tvz, e1.y));
  const float qvy = sub(mul(tvz, e1.x), mul(tvx, e1.z));
  const float qvz = sub(mul(tvx, e1.y), mul(tvy, e1.x));
  return {dot3(e1.x, e1.y, e1.z, pvx, pvy, pvz),
          dot3(tvx, tvy, tvz, pvx, pvy, pvz),
          dot3(r.dx, r.dy, r.dz, qvx, qvy, qvz),
          dot3(e2.x, e2.y, e2.z, qvx, qvy, qvz)};
}

// x with its sign bit flipped where `sign` has its own set
__device__ __forceinline__ float flip(float x, unsigned sign) {
  return __uint_as_float(__float_as_uint(x) ^ (sign & kSign));
}

// The filter's bound on t from the best t_b (`candidate`): t_b (1 + 2^-20),
// infinite where 0 < t_b < 2^-60 (t_b <= 0 stays: nothing passes t > 0 and
// t < t_b).
__device__ __forceinline__ float best_bound(float t_b) {
  return t_b > 0.f && t_b < kTinyBest ? INFINITY : mul(t_b, kSlack);
}

// Whether the exact test (`take`) could accept the pair at a best whose
// bound (best_bound) is tb_s. With ad = |det| and us, vs, ts the numerators
// with det's sign folded in (a sign-bit XOR: exact), the exact test takes
// inv = RN(1/ad) (det's sign aside, RN is odd) and u = RN(us inv), v, t
// alike. It is dropped only where the exact test must fail:
//   - ad <= 1e-12: the exact test's own `ok`, the same bits; a NaN det
//     fails both;
//   - us < -lim or vs < -lim, lim = RN(ad 2^-148) (kUnderflow): the exact
//     u >= 0 accepts u = -0, where us < 0 and |us| inv <= 2^-150 rounds
//     to zero. inv >= (1/ad)(1 - 2^-22) (2^-24 where inv is normal; 2^-22
//     where it is subnormal, ad above 2^126), so that needs |us| < 2^-149
//     ad, and a nonzero |us| >= 2^-149 only underflows where inv <= 1/2,
//     ad >= 2; there lim >= ad 2^-148 - 2^-150 >= ad 2^-149. A NaN term
//     fails both tests;
//   - RN(us + vs) > RN(ad k), k = kSlack = 1 + 2^-20: the exact test needs
//     RN(u + v) <= 1, so u + v <= 1 + 2^-24; each of u, v >= 0 is at
//     least its exact product (1 - 2^-24) less 2^-150 (its subnormal
//     half-step), so us + vs <= ad (1 + 2^-24 + 2^-149) / ((1 - 2^-24)
//     (1 - 2^-22)) < ad (1 + 2^-21) <= RN(ad k) (ad > 1e-12: ad k is
//     normal, or overflows to inf and keeps every pair);
//   - ts <= 0: t = RN(ts inv) > 0 needs ts > 0 (a NaN fails both);
//   - ts > RN(ad tb_s): t < t_b needs ts inv < t_b (RN is monotone and
//     t_b a float), ts < t_b ad / (1 - 2^-22); where t_b >= 2^-60, tb_s =
//     RN(t_b k) and ad tb_s >= 2^-100 are normal (or inf), so RN(ad tb_s)
//     >= t_b ad k (1 - 2^-24)^2 > t_b ad (1 + 2^-21); where 0 < t_b <
//     2^-60, tb_s is inf; where t_b <= 0 the exact test fails. A stale
//     best, above the running one, only keeps more pairs.
// The slack's margin is four times the bounds above; the zero rows that
// pad a stage and a zero ray have det = 0.
__device__ __forceinline__ bool candidate(const ClassicTerms& q, float tb_s) {
  const unsigned sign = __float_as_uint(q.det);
  const float ad = fabsf(q.det);
  const float us = flip(q.un, sign), vs = flip(q.vn, sign),
              ts = flip(q.tn, sign);
  const float lim = mul(ad, kUnderflow);
  // joined by & (no short circuit: the flags stay predicates)
  return (ad > kDetEps) & (us >= -lim) & (vs >= -lim) &
         (__fadd_rn(us, vs) <= mul(ad, kSlack)) & (ts > 0.f) &
         (ts <= mul(ad, tb_s));
}

// a ray's best hit so far and the filter's bound on t from it
struct ClassicBest {
  float t, u, v, tb_s;
  int prim;
};

// The exact test of row k as the plain version writes it (`ok` is |det| >
// 1e-12, known where the filter passed the pair): inv_det = [ok] / det
// (1 / det where ok, else +0, as the plain 0 / 1),
// u, v, t its products, a hit where ok, u >= 0, v >= 0, u + v <= 1, t > 0
// and t < the best (strict, rows taken in order: the first of two equal
// hits wins); written out so that a NaN term fails. Returns the hit.
__device__ __forceinline__ bool take(const ClassicTerms& q, bool ok, int k,
                                     ClassicBest& b) {
  const float rcp = 1.f / (ok ? q.det : 1.f);
  const float inv_det = ok ? rcp : 0.f;
  const float u = mul(q.un, inv_det), v = mul(q.vn, inv_det),
              t = mul(q.tn, inv_det);
  const bool hit = ok && u >= 0.f && v >= 0.f && __fadd_rn(u, v) <= 1.f &&
                   t > 0.f && t < b.t;
  if (hit) b = {t, u, v, best_bound(t), k};
  return hit;
}

// Stages rows [base, base + cnt) of tri [*, 9] into s_tri as three float4
// a row (p0, e1, e2; w not written, never read), then zero rows up to the
// next whole trip of kStep rows.
__device__ __forceinline__ void stage_rows(float4* s_tri,
                                           const float* __restrict__ tri,
                                           int base, int cnt) {
  float* s = reinterpret_cast<float*>(s_tri);
  const int padded = (cnt + kStep - 1) / kStep * kStep;
  for (int k = threadIdx.x; k < 9 * padded; k += kBlock) {
    const int row = k / 9, c = k - 9 * row;
    s[12 * row + 4 * (c / 3) + c % 3] = k < 9 * cnt ? tri[9 * base + k] : 0.f;
  }
}

// The closest hit: one thread a ray, the filter on every pair and the exact
// test on the candidates, or with kDense the exact test on every pair (see
// the note at the top). With kAudit every pair takes the exact test after
// the filter, and audit[0] / audit[1] gain the candidates and the hits the
// filter dropped.
template <bool kAudit, bool kDense>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    classic_kernel(const float* __restrict__ tri, int n_tris,
                   const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ maxt, int n,
                   float* __restrict__ t_out, int* __restrict__ prim_out,
                   float* __restrict__ u_out, float* __restrict__ v_out,
                   unsigned long long* __restrict__ audit) {
  __shared__ float4 s_tri[3 * kChunk];
  const bool resident = n_tris <= kChunk;
  if (resident) {
    stage_rows(s_tri, tri, 0, n_tris);
    __syncthreads();
  }
  unsigned n_cand = 0, n_dropped = 0;  // kAudit
  const int n_tiles = (n + kBlock - 1) / kBlock;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int i = tile * kBlock + threadIdx.x;
    // a lane past n runs a zero ray (d = 0: det = 0, never a candidate)
    const ClassicRay r = i < n ? load_ray(o, d, maxt, i) : ClassicRay{};
    ClassicBest b = {r.mt, 0.f, 0.f, best_bound(r.mt), -1};
    for (int base = 0; base < n_tris; base += kChunk) {
      const int cnt = min(kChunk, n_tris - base);
      if (!resident) {
        __syncthreads();
        stage_rows(s_tri, tri, base, cnt);
        __syncthreads();
      }
      const int trips = (cnt + kStep - 1) / kStep;
#pragma unroll 1
      for (int s = 0; s < trips; ++s) {
        const float4* rows = s_tri + 3 * kStep * s;
        if (kDense) {
#pragma unroll
          for (int j = 0; j < kStep; ++j) {
            const ClassicTerms q = classic_terms(
                rows[3 * j], rows[3 * j + 1], rows[3 * j + 2], r);
            take(q, fabsf(q.det) > kDetEps, base + kStep * s + j, b);
          }
          continue;
        }
        bool c[kStep];
        bool any = false;
#pragma unroll
        for (int j = 0; j < kStep; ++j) {
          c[j] = candidate(
              classic_terms(rows[3 * j], rows[3 * j + 1], rows[3 * j + 2], r),
              b.tb_s);
          any |= c[j];
        }
        if (!__any_sync(kFull, any || kAudit)) continue;
        unsigned cand = 0;
#pragma unroll
        for (int j = 0; j < kStep; ++j) cand |= c[j] ? 1u << j : 0u;
        unsigned todo = kAudit ? (1u << kStep) - 1u : cand;
        n_cand += __popc(cand);
        // each lane's next row in order, the warp's lanes together
        while (__any_sync(kFull, todo != 0)) {
          if (!todo) continue;
          const int j = __ffs(todo) - 1;
          todo &= todo - 1;
          const float4* row = rows + 3 * j;
          const ClassicTerms q = classic_terms(row[0], row[1], row[2], r);
          const bool ok = !kAudit || fabsf(q.det) > kDetEps;
          const bool hit = take(q, ok, base + kStep * s + j, b);
          n_dropped += hit && !((cand >> j) & 1u);
        }
      }
    }
    if (i >= n) continue;
    prim_out[i] = b.prim;
    t_out[i] = b.prim >= 0 ? b.t : INFINITY;
    u_out[i] = b.u;
    v_out[i] = b.v;
  }
  if (kAudit) {
    n_cand = __reduce_add_sync(kFull, n_cand);
    n_dropped = __reduce_add_sync(kFull, n_dropped);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(audit, (unsigned long long)n_cand);
      atomicAdd(audit + 1, (unsigned long long)n_dropped);
    }
  }
}

// The any hit over a table resident in shared memory: tiles of kLanes
// lanes a ray that take the block's next ray when theirs ends (see the
// note at the top). Block b answers rays [b span, (b + 1) span).
template <int kLanes, int kSteps>
__global__ void __launch_bounds__(kAnyBlock)
    anyhit_resident_kernel(const float* __restrict__ tri, int n_tris,
                           const float* __restrict__ o,
                           const float* __restrict__ d,
                           const float* __restrict__ maxt, int n, int span,
                           bool* __restrict__ occ_out) {
  extern __shared__ float s_tri[];
  __shared__ int s_next;  // the block's next ray
  const int begin = (int)blockIdx.x * span, end = min(begin + span, n);
  for (int k = threadIdx.x; k < 9 * n_tris; k += kAnyBlock) s_tri[k] = tri[k];
  if (threadIdx.x == 0) s_next = begin;
  __syncthreads();

  constexpr unsigned kTileMask =
      kLanes == 32 ? kFull : (1u << kLanes) - 1u;
  const int wl = threadIdx.x & 31;
  const int lane = wl & (kLanes - 1);
  const int base = wl & ~(kLanes - 1);
  // the tile's ray (-1: none), its next row and the ray's terms, the same
  // on every lane of the tile; `drained`, the same on every lane of the
  // warp, once the block's span is used up
  int ray = -1, row = 0;
  bool drained = false;
  ClassicRay r = {};
  while (true) {
    if (!drained) {
      const unsigned want = __ballot_sync(kFull, ray < 0 && lane == 0);
      if (want) {
        int first = 0;
        if (wl == 0) first = atomicAdd(&s_next, __popc(want));
        first = __shfl_sync(kFull, first, 0);
        const int j = first + __popc(want & ((1u << base) - 1u));
        if (ray < 0 && j < end) {
          ray = j;
          row = 0;
          r = load_ray(o, d, maxt, j);
        }
        drained = first + __popc(want) >= end;
      }
    }
    if (!__any_sync(kFull, ray >= 0)) break;
    // every lane tests kSteps rows, without branches, so that the tests
    // overlap; a lane past the table's end or without a ray takes nothing
    // from its test
    bool hit = false;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int k = row + lane + s * kLanes;
      const bool h = occludes(s_tri + 9 * min(k, n_tris - 1), r);
      hit |= h && ray >= 0 && k < n_tris;
    }
    const bool occ = (__ballot_sync(kFull, hit) >> base) & kTileMask;
    row += kLanes * kSteps;
    if (ray >= 0 && (occ || row >= n_tris)) {
      if (lane == 0) occ_out[ray] = occ;
      ray = -1;
    }
  }
}

// The any hit over a table too large to keep resident: a warp a ray over
// staged chunks (see the note at the top).
constexpr int kChunkBlock = 256;
constexpr int kChunkRays = kChunkBlock / 32;

__global__ void __launch_bounds__(kChunkBlock)
    anyhit_chunked_kernel(const float* __restrict__ tri, int n_tris,
                          const float* __restrict__ o,
                          const float* __restrict__ d,
                          const float* __restrict__ maxt, int n,
                          bool* __restrict__ occ_out) {
  __shared__ float s_tri[kChunk * 9];
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kChunkRays + threadIdx.x / 32;
  const bool live = i < n;
  const ClassicRay r = load_ray(o, d, maxt, live ? i : n - 1);
  bool occ = false;  // the same on every lane of the warp
  // the vote is also the barrier before a chunk overwrites the last
  for (int b = 0; b < n_tris && __syncthreads_or(live && !occ);
       b += kChunk) {
    const int cnt = min(kChunk, n_tris - b);
    for (int k = threadIdx.x; k < cnt * 9; k += kChunkBlock)
      s_tri[k] = tri[b * 9 + k];
    __syncthreads();
    if (!live || occ) continue;
    for (int j = lane; j - lane < cnt; j += 32) {
      if (__ballot_sync(kFull, j < cnt && occludes(s_tri + 9 * j, r))) {
        occ = true;
        break;
      }
    }
  }
  if (live && lane == 0) occ_out[i] = occ;
}

// The resident any hit, one block an SM (the table takes most of an SM's
// shared memory, or the rays of one block fill an SM's lanes), no more
// blocks than the rays fill. The SM count is asked of the runtime at the
// first call on a device; the kernel's dynamic shared memory limit is set
// to the table's size at the first call on a device and for a new size.
template <int kLanes, int kSteps>
cudaError_t launch_resident(const float* tri, int n_tris, const float* o,
                            const float* d, const float* maxt, int n,
                            bool* occ, cudaStream_t stream) {
  static int cached_dev = -1, cached_smem = -1, sms = 0;
  const int smem = 9 * (int)sizeof(float) * n_tris;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev != cached_dev)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && (dev != cached_dev || smem != cached_smem))
    err = cudaFuncSetAttribute(anyhit_resident_kernel<kLanes, kSteps>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return err;
  cached_dev = dev;
  cached_smem = smem;
  const int grid =
      min(sms, (n + kAnyBlock / kLanes - 1) / (kAnyBlock / kLanes));
  const int span = (n + grid - 1) / grid;
  anyhit_resident_kernel<kLanes, kSteps><<<grid, kAnyBlock, smem, stream>>>(
      tri, n_tris, o, d, maxt, n, span, occ);
  return cudaGetLastError();
}

// Rows of the largest table kept resident on the current device.
cudaError_t resident_rows(int& rows) {
  int dev, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr,
                                anyhit_resident_kernel<32, kWarpSteps>);
  rows = (optin - (int)attr.sharedSizeBytes) / (9 * (int)sizeof(float));
  return err;
}

}  // namespace

extern "C" int plt_intersect_classic(const float* tri, int n_tris,
                                     const float* o, const float* d,
                                     const float* maxt, int n, float* t,
                                     int* prim, float* u, float* v,
                                     void* stream) {
  if (n > 0) {
    if (n_tris <= kDenseRows)
      classic_kernel<false, true>
          <<<grid_for<classic_kernel<false, true>, kBlock, kWaves>(n), kBlock,
             0, (cudaStream_t)stream>>>(tri, n_tris, o, d, maxt, n, t, prim, u,
                                        v, nullptr);
    else
      classic_kernel<false, false>
          <<<grid_for<classic_kernel<false, false>, kBlock, kWaves>(n),
             kBlock, 0, (cudaStream_t)stream>>>(tri, n_tris, o, d, maxt, n, t,
                                                prim, u, v, nullptr);
  }
  return (int)cudaGetLastError();
}

// The closest hit with every pair through the exact test (kAudit): the
// same outputs, and counts[0] / counts[1] (zeroed by the caller) gain the
// pairs the filter keeps and the hits it would have dropped.
extern "C" int plt_intersect_classic_audit(const float* tri, int n_tris,
                                           const float* o, const float* d,
                                           const float* maxt, int n,
                                           float* t, int* prim, float* u,
                                           float* v,
                                           unsigned long long* counts,
                                           void* stream) {
  if (n > 0) {
    classic_kernel<true, false>
        <<<grid_for<classic_kernel<true, false>, kBlock, kWaves>(n), kBlock, 0,
           (cudaStream_t)stream>>>(tri, n_tris, o, d, maxt, n, t, prim, u, v,
                                   counts);
  }
  return (int)cudaGetLastError();
}

// The any hit; the kernel by the table's size: up to kLaneRows rows a lane
// a ray, up to the resident size a warp a ray, above it the chunked warps.
extern "C" int plt_occluded_classic(const float* tri, int n_tris,
                                    const float* o, const float* d,
                                    const float* maxt, int n, bool* occ,
                                    void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (n_tris > 0 && n_tris <= kLaneRows)
    return (int)launch_resident<1, kLaneSteps>(tri, n_tris, o, d, maxt, n,
                                               occ, s);
  int rows = 0;
  const cudaError_t err = resident_rows(rows);
  if (err != cudaSuccess) return (int)err;
  if (n_tris > 0 && n_tris <= rows)
    return (int)launch_resident<32, kWarpSteps>(tri, n_tris, o, d, maxt, n,
                                                occ, s);
  const int grid = (n + kChunkRays - 1) / kChunkRays;
  anyhit_chunked_kernel<<<grid, kChunkBlock, 0, s>>>(tri, n_tris, o, d, maxt,
                                                     n, occ);
  return (int)cudaGetLastError();
}
