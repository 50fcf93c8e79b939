// Closest hit with Moller-Trumbore's four quantities as dot products of a
// per-ray feature vector with per-triangle weight rows: a product on the
// tensor cores (3xTF32) finds the few (ray, triangle) pairs that could
// hit, and each of those is tested again in FP32 as before.
//
// Replaces: mitsuba3_plt_tpu/ops/intersect_pallas.py::pallas_intersect_mxu
// (Pallas body _mxu_kernel), whose table comes from pack_tri_mxu.
//
// Function: det, u' = u det, v' = v det and t' = t det are affine in the
// ray features phi = (d, o, dx o, dy o, dz o, 1) (16 terms, each product
// rounded), so a triangle is four rows of W [4 T_pad, 16], grouped [det |
// u' | v' | t'] with T_pad rows each (zero rows pad T_pad to a multiple of
// 128). The TPU kernel takes the whole soup as one f32 product on the MXU,
// U = W phi^T [4 T_pad, B], then the sign logic and an argmin. The result
// here is the FP32 test of the first port of this kernel, bit for bit:
// each of the four quantities a 16-term fmaf chain in term order (dot16),
//   sd = sign(det) (+1 at 0), us, vs, ts = sd (u', v', t'),
//   inv = [|det| > 1e-12] / |det|, t = ts inv,
//   hit = ok & us >= 0 & vs >= 0 & us + vs <= |det| & ts > 0 & t < maxt,
// over the first n_tris triangles, keeping the smallest t with the lowest
// triangle index on ties (argmin's rule), and u = us inv, v = vs inv of
// that triangle. A lane with no hit gives t = inf, prim = -1, u = v = 0;
// an infinite maxt is carried as 3.4e38. Not equal to the bit to the TPU
// kernel or to the plain version: the MXU's HIGHEST precision, cuBLAS and
// these FMAs each round the product their own way.
//
// What bounds it on the H100: the product, 4 x 16 multiply-adds a (ray,
// triangle) pair, against ~30 other operations, 28 bytes of ray in and 16
// out. On the CUDA cores that is 158 operations a pair at 67 TFLOP/s (12.66
// ms on the 5,120-face icosphere's 2^20 rays; the first port took 28.1).
// In this design the tensor cores (495 TFLOP/s dense TF32) take u' and v'
// in 3xTF32, 192 FLOP a pair, and the CUDA cores det and the filter, 25
// operations a pair, and the FP32 test of each candidate: each side ~2.1
// ms on the icosphere (`chip_smoke.py::tc_bound`).
//
// Design. Rays are the M dimension: a warp holds kRayTiles tiles of 16
// rays, builds their phi once a tile of rays, splits it into TF32 big +
// small parts (cvt.rna; small = x - big is exact) and keeps the A
// fragments in registers over the whole table. Only u' and v' go through
// the tensor cores (mma.sync m16n8k8 TF32): one n8 tile holds u' and v'
// of four triangles (columns 2j, 2j + 1 for triangle j), so the thread
// holding rays g and g + 8 receives both of triangle j = its lane % 4. det's
// row has three non-zero terms (-n2 . d), so det is computed in FP32 on
// the CUDA cores, exactly as dot16 computes it (the zero terms add +-0);
// the filter reads no t'. K = 16 is two k-steps; 3xTF32 is small.big +
// big.small + big.big (the small.small term dropped): 6 HMMA a warp a step
// of 16 rays x 4 triangles (a first layout, det and u' in one n8 tile and
// v', t' in another, took 12: PERF.md). The table is staged through shared
// memory in chunks of kChunkTris triangles, a row a thread, split into big
// and small as it is staged and laid out so that a thread's B fragments of
// a step are two conflict-free LDS.128; the next chunk's rows wait in
// registers while the current one is computed. A table of one chunk is
// staged once a block. Blocks loop over tiles of kTileRays rays in one
// wave, so re-reading the table (0.98
// MB of u', v' and det rows a tile on the 5,120-face icosphere) is under a
// byte a pair.
//
// Where it stands (one H100 80GB HBM3 at 700 W, `chip_smoke.py --turns`,
// PERF.md): 9.4 ms on the icosphere's 2^20 rays (the first port 28.1),
// 0.18-0.19 on the Cornell box's (0.21). A trip of the row loop (32 rays
// x 4 triangles) issues 87 instructions, 12 of them HMMA
// (`ops/mfu.py::loop_trip`): the HMMA run at ~22% of the dense TF32 peak
// and the trip's instructions at ~40% of the FMA roof's issue rate, at 128
// registers and 16 warps an SM, so neither pipe is full (likely: a step's
// filter waits on its 6-deep HMMA chain, and a block's warps keep in step
// between the chunks' barriers). The variants timed beside it are in
// PERF.md; wgmma is the next design.
//
// The filter. A pair is a candidate unless det or the 3xTF32 values U, V
// fail the hit test by more than a rigorous bound on the error of U, V
// against the FP32 chain (dot16). With us, vs = U, V with det's sign bit
// folded in and scale = max_k |phi_k| of the ray, a pair is dropped where
//   |det| <= 1e-12,  or  us + S1 scale < 0,  or  vs + S2 scale < 0,
//   or  us + vs > |det| + S3 scale,
// S1 = eps |w_u|_1, S2 = eps |w_v|_1, S3 = 1.25 (S1 + S2), eps = kSlack =
// 2^-13, per triangle, computed at the stage. The error of U or V,
// |3xTF32 - dot16| <= e |w|_1 scale, sums: the TF32 rounding of the small
// parts and the dropped small.small term (3 x 2^-22), the tensor core's
// FP32 accumulation of 48 products, taken as 2 units in the last place of
// the running sum a product (48 x 2^-22, truncation included), and dot16's
// own 16 roundings (2^-20): e ~ 1.3e-5, under a tenth of eps, whose margin
// also covers the filter's own roundings and us + vs <= |det| (1 + 2^-24)
// where fl(us + vs) <= |det|. A ray whose o, d are not finite or whose
// scale is above 1e18 takes scale NaN; a triangle whose norms are not
// finite or above 1e18, or whose det row has a term past the third, NaN
// for det's terms and slacks: each comparison then fails and the pair is
// a candidate. A triangle past n_tris or whose det row is zero (det = 0
// for every finite ray: never a hit) is staged with det's terms 0, which
// every ray drops; a lane past n has d = 0, so det = 0 too.
//
// Candidates (about 1.8 a ray on the icosphere's incoherent rays, 2.6 on
// its coherent ones and 2.1-2.3 on the Cornell box's: `chip_smoke.py`'s
// kernels phase) go to a ring of entries in
// shared memory a warp, and each time it holds 32 the warp's lanes take
// one each through the first port's test, reading the triangle's rows
// from device memory; a hit lowers its ray's key (t, triangle) in shared
// memory by a 64-bit atomicMin, which keeps the smallest t with the lowest
// index. (A first design tested each candidate in the lane that found it,
// one or two lanes of a warp at a time, and spilled: PERF.md.) At the end
// of a tile of rays the rest are tested, and each lane takes u, v again
// from its ray's winner.
// The same template with the filter off (kFilter false) sends every pair
// through the ring and counts the candidates and the hits the filter
// would have dropped: the checks' reference, which intersect_mxu never
// calls.
#include <cuda_runtime.h>
#include <math.h>

#include "launch.cuh"  // grid_for

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRayTiles = 2;                         // m16 tiles a warp
constexpr int kWarpRays = 16 * kRayTiles;            // rays a warp
constexpr int kTileRays = kWarps * kWarpRays;        // rays a block tile
constexpr int kChunkTris = kThreads / 4;             // a row a thread
constexpr int kChunkGroups = kChunkTris / 4;         // steps a chunk
constexpr int kRing = 256;  // candidate entries a warp: 31 + 4 x 32 fit
constexpr float kSlack = 0x1p-13f;
constexpr float kWild = 1e18f;  // above this scale or norm, no filter
constexpr float kBig = 3.4e38f;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kSign = 0x80000000u;
constexpr unsigned long long kNoHit = ~0ull;

static_assert(kWarpRays == 32, "a lane a ray at the end of a tile");
static_assert(kTileRays == kThreads, "grid_for's tile: a ray a thread");

__device__ __forceinline__ unsigned tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small exactly, big TF32; small rounded to TF32 in turn
__device__ __forceinline__ void split(float x, unsigned& big,
                                      unsigned& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// c += a b on the tensor cores: a 16x8 TF32 A fragment, an 8x8 B fragment
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
        "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// one k-step of 3xTF32; b: (big b0, big b1, small b0, small b1)
__device__ __forceinline__ void mma3(float (&c)[4], const unsigned (&big)[4],
                                     const unsigned (&small)[4],
                                     const float4& b) {
  mma(c, small, b.x, b.y);
  mma(c, big, b.z, b.w);
  mma(c, big, b.x, b.y);
}

// phi of ray i
__device__ __forceinline__ void features(const float* __restrict__ o,
                                         const float* __restrict__ d, int i,
                                         float (&phi)[16]) {
  const float dd[3] = {d[3 * i + 0], d[3 * i + 1], d[3 * i + 2]};
  const float oo[3] = {o[3 * i + 0], o[3 * i + 1], o[3 * i + 2]};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    phi[a] = dd[a];
    phi[3 + a] = oo[a];
#pragma unroll
    for (int b = 0; b < 3; ++b) phi[6 + 3 * a + b] = __fmul_rn(dd[a], oo[b]);
  }
  phi[15] = 1.f;
}

// phi[k] for a k known only at run time, without indexing the registers
__device__ __forceinline__ float pick(const float (&phi)[16], int k) {
  float r = 0.f;
#pragma unroll
  for (int c = 0; c < 16; ++c) r = c == k ? phi[c] : r;
  return r;
}

// the first port's dot product: 16 fmaf in term order over a table row
__device__ __forceinline__ float dot16(const float* __restrict__ row,
                                       const float (&phi)[16]) {
  const float4* r = reinterpret_cast<const float4*>(row);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float4 v = __ldg(r + c);
    acc = fmaf(v.x, phi[4 * c + 0], acc);
    acc = fmaf(v.y, phi[4 * c + 1], acc);
    acc = fmaf(v.z, phi[4 * c + 2], acc);
    acc = fmaf(v.w, phi[4 * c + 3], acc);
  }
  return acc;
}

struct Test {
  bool hit;
  float t, us, vs, inv;
};

// the first port's FP32 test of triangle j for a ray with features phi
__device__ __forceinline__ Test exact_test(const float* __restrict__ w,
                                           int t_pad, int j,
                                           const float (&phi)[16],
                                           float t_max) {
  const float det = dot16(w + (size_t)j * 16, phi);
  const float up = dot16(w + ((size_t)t_pad + j) * 16, phi);
  const float vp = dot16(w + ((size_t)2 * t_pad + j) * 16, phi);
  const float tp = dot16(w + ((size_t)3 * t_pad + j) * 16, phi);
  const bool ok = fabsf(det) > 1e-12f;
  const float sd = det >= 0.f ? 1.f : -1.f;
  const float adet = fabsf(det);
  Test x;
  x.us = up * sd;
  x.vs = vp * sd;
  const float ts = tp * sd;
  x.inv = (ok ? 1.f : 0.f) / (ok ? adet : 1.f);
  x.t = __fmul_rn(ts, x.inv);
  // written out so that a NaN term fails
  x.hit = ok && x.us >= 0.f && x.vs >= 0.f && __fadd_rn(x.us, x.vs) <= adet &&
          ts > 0.f && x.t < t_max;
  return x;
}

__device__ __forceinline__ float elem(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// thread t's row of the chunk at triangle `base`: row t % 4 (det, u', v')
// of triangle base + t / 4, zeros past n_tris and for t' (not read)
__device__ __forceinline__ void fetch(float4 (&pre)[4],
                                      const float* __restrict__ w, int t_pad,
                                      int n_tris, int base) {
  const int j = base + (threadIdx.x >> 2), q = threadIdx.x & 3;
  const float4* r =
      reinterpret_cast<const float4*>(w + ((size_t)q * t_pad + j) * 16);
#pragma unroll
  for (int c = 0; c < 4; ++c)
    pre[c] = j < n_tris && q < 3 ? __ldg(r + c)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
}

// Stages the fetched chunk: s_b[(G * 2 + kstep) * 32 + lane] holds lane's
// B fragment (big b0, big b1, small b0, small b1) of step G, s_d[triangle]
// det's three terms and s_n[triangle] the slacks (S1, S2, S3).
__device__ __forceinline__ void stage(float4* s_b, float4* s_d, float4* s_n,
                                      const float4 (&pre)[4], int base,
                                      int n_tris) {
  const int jl = threadIdx.x >> 2, q = threadIdx.x & 3;
  const int lead = threadIdx.x & 28;  // the quad's det row, in the warp
  // |row|_1, and (for det's row) its terms past the third, zero in
  // pack_tri_mxu's table
  float rest = 0.f;
#pragma unroll
  for (int k = 3; k < 16; ++k) rest += fabsf(elem(pre[k >> 2], k & 3));
  const float norm = fabsf(pre[0].x) + fabsf(pre[0].y) + fabsf(pre[0].z) +
                     rest;
  const float n_det = __shfl_sync(kFull, norm, lead);
  const float n_u = __shfl_sync(kFull, norm, lead + 1);
  const float n_v = __shfl_sync(kFull, norm, lead + 2);
  const bool pad = base + jl >= n_tris || n_det == 0.f;
  if (q == 1 || q == 2) {
    float4* out = s_b + (jl >> 2) * 64 + (2 * (jl & 3) + q - 1) * 4;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int tg = 0; tg < 4; ++tg) {
        unsigned lb, ls, hb, hs;
        split(pad ? 0.f : elem(pre[2 * s], tg), lb, ls);
        split(pad ? 0.f : elem(pre[2 * s + 1], tg), hb, hs);
        out[s * 32 + tg] =
            make_float4(__uint_as_float(lb), __uint_as_float(hb),
                        __uint_as_float(ls), __uint_as_float(hs));
      }
    }
  } else if (q == 0) {
    const bool wild = !(n_det + n_u + n_v <= kWild) || rest != 0.f;
    const float s1 = kSlack * n_u, s2 = kSlack * n_v;
    s_d[jl] = pad    ? make_float4(0.f, 0.f, 0.f, 0.f)
              : wild ? make_float4(NAN, NAN, NAN, 0.f)
                     : make_float4(pre[0].x, pre[0].y, pre[0].z, 0.f);
    s_n[jl] = wild && !pad ? make_float4(NAN, NAN, NAN, 0.f)
                           : make_float4(s1, s2, 1.25f * (s1 + s2), 0.f);
  }
}

// Tests the ring's entries [head, head + cnt) (cnt <= 32), a lane each:
// an entry is (triangle j << 6) | (kept by the filter << 5) | the ray's
// place r in the warp. A hit lowers the ray's key (t, j). Returns the
// lane's hits the filter did not keep (filter off; else 0).
template <bool kFilter>
__device__ __forceinline__ int drain(const int* ring, unsigned head,
                                     unsigned cnt, int ray0,
                                     const float* __restrict__ w, int t_pad,
                                     int n_tris, const float* __restrict__ o,
                                     const float* __restrict__ d,
                                     const float* __restrict__ maxt, int n,
                                     unsigned long long* best) {
  const int lane = threadIdx.x & 31;
  int dropped = 0;
  __syncwarp();
  if ((unsigned)lane < cnt) {
    const int e = ring[(head + lane) & (kRing - 1)];
    const int r = e & 31, j = e >> 6, i = ray0 + r;
    if (i < n && j < n_tris) {
      float phi[16];
      features(o, d, i, phi);
      const float mt = maxt[i];
      const Test x = exact_test(w, t_pad, j, phi, isfinite(mt) ? mt : kBig);
      if (x.hit)
        atomicMin(best + r, (unsigned long long)__float_as_uint(x.t) << 32 |
                                (unsigned)j);
      dropped = !kFilter && x.hit && !(e & 32);
    }
  }
  __syncwarp();
  return dropped;
}

template <bool kFilter>
__global__ void __launch_bounds__(kThreads, 2)  // 128 registers, 16 warps
    mxu_kernel(const float* __restrict__ w, int t_pad, int n_tris,
               const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ maxt, int n,
               float* __restrict__ t_out, int* __restrict__ prim_out,
               float* __restrict__ u_out, float* __restrict__ v_out,
               unsigned long long* __restrict__ counts) {
  __shared__ float4 s_b[kChunkGroups * 2 * 32];
  __shared__ float4 s_d[kChunkTris], s_n[kChunkTris];
  __shared__ int s_ring[kWarps][kRing];
  __shared__ unsigned long long s_best[kWarps][kWarpRays];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const unsigned below = (1u << lane) - 1;
  int* ring = s_ring[warp];
  unsigned long long* best = s_best[warp];
  const int n_groups = (n_tris + 3) / 4;
  const int n_chunks = (n_groups + kChunkGroups - 1) / kChunkGroups;
  const bool resident = n_chunks <= 1;
  const int n_tiles = (n + kTileRays - 1) / kTileRays;
  float4 pre[4];
  if (n_chunks > 0) fetch(pre, w, t_pad, n_tris, 0);
  if (resident && n_chunks > 0) {
    stage(s_b, s_d, s_n, pre, 0, n_tris);
    __syncthreads();
  }
  best[lane] = kNoHit;
  unsigned long long n_cand = 0, n_dropped = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    // slot (m, h): the warp's ray r = 16 m + 8 h + g, row g + 8 h of its
    // m-tile
    const int ray0 = tile * kTileRays + warp * kWarpRays;
    unsigned a_big[kRayTiles][2][4], a_small[kRayTiles][2][4];
    float scale[kRayTiles][2], dir[kRayTiles][2][3];
#pragma unroll
    for (int m = 0; m < kRayTiles; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = ray0 + 16 * m + 8 * h + g;
        float phi[16];
        if (i < n) {
          features(o, d, i, phi);
          float mx = 0.f;
          bool finite = true;
#pragma unroll
          for (int k = 0; k < 6; ++k) finite = finite && isfinite(phi[k]);
#pragma unroll
          for (int k = 0; k < 16; ++k) mx = fmaxf(mx, fabsf(phi[k]));
          scale[m][h] = finite && mx <= kWild ? mx : NAN;
        } else {  // d = 0: det = 0, never a candidate
#pragma unroll
          for (int k = 0; k < 16; ++k) phi[k] = 0.f;
          scale[m][h] = 0.f;
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) dir[m][h][k] = phi[k];
        // A fragment: a0 / a1 row g / g + 8 at column tig, a2 / a3 at
        // column tig + 4, of each k-step
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          split(pick(phi, 8 * s + tig), a_big[m][s][h], a_small[m][s][h]);
          split(pick(phi, 8 * s + tig + 4), a_big[m][s][2 + h],
                a_small[m][s][2 + h]);
        }
      }
    }
    unsigned head = 0, tail = 0;  // the ring's, the same in every lane
    for (int c = 0; c < n_chunks; ++c) {
      if (!resident) {
        __syncthreads();
        stage(s_b, s_d, s_n, pre, c * kChunkTris, n_tris);
        __syncthreads();
        // the next chunk, or this block's next tile's first
        const bool more = c + 1 < n_chunks;
        if (more || tile + gridDim.x < n_tiles)
          fetch(pre, w, t_pad, n_tris, more ? (c + 1) * kChunkTris : 0);
      }
      const int groups = min(kChunkGroups, n_groups - c * kChunkGroups);
#pragma unroll 1
      for (int G = 0; G < groups; ++G) {
        const int j = (c * kChunkGroups + G) * 4 + tig;
        const float4 b0 = s_b[G * 64 + lane], b1 = s_b[G * 64 + 32 + lane];
        const float4 dw = s_d[G * 4 + tig], sn = s_n[G * 4 + tig];
        bool keep[kRayTiles][2];
        bool any = !kFilter;
#pragma unroll
        for (int m = 0; m < kRayTiles; ++m) {
          float uv[4] = {0.f, 0.f, 0.f, 0.f};
          mma3(uv, a_big[m][0], a_small[m][0], b0);
          mma3(uv, a_big[m][1], a_small[m][1], b1);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // det as dot16 takes it: its terms past the third are zero
            const float det =
                fmaf(dw.z, dir[m][h][2],
                     fmaf(dw.y, dir[m][h][1], fmaf(dw.x, dir[m][h][0], 0.f)));
            const float ad = fabsf(det), sc = scale[m][h];
            const unsigned neg = __float_as_uint(det) & kSign;
            const float us = __uint_as_float(__float_as_uint(uv[2 * h]) ^ neg);
            const float vs =
                __uint_as_float(__float_as_uint(uv[2 * h + 1]) ^ neg);
            // comparisons that a NaN fails, so that it keeps the pair
            keep[m][h] = !((ad <= 1e-12f) | (fmaf(sn.x, sc, us) < 0.f) |
                           (fmaf(sn.y, sc, vs) < 0.f) |
                           (us + vs > fmaf(sn.z, sc, ad)));
            any = any || keep[m][h];
          }
        }
        if (!__any_sync(kFull, any)) continue;
        // append the candidates (every pair, filter off) to the ring
#pragma unroll
        for (int m = 0; m < kRayTiles; ++m) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const bool put = kFilter ? keep[m][h] : j < n_tris;
            const unsigned ballot = __ballot_sync(kFull, put);
            if (put)
              ring[(tail + __popc(ballot & below)) & (kRing - 1)] =
                  j << 6 | keep[m][h] << 5 | (16 * m + 8 * h + g);
            tail += __popc(ballot);
            if (!kFilter) n_cand += put && keep[m][h] && ray0 + 16 * m +
                                    8 * h + g < n;
          }
        }
        for (; tail - head >= 32; head += 32)
          n_dropped += drain<kFilter>(ring, head, 32, ray0, w, t_pad, n_tris,
                                      o, d, maxt, n, best);
      }
    }
    n_dropped += drain<kFilter>(ring, head, tail - head, ray0, w, t_pad,
                                n_tris, o, d, maxt, n, best);
    // a lane a ray: its key, and u, v again from the winner
    const int i = ray0 + lane;
    const unsigned long long key = best[lane];
    best[lane] = kNoHit;
    if (i < n) {
      const int p = key == kNoHit ? -1 : (int)(unsigned)key;
      float u = 0.f, v = 0.f;
      if (p >= 0) {
        float phi[16];
        features(o, d, i, phi);
        const Test x = exact_test(w, t_pad, p, phi, kBig);
        u = __fmul_rn(x.us, x.inv);
        v = __fmul_rn(x.vs, x.inv);
      }
      prim_out[i] = p;
      t_out[i] = p >= 0 ? __uint_as_float((unsigned)(key >> 32)) : INFINITY;
      u_out[i] = u;
      v_out[i] = v;
    }
    __syncwarp();
  }
  if (!kFilter) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      n_cand += __shfl_xor_sync(kFull, n_cand, off);
      n_dropped += __shfl_xor_sync(kFull, n_dropped, off);
    }
    if (lane == 0) {
      atomicAdd(counts, n_cand);
      atomicAdd(counts + 1, n_dropped);
    }
  }
}

template <bool kFilter>
int launch(const float* w, int t_pad, int n_tris, const float* o,
           const float* d, const float* maxt, int n, float* t, int* prim,
           float* u, float* v, unsigned long long* counts, void* stream) {
  if (n > 0) {
    // one wave of resident blocks: tiles cost the same
    mxu_kernel<kFilter>
        <<<grid_for<mxu_kernel<kFilter>, kThreads, 1>(n), kThreads, 0,
           (cudaStream_t)stream>>>(w, t_pad, n_tris, o, d, maxt, n, t, prim,
                                   u, v, counts);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// w 16-byte aligned
extern "C" int plt_intersect_mxu(const float* w, int t_pad, int n_tris,
                                 const float* o, const float* d,
                                 const float* maxt, int n,
                                 float* t, int* prim, float* u, float* v,
                                 void* stream) {
  return launch<true>(w, t_pad, n_tris, o, d, maxt, n, t, prim, u, v,
                      nullptr, stream);
}

// The filter-off reference: every pair tested in FP32; counts[0] += the
// pairs the filter keeps, counts[1] += the hits it would have dropped
// (counts: two zeroed unsigned 64-bit integers)
extern "C" int plt_intersect_mxu_unfiltered(
    const float* w, int t_pad, int n_tris, const float* o, const float* d,
    const float* maxt, int n, float* t, int* prim, float* u, float* v,
    unsigned long long* counts, void* stream) {
  return launch<false>(w, t_pad, n_tris, o, d, maxt, n, t, prim, u, v,
                       counts, stream);
}
