// Closest-hit and any-hit over the flat treelet tables (ClusterTable) of
// mid-size scenes, one thread per ray walking the boxes; each runs a
// cluster that few lanes of a warp enter with a tile of lanes per ray.
//
// Replaces: mitsuba3_plt_tpu/ops/intersect_pallas.py::pallas_intersect_clu
// (Pallas body _clu_kernel) and ::pallas_occluded_clu (body
// _clu_anyhit_kernel).
//
// Tables (scene/bvh.py::pack_clusters, all relative to the anchor):
//   boxes [K, 16]: lo(3) hi(3) first_row trips; the cluster's triangles are
//                  rows [first_row, first_row + 8 trips)
//   rows  [R, 32]: one triangle a row: e1 e2 m1 m2 n2 k, then the face
//                  index as a float in column 16 (-1 on padding rows, whose
//                  n2 = 0 never hits).
// Walk (both, the plain version's): every box in table order; a ray enters
// a box when its slab test passes (near <= far, far > 0) and its gate
// holds (closest hit near * ad_b < ts_b against its best so far; any hit
// near < maxt and not yet occluded), then tests the box's rows in order.
// Each ray's answer is that of its own walk, to the bit. (The TPU kernel
// lets every lane of an 8,192-ray tile take the rows that any lane of the
// tile needs; the two differ only where a lane's own slab test fails by
// rounding on a box that holds its hit.)
//
// Triangle math is that of intersect_clu2.cu: every product and sum
// rounded on its own in the plain version's order (no FMA contraction).
// The closest hit keeps (t|det|, |det|), accepts on the strict
// cross-multiplied compare, so the first of two tied rows in table order
// wins, and divides once at the end. The inverse direction goes through
// signed_eps (|d| >= 1e-12); an infinite maxt is carried as 3.4e38.
//
// What bounds them on the H100: operations. On the 5,120-face icosphere a
// ray makes 128 slab tests and, on rays from inside it, ~80 triangle tests
// of its own (~29 and ~55 operations each) against 28 bytes of ray in and
// 16 out; the tables (~0.7 MB) stay in L2. Boxes and rows are read through
// the read-only path, a box as a warp-uniform broadcast load.
//
// Closest hit (clu_closest_kernel). The first port ran a cluster's rows for
// the whole warp, one lane a ray, when any lane entered it, so on
// incoherent rays a warp paid for the union of 32 walks: 18.9x its measured
// bound on the icosphere's interior rays (PERF.md). A tile of 8 lanes a ray
// over the whole walk cut that 2.8x but ran the coherent sets 3.7-6x
// slower: a warp then holds 4 rays, and every box and row it loads serves
// 4 rays where it served 32. Design: each lane walks its own ray's boxes
// (slab test and gate, one thread a ray), and per entered cluster the warp
// counts its entrants. Above kTileRays, every lane runs the cluster's rows
// for its own ray (broadcast loads, as before). At or below, the entrants
// are taken kRaysPerRound at a time, one to each tile of kTile lanes: the
// tile takes the entrant's ray terms and best from its lane by shuffles,
// tests the cluster's rows kTile at a time (a trip a step, one row a
// lane), applies the step's inside rows one by one in row order with the
// strict cross-multiplied compare (one shuffle of ts, ad, us, vs a row),
// so the first of two tied rows wins as in the sequential walk, and hands
// the best back. A tree reduction would not give these bits: the rounded
// compare is not transitive. All loops and shuffles are warp-uniform,
// with per-tile masks. The best keeps its row; the face index is read
// once at the end. kTileRays = 8 was the fastest of 4, 8, 16, 24 and 32 on
// the mask-sort tool's sets (PERF.md section 6). What bounds it now, on
// the icosphere's incoherent rays: the rows' bytes. A warp still enters
// ~44 clusters (78% of them by one lane; the plain walk's counts) and
// reads each one's rows from L2, ~5 GB a launch at ~3.1 TB/s; a tile of
// the whole warp for a lone entrant cut its row steps 4x and moved
// nothing.
//
// Any hit (clu_anyhit_kernel). The first port ran a cluster's rows for the
// whole warp, one lane a ray, when any of its lanes entered, so a warp paid
// for the union of 32 walks: 2.26x its measured bound on the icosphere's
// shadow rays (PERF.md). Design, the closest hit's per-cluster choice: each
// lane walks its own ray's boxes (slab test and gate); per entered cluster
// the warp counts its entrants (the gate keeps occluded rays out). Above
// kTileRays every lane runs the cluster's rows for its own ray (broadcast
// loads) and the warp leaves the cluster after a trip where no entrant is
// left unoccluded. At or below, the entrants go kRaysPerRound a round, one
// to each tile of kTile lanes: the tile takes its entrant's ray terms by
// shuffles, tests the cluster's rows one a lane, a trip a step, and stops
// at its first step with a hit (the tile's bits of the step's ballot,
// folded into one bit a tile, the same on every lane); each entrant's lane
// reads its tile's bit. The answer is an OR over the cluster's rows, so any
// split of them among lanes gives the plain walk's bits. All loops and
// votes are warp-uniform, with per-tile masks. The walk ends when no live
// lane is left unoccluded.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlock = 128;
constexpr int kUnroll = 8;  // rows per trip (scene/bvh.py CLU_UNROLL)
// The closest hit's tile mode: kTile lanes a ray (a trip's rows, one a
// lane), so kRaysPerRound entrants a round; a cluster that more than
// kTileRays lanes of a warp enter runs a lane a ray
constexpr int kTile = 8;
constexpr int kRaysPerRound = 32 / kTile;
constexpr int kTileRays = 8;
// the any hit: blocks an SM its registers must allow (40 a thread; 16
// blocks, 32 registers, spilled 148 bytes and ran 7-29% slower, 12 ran
// 5-10% faster than the 48 nvcc takes unbounded: PERF.md section 6)
constexpr int kAnyMinBlocks = 12;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kSign = 0x80000000u;
constexpr unsigned kTileMask = (1u << kTile) - 1u;
constexpr unsigned kTileLow = 0x01010101u;  // the lowest bit of each tile
static_assert(kUnroll % kTile == 0, "a trip is whole steps of a tile");
static_assert(kTile == 8, "tile_bits folds 8 bits a tile");

struct CluRay {
  float ox, oy, oz, dx, dy, dz, cx, cy, cz, ix, iy, iz, tmax;
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

__device__ __forceinline__ float signed_eps(float x) {
  return fabsf(x) > 1e-12f ? x : (x >= 0.f ? 1e-12f : -1e-12f);
}

__device__ __forceinline__ CluRay load_ray(const float* __restrict__ o,
                                           const float* __restrict__ d,
                                           const float* __restrict__ maxt,
                                           const float* __restrict__ anchor,
                                           int i) {
  CluRay r;
  r.ox = o[3 * i + 0] - anchor[0];
  r.oy = o[3 * i + 1] - anchor[1];
  r.oz = o[3 * i + 2] - anchor[2];
  r.dx = d[3 * i + 0];
  r.dy = d[3 * i + 1];
  r.dz = d[3 * i + 2];
  r.cx = sub(mul(r.oy, r.dz), mul(r.oz, r.dy));
  r.cy = sub(mul(r.oz, r.dx), mul(r.ox, r.dz));
  r.cz = sub(mul(r.ox, r.dy), mul(r.oy, r.dx));
  r.ix = 1.f / signed_eps(r.dx);
  r.iy = 1.f / signed_eps(r.dy);
  r.iz = 1.f / signed_eps(r.dz);
  const float mt = maxt[i];
  r.tmax = isfinite(mt) ? mt : 3.4e38f;
  return r;
}

// slab test of box (a = lo.xyz hi.x, b = hi.yz first trips): the ray's
// entry and exit distances
__device__ __forceinline__ void slab(const float4& a, const float4& b,
                                     const CluRay& r, float& near,
                                     float& far) {
  const float tx0 = mul(a.x - r.ox, r.ix), tx1 = mul(a.w - r.ox, r.ix);
  const float ty0 = mul(a.y - r.oy, r.iy), ty1 = mul(b.x - r.oy, r.iy);
  const float tz0 = mul(a.z - r.oz, r.iz), tz1 = mul(b.y - r.oz, r.iz);
  near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
}

// The q test of row k: (ad, us, vs, ts), |det| and the sign-folded
// numerators, and whether the ray meets the triangle at 0 < t.
// clu_anyhit_kernel holds a copy of it written out (see there).
__device__ __forceinline__ bool row_test(const float* __restrict__ rows,
                                         int k, const CluRay& r, float& ad,
                                         float& us, float& vs, float& ts) {
  const float4* tq = reinterpret_cast<const float4*>(rows + 32 * k);
  // q0 = e1 e2.x, q1 = e2.yz m1.xy, q2 = m1.z m2, q3 = n2 k
  const float4 q0 = __ldg(tq), q1 = __ldg(tq + 1);
  const float4 q2 = __ldg(tq + 2), q3 = __ldg(tq + 3);
  const float det = -dot3(r.dx, r.dy, r.dz, q3.x, q3.y, q3.z);
  const float up = add(dot3(r.cx, r.cy, r.cz, q0.w, q1.x, q1.y),
                       r.dx, r.dy, r.dz, q2.y, q2.z, q2.w);
  const float vp = -add(dot3(r.cx, r.cy, r.cz, q0.x, q0.y, q0.z),
                        r.dx, r.dy, r.dz, q1.z, q1.w, q2.x);
  const float tp = sub(dot3(r.ox, r.oy, r.oz, q3.x, q3.y, q3.z), q3.w);
  const float sg = det >= 0.f ? 1.f : -1.f;
  ad = det * sg;
  us = up * sg;
  vs = vp * sg;
  ts = tp * sg;
  // written out so that a NaN term fails, as jnp.minimum(...) >= 0
  return ad > 1e-12f && us >= 0.f && vs >= 0.f &&
         sub(sub(ad, us), vs) >= 0.f && ts > 0.f;
}

// x with its sign bit flipped where `sign` has its own set
__device__ __forceinline__ float flip(float x, unsigned sign) {
  return __uint_as_float(__float_as_uint(x) ^ sign);
}

// The union over the warp's tiles of a ballot's per-tile bits, in the low
// kTile bits (the same on every lane).
__device__ __forceinline__ unsigned tile_union(unsigned ballot) {
#pragma unroll
  for (int s = kTile; s < 32; s <<= 1) ballot |= ballot >> s;
  return ballot & kTileMask;
}

// Each tile's bits of a ballot folded into the tile's lowest bit (the same
// on every lane).
__device__ __forceinline__ unsigned tile_bits(unsigned ballot) {
  ballot |= ballot >> 4;
  ballot |= ballot >> 2;
  ballot |= ballot >> 1;
  return ballot & kTileLow;
}

// The closest hit: one thread a ray walks the boxes; an entered cluster's
// rows run a lane a ray when many lanes of the warp entered it, else a
// tile a ray over a few entrants at a time (see the note at the top).
__global__ void __launch_bounds__(kBlock)
    clu_closest_kernel(const float* __restrict__ boxes, int n_boxes,
                       const float* __restrict__ rows,
                       const float* __restrict__ anchor,
                       const float* __restrict__ o,
                       const float* __restrict__ d,
                       const float* __restrict__ maxt, int n,
                       float* __restrict__ t_out, int* __restrict__ prim_out,
                       float* __restrict__ u_out, float* __restrict__ v_out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n;
  const int wl = threadIdx.x & 31;
  const int lane = wl & (kTile - 1), tile = wl / kTile;
  CluRay r = {};
  r.ix = r.iy = r.iz = 1e12f;
  if (live) r = load_ray(o, d, maxt, anchor, i);

  // this lane's ray's best so far
  float ts_b = r.tmax, ad_b = 1.f, us_b = 0.f, vs_b = 0.f;
  int k_b = -1;
  // every lane of a warp runs every iteration below: the loop bounds are
  // read by all lanes from the same table row, and the votes are uniform
  for (int c = 0; c < n_boxes; ++c) {
    const float4* bp = reinterpret_cast<const float4*>(boxes + 16 * c);
    const float4 ba = __ldg(bp), bb = __ldg(bp + 1);
    float near, far;
    slab(ba, bb, r, near, far);
    const bool enter =
        live && near <= far && far > 0.f && mul(near, ad_b) < ts_b;
    const unsigned entered = __ballot_sync(kFull, enter);
    if (!entered) continue;
    const int first = (int)bb.z, k_end = first + kUnroll * (int)bb.w;
    if (__popc(entered) > kTileRays) {
      // a lane a ray: every row for every lane (broadcast loads), taken by
      // the lanes that entered
      for (int k = first; k < k_end; ++k) {
        float ad, us, vs, ts;
        const bool inside = row_test(rows, k, r, ad, us, vs, ts);
        if (enter && inside && mul(ts, ad_b) < mul(ts_b, ad)) {
          ts_b = ts;
          ad_b = ad;
          us_b = us;
          vs_b = vs;
          k_b = k;
        }
      }
      continue;
    }
    // a tile a ray: the entrants in lane order, one a tile a round
    for (unsigned rest = entered; rest;) {
      // this tile's entrant: the tile-th set bit of rest, if any
      unsigned mine = rest;
      for (int s = 0; s < tile; ++s) mine &= mine - 1;
      const bool busy = mine != 0;
      const int src = busy ? __ffs(mine) - 1 : wl;
      CluRay q = {};
      q.ox = __shfl_sync(kFull, r.ox, src);
      q.oy = __shfl_sync(kFull, r.oy, src);
      q.oz = __shfl_sync(kFull, r.oz, src);
      q.dx = __shfl_sync(kFull, r.dx, src);
      q.dy = __shfl_sync(kFull, r.dy, src);
      q.dz = __shfl_sync(kFull, r.dz, src);
      q.cx = __shfl_sync(kFull, r.cx, src);
      q.cy = __shfl_sync(kFull, r.cy, src);
      q.cz = __shfl_sync(kFull, r.cz, src);
      float qts = __shfl_sync(kFull, ts_b, src);
      float qad = __shfl_sync(kFull, ad_b, src);
      float qus = __shfl_sync(kFull, us_b, src);
      float qvs = __shfl_sync(kFull, vs_b, src);
      int qk = __shfl_sync(kFull, k_b, src);
      for (int k0 = first; k0 < k_end; k0 += kTile) {
        float ad = 0.f, us = 0.f, vs = 0.f, ts = 0.f;
        const bool inside =
            busy && row_test(rows, k0 + lane, q, ad, us, vs, ts);
        const unsigned found = __ballot_sync(kFull, inside);
        const unsigned own = (found >> (tile * kTile)) & kTileMask;
        // the step's candidates in row order, against the running best
        for (unsigned cand = tile_union(found); cand; cand &= cand - 1) {
          const int j = __ffs(cand) - 1;
          const float ts_j = __shfl_sync(kFull, ts, j, kTile);
          const float ad_j = __shfl_sync(kFull, ad, j, kTile);
          const float us_j = __shfl_sync(kFull, us, j, kTile);
          const float vs_j = __shfl_sync(kFull, vs, j, kTile);
          if (((own >> j) & 1u) && mul(ts_j, qad) < mul(qts, ad_j)) {
            qts = ts_j;
            qad = ad_j;
            qus = us_j;
            qvs = vs_j;
            qk = k0 + j;
          }
        }
      }
      // each entrant's lane takes its tile's best back
      const int rank = __popc(rest & ((1u << wl) - 1u));
      const bool back = ((rest >> wl) & 1u) && rank < kRaysPerRound;
      const int from = back ? rank * kTile : wl;
      const float nts = __shfl_sync(kFull, qts, from);
      const float nad = __shfl_sync(kFull, qad, from);
      const float nus = __shfl_sync(kFull, qus, from);
      const float nvs = __shfl_sync(kFull, qvs, from);
      const int nk = __shfl_sync(kFull, qk, from);
      if (back) {
        ts_b = nts;
        ad_b = nad;
        us_b = nus;
        vs_b = nvs;
        k_b = nk;
      }
      for (int s = 0; s < kRaysPerRound; ++s) rest &= rest - 1;
    }
  }
  if (!live) return;
  const float inv = 1.f / ad_b;
  const int prim = k_b >= 0 ? (int)__ldg(rows + 32 * k_b + 16) : -1;
  prim_out[i] = prim;
  t_out[i] = prim >= 0 ? ts_b * inv : INFINITY;
  u_out[i] = us_b * inv;
  v_out[i] = vs_b * inv;
}

// The any hit: one thread a ray walks the boxes; an entered cluster's rows
// run a lane a ray when many lanes of the warp entered it, else a tile a
// ray over a few entrants at a time (see the note at the top). The lane
// mode's row test is `row_test` written out, every rounded operation the
// same and in the same order but det's sign, folded in by its sign bit
// (the same occlusion bits; 3% faster on the icosphere's shadow0 set than
// the product by +-1); keep the two in step. Built on the helper it ran
// 5-6% slower on each of the Cornell box's shadow sets: nvcc then
// carried `occ` across the row loop as a byte (PRMT and SEL) where it keeps
// it in a predicate here (PERF.md section 6).
__global__ void __launch_bounds__(kBlock, kAnyMinBlocks)
    clu_anyhit_kernel(const float* __restrict__ boxes, int n_boxes,
                      const float* __restrict__ rows,
                      const float* __restrict__ anchor,
                      const float* __restrict__ o,
                      const float* __restrict__ d,
                      const float* __restrict__ maxt, int n,
                      bool* __restrict__ occ_out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n;
  const int wl = threadIdx.x & 31;
  const int lane = wl & (kTile - 1), tile = wl / kTile;
  CluRay r = {};
  r.ix = r.iy = r.iz = 1e12f;
  if (live) r = load_ray(o, d, maxt, anchor, i);

  bool occ = false;
  if (!__any_sync(kFull, live)) return;
  // every lane of a warp runs every iteration below: the loop bounds are
  // read by all lanes from the same table row, and the votes are uniform;
  // `occ` changes only where a cluster's rows run, so the walk's end is
  // voted there; flags are joined by & and | (no short circuit: they stay
  // predicates)
  for (int c = 0; c < n_boxes; ++c) {
    const float4* bp = reinterpret_cast<const float4*>(boxes + 16 * c);
    const float4 ba = __ldg(bp), bb = __ldg(bp + 1);
    float near, far;
    slab(ba, bb, r, near, far);
    const bool enter =
        live && near <= far && far > 0.f && (near < r.tmax && !occ);
    const unsigned entered = __ballot_sync(kFull, enter);
    if (!entered) continue;
    const int first = (int)bb.z, k_end = first + kUnroll * (int)bb.w;
    if (__popc(entered) > kTileRays) {
      // a lane a ray: every row for every lane (broadcast loads), taken by
      // the lanes that entered
      for (int k = first; k < k_end; ++k) {
        const float4* tq = reinterpret_cast<const float4*>(rows + 32 * k);
        // q0 = e1 e2.x, q1 = e2.yz m1.xy, q2 = m1.z m2, q3 = n2 k
        const float4 q0 = __ldg(tq), q1 = __ldg(tq + 1);
        const float4 q2 = __ldg(tq + 2), q3 = __ldg(tq + 3);
        const float det = -dot3(r.dx, r.dy, r.dz, q3.x, q3.y, q3.z);
        const float up = add(dot3(r.cx, r.cy, r.cz, q0.w, q1.x, q1.y),
                             r.dx, r.dy, r.dz, q2.y, q2.z, q2.w);
        const float vp = -add(dot3(r.cx, r.cy, r.cz, q0.x, q0.y, q0.z),
                              r.dx, r.dy, r.dz, q1.z, q1.w, q2.x);
        const float tp = sub(dot3(r.ox, r.oy, r.oz, q3.x, q3.y, q3.z), q3.w);
        // det's sign folded in by its sign bit: the plain version's
        // product by +-1 for every det the test can take (at det = +-0 or
        // NaN, ad fails it either way)
        const unsigned sg = __float_as_uint(det) & kSign;
        const float ad = fabsf(det), us = flip(up, sg), vs = flip(vp, sg),
                    ts = flip(tp, sg);
        // written out so that a NaN term fails, as jnp.minimum(...) >= 0
        const bool inside = ad > 1e-12f && us >= 0.f && vs >= 0.f &&
                            sub(sub(ad, us), vs) >= 0.f && ts > 0.f;
        occ |= enter & inside & (ts < mul(r.tmax, ad));
        // the lane is done at its first hit, the warp when every lane that
        // entered is
        if ((k & (kUnroll - 1)) == kUnroll - 1 &&
            !__any_sync(kFull, enter && !occ))
          break;
      }
      if (!__any_sync(kFull, live && !occ)) break;
      continue;
    }
    // a tile a ray: the entrants in lane order, one a tile a round
    for (unsigned rest = entered; rest;) {
      // this tile's entrant: the tile-th set bit of rest, if any
      unsigned mine = rest;
      for (int s = 0; s < tile; ++s) mine &= mine - 1;
      const bool busy = mine != 0;
      const int src = busy ? __ffs(mine) - 1 : wl;
      CluRay q = {};
      q.ox = __shfl_sync(kFull, r.ox, src);
      q.oy = __shfl_sync(kFull, r.oy, src);
      q.oz = __shfl_sync(kFull, r.oz, src);
      q.dx = __shfl_sync(kFull, r.dx, src);
      q.dy = __shfl_sync(kFull, r.dy, src);
      q.dz = __shfl_sync(kFull, r.dz, src);
      q.cx = __shfl_sync(kFull, r.cx, src);
      q.cy = __shfl_sync(kFull, r.cy, src);
      q.cz = __shfl_sync(kFull, r.cz, src);
      q.tmax = __shfl_sync(kFull, r.tmax, src);
      // the busy tiles and those whose entrant is occluded, a bit a tile
      const unsigned busy_tiles = tile_bits(__ballot_sync(kFull, busy));
      unsigned hit_tiles = 0;
      for (int k0 = first; k0 < k_end && hit_tiles != busy_tiles;
           k0 += kTile) {
        float ad, us, vs, ts;
        const bool inside = row_test(rows, k0 + lane, q, ad, us, vs, ts);
        hit_tiles |= tile_bits(__ballot_sync(
            kFull, busy && inside && ts < mul(q.tmax, ad)));
      }
      // each entrant's lane takes its tile's bit (an entrant was not
      // occluded)
      const int rank = __popc(rest & ((1u << wl) - 1u));
      occ |= ((rest >> wl) & 1u) & (rank < kRaysPerRound) &
             (hit_tiles >> (kTile * (rank & (kRaysPerRound - 1))));
      for (int s = 0; s < kRaysPerRound; ++s) rest &= rest - 1;
    }
    if (!__any_sync(kFull, live && !occ)) break;
  }
  if (!live) return;
  occ_out[i] = occ;
}

}  // namespace

extern "C" int plt_intersect_clu(const float* boxes, int n_boxes,
                                 const float* rows, const float* anchor,
                                 const float* o, const float* d,
                                 const float* maxt, int n, float* t,
                                 int* prim, float* u, float* v,
                                 void* stream) {
  if (n > 0) {
    const int grid = (n + kBlock - 1) / kBlock;
    clu_closest_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        boxes, n_boxes, rows, anchor, o, d, maxt, n, t, prim, u, v);
  }
  return (int)cudaGetLastError();
}

extern "C" int plt_occluded_clu(const float* boxes, int n_boxes,
                                const float* rows, const float* anchor,
                                const float* o, const float* d,
                                const float* maxt, int n, bool* occ,
                                void* stream) {
  if (n > 0) {
    const int grid = (n + kBlock - 1) / kBlock;
    clu_anyhit_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        boxes, n_boxes, rows, anchor, o, d, maxt, n, occ);
  }
  return (int)cudaGetLastError();
}
