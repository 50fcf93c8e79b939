// Closest hit and any hit over the WideBVH, a tile of lanes per ray, for
// the packet route of big meshes.
//
// Replaces: mitsuba3_plt_tpu/ops/intersect_pallas.py::pallas_bvh_intersect
// (Pallas body _bvh_kernel; wide_kernel) and ::pallas_bvh_occluded (body
// _bvh_anyhit_kernel; wide_anyhit_kernel).
//
// Tables (scene/bvh.py, world coordinates):
//   WideBVH nodes [NW, 64]: 8 child slots of lo(3) hi(3) first count, the
//     PacketBVH collapsed to nodes of up to 8 children; count -1 an empty
//     slot, 0 an inner child (wide node `first`), > 0 a leaf's rows.
//   tri [P, 16]: p0(3) e1(3) e2(3), the face index as a float, pad(6): the
//     PacketBVH's rows (a leaf's rows are consecutive).
//
// Triangle test (both): classic Moller-Trumbore on (p0, e1, e2) with the
// division folded into inv_det = [|det| > 1e-12] / det, as the TPU kernel
// has it. Every product and sum is rounded on its own, left to right (no FMA
// contraction), so a lane equals the plain PyTorch version bit for bit. The
// inverse direction goes through signed_eps (|d| >= 1e-12); an infinite
// maxt is carried as 3.4e38.
//
// Closest hit. What bounded the per-ray skip-link walk on the H100 was its
// critical path, not bytes or operations: 131,072 rays a launch (the
// regenerative wavefront) are under 8 blocks of 128 threads an SM, each
// thread a chain of dependent node loads, slab tests and up to 16 triangle
// tests one after another, and a warp runs as long as the union of its 32
// walks (44.5x its byte bound). Design: 8 lanes a ray, so the wavefront puts
// 8x the threads in flight, over a table whose node holds its 8 children's
// boxes: the tile tests a node's children in one step, one slot a lane (256
// coalesced bytes), and a leaf's rows 8 at a time, so a walk takes ~3-5
// pops where it took ~29 node steps. The ray keeps a stack of (child,
// near) in shared memory (the table's `stack` entries, its worst case; 2 KB
// a block of 8 rays at mesh82k): an inner node pushes every child the ray
// enters, ranked by shuffles so that the nearest (then the lower slot) is
// popped first, and an entry whose near lies beyond the best distance is
// dropped. A warp's four tiles move in step: each trip pops one entry of
// every tile, and the node step and the leaf step each run where a tile
// needs them, so every shuffle takes the full warp (tiles that each ran
// their own loop diverged, and the compiler wrapped each shuffle in
// collective code; that design was 1.6x slower on the wavefront). What
// bounds it now: the latency of a trip (a shared-memory pop, then the
// node's or the rows' loads) times the longest walk of a warp (~3 trips a
// ray on the wavefront, 38 at most), ~12-15x its byte bound. Box gate:
// near <= far, far > 0, near <= best. Tie rule: the best hit is the least
// (t, row) among hits with 0 < t < maxt, each lane keeping its own and the
// tile reducing by shuffles at the end, so a tie goes to the lower
// PacketBVH row, as the skip-link walk's strict t < best in DFS row order
// gave it; the tile shares the least t after each leaf for the gates. The
// walk's order decides only what the best distance culls, and the plain
// version walks in the same order.
//
// Any hit (replaces pallas_bvh_occluded). The first port walked the
// PacketBVH's skip links one thread a ray: a chain of dependent 48-byte
// node loads, each followed by a slab test and up to 16 triangle tests one
// after another, and a warp as long as the longest of its 32 walks: 0.079
// ms on the regenerative wavefront's 131,072 sorted shadow rays, ~24x its
// measured byte bound, with 131,072 threads too few to hide that chain.
// Design: the closest hit's tiles and trips over the same WideBVH, with
// what an any hit does not need taken out. No order and no best distance:
// the gate is near <= far, far > 0, near < maxt (the skip-link walk's
// strict <), the stack holds child codes alone (4 bytes an entry, 1 KB a
// block of 8 rays at mesh82k), and an inner node pushes the children its
// ray enters in slot order, each ranked by __popc of the lower bits of the
// tile's ballot (the highest slot is popped first; B7a's nearest-first
// rank was slower here, PERF.md section 6). A leaf's rows are tested 8 at
// a time; after each 8-row step the tile takes a ballot, and a tile whose
// ray is occluded empties its stack; the warp leaves when no tile holds an
// entry. The flag is a function of the set of leaves the ray enters: a
// child's box lies inside its parent's, and slab rounding is monotone in
// the box planes, so the walk reaches the leaves the skip-link walk
// reaches and returns its flag bit for bit. What bounds it now: as the
// closest hit, the latency of a trip times the longest walk of the warp
// (~5x the measured byte bound on the wavefront); and a ray that needs
// one slab test still takes a tile: a dead ray (o = 1e8) pops the root
// and fails its 8 slab tests, so an all-dead launch costs ~8x the
// one-thread walk's (PERF.md). A root-box gate one lane a ray, with each
// warp's passing rays packed into tiles, took that to ~1.3x but serialised
// the clustered live rays of a sorted wavefront (4x slower there).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWide = 8;  // lanes per ray = child slots per node
constexpr int kMaxLeaf = 16;  // rows of a leaf at most (PACKET_LEAF)
// 8 rays a block: 4 were slower on every ray set, 16 no faster in the
// render (chip_smoke.py --turns; PERF.md section 6)
constexpr int kWideBlock = 64;
constexpr int kRaysPerBlock = kWideBlock / kWide;
constexpr int kNoRow = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kTileMask = (1u << kWide) - 1u;

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

__device__ __forceinline__ float signed_eps(float x) {
  return fabsf(x) > 1e-12f ? x : (x >= 0.f ? 1e-12f : -1e-12f);
}

struct WideRay {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, mt;
};

__device__ __forceinline__ WideRay load_ray(const float* __restrict__ o,
                                            const float* __restrict__ d,
                                            const float* __restrict__ maxt,
                                            int i) {
  WideRay r;
  r.ox = o[3 * i + 0], r.oy = o[3 * i + 1], r.oz = o[3 * i + 2];
  r.dx = d[3 * i + 0], r.dy = d[3 * i + 1], r.dz = d[3 * i + 2];
  r.ix = 1.f / signed_eps(r.dx);
  r.iy = 1.f / signed_eps(r.dy);
  r.iz = 1.f / signed_eps(r.dz);
  const float mt = maxt[i];
  r.mt = isfinite(mt) ? mt : 3.4e38f;
  return r;
}

// Child slot `lane` of wide node `first` (a = lo.xyz hi.x, b = hi.yz first
// count; zeros where `load` is false) and its (near, far) along the ray.
__device__ __forceinline__ void child_slab(const float* __restrict__ nodes,
                                           int first, int lane, bool load,
                                           const WideRay& r, float4& a,
                                           float4& b, float& near,
                                           float& far) {
  a = make_float4(0.f, 0.f, 0.f, 0.f);
  b = a;
  if (load) {
    const float4* np =
        reinterpret_cast<const float4*>(nodes + 8 * (kWide * first + lane));
    a = __ldg(np);
    b = __ldg(np + 1);
  }
  const float tx0 = mul(sub(a.x, r.ox), r.ix), tx1 = mul(sub(a.w, r.ox), r.ix);
  const float ty0 = mul(sub(a.y, r.oy), r.iy), ty1 = mul(sub(b.x, r.oy), r.iy);
  const float tz0 = mul(sub(a.z, r.oz), r.iz), tz1 = mul(sub(b.y, r.oz), r.iz);
  near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
}

// Moller-Trumbore on table row `row`: (t, u, v), and whether the ray meets
// the triangle at 0 < t (maxt is the caller's).
__device__ __forceinline__ bool triangle(const float* __restrict__ tri,
                                         int row, const WideRay& r, float& t,
                                         float& u, float& v) {
  const float4* tp = reinterpret_cast<const float4*>(tri + 16 * row);
  // q0 = p0 e1.x, q1 = e1.yz e2.xy, q2 = e2.z face
  const float4 q0 = __ldg(tp), q1 = __ldg(tp + 1), q2 = __ldg(tp + 2);
  const float e1x = q0.w, e1y = q1.x, e1z = q1.y;
  const float e2x = q1.z, e2y = q1.w, e2z = q2.x;
  const float pvx = sub(mul(r.dy, e2z), mul(r.dz, e2y));
  const float pvy = sub(mul(r.dz, e2x), mul(r.dx, e2z));
  const float pvz = sub(mul(r.dx, e2y), mul(r.dy, e2x));
  const float det = dot3(e1x, e1y, e1z, pvx, pvy, pvz);
  const bool ok = fabsf(det) > 1e-12f;
  const float inv_det = (ok ? 1.f : 0.f) / (ok ? det : 1.f);
  const float tvx = sub(r.ox, q0.x), tvy = sub(r.oy, q0.y),
              tvz = sub(r.oz, q0.z);
  u = mul(dot3(tvx, tvy, tvz, pvx, pvy, pvz), inv_det);
  const float qvx = sub(mul(tvy, e1z), mul(tvz, e1y));
  const float qvy = sub(mul(tvz, e1x), mul(tvx, e1z));
  const float qvz = sub(mul(tvx, e1y), mul(tvy, e1x));
  v = mul(dot3(r.dx, r.dy, r.dz, qvx, qvy, qvz), inv_det);
  t = mul(dot3(e2x, e2y, e2z, qvx, qvy, qvz), inv_det);
  // written out so that a NaN term fails
  return ok && u >= 0.f && v >= 0.f && __fadd_rn(u, v) <= 1.f && t > 0.f;
}

// The closest hit: a tile of kWide lanes per ray, four tiles a warp kept
// in step (see the note at the top).
__global__ void __launch_bounds__(kWideBlock)
    wide_kernel(const float* __restrict__ nodes, const float* __restrict__ tri,
                const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ maxt, int n, int cap,
                float* __restrict__ t_out, int* __restrict__ prim_out,
                float* __restrict__ u_out, float* __restrict__ v_out) {
  extern __shared__ int stack_mem[];
  const int lane = threadIdx.x & (kWide - 1);
  const int slot = threadIdx.x / kWide;
  const int base = threadIdx.x & 31 & ~(kWide - 1);
  // no early return: the whole warp meets at every shuffle; a tile past
  // the end repeats the last ray with an empty stack and stores nothing
  const int i0 = blockIdx.x * kRaysPerBlock + slot;
  const int i = i0 < n ? i0 : n - 1;
  int* st_code = stack_mem + 2 * cap * slot;
  float* st_near = reinterpret_cast<float*>(st_code + cap);

  const WideRay r = load_ray(o, d, maxt, i);
  // best: the tile's least hit distance (uniform over the tile); t_b, row_b,
  // u_b, v_b: the least (t, row) among the hits this lane has tested
  float best = r.mt, t_b = r.mt, u_b = 0.f, v_b = 0.f;
  int row_b = kNoRow;

  if (lane == 0) {
    st_code[0] = 0;  // the root: inner node 0
    st_near[0] = -INFINITY;
  }
  int sp = i0 < n ? 1 : 0;
  __syncwarp();
  // each trip pops one entry of every tile whose stack holds one; the node
  // step and the leaf step run where a tile of the warp needs them
  while (__any_sync(kFull, sp > 0)) {
    int code = 0;
    bool live = sp > 0;
    if (live) {
      --sp;
      code = st_code[sp];
      live = st_near[sp] <= best;
    }
    __syncwarp();  // read by all before a push overwrites it
    const int count = code & 31, first = code >> 5;
    const bool inner = live && count == 0;
    const bool leaf = live && count > 0;
    if (__any_sync(kFull, inner)) {
      // an inner node: lane j tests child slot j
      float4 a, b;
      float near, far;
      child_slab(nodes, first, lane, inner, r, a, b, near, far);
      const bool enter = inner && b.w >= 0.f && near <= far && far > 0.f &&
                         near <= best;
      const unsigned entered = (__ballot_sync(kFull, enter) >> base) &
                               kTileMask;
      // entered children after this one in (near, slot) order: the least
      // lands on top of the stack
      int above = 0;
#pragma unroll
      for (int j = 0; j < kWide; ++j) {
        const float nj = __shfl_sync(kFull, near, j, kWide);
        above += ((entered >> j) & 1u) &&
                 (nj > near || (nj == near && j > lane));
      }
      if (enter) {
        st_code[sp + above] = (int)b.z * 32 + (int)b.w;
        st_near[sp + above] = near;
      }
      sp += __popc(entered);
      __syncwarp();
    }
    if (__any_sync(kFull, leaf)) {
      // a leaf: its rows kWide at a time, one a lane
#pragma unroll
      for (int k = lane; k < kMaxLeaf; k += kWide) {
        if (!(leaf && k < count)) continue;
        const int row = first + k;
        float t, u, v;
        const bool hit = triangle(tri, row, r, t, u, v) && t < r.mt &&
                         (t < t_b || (t == t_b && row < row_b));
        if (hit) {
          t_b = t;
          row_b = row;
          u_b = u;
          v_b = v;
        }
      }
      float m = t_b;
#pragma unroll
      for (int off = kWide / 2; off > 0; off >>= 1)
        m = fminf(m, __shfl_xor_sync(kFull, m, off, kWide));
      best = m;
    }
  }
  // the least (t, row) of the tile
#pragma unroll
  for (int off = kWide / 2; off > 0; off >>= 1) {
    const float t2 = __shfl_xor_sync(kFull, t_b, off, kWide);
    const int r2 = __shfl_xor_sync(kFull, row_b, off, kWide);
    const float u2 = __shfl_xor_sync(kFull, u_b, off, kWide);
    const float v2 = __shfl_xor_sync(kFull, v_b, off, kWide);
    if (t2 < t_b || (t2 == t_b && r2 < row_b)) {
      t_b = t2;
      row_b = r2;
      u_b = u2;
      v_b = v2;
    }
  }
  if (lane == 0 && i0 < n) {
    const bool found = row_b != kNoRow;
    prim_out[i] = found ? (int)tri[16 * row_b + 9] : -1;
    t_out[i] = found ? t_b : INFINITY;
    u_out[i] = u_b;
    v_out[i] = v_b;
  }
}

// The any hit: the closest hit's tiles and trips with a stack of child
// codes pushed in slot order, leaving at the first hit (see the note at
// the top).
__global__ void __launch_bounds__(kWideBlock)
    wide_anyhit_kernel(const float* __restrict__ nodes,
                       const float* __restrict__ tri,
                       const float* __restrict__ o,
                       const float* __restrict__ d,
                       const float* __restrict__ maxt, int n, int cap,
                       bool* __restrict__ occ_out) {
  extern __shared__ int stack_mem[];
  const int lane = threadIdx.x & (kWide - 1);
  const int slot = threadIdx.x / kWide;
  const int base = threadIdx.x & 31 & ~(kWide - 1);
  // as in wide_kernel: no early return, a tile past the end stores nothing
  const int i0 = blockIdx.x * kRaysPerBlock + slot;
  const int i = i0 < n ? i0 : n - 1;
  int* st = stack_mem + cap * slot;

  const WideRay r = load_ray(o, d, maxt, i);
  bool occ = false;  // uniform over the tile
  if (lane == 0) st[0] = 0;  // the root: inner node 0
  int sp = i0 < n ? 1 : 0;
  __syncwarp();
  while (__any_sync(kFull, sp > 0)) {
    const bool live = sp > 0;
    const int code = live ? st[--sp] : 0;
    __syncwarp();  // read by all before a push overwrites it
    const int count = code & 31, first = code >> 5;
    const bool inner = live && count == 0;
    const bool leaf = live && count > 0;
    if (__any_sync(kFull, inner)) {
      float4 a, b;
      float near, far;
      child_slab(nodes, first, lane, inner, r, a, b, near, far);
      const bool enter = inner && b.w >= 0.f && near <= far && far > 0.f &&
                         near < r.mt;
      const unsigned entered = (__ballot_sync(kFull, enter) >> base) &
                               kTileMask;
      // slot order: an entered child lands above the lower entered slots
      if (enter)
        st[sp + __popc(entered & ((1u << lane) - 1u))] =
            (int)b.z * 32 + (int)b.w;
      sp += __popc(entered);
      __syncwarp();
    }
    if (__any_sync(kFull, leaf)) {
      // a leaf's rows kWide at a time; an occluded tile empties its stack
#pragma unroll
      for (int k = lane; k < kMaxLeaf; k += kWide) {
        bool hit = false;
        if (leaf && !occ && k < count) {
          float t, u, v;
          hit = triangle(tri, first + k, r, t, u, v) && t < r.mt;
        }
        if ((__ballot_sync(kFull, hit) >> base) & kTileMask) {
          occ = true;
          sp = 0;
        }
      }
    }
  }
  if (lane == 0 && i0 < n) occ_out[i] = occ;
}

}  // namespace

// The WideBVH closest hit; `cap` is the table's stack bound (entries a ray),
// which sets the shared memory: kRaysPerBlock x cap x 8 bytes.
extern "C" int plt_intersect_bvh(const float* nodes, const float* tri,
                                 const float* o, const float* d,
                                 const float* maxt, int n, int cap, float* t,
                                 int* prim, float* u, float* v,
                                 void* stream) {
  if (n > 0) {
    const int grid = (n + kRaysPerBlock - 1) / kRaysPerBlock;
    const size_t smem = (size_t)kRaysPerBlock * cap * 2 * sizeof(int);
    wide_kernel<<<grid, kWideBlock, smem, (cudaStream_t)stream>>>(
        nodes, tri, o, d, maxt, n, cap, t, prim, u, v);
  }
  return (int)cudaGetLastError();
}

// The WideBVH any hit; shared memory kRaysPerBlock x cap x 4 bytes.
extern "C" int plt_occluded_bvh(const float* nodes, const float* tri,
                                const float* o, const float* d,
                                const float* maxt, int n, int cap, bool* occ,
                                void* stream) {
  if (n > 0) {
    const int grid = (n + kRaysPerBlock - 1) / kRaysPerBlock;
    const size_t smem = (size_t)kRaysPerBlock * cap * sizeof(int);
    wide_anyhit_kernel<<<grid, kWideBlock, smem, (cudaStream_t)stream>>>(
        nodes, tri, o, d, maxt, n, cap, occ);
  }
  return (int)cudaGetLastError();
}
