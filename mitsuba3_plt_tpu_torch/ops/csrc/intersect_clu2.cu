// Closest-hit and any-hit over the two-level treelet tables (ClusterTable2)
// of big meshes, one thread per ray, with two gates above the supers.
//
// Replaces: mitsuba3_plt_tpu/ops/intersect_pallas.py::pallas_intersect_clu2
// (Pallas body _clu2_kernel) and ::pallas_occluded_clu2 (body
// _clu2_anyhit_kernel).
//
// Tables (scene/bvh.py::pack_clusters2, all relative to the anchor):
//   supers [S, 16]: lo(3) hi(3) first_cluster n_clusters
//   boxes  [K, 16]: lo(3) hi(3) first_row n_rows
//   rows   [R, 128]: 4 triangles x 32 floats: e1 e2 m1 m2 n2 k, then the
//                    face index as a float at 32j + 16 (-1 on padding).
//   root   [8]: lo(3) hi(3) of the supers that hold clusters
//   groups [G, 8]: lo(3) hi(3) first_super n_supers of each run of 16 such
//                supers (ops/intersect.py::clu2_gates; ClusterTable2.root
//                and .groups, derived from supers).
// Walk: the root box, then the groups in order, the supers of an entered
// group in order, the clusters of an entered super in DFS order, then the
// rows of an entered cluster. A warp descends into a group, a super or a
// cluster when any of its lanes passes the slab test (__any_sync), as the
// TPU kernel's tile-uniform pl.when(jnp.any(...)) does for its ray tile;
// every lane of the warp then reads the same box and row (broadcast loads
// through the read-only path), but a lane takes a hit only from a cluster
// it entered itself, as the plain walk does. A warp none of whose lanes
// enters the root box leaves at once.
//
// The gates change no result. A group's planes are the least and greatest
// of its supers' and the root's of all groups, and a slab plane is rounded
// monotonically in its box plane, so near only falls and far only rises
// from a super to its group and the root. A lane that fails a gate box
// would fail every super below it with the same best hit, and it finds no
// hit there to change the best. So the kernel returns what the walk over
// every super in order returns, bit for bit.
//
// What bounded the first port (no gates), at the mesh82k path (81,920
// faces, 120 supers, 1,048,576 rays a launch; H100 80GB HBM3 at 700 W):
//   1. Every ray slab-tested every super, 120 dependent iterations of two
//      float4 loads, ~29 operations and a warp vote: ~42% of the counted
//      operations of a camera ray (44 cluster and 62 triangle tests) and
//      ~67% of a bounce or shadow ray's (13 clusters, 24-27 triangles).
//   2. Launches whose lanes are all dead still ran that scan: after the
//      first bounce off the convex icosphere only the integrator's dead
//      rays (o = 1e8) are left, 0.22 ms a closest-hit and 0.24 ms an
//      any-hit launch, about half of a pass's clu2 time.
// The root gate takes a dead launch to the rays' loads; the group gate
// takes a ray's super tests from 120 to 8 group tests and the 16 supers of
// each group it enters. What bounds it now: the clusters and triangles of
// the warp's union of walks, in table order (the best distance culls only
// the boxes after the hit). A tile of lanes a ray with supers and clusters
// visited nearest first was measured against this kernel and lost on the
// path's coherent sets (PERF.md; ROADMAP queue D keeps it for incoherent
// rays, where it was 3.0-3.3x faster).
//
// Triangle math is that of intersect_q.cu (Moller-Trumbore re-associated
// around per-triangle constants). The closest hit keeps (t|det|, |det|),
// accepts on the strict cross-multiplied compare, so the first of two tied
// triangles in (super, cluster, row, slot) order wins, and divides once at
// the end. Box gates: closest hit near * ad_b < ts_b; any hit near < maxt
// and not yet occluded. The inverse direction goes through signed_eps
// (|d| >= 1e-12) so axis-parallel rays stay finite; an infinite maxt is
// carried as 3.4e38. A dead ray (o = 1e8) is outside the root box.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlock = 128;
constexpr unsigned kFull = 0xffffffffu;

struct CluRay {
  float ox, oy, oz, dx, dy, dz, cx, cy, cz, ix, iy, iz, tmax;
};

// The ray terms and triangle terms are rounded after every multiply and
// add, in the plain version's order (no FMA contraction), so a lane that
// hits the same triangle in both gets the same t, u and v bit for bit: the
// q form cancels terms of size |o| |e| to get values of size |e|^2, so a
// contracted kernel differs from the plain version in u by up to ~1e-3
// relative on an 82k-face mesh seen from 4 units away.
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

// slab test of the box at p (lo.xyz hi.x, then hi.yz and two more floats,
// returned in b): the ray's entry and exit distances
__device__ __forceinline__ void slab(const float* __restrict__ p,
                                     const CluRay& r, float& near,
                                     float& far, float4& b) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  const float tx0 = (a.x - r.ox) * r.ix, tx1 = (a.w - r.ox) * r.ix;
  const float ty0 = (a.y - r.oy) * r.iy, ty1 = (b.x - r.oy) * r.iy;
  const float tz0 = (a.z - r.oz) * r.iz, tz1 = (b.y - r.oz) * r.iz;
  near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
}

// a box gate with the best hit so far: the closest hit's near * |det|_best
// < (t |det|)_best, the any hit's near < maxt while not occluded
template <bool kAnyHit>
__device__ __forceinline__ bool enters(float near, float far, const CluRay& r,
                                       bool occ, float ad_b, float ts_b) {
  return near <= far && far > 0.f &&
         (kAnyHit ? (near < r.tmax && !occ) : (near * ad_b < ts_b));
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
    clu2_kernel(const float* __restrict__ supers,
                const float* __restrict__ groups, int n_groups,
                const float* __restrict__ boxes,
                const float* __restrict__ rows,
                const float* __restrict__ anchor,
                const float* __restrict__ root, const float* __restrict__ o,
                const float* __restrict__ d, const float* __restrict__ maxt,
                int n, float* __restrict__ t_out, int* __restrict__ prim_out,
                float* __restrict__ u_out, float* __restrict__ v_out,
                bool* __restrict__ occ_out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  CluRay r = {};
  r.ix = r.iy = r.iz = 1e12f;
  if (i < n) r = load_ray(o, d, maxt, anchor, i);

  float ts_b = r.tmax, ad_b = 1.f, us_b = 0.f, vs_b = 0.f, prim_b = -1.f;
  bool occ = false;
  float near, far;
  float4 b;
  bool live = false;
  if (i < n) {
    slab(root, r, near, far, b);
    live = enters<kAnyHit>(near, far, r, occ, ad_b, ts_b);
  }
  // every lane of a warp runs every iteration below: the loop bounds are
  // read by all lanes from the same table row, and the votes are uniform
  for (int g = 0; g < n_groups; ++g) {
    if (!__any_sync(kFull, live && !occ)) break;
    slab(groups + 8 * g, r, near, far, b);
    const bool enter_g =
        live && enters<kAnyHit>(near, far, r, occ, ad_b, ts_b);
    if (!__any_sync(kFull, enter_g)) continue;
    const int s_end = (int)b.z + (int)b.w;
    for (int s = (int)b.z; s < s_end; ++s) {
      if (kAnyHit && !__any_sync(kFull, enter_g && !occ)) break;
      float4 sb;
      slab(supers + 16 * s, r, near, far, sb);
      const bool enter_s =
          enter_g && enters<kAnyHit>(near, far, r, occ, ad_b, ts_b);
      if (!__any_sync(kFull, enter_s)) continue;
      const int c_end = (int)sb.z + (int)sb.w;
      for (int c = (int)sb.z; c < c_end; ++c) {
        if (kAnyHit && !__any_sync(kFull, enter_s && !occ)) break;
        float4 bb;
        slab(boxes + 16 * c, r, near, far, bb);
        const bool enter =
            enter_s && enters<kAnyHit>(near, far, r, occ, ad_b, ts_b);
        if (!__any_sync(kFull, enter)) continue;
        const int k_end = (int)bb.z + (int)bb.w;
        for (int k = (int)bb.z; k < k_end; ++k) {
          const float* row = rows + (size_t)128 * k;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4* tq = reinterpret_cast<const float4*>(row + 32 * j);
            // q0 = e1 e2.x, q1 = e2.yz m1.xy, q2 = m1.z m2, q3 = n2 k
            const float4 q0 = __ldg(tq), q1 = __ldg(tq + 1);
            const float4 q2 = __ldg(tq + 2), q3 = __ldg(tq + 3);
            const float det = -dot3(r.dx, r.dy, r.dz, q3.x, q3.y, q3.z);
            const float up =
                add(dot3(r.cx, r.cy, r.cz, q0.w, q1.x, q1.y),
                    r.dx, r.dy, r.dz, q2.y, q2.z, q2.w);
            const float vp =
                -add(dot3(r.cx, r.cy, r.cz, q0.x, q0.y, q0.z),
                     r.dx, r.dy, r.dz, q1.z, q1.w, q2.x);
            const float tp =
                sub(dot3(r.ox, r.oy, r.oz, q3.x, q3.y, q3.z), q3.w);
            const float sg = det >= 0.f ? 1.f : -1.f;
            const float ad = det * sg, us = up * sg, vs = vp * sg,
                        ts = tp * sg;
            // written out so that a NaN term fails, as jnp.minimum(...) >= 0
            const bool inside = enter && ad > 1e-12f && us >= 0.f &&
                                vs >= 0.f && (ad - us - vs) >= 0.f &&
                                ts > 0.f;
            if (kAnyHit) {
              occ = occ || (inside && ts < r.tmax * ad);
            } else if (inside && ts * ad_b < ts_b * ad) {
              ts_b = ts;
              ad_b = ad;
              us_b = us;
              vs_b = vs;
              prim_b = __ldg(row + 32 * j + 16);
            }
          }
          if (kAnyHit && !__any_sync(kFull, enter && !occ)) break;
        }
      }
    }
  }
  if (i >= n) return;
  if (kAnyHit) {
    occ_out[i] = occ;
    return;
  }
  const float inv = 1.f / ad_b;
  const int prim = (int)prim_b;
  prim_out[i] = prim;
  t_out[i] = prim >= 0 ? ts_b * inv : INFINITY;
  u_out[i] = us_b * inv;
  v_out[i] = vs_b * inv;
}

template <bool kAnyHit>
int launch(const float* supers, const float* groups, int n_groups,
           const float* boxes, const float* rows, const float* anchor,
           const float* root, const float* o, const float* d,
           const float* maxt, int n, float* t, int* prim, float* u, float* v,
           bool* occ, void* stream) {
  if (n > 0) {
    const int grid = (n + kBlock - 1) / kBlock;
    clu2_kernel<kAnyHit><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        supers, groups, n_groups, boxes, rows, anchor, root, o, d, maxt, n,
        t, prim, u, v, occ);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int plt_intersect_clu2(const float* supers, const float* groups,
                                  int n_groups, const float* boxes,
                                  const float* rows, const float* anchor,
                                  const float* root, const float* o,
                                  const float* d, const float* maxt, int n,
                                  float* t, int* prim, float* u, float* v,
                                  void* stream) {
  return launch<false>(supers, groups, n_groups, boxes, rows, anchor, root, o,
                       d, maxt, n, t, prim, u, v, nullptr, stream);
}

extern "C" int plt_occluded_clu2(const float* supers, const float* groups,
                                 int n_groups, const float* boxes,
                                 const float* rows, const float* anchor,
                                 const float* root, const float* o,
                                 const float* d, const float* maxt, int n,
                                 bool* occ, void* stream) {
  return launch<true>(supers, groups, n_groups, boxes, rows, anchor, root, o,
                      d, maxt, n, nullptr, nullptr, nullptr, nullptr, occ,
                      stream);
}
