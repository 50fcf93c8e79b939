// Closest-hit and any-hit over the two-level treelet tables (ClusterTable2)
// of big meshes, one thread per ray.
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
// Walk: supers in order, the clusters of an entered super in DFS order,
// then the rows of an entered cluster. A warp descends into a super or a
// cluster when any of its live lanes passes the slab test (__any_sync), as
// the TPU kernel's tile-uniform pl.when(jnp.any(...)) does for its ray
// tile; every lane of the warp then reads the same box and row (broadcast
// loads through the read-only path). Results do not depend on the gate:
// a triangle hit still has to pass the exact test below.
//
// Triangle math is that of intersect_q.cu (Moller-Trumbore re-associated
// around per-triangle constants). The closest hit keeps (t|det|, |det|),
// accepts on the strict cross-multiplied compare, so the first of two tied
// triangles in (super, cluster, row, slot) order wins, and divides once at
// the end. Box gates: closest hit near * ad_b < ts_b; any hit near < maxt
// and not yet occluded. The inverse direction goes through signed_eps
// (|d| >= 1e-12) so axis-parallel rays stay finite; an infinite maxt is
// carried as 3.4e38. A dead ray (o = 1e8) is outside every box.
//
// What bounds it on the H100: operations. At the mesh82k scene a camera
// ray runs ~120 super slab tests, a few dozen cluster tests and a few
// hundred triangle tests (~25 and ~55 flops each) against 28 bytes of ray
// in and 16 out; the 10.8 MB of rows stay in the 50 MB L2. Design: no
// shared-memory staging (each warp reads only the rows it enters), the ray
// and its best hit in registers, the any-hit walk leaves a lane at its
// first hit and a warp when no live lane is left.
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

// slab test of box (a = lo.xyz hi.x, b = hi.yz first count): the ray's
// entry and exit distances
__device__ __forceinline__ void slab(const float4& a, const float4& b,
                                     const CluRay& r, float& near,
                                     float& far) {
  const float tx0 = (a.x - r.ox) * r.ix, tx1 = (a.w - r.ox) * r.ix;
  const float ty0 = (a.y - r.oy) * r.iy, ty1 = (b.x - r.oy) * r.iy;
  const float tz0 = (a.z - r.oz) * r.iz, tz1 = (b.y - r.oz) * r.iz;
  near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
}

__device__ __forceinline__ void load_box(const float* __restrict__ tab,
                                         int idx, float4& a, float4& b) {
  const float4* p = reinterpret_cast<const float4*>(tab + 16 * idx);
  a = __ldg(p);
  b = __ldg(p + 1);
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
    clu2_kernel(const float* __restrict__ supers, int n_supers,
                const float* __restrict__ boxes,
                const float* __restrict__ rows,
                const float* __restrict__ anchor,
                const float* __restrict__ o, const float* __restrict__ d,
                const float* __restrict__ maxt, int n,
                float* __restrict__ t_out, int* __restrict__ prim_out,
                float* __restrict__ u_out, float* __restrict__ v_out,
                bool* __restrict__ occ_out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n;
  CluRay r = {};
  r.ix = r.iy = r.iz = 1e12f;
  if (live) r = load_ray(o, d, maxt, anchor, i);

  float ts_b = r.tmax, ad_b = 1.f, us_b = 0.f, vs_b = 0.f, prim_b = -1.f;
  bool occ = false;
  // every lane of a warp runs every iteration below: the loop bounds are
  // read by all lanes from the same table row, and the votes are uniform
  for (int s = 0; s < n_supers; ++s) {
    if (kAnyHit && !__any_sync(kFull, live && !occ)) break;
    float4 sa, sb;
    load_box(supers, s, sa, sb);
    float near, far;
    slab(sa, sb, r, near, far);
    const bool enter_s =
        live && near <= far && far > 0.f &&
        (kAnyHit ? (near < r.tmax && !occ) : (near * ad_b < ts_b));
    if (!__any_sync(kFull, enter_s)) continue;
    const int c_end = (int)sb.z + (int)sb.w;
    for (int c = (int)sb.z; c < c_end; ++c) {
      if (kAnyHit && !__any_sync(kFull, live && !occ)) break;
      float4 ba, bb;
      load_box(boxes, c, ba, bb);
      slab(ba, bb, r, near, far);
      const bool enter =
          live && near <= far && far > 0.f &&
          (kAnyHit ? (near < r.tmax && !occ) : (near * ad_b < ts_b));
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
          const bool inside = ad > 1e-12f && us >= 0.f && vs >= 0.f &&
                              (ad - us - vs) >= 0.f && ts > 0.f;
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
        if (kAnyHit && !__any_sync(kFull, live && !occ)) break;
      }
    }
  }
  if (!live) return;
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

}  // namespace

extern "C" int plt_intersect_clu2(const float* supers, int n_supers,
                                  const float* boxes, const float* rows,
                                  const float* anchor, const float* o,
                                  const float* d, const float* maxt, int n,
                                  float* t, int* prim, float* u, float* v,
                                  void* stream) {
  if (n > 0) {
    const int grid = (n + kBlock - 1) / kBlock;
    clu2_kernel<false><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        supers, n_supers, boxes, rows, anchor, o, d, maxt, n, t, prim, u, v,
        nullptr);
  }
  return (int)cudaGetLastError();
}

extern "C" int plt_occluded_clu2(const float* supers, int n_supers,
                                 const float* boxes, const float* rows,
                                 const float* anchor, const float* o,
                                 const float* d, const float* maxt, int n,
                                 bool* occ, void* stream) {
  if (n > 0) {
    const int grid = (n + kBlock - 1) / kBlock;
    clu2_kernel<true><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        supers, n_supers, boxes, rows, anchor, o, d, maxt, n, nullptr,
        nullptr, nullptr, nullptr, occ);
  }
  return (int)cudaGetLastError();
}
