// Closest-hit and any-hit over the flat treelet tables (ClusterTable) of
// mid-size scenes, one thread per ray.
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
// Walk: every box in table order; a lane enters a box when its own slab
// test passes (near <= far, far > 0) and its own gate holds (closest hit
// near * ad_b < ts_b; any hit near < maxt and not yet occluded). A warp
// runs a cluster's rows when any of its lanes enters (__any_sync), but a
// lane that did not enter takes nothing from them, so each lane's answer
// is that of its own walk, the plain version's, to the bit. (The TPU kernel
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
// What bounds it on the H100: operations. On the 5,120-face icosphere a
// ray makes 128 slab tests and, on rays from inside it, ~80 triangle tests
// of its own (~29 and ~55 operations each) against 28 bytes of ray in and
// 16 out; the tables (~0.7 MB) stay in L2. But a warp runs the rows of
// every cluster any of its lanes enters, so incoherent rays cost the
// union of 32 walks. Design: boxes and rows read as warp-uniform broadcast
// loads through the read-only path (every lane of a warp reads the same
// address), the ray and its best hit in registers, no shared memory; the
// any-hit warp leaves a cluster, and the walk, when no lane that entered
// is left unoccluded.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlock = 128;
constexpr int kUnroll = 8;  // rows per trip (scene/bvh.py CLU_UNROLL)
constexpr unsigned kFull = 0xffffffffu;

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

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
    clu_kernel(const float* __restrict__ boxes, int n_boxes,
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
  for (int c = 0; c < n_boxes; ++c) {
    if (kAnyHit && !__any_sync(kFull, live && !occ)) break;
    const float4* bp = reinterpret_cast<const float4*>(boxes + 16 * c);
    const float4 ba = __ldg(bp), bb = __ldg(bp + 1);
    float near, far;
    slab(ba, bb, r, near, far);
    const bool enter =
        live && near <= far && far > 0.f &&
        (kAnyHit ? (near < r.tmax && !occ) : (mul(near, ad_b) < ts_b));
    if (!__any_sync(kFull, enter)) continue;
    const int k_end = (int)bb.z + kUnroll * (int)bb.w;
    for (int k = (int)bb.z; k < k_end; ++k) {
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
      const float ad = det * sg, us = up * sg, vs = vp * sg, ts = tp * sg;
      // written out so that a NaN term fails, as jnp.minimum(...) >= 0
      const bool inside = ad > 1e-12f && us >= 0.f && vs >= 0.f &&
                          sub(sub(ad, us), vs) >= 0.f && ts > 0.f;
      if (kAnyHit) {
        occ = occ || (enter && inside && ts < mul(r.tmax, ad));
        // the lane is done at its first hit, the warp when every lane
        // that entered is
        if ((k & (kUnroll - 1)) == kUnroll - 1 &&
            !__any_sync(kFull, enter && !occ))
          break;
      } else if (enter && inside && mul(ts, ad_b) < mul(ts_b, ad)) {
        ts_b = ts;
        ad_b = ad;
        us_b = us;
        vs_b = vs;
        prim_b = __ldg(rows + 32 * k + 16);
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

extern "C" int plt_intersect_clu(const float* boxes, int n_boxes,
                                 const float* rows, const float* anchor,
                                 const float* o, const float* d,
                                 const float* maxt, int n, float* t,
                                 int* prim, float* u, float* v,
                                 void* stream) {
  if (n > 0) {
    const int grid = (n + kBlock - 1) / kBlock;
    clu_kernel<false><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        boxes, n_boxes, rows, anchor, o, d, maxt, n, t, prim, u, v,
        nullptr);
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
    clu_kernel<true><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        boxes, n_boxes, rows, anchor, o, d, maxt, n, nullptr, nullptr,
        nullptr, nullptr, occ);
  }
  return (int)cudaGetLastError();
}
