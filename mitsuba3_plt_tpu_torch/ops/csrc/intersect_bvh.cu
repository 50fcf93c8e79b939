// Closest-hit and any-hit by a stackless skip-link BVH walk over the packet
// tables (PacketBVH) of big meshes, one thread per ray.
//
// Replaces: mitsuba3_plt_tpu/ops/intersect_pallas.py::pallas_bvh_intersect
// (Pallas body _bvh_kernel) and ::pallas_bvh_occluded (body
// _bvh_anyhit_kernel).
//
// Tables (scene/bvh.py::pack_packet_bvh, world coordinates):
//   nodes [NN, 16]: lo(3) hi(3) first count miss pad(7), DFS pre-order;
//                   count = 0 marks an inner node whose left child is
//                   `first`; a leaf owns rows [first, first + count) of tri;
//                   `miss` is the node after the subtree, -1 at the end.
//   tri   [P, 16]:  p0(3) e1(3) e2(3), the face index as a float, pad(6).
// Walk: node = (box entered and inner) ? first : miss, until node < 0. The
// TPU kernel moves a whole ray tile through the tree and descends when any
// lane enters a box; here every thread walks alone and tests only the
// leaves whose box its own ray enters. A hit still has to pass the exact
// triangle test, so the two agree except where the slab test rejects, by
// rounding, a box whose triangle the ray grazes.
//
// Triangle test: classic Moller-Trumbore on (p0, e1, e2) with the division
// folded into inv_det = [|det| > 1e-12] / det, as the TPU kernel has it.
// Every product and sum is rounded on its own, left to right (no FMA
// contraction), so a lane equals the plain PyTorch version bit for bit.
// Closest hit accepts on strict t < best with leaves in DFS order and rows
// in order: the first of two equal hits wins. Box gates: closest hit
// near <= far, far > 0, near < best; any hit near < maxt, and the thread
// returns at its first hit with 0 < t < maxt. The inverse direction goes
// through signed_eps (|d| >= 1e-12); an infinite maxt is carried as
// 3.4e38. A dead ray (o = 1e8) fails the root's slab test and leaves.
//
// What bounds it on the H100: operations, and in practice the latency of
// the dependent loads behind them. A camera ray of the 81,920-face scene
// visits 29 nodes (29 operations each) and tests 17 triangles (64 each)
// on average against 28 bytes of ray in and 16 out; the 0.9 MB of nodes
// and 5.2 MB of triangle rows stay in the 50 MB L2. Design: a node is three
// 16-byte loads and a triangle three, through the read-only path; the ray,
// its inverse direction and its best hit stay in registers; no stack, no
// shared memory, no cooperation between the threads of a warp, so an
// incoherent warp pays divergence but never another lane's subtree.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlock = 128;

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

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
    bvh_kernel(const float* __restrict__ nodes, const float* __restrict__ tri,
               const float* __restrict__ o, const float* __restrict__ d,
               const float* __restrict__ maxt, int n,
               float* __restrict__ t_out, int* __restrict__ prim_out,
               float* __restrict__ u_out, float* __restrict__ v_out,
               bool* __restrict__ occ_out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const float ox = o[3 * i + 0], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i + 0], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float ix = 1.f / signed_eps(dx);
  const float iy = 1.f / signed_eps(dy);
  const float iz = 1.f / signed_eps(dz);
  const float mt = maxt[i];
  // the closest hit so far; the any-hit walk keeps it at maxt
  float t_b = isfinite(mt) ? mt : 3.4e38f;
  float prim_b = -1.f, u_b = 0.f, v_b = 0.f;

  int node = 0;
  while (node >= 0) {
    const float4* np = reinterpret_cast<const float4*>(nodes + 16 * node);
    // a = lo.xyz hi.x, b = hi.yz first count, c = miss
    const float4 a = __ldg(np), b = __ldg(np + 1), c = __ldg(np + 2);
    const float tx0 = mul(sub(a.x, ox), ix), tx1 = mul(sub(a.w, ox), ix);
    const float ty0 = mul(sub(a.y, oy), iy), ty1 = mul(sub(b.x, oy), iy);
    const float tz0 = mul(sub(a.z, oz), iz), tz1 = mul(sub(b.y, oz), iz);
    const float near =
        fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
    const float far =
        fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
    const bool enter = near <= far && far > 0.f && near < t_b;
    const int first = (int)b.z, count = (int)b.w;
    if (enter && count > 0) {
      for (int k = first; k < first + count; ++k) {
        const float4* tp = reinterpret_cast<const float4*>(tri + 16 * k);
        // q0 = p0 e1.x, q1 = e1.yz e2.xy, q2 = e2.z face
        const float4 q0 = __ldg(tp), q1 = __ldg(tp + 1), q2 = __ldg(tp + 2);
        const float e1x = q0.w, e1y = q1.x, e1z = q1.y;
        const float e2x = q1.z, e2y = q1.w, e2z = q2.x;
        const float pvx = sub(mul(dy, e2z), mul(dz, e2y));
        const float pvy = sub(mul(dz, e2x), mul(dx, e2z));
        const float pvz = sub(mul(dx, e2y), mul(dy, e2x));
        const float det = dot3(e1x, e1y, e1z, pvx, pvy, pvz);
        const bool ok = fabsf(det) > 1e-12f;
        const float inv_det = (ok ? 1.f : 0.f) / (ok ? det : 1.f);
        const float tvx = sub(ox, q0.x), tvy = sub(oy, q0.y),
                    tvz = sub(oz, q0.z);
        const float u = mul(dot3(tvx, tvy, tvz, pvx, pvy, pvz), inv_det);
        const float qvx = sub(mul(tvy, e1z), mul(tvz, e1y));
        const float qvy = sub(mul(tvz, e1x), mul(tvx, e1z));
        const float qvz = sub(mul(tvx, e1y), mul(tvy, e1x));
        const float v = mul(dot3(dx, dy, dz, qvx, qvy, qvz), inv_det);
        const float t = mul(dot3(e2x, e2y, e2z, qvx, qvy, qvz), inv_det);
        // written out so that a NaN term fails
        const bool hit = ok && u >= 0.f && v >= 0.f &&
                         __fadd_rn(u, v) <= 1.f && t > 0.f && t < t_b;
        if (hit) {
          if (kAnyHit) {
            occ_out[i] = true;
            return;
          }
          t_b = t;
          u_b = u;
          v_b = v;
          prim_b = q2.y;
        }
      }
    }
    node = (enter && count == 0) ? first : (int)c.x;
  }
  if (kAnyHit) {
    occ_out[i] = false;
    return;
  }
  const int prim = (int)prim_b;
  prim_out[i] = prim;
  t_out[i] = prim >= 0 ? t_b : INFINITY;
  u_out[i] = u_b;
  v_out[i] = v_b;
}

}  // namespace

extern "C" int plt_intersect_bvh(const float* nodes, const float* tri,
                                 const float* o, const float* d,
                                 const float* maxt, int n, float* t,
                                 int* prim, float* u, float* v,
                                 void* stream) {
  if (n > 0) {
    const int grid = (n + kBlock - 1) / kBlock;
    bvh_kernel<false><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        nodes, tri, o, d, maxt, n, t, prim, u, v, nullptr);
  }
  return (int)cudaGetLastError();
}

extern "C" int plt_occluded_bvh(const float* nodes, const float* tri,
                                const float* o, const float* d,
                                const float* maxt, int n, bool* occ,
                                void* stream) {
  if (n > 0) {
    const int grid = (n + kBlock - 1) / kBlock;
    bvh_kernel<true><<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        nodes, tri, o, d, maxt, n, nullptr, nullptr, nullptr, nullptr, occ);
  }
  return (int)cudaGetLastError();
}
