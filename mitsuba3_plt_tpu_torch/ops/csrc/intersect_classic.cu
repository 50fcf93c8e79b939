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
// Closest hit (classic_kernel), one thread a ray: the rows are staged into
// shared memory in chunks of kChunk (every thread of the block reads the
// same row: a broadcast), the ray and its best hit stay in registers.
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

namespace {

constexpr int kBlock = 256;
constexpr int kChunk = 512;  // triangle rows per shared-memory stage (18 KB)
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
// ray meets the triangle at 0 < t (the bound on t is the caller's).
// classic_kernel holds a copy of it written out (see there).
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

// The closest hit: one thread a ray over staged chunks. Its test is
// `triangle` written out, every rounded operation the same and in the same
// order; keep the two in step. Built on the helper it ran 6.3% slower on
// each of the intersection tool's four sets (8.8% with the bound on t
// inside the helper), from the same floating-point instructions that nvcc
// scheduled in another order in the row loop (PERF.md section 6).
__global__ void __launch_bounds__(kBlock)
    classic_kernel(const float* __restrict__ tri, int n_tris,
                   const float* __restrict__ o, const float* __restrict__ d,
                   const float* __restrict__ maxt, int n,
                   float* __restrict__ t_out, int* __restrict__ prim_out,
                   float* __restrict__ u_out, float* __restrict__ v_out) {
  __shared__ float s_tri[kChunk * 9];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float t_b = 0.f;
  if (live) {
    ox = o[3 * i + 0];
    oy = o[3 * i + 1];
    oz = o[3 * i + 2];
    dx = d[3 * i + 0];
    dy = d[3 * i + 1];
    dz = d[3 * i + 2];
    const float mt = maxt[i];
    t_b = isfinite(mt) ? mt : 3.4e38f;
  }
  float u_b = 0.f, v_b = 0.f;
  int prim = -1;
  for (int base = 0; base < n_tris; base += kChunk) {
    const int cnt = min(kChunk, n_tris - base);
    __syncthreads();
    for (int k = threadIdx.x; k < cnt * 9; k += kBlock)
      s_tri[k] = tri[base * 9 + k];
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < cnt; ++j) {
      const float* r = s_tri + 9 * j;
      const float e1x = r[3], e1y = r[4], e1z = r[5];
      const float e2x = r[6], e2y = r[7], e2z = r[8];
      const float pvx = sub(mul(dy, e2z), mul(dz, e2y));
      const float pvy = sub(mul(dz, e2x), mul(dx, e2z));
      const float pvz = sub(mul(dx, e2y), mul(dy, e2x));
      const float det = dot3(e1x, e1y, e1z, pvx, pvy, pvz);
      const bool ok = fabsf(det) > 1e-12f;
      const float inv_det = (ok ? 1.f : 0.f) / (ok ? det : 1.f);
      const float tvx = sub(ox, r[0]), tvy = sub(oy, r[1]),
                  tvz = sub(oz, r[2]);
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
        t_b = t;
        u_b = u;
        v_b = v;
        prim = base + j;
      }
    }
  }
  if (!live) return;
  prim_out[i] = prim;
  t_out[i] = prim >= 0 ? t_b : INFINITY;
  u_out[i] = u_b;
  v_out[i] = v_b;
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
    const int grid = (n + kBlock - 1) / kBlock;
    classic_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        tri, n_tris, o, d, maxt, n, t, prim, u, v);
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
