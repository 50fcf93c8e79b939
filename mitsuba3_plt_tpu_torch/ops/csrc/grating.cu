// Rough diffraction-grating kernels of the PLT wave BSDF, one thread per
// lane:
//
//   plt_grating_lobe_sum  replaces mitsuba3_plt_tpu/ops/grating_pallas.py::
//     grating_lobe_sum (Pallas body _kernel): per-wavelength sum of the
//     diffraction lobes: J_0..J_half of the groove phase, grating-equation
//     lobe centres, the acceptance cone and the angular-coherence Gaussian.
//     Its recording instance (where autograd records) also stores, as
//     bits, which lobes its gates selected.
//   plt_grating_lobe_sum_bwd  replaces the backward of the custom_vjp
//     around grating_lobe_sum (::_make_lobe_sum_vjp): the vector-Jacobian
//     product of the lobe sum, on the same Bessel table, over those bits.
//   plt_grating_sample    replaces ::grating_sample (Pallas body
//     _sample_kernel): visible-normal sample (GGX or Beckmann), microfacet
//     frame, Bessel sweep at the hero wavelength, lobe-CDF pick, grating
//     equation, pdf and Smith G1 times the lobe intensity.
//
// What bounds them on the H100 (B4b aside: below): issue slots, not
// memory. A lane reads 88 bytes and writes 12 (lobe sum, C = 3) or reads
// 76 and writes 66 (sample), and does thousands of instructions. The
// sample kernel keeps the first port's design: the whole chain in the
// registers of one thread, the Miller sweep (64 steps, Hankel asymptotics
// beyond 48) unrolled.
//
// The lobe sum spent most of its slots on work its lanes threw away: 192
// dependent Miller steps a lane, 8 Hankel cosf/sinf a channel computed and
// then dropped by a select, sin(a/2) for every grating type. Design:
// J_0..J_half for |a| <= 48 come from a table (ops/grating.py::
// bessel_table: cubic Hermite coefficients of the sweep in float64 on a
// grid of 1/32, off by ~1e-9, read through the read-only path), three FMAs
// an order; the asymptotics beyond 48 cost one sincosf a channel (cos and
// sin of the other orders' phases by quarter turns); each branch, and
// sin(a/2) for the rectangular profile, runs only where a lane of the warp
// needs it (__any_sync). Every product and sum is written out, as fmaf or
// rounded on its own (__fmul_rn, __fadd_rn), so chip_smoke.py counts its
// operations and FMAs; the IEEE special functions (sqrtf, division, asinf,
// expf, sincosf, sinf) are weighed by their fast paths in the SASS of the
// one-function probes at the end of this file. A lobe's chain (the
// grating equation's division, four square roots, asinf, expf) is what is
// left: 7 lobes x 3 channels of it a lane on the main path. Built without
// --use_fast_math: the IEEE functions are what the tolerances against the
// plain PyTorch version assume. asinf replaces the TPU kernel's
// polynomial asin.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr double kPiD = 3.14159265358979323846;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kEpsilon = 5.9604644775390625e-08f;  // float32 eps / 2
constexpr int kBesselM = 64;
constexpr float kAsympSwitch = 0.75f * kBesselM;
constexpr int kBlock = 128;

// sin(pi j / 2) / (pi j / 2) and 1 / sqrt(j) for j = 1..4 (j is a
// compile-time constant at every call, so these fold away)
__device__ __forceinline__ float rect_sinc(int j) {
  return j == 1 ? 0.6366197723675814f
       : j == 2 ? 3.8981718325193755e-17f
       : j == 3 ? -0.2122065907891938f
                : -3.8981718325193755e-17f;
}
__device__ __forceinline__ float linear_order(int j) {
  return j == 1 ? 1.0f
       : j == 2 ? 0.7071067811865475f
       : j == 3 ? 0.5773502691896258f
                : 0.5f;
}

__device__ __forceinline__ float safe_sqrt(float x) {
  return sqrtf(x > 0.f ? x : 0.f);
}

__device__ __forceinline__ float unit_angle_dot(float dot_uv) {
  const float d = safe_sqrt(2.f - 2.f * fabsf(dot_uv));
  const float theta = 2.f * asinf(fminf(fmaxf(0.5f * d, -1.f), 1.f));
  return dot_uv < 0.f ? kPi - theta : theta;
}

// J_0(|a|)..J_HALF(|a|): Miller downward recurrence from order 64 with the
// 1e18 rescale guard, normalized by J0 + 2 sum J_2k = 1; two-term Hankel
// asymptotics beyond |a| > 48; exact values at 0.
template <int HALF>
__device__ __forceinline__ void bessel_sweep(float a, float (&res)[HALF + 1]) {
  const float x_abs = fabsf(a);
  const float x_safe = fmaxf(x_abs, 1e-6f);
  const float inv_x = 1.0f / x_safe;
  float jp1 = 0.f, jk = 1e-30f, norm = 0.f;
  float outs[HALF + 1];
#pragma unroll
  for (int j = 0; j <= HALF; ++j) outs[j] = 0.f;
#pragma unroll
  for (int i = 0; i < kBesselM; ++i) {
    const float k = (float)(kBesselM - i);
    const float jm1 = (2.0f * k) * inv_x * jk - jp1;
    jp1 = jk;
    jk = jm1;
    const float scale = fabsf(jk) > 1e18f ? 1e-18f : 1.0f;
    const int kk = kBesselM - i - 1;  // jk holds J_kk (unnormalized)
    if (kk % 2 == 0) norm = norm + (kk == 0 ? jk : 2.0f * jk);
    jp1 *= scale;
    jk *= scale;
    norm *= scale;
    if (kk <= HALF) {
      outs[kk] = jk;
#pragma unroll
      for (int j = kk + 1; j <= HALF; ++j) outs[j] *= scale;
    }
  }
  const float inv_norm = (norm >= 0.f ? 1.f : -1.f) / fmaxf(fabsf(norm), 1e-30f);
  const bool use_asym = x_abs > kAsympSwitch;
  const float i8x = 1.0f / (8.0f * x_safe);
  const float sq = sqrtf(2.0f / (kPi * x_safe));
  const bool at_zero = x_abs < 1e-6f;
#pragma unroll
  for (int nu = 0; nu <= HALF; ++nu) {
    const float mu = 4.0f * nu * nu;
    const float p = (mu - 1.0f) * (mu - 9.0f) * 0.5f;
    const float pp = 1.0f - p * i8x * i8x;
    const float q = (mu - 1.0f) * i8x;
    const float omega = x_abs - (float)((0.5 * nu + 0.25) * kPiD);
    const float asym = sq * (cosf(omega) * pp - sinf(omega) * q);
    float r = use_asym ? asym : outs[nu] * inv_norm;
    res[nu] = at_zero ? (nu == 0 ? 1.f : 0.f) : r;
  }
}

// per-order intensities 0..HALF: sinusoidal J_j(a)^2, rectangular
// sin(a/2) sinc(pi j / 2), linear 1/sqrt(j); order 0 is 1 for all
template <int HALF>
__device__ __forceinline__ void base_intensities(float a, bool is_sin,
                                                 bool is_rect,
                                                 float (&base)[HALF + 1]) {
  float J[HALF + 1];
  bessel_sweep<HALF>(a, J);
  const float sin_half_a = sinf(a * 0.5f);
  base[0] = 1.f;
#pragma unroll
  for (int j = 1; j <= HALF; ++j)
    base[j] = is_sin ? J[j] * J[j]
                     : (is_rect ? sin_half_a * rect_sinc(j) : linear_order(j));
}

// diffracted direction components for lobe (lx, ly) via the grating
// equation on the reciprocal lattice
struct Diffracted {
  float aa, bb, mm, qq;
  bool ok;
};

__device__ __forceinline__ Diffracted diffract(float wl_um, float cg, float sg,
                                               float lx, float ly, float ip_x,
                                               float ip_y, float sin_ix,
                                               float sin_iy) {
  Diffracted r;
  const float lob_rx = cg * lx - sg * ly;
  const float lob_ry = sg * lx + cg * ly;
  r.aa = wl_um * lob_rx * ip_x - sin_ix;
  r.bb = wl_um * lob_ry * ip_y - sin_iy;
  const float den = r.aa * r.aa * r.bb * r.bb - 1.0f;
  r.mm = (r.aa * r.aa - 1.0f) / (fabsf(den) > 1e-12f ? den : 1e-12f);
  r.qq = 1.0f - r.bb * r.bb * r.mm;
  r.ok = fabsf(r.aa) <= 1.0f && fabsf(r.bb) <= 1.0f;
  return r;
}

// ---------------------------------------------------------------------------
// lobe sum over the Bessel table
// ---------------------------------------------------------------------------

constexpr int kTableN = 1536;           // intervals of the Bessel table
constexpr float kTableInvStep = 32.0f;  // 1 / its grid step
constexpr float kQuarterPi = 0.78539816339744831f;
constexpr unsigned kFull = 0xffffffffu;

// every product and sum below is rounded on its own (these are never
// contracted) or written as one fmaf, so each operation is counted
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// J_0(|a|)..J_HALF(|a|) of the lanes that `need` them, 0 elsewhere. x <= 48
// from the table: row nu, interval i = floor(32 x) holds the cubic Hermite
// coefficients of J_nu on [i / 32, (i + 1) / 32] in t = 32 x - i (both
// exact), three FMAs an order. x > 48: the two-term Hankel asymptotics,
// with cos and sin of omega_nu = omega_0 - nu pi / 2 read off one sincosf of
// omega_0 = x - pi / 4 by quarter turns. Each branch runs only where a lane
// of the warp takes it. 1 and 0 at x < 1e-6, as the sweep gives.
template <int HALF>
__device__ __forceinline__ void bessel_lookup(float a, bool need,
                                              const float4* __restrict__ table,
                                              float (&res)[HALF + 1]) {
  const float x = fabsf(a);
  const bool use_asym = x > kAsympSwitch;
#pragma unroll
  for (int nu = 0; nu <= HALF; ++nu) res[nu] = 0.f;
  if (__any_sync(kFull, need && !use_asym)) {
    const float s = mul(fminf(x, kAsympSwitch), kTableInvStep);
    const float fi = fminf(floorf(s), (float)(kTableN - 1));
    const float t = sub(s, fi);
    const float4* row = table + (int)fi;
#pragma unroll
    for (int nu = 0; nu <= HALF; ++nu) {
      const float4 c = __ldg(row + nu * kTableN);
      res[nu] = fmaf(t, fmaf(t, fmaf(t, c.w, c.z), c.y), c.x);
    }
  }
  if (__any_sync(kFull, need && use_asym)) {
    const float i8x = 1.0f / mul(8.0f, x);
    const float sq = sqrtf(2.0f / mul(kPi, x));
    float s0, c0;
    sincosf(sub(x, kQuarterPi), &s0, &c0);
#pragma unroll
    for (int nu = 0; nu <= HALF; ++nu) {
      const float mu = 4.0f * nu * nu;
      const float p = fmaf(mul(-(mu - 1.0f) * (mu - 9.0f) * 0.5f, i8x), i8x,
                           1.0f);
      const float q = mul(mu - 1.0f, i8x);
      const float cw = nu % 4 == 0 ? c0 : nu % 4 == 1 ? s0
                     : nu % 4 == 2 ? -c0 : -s0;
      const float sw = nu % 4 == 0 ? s0 : nu % 4 == 1 ? -c0
                     : nu % 4 == 2 ? -s0 : c0;
      const float asym = mul(sq, fmaf(cw, p, -mul(sw, q)));
      res[nu] = use_asym ? asym : res[nu];
    }
  }
  const bool at_zero = x < 1e-6f;
#pragma unroll
  for (int nu = 0; nu <= HALF; ++nu)
    res[nu] = at_zero ? (nu == 0 ? 1.f : 0.f) : res[nu];
}

__device__ __forceinline__ float unit_angle(float dot_uv) {
  const float d = safe_sqrt(fmaf(-2.0f, fabsf(dot_uv), 2.0f));
  const float theta =
      mul(2.0f, asinf(fminf(fmaxf(mul(0.5f, d), -1.f), 1.f)));
  return dot_uv < 0.f ? sub(kPi, theta) : theta;
}

// The lobes of a set, in the order both kernels number them: k = (lx +
// HALF) (2 HALF + 1) + ly + HALF (k = lx + HALF for a separable set, whose
// ly is 0), and the 32-bit words of a (lane, channel)'s selection bits.
template <int HALF, bool SEP>
struct LobeSet {
  static constexpr int kSide = 2 * HALF + 1;
  static constexpr int kLobes = SEP ? kSide : kSide * kSide;
  static constexpr int kWords = (kLobes + 31) / 32;
};

// REC (B4's recording instance, launched where autograd records) also
// stores the gates' verdict (lobe_ok, in_cone, live) of every lobe: bit k
// % 32 of word sel[(C i + c) kWords + k / 32]; B4b reads it. Without REC
// the kernel is PR 7's.
template <int HALF, bool SEP, int C, bool REC>
__global__ void __launch_bounds__(kBlock)
    lobe_sum_kernel(const float* __restrict__ wi, const float* __restrict__ wo,
                    const float* __restrict__ wl_nm,
                    const float* __restrict__ gdir, const float* __restrict__ ip,
                    const float* __restrict__ q, const int* __restrict__ lobes,
                    const int* __restrict__ gtype,
                    const float* __restrict__ mult,
                    const float* __restrict__ coh,
                    const float* __restrict__ acone,
                    const float4* __restrict__ table, int n,
                    float* __restrict__ out, unsigned* __restrict__ sel_out) {
  using Set = LobeSet<HALF, SEP>;
  // no early return: the warp votes below need all 32 threads, so a thread
  // past the end repeats the last lane and stores nothing
  const int i0 = blockIdx.x * kBlock + threadIdx.x;
  const int i = i0 < n ? i0 : n - 1;
  const float wi_x = wi[3 * i], wi_y = wi[3 * i + 1], wi_z = wi[3 * i + 2];
  const float wo_x = wo[3 * i], wo_y = wo[3 * i + 1], wo_z = wo[3 * i + 2];
  const float cg = gdir[2 * i], sg = gdir[2 * i + 1];
  const float ip_x = ip[2 * i], ip_y = ip[2 * i + 1];
  const float qv = q[i], mu_ = mult[i], co_ = coh[i], ac_ = acone[i];
  const float lob = (float)lobes[i], gt = (float)gtype[i];

  // channel-independent quantities
  const float px = sqrtf(fmaf(wi_x, wi_x, mul(wi_z, wi_z)));
  const float py = sqrtf(fmaf(wi_y, wi_y, mul(wi_z, wi_z)));
  const float sin_ix = px > kEpsilon ? wi_x / fmaxf(px, 1e-20f) : 0.f;
  const float sin_iy = py > kEpsilon ? wi_y / fmaxf(py, 1e-20f) : 0.f;
  const float cos_t = fabsf(wi_z);
  const float half_lobes = floorf(mul(lob, 0.5f));
  const bool is_1d = ip_y < kEpsilon;
  const bool is_sin = gt < 0.5f;
  const bool is_rect = fabsf(sub(gt, 1.0f)) < 0.5f;
  const float ny = fmaf(2.0f, half_lobes, 1.0f);
  const float four_pi_q = mul(4.0f * kPi, qv);

#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float wl_um = mul(wl_nm[C * i + c], 1e-3f);
    const float kwn = (2.0f * kPi) / fmaxf(wl_um, 1e-6f);
    const float a = four_pi_q / fmaxf(mul(wl_um, cos_t), 1e-12f);
    float J[HALF + 1];
    bessel_lookup<HALF>(a, is_sin, table, J);
    float sin_half_a = 0.f;
    if (__any_sync(kFull, is_rect)) sin_half_a = sinf(mul(a, 0.5f));
    float base[HALF + 1];
    base[0] = 1.f;
#pragma unroll
    for (int j = 1; j <= HALF; ++j)
      base[j] = is_sin ? mul(J[j], J[j])
                       : (is_rect ? mul(sin_half_a, rect_sinc(j))
                                  : linear_order(j));
    // inverse coherence det of Coherence.isotropic(coh, opl = 1), times
    // -1/2: the Gaussian's exponent is ang^2 times this
    const float s = mul(mul(co_, kwn), (float)(1.0 / (2.0 * kPiD * 1e3)));
    const float expo = mul(mul(s, s), -0.5f);

    float acc = 0.f, corr = 0.f;
    unsigned bits[Set::kWords];
    if constexpr (REC) {
#pragma unroll
      for (int w = 0; w < Set::kWords; ++w) bits[w] = 0u;
    }
#pragma unroll
    for (int lx = -HALF; lx <= HALF; ++lx) {
#pragma unroll
      for (int ly = (SEP ? 0 : -HALF); ly <= (SEP ? 0 : HALF); ++ly) {
        const int ax = lx < 0 ? -lx : lx;
        const int ay = ly < 0 ? -ly : ly;
        const bool live = half_lobes >= (float)(ax > ay ? ax : ay);
        const float ix = base[ax];
        const float iy = is_1d ? ix : base[ay];
        const float lobe_int = mul(mul(mu_, ix), iy);
        // the grating equation on the reciprocal lattice; ly = 0 leaves
        // the products of lx exact, as the plain version's sums give them
        const float flx = (float)lx, fly = (float)ly;
        const float lob_rx =
            SEP ? mul(cg, flx) : sub(mul(cg, flx), mul(sg, fly));
        const float lob_ry =
            SEP ? mul(sg, flx) : add(mul(sg, flx), mul(cg, fly));
        const float aa = sub(mul(mul(wl_um, lob_rx), ip_x), sin_ix);
        const float bb = sub(mul(mul(wl_um, lob_ry), ip_y), sin_iy);
        const float aa2 = mul(aa, aa), bb2 = mul(bb, bb);
        const float den = fmaf(mul(aa2, bb), bb, -1.0f);
        const float mm = sub(aa2, 1.0f) / (fabsf(den) > 1e-12f ? den : 1e-12f);
        const float qq = fmaf(-bb2, mm, 1.0f);
        const bool ok = fabsf(aa) <= 1.0f && fabsf(bb) <= 1.0f;
        const float rz = fmaf(-bb2, mm, fmaf(-aa2, qq, 1.0f));
        const float cd_dot_wo =
            fmaf(safe_sqrt(rz), wo_z,
                 fmaf(mul(bb, safe_sqrt(mm)), wo_y,
                      mul(mul(aa, safe_sqrt(qq)), wo_x)));
        const float ang = unit_angle(cd_dot_wo);
        const bool sel = ok && fabsf(ang) < ac_ && live;
        if constexpr (REC) {
          const int k = (lx + HALF) * (SEP ? 1 : Set::kSide) + ly + HALF -
                        (SEP ? HALF : 0);
          bits[k / 32] |= sel ? 1u << (k % 32) : 0u;
        }
        const float ang_coh = expf(mul(mul(ang, ang), expo));
        if (lx == 0 && ly == 0) {
          acc = add(acc, sel ? lobe_int : 0.f);
          if (SEP)
            corr = sel ? mul(mul(lobe_int, sub(ang_coh, 1.0f)),
                             sub(ny, 1.0f))
                       : 0.f;
        } else {
          acc = add(acc, sel ? mul(lobe_int, ang_coh) : 0.f);
        }
      }
    }
    if (SEP) acc = add(mul(acc, ny), corr);
    if (i0 < n) {
      out[C * i + c] = acc;
      if constexpr (REC) {
#pragma unroll
        for (int w = 0; w < Set::kWords; ++w)
          sel_out[(C * i + c) * Set::kWords + w] = bits[w];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// lobe sum backward (B4b)
// ---------------------------------------------------------------------------

// bessel_lookup's values and their derivatives in x = |a|: on the table
// the Hermite cubic's own, 32 (c1 + t (2 c2 + 3 t c3)); beyond 48 the
// Hankel form's own, with cw' = -sw, sw' = cw, p' = (mu - 1)(mu - 9)
// i8x^2 / x, q' = -(mu - 1) i8x / x and sq' = -sq / (2 x); 0 at x < 1e-6,
// where the values are the constants 1 and 0. A branch runs where this
// lane needs it (no warp vote: B4b's lanes leave early).
template <int HALF>
__device__ __forceinline__ void bessel_lookup_grad(
    float a, const float4* __restrict__ table, float (&res)[HALF + 1],
    float (&dres)[HALF + 1]) {
  const float x = fabsf(a);
  const bool use_asym = x > kAsympSwitch;
#pragma unroll
  for (int nu = 0; nu <= HALF; ++nu) res[nu] = dres[nu] = 0.f;
  if (!use_asym) {
    const float s = mul(fminf(x, kAsympSwitch), kTableInvStep);
    const float fi = fminf(floorf(s), (float)(kTableN - 1));
    const float t = sub(s, fi);
    const float4* row = table + (int)fi;
#pragma unroll
    for (int nu = 0; nu <= HALF; ++nu) {
      const float4 c = __ldg(row + nu * kTableN);
      res[nu] = fmaf(t, fmaf(t, fmaf(t, c.w, c.z), c.y), c.x);
      dres[nu] = kTableInvStep * fmaf(t, fmaf(3.0f * t, c.w, 2.0f * c.z), c.y);
    }
  } else {
    const float i8x = 1.0f / mul(8.0f, x);
    const float sq = sqrtf(2.0f / mul(kPi, x));
    const float inv_x = 1.0f / x;
    float s0, c0;
    sincosf(sub(x, kQuarterPi), &s0, &c0);
#pragma unroll
    for (int nu = 0; nu <= HALF; ++nu) {
      const float mu = 4.0f * nu * nu;
      const float p = fmaf(mul(-(mu - 1.0f) * (mu - 9.0f) * 0.5f, i8x), i8x,
                           1.0f);
      const float q = mul(mu - 1.0f, i8x);
      const float cw = nu % 4 == 0 ? c0 : nu % 4 == 1 ? s0
                     : nu % 4 == 2 ? -c0 : -s0;
      const float sw = nu % 4 == 0 ? s0 : nu % 4 == 1 ? -c0
                     : nu % 4 == 2 ? -s0 : c0;
      res[nu] = mul(sq, fmaf(cw, p, -mul(sw, q)));
      const float dp = (mu - 1.0f) * (mu - 9.0f) * i8x * i8x * inv_x;
      const float dq = -(mu - 1.0f) * i8x * inv_x;
      dres[nu] = sq * (cw * (dp - q) - sw * (p + dq)) - 0.5f * inv_x * res[nu];
    }
  }
  const bool at_zero = x < 1e-6f;
#pragma unroll
  for (int nu = 0; nu <= HALF; ++nu) {
    res[nu] = at_zero ? (nu == 0 ? 1.f : 0.f) : res[nu];
    dres[nu] = at_zero ? 0.f : dres[nu];
  }
}

// B4b, the vector-Jacobian product of lobe_sum_kernel with the cotangent
// g [N, C], over the selection bits of B4's recording instance (sel). It
// replaces the backward of the JAX package's custom_vjp around
// grating_lobe_sum (ops/grating_pallas.py::_make_lobe_sum_vjp, which
// linearizes _lobe_sum_xla in XLA). The output is a sum over the lobes the
// gates (lobe_ok, in_cone, live) select, so only those lobes carry a
// derivative and no lobe needs another's; a lane with no bit set has every
// gradient 0.
//
// What bounds it: bytes, where its design lets it. Every lane reads its
// bits (4 B a channel on a separable set) and writes 16 floats (C = 3);
// only the (lane, channel)s with bits (a tenth of lanes or fewer on the
// paths) read inputs and do arithmetic, a few hundred operations a
// selected lobe in one long dependent chain. Such a chain is latency, so
// what counts is how many run at once: a block of kBwdBlock lanes gathers
// its (lane, channel)s with bits (a warp ballot each, one atomic a warp)
// and its threads take them one each, a channel's chain a thread, in as
// few warps as there are items; each item leaves its 13 lane-level
// adjoints in its own shared-memory slot, and each lane then sums its
// channels' slots in channel order (so the result does not depend on the
// order the items ran in) and finishes its gradients.

constexpr int kBwdBlock = 128;
// the lane-level adjoints a (lane, channel) adds: wo, grating_dir,
// inv_period, q, multiplier, coherence, sin_ix, sin_iy, cos_t
enum LaneAdj {
  kWox, kWoy, kWoz, kCg, kSg, kIpx, kIpy, kQv, kMu, kCo, kSix, kSiy, kCos,
  kLaneAdj
};

// Whether channel c of lane i has a selection bit.
template <int HALF, bool SEP, int C>
__device__ __forceinline__ bool lobe_bwd_has_bits(
    const unsigned* __restrict__ sel, int i, int c) {
  constexpr int kW = LobeSet<HALF, SEP>::kWords;
  unsigned any = 0u;
#pragma unroll
  for (int w = 0; w < kW; ++w) any |= sel[(C * i + c) * kW + w];
  return any != 0u;
}

// Channel c of lane i, which has bits: its g_wl, and its lane-level
// adjoints (LaneAdj) in adj[k * stride]. It takes the Bessel values and
// derivatives (bessel_lookup_grad) and the base intensities once, then
// each set bit (__ffs) recomputes that lobe's chain and takes its
// adjoints. The chain is the plain version's, each
// operation rounded on its own in its order (not B4's fused one: the bits
// already hold B4's gates), so the derivative's own branches (safe_sqrt's
// zeros, d = 0 where wo is the lobe's direction, the 1e-12 floor) fall
// where the plain version's do. The adjoint body is written once: base[ax]
// and its derivative are selects over the HALF + 1 orders, since a runtime
// index into a register array would go to local memory. Conventions,
// those of autograd of the plain version: a clamp passes its whole
// gradient at a tie, |x| has derivative 0 at 0, safe_sqrt's is 0 where its
// argument is <= 0, and unit_angle's is -1 / (d sqrt(1 - d^2 / 4)), d =
// sqrt(2 - 2|cd|) (the arccos derivative), 0 where d or cd is 0. The
// Bessel values and derivatives are the table's. a_cone has no gradient
// (only the cone's gate reads it, and the bits hold that).
template <int HALF, bool SEP, int C>
__device__ __forceinline__ void lobe_bwd_channel(
    int i, int c, const float* __restrict__ wi, const float* __restrict__ wo,
    const float* __restrict__ wl_nm, const float* __restrict__ gdir,
    const float* __restrict__ ip, const float* __restrict__ q,
    const int* __restrict__ lobes, const int* __restrict__ gtype,
    const float* __restrict__ mult, const float* __restrict__ coh,
    const float4* __restrict__ table, const unsigned* __restrict__ sel,
    const float* __restrict__ gout, float* __restrict__ g_wl,
    float* __restrict__ adj, int stride) {
  using Set = LobeSet<HALF, SEP>;
  const float wo_x = wo[3 * i], wo_y = wo[3 * i + 1], wo_z = wo[3 * i + 2];
  const float cg = gdir[2 * i], sg = gdir[2 * i + 1];
  const float ip_x = ip[2 * i], ip_y = ip[2 * i + 1];
  const float mu_ = mult[i], co_ = coh[i];
  const float gt = (float)gtype[i];
  float sin_ix, sin_iy, cos_t;
  {
    const float wi_x = wi[3 * i], wi_y = wi[3 * i + 1], wi_z = wi[3 * i + 2];
    const float px = sqrtf(add(mul(wi_x, wi_x), mul(wi_z, wi_z)));
    const float py = sqrtf(add(mul(wi_y, wi_y), mul(wi_z, wi_z)));
    sin_ix = px > kEpsilon ? wi_x / fmaxf(px, 1e-20f) : 0.f;
    sin_iy = py > kEpsilon ? wi_y / fmaxf(py, 1e-20f) : 0.f;
    cos_t = fabsf(wi_z);
  }
  const float half_lobes = floorf(mul((float)lobes[i], 0.5f));
  const bool is_1d = ip_y < kEpsilon;
  const bool is_sin = gt < 0.5f;
  const bool is_rect = fabsf(sub(gt, 1.0f)) < 0.5f;
  const float ny = add(mul(2.0f, half_lobes), 1.0f);
  const float four_pi_q = mul(4.0f * kPi, q[i]);
  const float kCoh = (float)(1.0 / (2.0 * kPiD * 1e3));

  // this channel's adjoints of the lane's inputs and of its
  // channel-independent terms
  float g_wox = 0.f, g_woy = 0.f, g_woz = 0.f, g_cg = 0.f, g_sg = 0.f;
  float g_ipx = 0.f, g_ipy = 0.f, g_qv = 0.f, g_mu = 0.f, g_co = 0.f;
  float g_six = 0.f, g_siy = 0.f, g_cos = 0.f;

  const unsigned* ch_sel = sel + (C * i + c) * Set::kWords;
  const float g = gout[C * i + c];
  const float wl_um = mul(wl_nm[C * i + c], 1e-3f);
  const float kwn = (2.0f * kPi) / fmaxf(wl_um, 1e-6f);
  const float den_a = mul(wl_um, cos_t);
  const float a = four_pi_q / fmaxf(den_a, 1e-12f);
  // base[j] and its derivative in a: sinusoidal J_j^2 (2 J_j J_j' sgn a),
  // rectangular sin(a / 2) sinc (cos(a / 2) sinc / 2), linear constant
  float base[HALF + 1], dbase[HALF + 1];
  if (is_sin) {
    bessel_lookup_grad<HALF>(a, table, base, dbase);
    const float sgn = a > 0.f ? 2.0f : a < 0.f ? -2.0f : 0.f;
#pragma unroll
    for (int j = 1; j <= HALF; ++j) {
      dbase[j] = sgn * base[j] * dbase[j];
      base[j] = mul(base[j], base[j]);
    }
  } else {
    float sin_half_a = 0.f, cos_half_a = 0.f;
    if (is_rect) sincosf(mul(a, 0.5f), &sin_half_a, &cos_half_a);
#pragma unroll
    for (int j = 1; j <= HALF; ++j) {
      base[j] = is_rect ? mul(sin_half_a, rect_sinc(j)) : linear_order(j);
      dbase[j] = is_rect ? 0.5f * cos_half_a * rect_sinc(j) : 0.f;
    }
  }
  base[0] = 1.f;
  const float s = mul(mul(co_, kwn), kCoh);
  const float expo = mul(mul(s, s), -0.5f);
  // d out / d acc (the separable sum is acc ny + corr)
  const float dacc = SEP ? g * ny : g;
  float g_expo = 0.f, g_wlu = 0.f, g_a = 0.f;

#pragma unroll 1
  for (int w = 0; w < Set::kWords; ++w) {
    unsigned bits = ch_sel[w];
    while (bits) {
      const int k = 32 * w + __ffs(bits) - 1;
      bits &= bits - 1u;
      const int kx = SEP ? k : k / Set::kSide;
      const int lx = kx - HALF, ly = SEP ? 0 : k - kx * Set::kSide - HALF;
      const int ax = lx < 0 ? -lx : lx, ay = ly < 0 ? -ly : ly;
      float ix = base[0], iyb = base[0];
#pragma unroll
      for (int j = 1; j <= HALF; ++j) {
        ix = ax == j ? base[j] : ix;
        iyb = ay == j ? base[j] : iyb;
      }
      const float iy = is_1d ? ix : iyb;
      const float lobe_int = mul(mul(mu_, ix), iy);
      // the plain version's chain of this lobe
      const float flx = (float)lx, fly = (float)ly;
      const float lob_rx =
          SEP ? mul(cg, flx) : sub(mul(cg, flx), mul(sg, fly));
      const float lob_ry =
          SEP ? mul(sg, flx) : add(mul(sg, flx), mul(cg, fly));
      const float aa = sub(mul(mul(wl_um, lob_rx), ip_x), sin_ix);
      const float bb = sub(mul(mul(wl_um, lob_ry), ip_y), sin_iy);
      const float aa2 = mul(aa, aa), bb2 = mul(bb, bb);
      const float den = sub(mul(mul(aa2, bb), bb), 1.0f);
      const bool den_ok = fabsf(den) > 1e-12f;
      const float den_c = den_ok ? den : 1e-12f;
      const float mm = sub(aa2, 1.0f) / den_c;
      const float qq = sub(1.0f, mul(bb2, mm));
      const float rz = sub(sub(1.0f, mul(aa2, qq)), mul(bb2, mm));
      const float sq_q = safe_sqrt(qq), sq_m = safe_sqrt(mm);
      const float sq_r = safe_sqrt(rz);
      const float cd = add(add(mul(mul(aa, sq_q), wo_x),
                               mul(mul(bb, sq_m), wo_y)),
                           mul(sq_r, wo_z));
      const float ang = unit_angle(cd);
      const float ang_coh = expf(mul(mul(ang, ang), expo));

      // adjoints of lobe_int and of ang_coh; the centre lobe's Gaussian
      // enters the separable sum only through its correction
      const bool centre = lx == 0 && ly == 0;
      const float d_li =
          centre ? (SEP ? dacc + g * (ang_coh - 1.0f) * (ny - 1.0f) : dacc)
                 : dacc * ang_coh;
      const float d_coh =
          centre ? (SEP ? g * lobe_int * (ny - 1.0f) : 0.f) : dacc * lobe_int;
      g_mu += d_li * ix * iy;
      const float g_ix = d_li * mu_ * iy, g_iy = d_li * mu_ * ix;
      const float g_bx = is_1d ? g_ix + g_iy : g_ix;
      const float g_by = is_1d ? 0.f : g_iy;
      float d_ax = 0.f, d_ay = 0.f;
#pragma unroll
      for (int j = 1; j <= HALF; ++j) {
        d_ax = ax == j ? dbase[j] : d_ax;
        d_ay = ay == j ? dbase[j] : d_ay;
      }
      g_a += g_bx * d_ax + g_by * d_ay;

      // ang_coh = exp(ang^2 expo)
      const float e = d_coh * ang_coh;
      g_expo += e * ang * ang;
      const float g_ang = 2.0f * e * ang * expo;
      const float d = safe_sqrt(fmaf(-2.0f, fabsf(cd), 2.0f));
      const float hd = 0.5f * d;
      const float g_cd = (d > 0.f && cd != 0.f)
                             ? -g_ang / (d * sqrtf(1.0f - hd * hd))
                             : 0.f;

      // cd = aa sqrt(qq) wo_x + bb sqrt(mm) wo_y + sqrt(rz) wo_z
      g_wox += g_cd * aa * sq_q;
      g_woy += g_cd * bb * sq_m;
      g_woz += g_cd * sq_r;
      float g_aa = g_cd * sq_q * wo_x;
      float g_bb = g_cd * sq_m * wo_y;
      float g_qq = qq > 0.f ? 0.5f * g_cd * aa * wo_x / sq_q : 0.f;
      float g_mm = mm > 0.f ? 0.5f * g_cd * bb * wo_y / sq_m : 0.f;
      const float g_rz = rz > 0.f ? 0.5f * g_cd * wo_z / sq_r : 0.f;
      // rz = 1 - aa^2 qq - bb^2 mm
      g_aa -= 2.0f * aa * qq * g_rz;
      g_qq -= aa2 * g_rz;
      g_bb -= 2.0f * bb * mm * g_rz;
      g_mm -= bb2 * g_rz;
      // qq = 1 - bb^2 mm
      g_bb -= 2.0f * bb * mm * g_qq;
      g_mm -= bb2 * g_qq;
      // mm = (aa^2 - 1) / den, den = aa^2 bb^2 - 1 (the 1e-12 floor has
      // none)
      g_aa += 2.0f * aa * g_mm / den_c;
      if (den_ok) {
        const float g_den = -mm * g_mm / den_c;
        g_aa += 2.0f * aa * bb2 * g_den;
        g_bb += 2.0f * bb * aa2 * g_den;
      }
      // aa = wl lob_rx ip_x - sin_ix, bb = wl lob_ry ip_y - sin_iy
      g_wlu += g_aa * lob_rx * ip_x + g_bb * lob_ry * ip_y;
      g_ipx += g_aa * wl_um * lob_rx;
      g_ipy += g_bb * wl_um * lob_ry;
      g_six -= g_aa;
      g_siy -= g_bb;
      const float g_rx = g_aa * wl_um * ip_x, g_ry = g_bb * wl_um * ip_y;
      // lob_rx = cg lx - sg ly, lob_ry = sg lx + cg ly
      g_cg += g_rx * flx + g_ry * fly;
      g_sg += g_ry * flx - g_rx * fly;
    }
  }

  // expo = -s^2 / 2, s = coh kwn / (2 pi 1e3), kwn = 2 pi / wl
  const float g_s = -s * g_expo;
  g_co += g_s * kwn * kCoh;
  if (wl_um > 1e-6f) g_wlu -= g_s * co_ * kCoh * kwn / wl_um;
  // a = 4 pi q / (wl cos_t)
  if (den_a > 1e-12f) {
    g_qv += g_a * (4.0f * kPi) / den_a;
    const float g_den_a = -g_a * a / den_a;
    g_wlu += g_den_a * cos_t;
    g_cos += g_den_a * wl_um;
  }
  g_wl[C * i + c] = g_wlu * 1e-3f;
  const float out[kLaneAdj] = {g_wox, g_woy, g_woz, g_cg, g_sg, g_ipx, g_ipy,
                               g_qv, g_mu, g_co, g_six, g_siy, g_cos};
#pragma unroll
  for (int k = 0; k < kLaneAdj; ++k) adj[k * stride] = out[k];
}

// Lane i's gradients from the lane-level adjoints its channels with bits
// (bit c of chans) left in adj[(c * kLaneAdj + k) * stride], summed in
// channel order; zeros where it has none.
template <int C>
__device__ __forceinline__ void lobe_bwd_finish(
    int i, unsigned chans, const float* __restrict__ wi,
    const float* __restrict__ adj, int stride, float* __restrict__ g_wi,
    float* __restrict__ g_wo, float* __restrict__ g_wl,
    float* __restrict__ g_gdir, float* __restrict__ g_ip,
    float* __restrict__ g_q, float* __restrict__ g_mult,
    float* __restrict__ g_coh) {
  float a[kLaneAdj];
#pragma unroll
  for (int k = 0; k < kLaneAdj; ++k) a[k] = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if ((chans >> c) & 1u) {
#pragma unroll
      for (int k = 0; k < kLaneAdj; ++k)
        a[k] += adj[(c * kLaneAdj + k) * stride];
    } else {
      g_wl[C * i + c] = 0.f;
    }
  }
  // sin_ix = wi_x / px, px = sqrt(wi_x^2 + wi_z^2) (0 below Epsilon); the
  // same for y; cos_t = |wi_z|
  float g_wix = 0.f, g_wiy = 0.f, g_wiz = 0.f;
  if (chans) {
    const float wi_x = wi[3 * i], wi_y = wi[3 * i + 1], wi_z = wi[3 * i + 2];
    const float px = sqrtf(add(mul(wi_x, wi_x), mul(wi_z, wi_z)));
    const float py = sqrtf(add(mul(wi_y, wi_y), mul(wi_z, wi_z)));
    const float g_six = a[kSix], g_siy = a[kSiy];
    g_wiz = wi_z > 0.f ? a[kCos] : wi_z < 0.f ? -a[kCos] : 0.f;
    if (px > kEpsilon) {
      const float sin_ix = wi_x / fmaxf(px, 1e-20f);
      const float g_px = -g_six * sin_ix / px;
      g_wix += g_six / px + g_px * wi_x / px;
      g_wiz += g_px * wi_z / px;
    }
    if (py > kEpsilon) {
      const float sin_iy = wi_y / fmaxf(py, 1e-20f);
      const float g_py = -g_siy * sin_iy / py;
      g_wiy += g_siy / py + g_py * wi_y / py;
      g_wiz += g_py * wi_z / py;
    }
  }
  g_wi[3 * i] = g_wix;
  g_wi[3 * i + 1] = g_wiy;
  g_wi[3 * i + 2] = g_wiz;
  g_wo[3 * i] = a[kWox];
  g_wo[3 * i + 1] = a[kWoy];
  g_wo[3 * i + 2] = a[kWoz];
  g_gdir[2 * i] = a[kCg];
  g_gdir[2 * i + 1] = a[kSg];
  g_ip[2 * i] = a[kIpx];
  g_ip[2 * i + 1] = a[kIpy];
  g_q[i] = a[kQv];
  g_mult[i] = a[kMu];
  g_coh[i] = a[kCo];
}

// B4b's kernel: a block takes kBwdBlock lanes, a thread each. Each thread
// reads its lane's bits and, with its warp (every lane of it votes; none
// has left), appends the lane's channels with bits to the block's list
// (todo: lane * C + channel). Then the listed items, one a thread
// (lobe_bwd_channel, no vote), each into its own slot of adj; then each
// thread finishes its lane (lobe_bwd_finish).
template <int HALF, bool SEP, int C>
__global__ void __launch_bounds__(kBwdBlock) lobe_sum_bwd_kernel(
    const float* __restrict__ wi, const float* __restrict__ wo,
    const float* __restrict__ wl_nm, const float* __restrict__ gdir,
    const float* __restrict__ ip, const float* __restrict__ q,
    const int* __restrict__ lobes, const int* __restrict__ gtype,
    const float* __restrict__ mult, const float* __restrict__ coh,
    const float4* __restrict__ table, const unsigned* __restrict__ sel,
    const float* __restrict__ gout, int n, float* __restrict__ g_wi,
    float* __restrict__ g_wo, float* __restrict__ g_wl,
    float* __restrict__ g_gdir, float* __restrict__ g_ip,
    float* __restrict__ g_q, float* __restrict__ g_mult,
    float* __restrict__ g_coh) {
  __shared__ float adj[C * kLaneAdj * kBwdBlock];
  __shared__ int todo[C * kBwdBlock];
  __shared__ int count;
  if (threadIdx.x == 0) count = 0;
  __syncthreads();
  const int first = blockIdx.x * kBwdBlock, l = threadIdx.x, i = first + l;
  const unsigned below = (1u << (l % 32)) - 1u;
  unsigned chans = 0u;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const bool has = i < n && lobe_bwd_has_bits<HALF, SEP, C>(sel, i, c);
    chans |= has ? 1u << c : 0u;
    const unsigned mask = __ballot_sync(kFull, has);
    int at = 0;
    if (l % 32 == 0 && mask) at = atomicAdd(&count, __popc(mask));
    at = __shfl_sync(kFull, at, 0);
    if (has) todo[at + __popc(mask & below)] = l * C + c;
  }
  __syncthreads();
  const int m = count;
  for (int j = l; j < m; j += kBwdBlock) {
    const int il = todo[j] / C, c = todo[j] - il * C;
    lobe_bwd_channel<HALF, SEP, C>(first + il, c, wi, wo, wl_nm, gdir, ip,
                                   q, lobes, gtype, mult, coh, table, sel,
                                   gout, g_wl,
                                   adj + c * kLaneAdj * kBwdBlock + il,
                                   kBwdBlock);
  }
  __syncthreads();
  if (i < n)
    lobe_bwd_finish<C>(i, chans, wi, adj + l, kBwdBlock, g_wi, g_wo, g_wl,
                       g_gdir, g_ip, g_q, g_mult, g_coh);
}

// Smith G1, NDF 0 = GGX, 1 = Beckmann (rational fit)
template <int NDF>
__device__ __forceinline__ float smith_g1(float vx, float vy, float vz,
                                          float mx, float my, float mz,
                                          float au, float av) {
  const float xy2 = (au * vx) * (au * vx) + (av * vy) * (av * vy);
  const float tan2 = xy2 / fmaxf(vz * vz, 1e-20f);
  float g;
  if (NDF == 1) {
    const float a = rsqrtf(fmaxf(tan2, 1e-30f));
    const float a2 = a * a;
    const float approx =
        (3.535f * a + 2.181f * a2) / (1.0f + 2.276f * a + 2.577f * a2);
    g = fminf(a >= 1.6f ? 1.0f : approx, 1.0f);
  } else {
    g = 2.0f / (1.0f + sqrtf(1.0f + tan2));
  }
  g = xy2 == 0.f ? 1.f : g;
  const bool backfacing = (vx * mx + vy * my + vz * mz) * vz <= 0.f;
  return backfacing ? 0.f : g;
}

struct PickedLobe {
  float idx, sgn, pdf;
};

// folded-uniform lobe pick: |2(u - 1/2)| walks the one-sided CDF
template <int HALF>
__device__ __forceinline__ PickedLobe pick_lobe(float u,
                                                const float (&p_ord)[HALF + 1]) {
  const float rn = (u - 0.5f) * 2.0f;
  PickedLobe r;
  r.sgn = rn >= 0.f ? 1.f : -1.f;
  const float arn = fabsf(rn);
  float cdf_excl = 0.f;
  int count = 0;
#pragma unroll
  for (int j = 0; j <= HALF; ++j) {
    count += arn > cdf_excl ? 1 : 0;
    cdf_excl = cdf_excl + p_ord[j];
  }
  const int idx = min(max(count - 1, 0), HALF);
  float pj = 0.f;
#pragma unroll
  for (int j = 0; j <= HALF; ++j) pj = idx == j ? p_ord[j] : pj;
  r.pdf = idx == 0 ? pj : pj * 0.5f;
  r.idx = (float)idx;
  return r;
}

template <int HALF, int NDF>
__global__ void __launch_bounds__(kBlock) sample_kernel(
    const float* __restrict__ wi, const float* __restrict__ u2,
    const float* __restrict__ lobe_u2, const float* __restrict__ wl,
    const float* __restrict__ alpha, const float* __restrict__ gdir,
    const float* __restrict__ ip, const float* __restrict__ q,
    const int* __restrict__ lobes, const int* __restrict__ gtype,
    const float* __restrict__ mult, int n, float* __restrict__ wo_out,
    float* __restrict__ pdf_out, int* __restrict__ lobe_out,
    float* __restrict__ wint_out, float* __restrict__ refl_out,
    float* __restrict__ m_out, bool* __restrict__ ok_out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const float wi_x = wi[3 * i], wi_y = wi[3 * i + 1], wi_z = wi[3 * i + 2];
  const float u1 = u2[2 * i], u2v = u2[2 * i + 1];
  const float lu1 = lobe_u2[2 * i], lu2 = lobe_u2[2 * i + 1];
  const float wl_um = wl[i];
  const float au = alpha[2 * i], av = alpha[2 * i + 1];
  const float cg = gdir[2 * i], sg = gdir[2 * i + 1];
  const float ip_x = ip[2 * i], ip_y = ip[2 * i + 1];
  const float qv = q[i], mu_ = mult[i];
  const float lob = (float)lobes[i], gt = (float)gtype[i];

  const float cos_i = wi_z;
  const bool flip = cos_i < 0.f;
  const float wux = flip ? -wi_x : wi_x;
  const float wuy = flip ? -wi_y : wi_y;
  const float wuz = flip ? -wi_z : wi_z;

  // visible-normal sample in the stretched configuration
  const float vx = au * wux, vy = av * wuy, vz = wuz;
  const float inv_n = rsqrtf(fmaxf(vx * vx + vy * vy + vz * vz, 1e-24f));
  const float vhx = vx * inv_n, vhy = vy * inv_n, vhz = vz * inv_n;
  float mx, my, mz;
  if (NDF == 1) {  // Beckmann: erf-domain Newton inversion (Heitz & d'Eon)
    const float sin2d = vhx * vhx + vhy * vhy;
    const float inv_l = rsqrtf(fmaxf(sin2d, 1e-30f));
    const bool near_n = sin2d < 1e-14f;
    const float cos_phi = near_n ? 1.f : vhx * inv_l;
    const float sin_phi = near_n ? 0.f : vhy * inv_l;
    const float ct = fminf(fmaxf(vhz, 1e-6f), 1.0f);
    const float tan_t = safe_sqrt(1.0f - ct * ct) / ct;
    const float cot_t = 1.0f / fmaxf(tan_t, 1e-12f);
    const float maxval = erff(fminf(cot_t, 6.0f));
    float uxs = fminf(fmaxf(u1, 1e-6f), 1.0f - 1e-6f);
    const float uys = fminf(fmaxf(u2v, 1e-6f), 1.0f - 1e-6f);
    const float inv_sqrt_pi = 0.5641895835477563f;
    float x = maxval - (maxval + 1.0f) * erff(sqrtf(-logf(uxs)));
    uxs = uxs * (1.0f + maxval + inv_sqrt_pi * tan_t * expf(-(cot_t * cot_t)));
#pragma unroll
    for (int it = 0; it < 3; ++it) {
      x = fminf(fmaxf(x, -1.0f + 1e-6f), 1.0f - 1e-6f);
      const float slope = erfinvf(x);
      const float value =
          1.0f + x + inv_sqrt_pi * tan_t * expf(-(slope * slope)) - uxs;
      const float deriv = 1.0f - slope * tan_t;
      x = x - value / (fabsf(deriv) > 1e-6f ? deriv
                                             : (deriv >= 0.f ? 1e-6f : -1e-6f));
    }
    x = fminf(fmaxf(x, -1.0f + 1e-6f), 1.0f - 1e-6f);
    const float slope_x = erfinvf(x);
    const float slope_y = erfinvf(2.0f * uys - 1.0f);
    const float sxs = (cos_phi * slope_x - sin_phi * slope_y) * au;
    const float sys = (sin_phi * slope_x + cos_phi * slope_y) * av;
    const float inv_m = rsqrtf(fmaxf(sxs * sxs + sys * sys + 1.0f, 1e-24f));
    mx = -sxs * inv_m;
    my = -sys * inv_m;
    mz = inv_m;
  } else {  // GGX (Heitz 2018)
    const float lensq = vhx * vhx + vhy * vhy;
    const float inv_len = rsqrtf(fmaxf(lensq, 1e-30f));
    const bool big = lensq > 1e-12f;
    const float t1x = big ? -vhy * inv_len : 1.f;
    const float t1y = big ? vhx * inv_len : 0.f;
    const float t2x = vhy * 0.0f - vhz * t1y;
    const float t2y = vhz * t1x - vhx * 0.0f;
    const float t2z = vhx * t1y - vhy * t1x;
    const float r = sqrtf(fmaxf(u1, 0.f));
    const float phi = (2.0f * kPi) * u2v;
    const float p1 = r * cosf(phi);
    float p2 = r * sinf(phi);
    const float s = 0.5f * (1.0f + vhz);
    p2 = (1.0f - s) * safe_sqrt(1.0f - p1 * p1) + s * p2;
    const float p3 = safe_sqrt(1.0f - p1 * p1 - p2 * p2);
    const float nhx = p1 * t1x + p2 * t2x + p3 * vhx;
    const float nhy = p1 * t1y + p2 * t2y + p3 * vhy;
    const float nhz = p1 * 0.0f + p2 * t2z + p3 * vhz;
    const float mxu = au * nhx, myu = av * nhy, mzu = fmaxf(nhz, 1e-6f);
    const float inv_m = rsqrtf(fmaxf(mxu * mxu + myu * myu + mzu * mzu, 1e-24f));
    mx = mxu * inv_m;
    my = myu * inv_m;
    mz = mzu * inv_m;
  }

  // visible-normal pdf G1(wi) |wi.m| D(m) / |cos_i|
  const float ct2 = mz * mz;
  const float cos4 = ct2 * ct2;
  const float inv_ct = 1.0f / fmaxf(fabsf(mz), 1e-12f);
  const float su = (-mx * inv_ct) / au;
  const float sv = (-my * inv_ct) / av;
  const float s2 = su * su + sv * sv;
  float d_ndf;
  if (NDF == 1) {
    d_ndf = expf(-s2) / (kPi * au * av * fmaxf(cos4, 1e-20f));
  } else {
    const float tmp = 1.0f + s2;
    d_ndf = 1.0f / (kPi * au * av * tmp * tmp * fmaxf(cos4, 1e-20f));
  }
  d_ndf = mz > 0.f ? d_ndf : 0.f;
  const float g1_wi = smith_g1<NDF>(wux, wuy, wuz, mx, my, mz, au, av);
  const float dot_wm = wux * mx + wuy * my + wuz * mz;
  const float mpdf = g1_wi * fabsf(dot_wm) * d_ndf / fmaxf(fabsf(wuz), 1e-12f);

  // specular reflection of the original wi about m
  const float dwm = wi_x * mx + wi_y * my + wi_z * mz;
  const float rx = 2.0f * dwm * mx - wi_x;
  const float ry = 2.0f * dwm * my - wi_y;
  const float rz = 2.0f * dwm * mz - wi_z;

  // frame around m (Duff et al. 2017)
  const float sgn = mz >= 0.f ? 1.f : -1.f;
  const float a_c = -1.0f / (sgn + mz);
  const float b_c = mx * my * a_c;
  const float msx = (mz >= 0.f ? mx * mx * a_c : -(mx * mx * a_c)) + 1.0f;
  const float msy = mz >= 0.f ? b_c : -b_c;
  const float msz = mz >= 0.f ? -mx : mx;
  const float mtx = b_c;
  const float mty = my * my * a_c + sgn;
  const float mtz = -my;
  const float wmx = wi_x * msx + wi_y * msy + wi_z * msz;
  const float wmy = wi_x * mtx + wi_y * mty + wi_z * mtz;
  const float wmz = wi_x * mx + wi_y * my + wi_z * mz;

  // order intensities at the hero wavelength
  const bool is_sin = gt < 0.5f;
  const bool is_rect = fabsf(gt - 1.0f) < 0.5f;
  const float a_b = 4.0f * kPi * qv / fmaxf(wl_um * fabsf(wmz), 1e-12f);
  float base[HALF + 1];
  base_intensities<HALF>(a_b, is_sin, is_rect, base);

  // one-sided lobe CDF
  const float half_lobes = floorf(lob * 0.5f);
  float ints[HALF + 1];
  float total = 0.f;
#pragma unroll
  for (int j = 0; j <= HALF; ++j) {
    float v = base[j] * mu_;
    if (j == 0) v = v * 0.5f;
    ints[j] = half_lobes >= (float)j ? v : 0.f;
    total = j == 0 ? ints[0] : total + ints[j];
  }
  const float inv_tot = 1.0f / fmaxf(total, 1e-30f);
  float p_ord[HALF + 1];
#pragma unroll
  for (int j = 0; j <= HALF; ++j) p_ord[j] = ints[j] * inv_tot;
  const PickedLobe pkx = pick_lobe<HALF>(lu1, p_ord);
  const PickedLobe pky = pick_lobe<HALF>(lu2, p_ord);
  const float lx = pkx.idx * pkx.sgn;
  const float ly = pky.idx * pky.sgn;

  // lobe intensity mult * I(|lx|) * I(|ly|)
  float bx = 0.f, by = 0.f;
#pragma unroll
  for (int j = 0; j <= HALF; ++j) {
    bx = pkx.idx == (float)j ? base[j] : bx;
    by = pky.idx == (float)j ? base[j] : by;
  }
  const bool is_1d = ip_y < kEpsilon;
  const float inten = mu_ * bx * (is_1d ? bx : by);

  // grating equation in the microfacet frame
  const float pxm = sqrtf(wmx * wmx + wmz * wmz);
  const float pym = sqrtf(wmy * wmy + wmz * wmz);
  const float sin_ix = pxm > kEpsilon ? wmx / fmaxf(pxm, 1e-20f) : 0.f;
  const float sin_iy = pym > kEpsilon ? wmy / fmaxf(pym, 1e-20f) : 0.f;
  const Diffracted g =
      diffract(wl_um, cg, sg, lx, ly, ip_x, ip_y, sin_ix, sin_iy);
  const float womx = g.aa * safe_sqrt(g.qq);
  const float womy = g.bb * safe_sqrt(g.mm);
  const float womz = safe_sqrt(1.0f - g.aa * g.aa * g.qq - g.bb * g.bb * g.mm);
  const float wox = msx * womx + mtx * womy + mx * womz;
  const float woy = msy * womx + mty * womy + my * womz;
  const float woz = msz * womx + mtz * womy + mz * womz;

  const float grating_pdf = pkx.pdf * pky.pdf;
  const float dot_rm = rx * mx + ry * my + rz * mz;
  const float pdf = mpdf * grating_pdf / fmaxf(4.0f * fabsf(dot_rm), 1e-12f);
  const bool ok = cos_i > 0.f && mpdf > 0.f && woz > 0.f && g.ok;
  const float g1_r = smith_g1<NDF>(rx, ry, rz, mx, my, mz, au, av);

  wo_out[3 * i] = wox;
  wo_out[3 * i + 1] = woy;
  wo_out[3 * i + 2] = woz;
  pdf_out[i] = pdf;
  lobe_out[2 * i] = (int)lx;
  lobe_out[2 * i + 1] = (int)ly;
  wint_out[i] = g1_r * inten;
  refl_out[3 * i] = rx;
  refl_out[3 * i + 1] = ry;
  refl_out[3 * i + 2] = rz;
  m_out[3 * i] = mx;
  m_out[3 * i + 1] = my;
  m_out[3 * i + 2] = mz;
  ok_out[i] = ok;
}

// instantiated for C = 3 only: the RGB configuration is the one this port
// renders (each instance adds seconds to the build)
constexpr int kChannels = 3;

template <int HALF, bool SEP>
void launch_lobe_sum(cudaStream_t st, const float* wi, const float* wo,
                     const float* wl, const float* gdir, const float* ip,
                     const float* q, const int* lobes, const int* gtype,
                     const float* mult, const float* coh, const float* acone,
                     const float4* table, int n, float* out, unsigned* sel) {
  const int grid = (n + kBlock - 1) / kBlock;
  if (sel)
    lobe_sum_kernel<HALF, SEP, kChannels, true><<<grid, kBlock, 0, st>>>(
        wi, wo, wl, gdir, ip, q, lobes, gtype, mult, coh, acone, table, n,
        out, sel);
  else
    lobe_sum_kernel<HALF, SEP, kChannels, false><<<grid, kBlock, 0, st>>>(
        wi, wo, wl, gdir, ip, q, lobes, gtype, mult, coh, acone, table, n,
        out, nullptr);
}

template <int HALF, bool SEP>
void launch_lobe_sum_bwd(cudaStream_t st, const float* wi, const float* wo,
                         const float* wl, const float* gdir, const float* ip,
                         const float* q, const int* lobes, const int* gtype,
                         const float* mult, const float* coh,
                         const float4* table, const unsigned* sel,
                         const float* g, int n, float* g_wi, float* g_wo,
                         float* g_wl, float* g_gdir, float* g_ip, float* g_q,
                         float* g_mult, float* g_coh) {
  const int grid = (n + kBwdBlock - 1) / kBwdBlock;
  lobe_sum_bwd_kernel<HALF, SEP, kChannels><<<grid, kBwdBlock, 0, st>>>(
      wi, wo, wl, gdir, ip, q, lobes, gtype, mult, coh, table, sel, g, n,
      g_wi, g_wo, g_wl, g_gdir, g_ip, g_q, g_mult, g_coh);
}

template <int HALF>
void launch_sample(int ndf, int grid, cudaStream_t st, const float* wi,
                   const float* u2, const float* lu2, const float* wl,
                   const float* alpha, const float* gdir, const float* ip,
                   const float* q, const int* lobes, const int* gtype,
                   const float* mult, int n, float* wo, float* pdf, int* lobe,
                   float* wint, float* refl, float* m, bool* ok) {
  if (ndf == 1)
    sample_kernel<HALF, 1><<<grid, kBlock, 0, st>>>(
        wi, u2, lu2, wl, alpha, gdir, ip, q, lobes, gtype, mult, n, wo, pdf,
        lobe, wint, refl, m, ok);
  else
    sample_kernel<HALF, 0><<<grid, kBlock, 0, st>>>(
        wi, u2, lu2, wl, alpha, gdir, ip, q, lobes, gtype, mult, n, wo, pdf,
        lobe, wint, refl, m, ok);
}

}  // namespace

// Returns cudaGetLastError(); cudaErrorInvalidValue (1) for an unsupported
// static configuration (half outside 0..4, channels other than 3). `table`
// is ops/grating.py::bessel_table: [5, 1536] float4 coefficients. With
// `sel` not null the recording instance also writes the selection bits
// ([n, 3, LobeSet::kWords] words) that B4b reads.
extern "C" int plt_grating_lobe_sum(
    const float* wi, const float* wo, const float* wl_nm, const float* gdir,
    const float* ip, const float* q, const int* lobes, const int* gtype,
    const float* mult, const float* coh, const float* acone,
    const float* table, int n, int half, int separable, int n_channels,
    float* out, unsigned* sel, void* stream) {
  if (half < 0 || half > 4 || n_channels != kChannels)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const float4* tab = reinterpret_cast<const float4*>(table);
#define PLT_HALF(H)                                                        \
  case H:                                                                  \
    if (separable)                                                         \
      launch_lobe_sum<H, true>(st, wi, wo, wl_nm, gdir, ip, q, lobes,      \
                               gtype, mult, coh, acone, tab, n, out, sel); \
    else                                                                   \
      launch_lobe_sum<H, false>(st, wi, wo, wl_nm, gdir, ip, q, lobes,     \
                                gtype, mult, coh, acone, tab, n, out,      \
                                sel);                                      \
    break;
    switch (half) {
      PLT_HALF(0)
      PLT_HALF(1)
      PLT_HALF(2)
      PLT_HALF(3)
      PLT_HALF(4)
    }
#undef PLT_HALF
  }
  return (int)cudaGetLastError();
}

// B4b. `sel` holds the selection bits of B4's recording launch on the same
// inputs, `g` the cotangent [n, 3]; the gradients are written in the
// layouts of their inputs (a_cone has none and is not read). Returns as
// plt_grating_lobe_sum.
extern "C" int plt_grating_lobe_sum_bwd(
    const float* wi, const float* wo, const float* wl_nm, const float* gdir,
    const float* ip, const float* q, const int* lobes, const int* gtype,
    const float* mult, const float* coh, const float* table,
    const unsigned* sel, const float* g, int n, int half, int separable,
    int n_channels, float* g_wi, float* g_wo, float* g_wl, float* g_gdir,
    float* g_ip, float* g_q, float* g_mult, float* g_coh, void* stream) {
  if (half < 0 || half > 4 || n_channels != kChannels)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    cudaStream_t st = (cudaStream_t)stream;
    const float4* tab = reinterpret_cast<const float4*>(table);
#define PLT_HALF(H)                                                          \
  case H:                                                                    \
    if (separable)                                                           \
      launch_lobe_sum_bwd<H, true>(st, wi, wo, wl_nm, gdir, ip, q, lobes,    \
                                   gtype, mult, coh, tab, sel, g, n, g_wi,   \
                                   g_wo, g_wl, g_gdir, g_ip, g_q, g_mult,    \
                                   g_coh);                                   \
    else                                                                     \
      launch_lobe_sum_bwd<H, false>(st, wi, wo, wl_nm, gdir, ip, q, lobes,   \
                                    gtype, mult, coh, tab, sel, g, n, g_wi,  \
                                    g_wo, g_wl, g_gdir, g_ip, g_q, g_mult,   \
                                    g_coh);                                  \
    break;
    switch (half) {
      PLT_HALF(0)
      PLT_HALF(1)
      PLT_HALF(2)
      PLT_HALF(3)
      PLT_HALF(4)
    }
#undef PLT_HALF
  }
  return (int)cudaGetLastError();
}

extern "C" int plt_grating_sample(
    const float* wi, const float* u2, const float* lobe_u2, const float* wl_um,
    const float* alpha, const float* gdir, const float* ip, const float* q,
    const int* lobes, const int* gtype, const float* mult, int n, int half,
    int ndf, float* wo, float* pdf, int* lobe, float* w_g1_int,
    float* reflection_dir, float* mvec, bool* ok, void* stream) {
  if (half < 0 || half > 4 || ndf < 0 || ndf > 1)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int grid = (n + kBlock - 1) / kBlock;
    cudaStream_t st = (cudaStream_t)stream;
#define PLT_HALF(H)                                                        \
  case H:                                                                  \
    launch_sample<H>(ndf, grid, st, wi, u2, lobe_u2, wl_um, alpha, gdir,   \
                     ip, q, lobes, gtype, mult, n, wo, pdf, lobe, w_g1_int, \
                     reflection_dir, mvec, ok);                            \
    break;
    switch (half) {
      PLT_HALF(0)
      PLT_HALF(1)
      PLT_HALF(2)
      PLT_HALF(3)
      PLT_HALF(4)
    }
#undef PLT_HALF
  }
  return (int)cudaGetLastError();
}

// One-function probes, built for their SASS only and never launched:
// o1 = f(a) + b (f(a, b) + b for the division; sin + b for sincos, whose
// cos goes to o2), o2 = b. F = 0 is the identity, whose instructions are the
// probes' own; `ops/mfu.py::special_fn_sass` counts each function's
// shortest way through as the probe's less the identity's.
template <int F>
__global__ void fn_probe_kernel(const float* __restrict__ a,
                                const float* __restrict__ b,
                                float* __restrict__ o1,
                                float* __restrict__ o2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float x = a[i], y = b[i];
  float r = x, r2 = y;
  if (F == 1) r = sqrtf(x);
  if (F == 2) r = x / y;
  if (F == 3) r = asinf(x);
  if (F == 4) r = expf(x);
  if (F == 5) sincosf(x, &r, &r2);
  if (F == 6) r = sinf(x);
  o1[i] = __fadd_rn(r, y);
  o2[i] = r2;
}
template __global__ void fn_probe_kernel<0>(const float*, const float*,
                                            float*, float*);
template __global__ void fn_probe_kernel<1>(const float*, const float*,
                                            float*, float*);
template __global__ void fn_probe_kernel<2>(const float*, const float*,
                                            float*, float*);
template __global__ void fn_probe_kernel<3>(const float*, const float*,
                                            float*, float*);
template __global__ void fn_probe_kernel<4>(const float*, const float*,
                                            float*, float*);
template __global__ void fn_probe_kernel<5>(const float*, const float*,
                                            float*, float*);
template __global__ void fn_probe_kernel<6>(const float*, const float*,
                                            float*, float*);
