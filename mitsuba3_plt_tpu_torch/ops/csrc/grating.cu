// Rough diffraction-grating kernels of the PLT wave BSDF, one thread per
// lane:
//
//   plt_grating_lobe_sum  replaces mitsuba3_plt_tpu/ops/grating_pallas.py::
//     grating_lobe_sum (Pallas body _kernel): per-wavelength sum of the
//     diffraction lobes with a Miller Bessel sweep (M = 64, 1e18 rescale
//     guard, Hankel asymptotics beyond 0.75 M), grating-equation lobe
//     centres, the acceptance cone and the angular-coherence Gaussian.
//   plt_grating_sample    replaces ::grating_sample (Pallas body
//     _sample_kernel): visible-normal sample (GGX or Beckmann), microfacet
//     frame, Bessel sweep at the hero wavelength, lobe-CDF pick, grating
//     equation, pdf and Smith G1 times the lobe intensity.
//
// What bounds them on the H100: arithmetic, not memory. A lane reads 88
// bytes and writes 12 (lobe sum, C = 3) or reads 76 and writes 66 (sample),
// but does several thousand float operations and tens of special-function
// calls (sinf, cosf, expf, asinf, erff, erfinvf) per lane: the Miller sweep
// alone is 64 steps per wavelength. Design: the whole chain runs in
// registers of one thread; the lobe count, the separable layout, the
// channel count and the NDF are template parameters, so the sweep and the
// lobe loops unroll fully and the small arrays (Bessel orders, per-order
// intensities) stay in registers; nothing intermediate touches memory.
// Built without --use_fast_math: the IEEE expf/sinf/asinf/sqrtf are what
// the tolerances against the plain PyTorch version assume. asinf replaces
// the TPU kernel's polynomial asin.
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

template <int HALF, bool SEP, int C>
__global__ void __launch_bounds__(kBlock)
    lobe_sum_kernel(const float* __restrict__ wi, const float* __restrict__ wo,
                    const float* __restrict__ wl_nm,
                    const float* __restrict__ gdir, const float* __restrict__ ip,
                    const float* __restrict__ q, const int* __restrict__ lobes,
                    const int* __restrict__ gtype,
                    const float* __restrict__ mult,
                    const float* __restrict__ coh,
                    const float* __restrict__ acone, int n,
                    float* __restrict__ out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const float wi_x = wi[3 * i], wi_y = wi[3 * i + 1], wi_z = wi[3 * i + 2];
  const float wo_x = wo[3 * i], wo_y = wo[3 * i + 1], wo_z = wo[3 * i + 2];
  const float cg = gdir[2 * i], sg = gdir[2 * i + 1];
  const float ip_x = ip[2 * i], ip_y = ip[2 * i + 1];
  const float qv = q[i], mu_ = mult[i], co_ = coh[i], ac_ = acone[i];
  const float lob = (float)lobes[i], gt = (float)gtype[i];

  // channel-independent quantities
  const float px = sqrtf(wi_x * wi_x + wi_z * wi_z);
  const float py = sqrtf(wi_y * wi_y + wi_z * wi_z);
  const float sin_ix = px > kEpsilon ? wi_x / fmaxf(px, 1e-20f) : 0.f;
  const float sin_iy = py > kEpsilon ? wi_y / fmaxf(py, 1e-20f) : 0.f;
  const float cos_t = fabsf(wi_z);
  const float half_lobes = floorf(lob * 0.5f);
  const bool is_1d = ip_y < kEpsilon;
  const bool is_sin = gt < 0.5f;
  const bool is_rect = fabsf(gt - 1.0f) < 0.5f;
  const float ny = 2.0f * half_lobes + 1.0f;

#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float wl_um = wl_nm[C * i + c] * 1e-3f;
    const float kwn = 2.0f * kPi / fmaxf(wl_um, 1e-6f);
    const float a = 4.0f * kPi * qv / fmaxf(wl_um * cos_t, 1e-12f);
    float base[HALF + 1];
    base_intensities<HALF>(a, is_sin, is_rect, base);
    // inverse coherence det of Coherence.isotropic(coh, opl = 1)
    const float s = co_ * kwn * (float)(1.0 / (2.0 * kPiD * 1e3));
    const float inv_det = s * s;

    float acc = 0.f, corr = 0.f;
#pragma unroll
    for (int lx = -HALF; lx <= HALF; ++lx) {
#pragma unroll
      for (int ly = (SEP ? 0 : -HALF); ly <= (SEP ? 0 : HALF); ++ly) {
        const int ax = lx < 0 ? -lx : lx;
        const int ay = ly < 0 ? -ly : ly;
        const bool live = half_lobes >= (float)(ax > ay ? ax : ay);
        const float ix = base[ax];
        const float iy = is_1d ? ix : base[ay];
        const float lobe_int = mu_ * ix * iy;
        const Diffracted g = diffract(wl_um, cg, sg, (float)lx, (float)ly,
                                      ip_x, ip_y, sin_ix, sin_iy);
        const float cd_dot_wo =
            g.aa * safe_sqrt(g.qq) * wo_x + g.bb * safe_sqrt(g.mm) * wo_y +
            safe_sqrt(1.0f - g.aa * g.aa * g.qq - g.bb * g.bb * g.mm) * wo_z;
        const float ang = unit_angle_dot(cd_dot_wo);
        const bool in_cone = fabsf(ang) < ac_;
        const float ang_coh = expf(-0.5f * ang * ang * inv_det);
        const bool sel = g.ok && in_cone && live;
        if (lx == 0 && ly == 0) {
          acc = acc + (sel ? lobe_int : 0.f);
          if (SEP) corr = sel ? lobe_int * (ang_coh - 1.0f) * (ny - 1.0f) : 0.f;
        } else {
          acc = acc + (sel ? lobe_int * ang_coh : 0.f);
        }
      }
    }
    if (SEP) acc = acc * ny + corr;
    out[C * i + c] = acc;
  }
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
void launch_lobe_sum(int grid, cudaStream_t st, const float* wi,
                     const float* wo, const float* wl, const float* gdir,
                     const float* ip, const float* q, const int* lobes,
                     const int* gtype, const float* mult, const float* coh,
                     const float* acone, int n, float* out) {
  lobe_sum_kernel<HALF, SEP, kChannels><<<grid, kBlock, 0, st>>>(
      wi, wo, wl, gdir, ip, q, lobes, gtype, mult, coh, acone, n, out);
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
// static configuration (half outside 0..4, channels other than 3).
extern "C" int plt_grating_lobe_sum(
    const float* wi, const float* wo, const float* wl_nm, const float* gdir,
    const float* ip, const float* q, const int* lobes, const int* gtype,
    const float* mult, const float* coh, const float* acone, int n, int half,
    int separable, int n_channels, float* out, void* stream) {
  if (half < 0 || half > 4 || n_channels != kChannels)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int grid = (n + kBlock - 1) / kBlock;
    cudaStream_t st = (cudaStream_t)stream;
#define PLT_HALF(H)                                                          \
  case H:                                                                    \
    if (separable)                                                           \
      launch_lobe_sum<H, true>(grid, st, wi, wo, wl_nm, gdir, ip, q, lobes,  \
                               gtype, mult, coh, acone, n, out);             \
    else                                                                     \
      launch_lobe_sum<H, false>(grid, st, wi, wo, wl_nm, gdir, ip, q, lobes, \
                                gtype, mult, coh, acone, n, out);            \
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
