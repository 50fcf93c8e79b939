"""The PLT gradient path of the port against the JAX package (CPU): the
Bessel sweep's derivative, the lobe sum's vector-Jacobian product (the
plain version's autograd, the `torch.autograd.Function` that holds B4 and
B4b, and a host build of the kernels' own source), the detached sample
chain, the grating-parameter gradients of PLT on grating_scene(16, 16,
coherence=5e3), and forward mode refused through the lobe sum."""
import ctypes
import functools
import os
import subprocess

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mitsuba3_plt_tpu.ad import render as jrender
from mitsuba3_plt_tpu.ad import traverse as jtraverse
from mitsuba3_plt_tpu.config import RGB as JRGB
from mitsuba3_plt_tpu.integrators.plt import PLTIntegrator as JPLT
from mitsuba3_plt_tpu.ops import grating_pallas as gp
from mitsuba3_plt_tpu.scene.presets import grating_scene as jgrating_scene
from mitsuba3_plt_tpu_torch import ad, ops
from mitsuba3_plt_tpu_torch.integrators.plt import PLTIntegrator
from mitsuba3_plt_tpu_torch.librender.records import Ray
from mitsuba3_plt_tpu_torch.ops import grating as g
from mitsuba3_plt_tpu_torch.plt import wbsdf as wb
from mitsuba3_plt_tpu_torch.scene.presets import grating_scene
from test_torch_golden_specular import one_torch_thread  # noqa: F401

NAMES = g.LOBE_SUM_INPUTS
# inputs whose gradient runs through a = 4 pi q / (wl |wi_z|) and the
# Bessel values
A_PATH = ("wi", "wl_nm", "q")


def lobe_inputs(rng, n, gtype, ip_y, q_range=(0.02, 0.1)):
    """Seeded lanes (numpy): directions with |z| >= ~0.45, so that with the
    default heights a <= ~7; lobe counts 1-9, rotated gratings, 1D where
    ip_y = 0."""
    def dirs():
        v = rng.normal(size=(n, 3))
        v[:, 2] = np.abs(v[:, 2]) + 0.5
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(
            np.float32)

    f32 = np.float32
    t = rng.uniform(0.0, 1.0, n)
    return dict(
        wi=dirs(), wo=dirs(),
        wl_nm=rng.uniform(380, 680, (n, 3)).astype(f32),
        grating_dir=np.stack([np.cos(t), np.sin(t)], -1).astype(f32),
        inv_period=np.stack([rng.uniform(0.5, 2.5, n), np.full(n, ip_y)],
                            -1).astype(f32),
        q=rng.uniform(*q_range, n).astype(f32),
        lobes=rng.choice([1, 3, 5, 7, 9], n).astype(np.int32),
        gtype=np.full(n, gtype, np.int32),
        multiplier=rng.uniform(0.5, 2.0, n).astype(f32),
        coherence=rng.uniform(1.0, 120.0, n).astype(f32),
        a_cone=rng.uniform(0.3, 1.5, n).astype(f32))


# (half, separable, gtype, ip_y, q range): half 0-4, separable or not, the
# sinusoidal (0), rectangular (1) and linear (2) profiles, 1D and 2D
# periods; "hankel" puts every lane's a beyond 48, where both packages
# take the Hankel asymptotics
CASES = {
    "h0-sep-sin": (0, True, 0, 0.0, (0.02, 0.1)),
    "h1-2d-rect": (1, False, 1, 0.8, (0.02, 0.1)),
    "h2-sep-sin": (2, True, 0, 0.0, (0.02, 0.1)),
    "h2-2d-lin": (2, False, 2, 1.1, (0.02, 0.1)),
    "h3-2d-sin": (3, False, 0, 1.2, (0.02, 0.1)),
    "h3-sep-sin-hankel": (3, True, 0, 0.0, (3.0, 5.0)),
    "h4-sep-rect": (4, True, 1, 0.0, (0.02, 0.1)),
    "h4-2d-sin": (4, False, 0, 0.9, (0.02, 0.1)),
}


def _case(name, n=384):
    half, sep, gtype, ip_y, q_range = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    ins = lobe_inputs(rng, n, gtype, ip_y, q_range)
    cot = rng.normal(size=(n, 3)).astype(np.float32)
    return half, sep, ins, cot


def _torch_args(ins, dtype=torch.float32):
    return [torch.as_tensor(ins[k]).to(dtype)
            if ins[k].dtype == np.float32 else torch.as_tensor(ins[k])
            for k in NAMES]


@functools.partial(jax.jit, static_argnames=("half", "sep"))
def _xla_vjp(args, cot, half, sep):
    _, vjp = jax.vjp(lambda *a: gp._lobe_sum_xla(*a, half=half,
                                                 separable=sep), *args)
    return vjp(cot)


def _jax_vjp(ins, cot, half, sep):
    args = [jnp.asarray(ins[k], jnp.float32) for k in NAMES]
    out = _xla_vjp(args, jnp.asarray(cot), half=half, sep=sep)
    return dict(zip(NAMES, (np.asarray(x) for x in out)))


def _fd64(ins, cot, half, sep, name, h=1e-6):
    """Per-lane central difference of sum_c cot * out in float64 (the
    plain version in float64) along each component of input `name`."""
    base = _torch_args(ins, torch.float64)
    i = NAMES.index(name)
    cot64 = torch.as_tensor(cot, dtype=torch.float64)
    x = base[i]
    cols = x.shape[1] if x.dim() > 1 else 1
    out = np.empty((x.shape[0], cols))
    for c in range(cols):
        e = torch.zeros_like(x)
        if x.dim() > 1:
            e[:, c] = h
        else:
            e[:] = h
        f = []
        for s in (1, -1):
            args = list(base)
            args[i] = x + s * e
            f.append((g.grating_lobe_sum_plain(*args, half, sep) * cot64)
                     .sum(-1).numpy())
        out[:, c] = (f[0] - f[1]) / (2 * h)
    return out.reshape(x.shape)


def test_bessel_sweep_derivative():
    """Under autograd the sweep keeps its values to the bit; its derivative
    (the recurrence identity on the sweep, the Hankel form's own beyond 48)
    against a float64 central difference of the float64 sweep: within
    1e-5 (3.3e-6 at most measured), finite everywhere."""
    a = torch.cat([torch.linspace(0.0, 80.0, 8001),
                   torch.tensor([1e-7, 47.999, 48.0, 48.001])])
    plain = g.bessel_sweep(a, 4)
    ag = a.clone().requires_grad_(True)
    attached = g.bessel_sweep(ag, 4)
    a64 = a.double()
    far = (a64 > 1e-3) & ((a64 - 48.0).abs() > 1e-3)
    h = 1e-5
    for nu in range(5):
        assert torch.equal(attached[nu].detach(), plain[nu])
        (d,) = torch.autograd.grad(attached[nu].sum(), ag, retain_graph=True)
        assert torch.isfinite(d).all()
        fd = (g.bessel_sweep(a64 + h, 4)[nu]
              - g.bessel_sweep(a64 - h, 4)[nu]) / (2 * h)
        assert (d.double() - fd)[far].abs().max() < 1e-5


@pytest.mark.parametrize("case", list(CASES))
def test_lobe_sum_vjp_matches_jax(case):
    """The plain version's autograd against jax.vjp of _lobe_sum_xla (what
    the JAX package's custom_vjp backward linearizes), under jit: every
    gradient within 1e-4 of its input's largest (float32 rounding of the
    lobe chain, which XLA fuses: 3e-5 at most measured, on the Hankel
    phase at |a| ~ 80 and a cancelling grating_dir sum), but on the a
    path. There JAX differentiates its float32 Miller recurrence, which
    is off by up to 3% on some sinusoidal lanes: each lane that differs
    must be one where the port agrees with a float64 central difference
    of the plain version (within the same 1e-4) and JAX does not."""
    half, sep, ins, cot = _case(case)
    got = g.grating_lobe_sum_bwd_plain(_torch_args(ins),
                                       torch.as_tensor(cot), half, sep)
    want = _jax_vjp(ins, cot, half, sep)
    for name, gt in zip(NAMES, got):
        if gt is None:
            assert name in ("lobes", "gtype", "a_cone")
            assert name != "a_cone" or not want[name].any()
            continue
        gt, w = gt.numpy(), want[name]
        tol = 1e-4 * max(np.abs(w).max(), 1e-30)
        bad = np.abs(gt - w) > tol
        if not bad.any():
            continue
        assert name in A_PATH and CASES[case][2] == 0, (case, name)
        fd = _fd64(ins, cot, half, sep, name)
        lanes = bad.any(-1) if bad.ndim > 1 else bad
        port_ok = np.abs(gt - fd) <= tol
        jax_ok = np.abs(w - fd) <= tol
        assert port_ok[bad].all() and not jax_ok[bad].any(), (
            case, name, np.flatnonzero(lanes))
        assert lanes.mean() < 0.05, (case, name, lanes.mean())


def test_lobe_sum_custom_vjp_matches():
    """Through the JAX package's own op: grating_lobe_sum(...,
    interpret=True), its Pallas forward in interpret mode and its
    custom_vjp backward, against the port's `grating_lobe_sum` (the
    autograd.Function) on the CPU: outputs at the forward's rtol 2e-3 /
    atol 2e-5, gradients within 2e-5 of each input's largest. A
    rectangular 2D case: the sinusoidal profile's lanes where JAX's
    recurrence derivative is off are named by the test above."""
    half, sep, ins, cot = _case("h1-2d-rect", n=256)
    jargs = [jnp.asarray(ins[k]) for k in NAMES]
    out, vjp = jax.vjp(
        lambda *a: gp.grating_lobe_sum(*a[:6], ins["lobes"], ins["gtype"],
                                       *a[8:], half=half, separable=sep,
                                       n_channels=3, interpret=True),
        *jargs)
    want = dict(zip(NAMES, vjp(jnp.asarray(cot))))
    xs = [t.requires_grad_(t.dtype == torch.float32) for t in
          _torch_args(ins)]
    y = g.grating_lobe_sum(*xs, half=half, separable=sep, n_channels=3)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out),
                               rtol=2e-3, atol=2e-5)
    y.backward(torch.as_tensor(cot))
    for name, x in zip(NAMES, xs):
        if name in ("lobes", "gtype"):
            continue
        w = np.asarray(want[name])
        if name == "a_cone":
            assert x.grad is None and not w.any()
            continue
        np.testing.assert_allclose(x.grad.numpy(), w, rtol=0,
                                   atol=2e-5 * max(np.abs(w).max(), 1e-30))


def test_function_is_plain_autograd_on_cpu():
    """On CPU tensors the autograd.Function's backward is autograd of the
    plain version: equal to the bit to differentiating
    grating_lobe_sum_plain directly; B4b never launches."""
    half, sep, ins, cot = _case("h3-2d-sin")
    ops.reset_launch_counts()
    xs = [t.requires_grad_(t.dtype == torch.float32) for t in
          _torch_args(ins)]
    y = g.grating_lobe_sum(*xs, half=half, separable=sep, n_channels=3)
    assert y.grad_fn is not None
    y.backward(torch.as_tensor(cot))
    zs = [t.requires_grad_(t.dtype == torch.float32) for t in
          _torch_args(ins)]
    z = g.grating_lobe_sum_plain(*zs, half, sep)
    assert torch.equal(y.detach(), z.detach())
    z.backward(torch.as_tensor(cot))
    for name, x, w in zip(NAMES, xs, zs):
        if name in ("lobes", "gtype"):
            continue
        if name == "a_cone":
            assert x.grad is None and w.grad is None
            continue
        assert torch.equal(x.grad, w.grad), name
    assert ops.launch_counts()["grating_lobe_sum"] == 0
    assert ops.launch_counts()["grating_lobe_sum_bwd"] == 0


# ---------------------------------------------------------------------------
# the kernels' own source, built for the host
# ---------------------------------------------------------------------------

_SHIM = r"""
#include <math.h>
#define __device__
#define __forceinline__ inline
#define __global__
#define __launch_bounds__(x)
struct float4 { float x, y, z, w; };
struct Idx { int x; };
static Idx blockIdx, threadIdx;
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
template <class T> static inline T __ldg(const T* p) { return *p; }
// each emulated thread votes alone: a lane computes the branches it needs
static inline bool __any_sync(unsigned, bool p) { return p; }
"""

_HARNESS = r"""
template <int H, bool S>
static void fwd(const float* const* in, const int* lob, const int* gt,
                const float* tab, int n, float* out) {
  for (int b = 0; b * kBlock < n; ++b)
    for (int t = 0; t < kBlock; ++t) {
      blockIdx.x = b; threadIdx.x = t;
      lobe_sum_kernel<H, S, 3>(in[0], in[1], in[2], in[3], in[4], in[5],
                               lob, gt, in[6], in[7], in[8],
                               (const float4*)tab, n, out);
    }
}
template <int H, bool S>
static void bwd(const float* const* in, const int* lob, const int* gt,
                const float* tab, const float* g, int n, float* const* o) {
  for (int b = 0; b * kBlock < n; ++b)
    for (int t = 0; t < kBlock; ++t) {
      blockIdx.x = b; threadIdx.x = t;
      lobe_sum_bwd_kernel<H, S, 3>(in[0], in[1], in[2], in[3], in[4], in[5],
                                   lob, gt, in[6], in[7], in[8],
                                   (const float4*)tab, g, n, o[0], o[1],
                                   o[2], o[3], o[4], o[5], o[6], o[7]);
    }
}
#define CASES(FN, ...)                                                   \
  switch (half * 2 + sep) {                                              \
    case 0: FN<0, false>(__VA_ARGS__); break;                            \
    case 1: FN<0, true>(__VA_ARGS__); break;                             \
    case 2: FN<1, false>(__VA_ARGS__); break;                            \
    case 3: FN<1, true>(__VA_ARGS__); break;                             \
    case 4: FN<2, false>(__VA_ARGS__); break;                            \
    case 5: FN<2, true>(__VA_ARGS__); break;                             \
    case 6: FN<3, false>(__VA_ARGS__); break;                            \
    case 7: FN<3, true>(__VA_ARGS__); break;                             \
    case 8: FN<4, false>(__VA_ARGS__); break;                            \
    case 9: FN<4, true>(__VA_ARGS__); break;                             \
  }
extern "C" void host_lobe_sum(const float* const* in, const int* lob,
                              const int* gt, const float* tab, int n,
                              int half, int sep, float* out) {
  CASES(fwd, in, lob, gt, tab, n, out)
}
extern "C" void host_lobe_sum_bwd(const float* const* in, const int* lob,
                                  const int* gt, const float* tab,
                                  const float* g, int n, int half, int sep,
                                  float* const* o) {
  CASES(bwd, in, lob, gt, tab, g, n, o)
}
"""


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """grating.cu's lobe-sum section (its helpers, lobe_sum_kernel and
    lobe_sum_bwd_kernel) built for the host with g++ (FMA contraction
    off, as nvcc's __fmul_rn / __fadd_rn keep the card's), each thread of
    each block run in turn."""
    src = open(os.path.join(os.path.dirname(g.__file__), "csrc",
                            "grating.cu")).read()
    body = src[src.index("namespace {"):src.index("// Smith G1")]
    d = tmp_path_factory.mktemp("host_kernels")
    cpp, so = d / "lobe_sum_host.cpp", d / "liblobe_sum_host.so"
    cpp.write_text(_SHIM + body + "}  // namespace\n" + _HARNESS)
    subprocess.run(["g++", "-O2", "-std=c++17", "-ffp-contract=off",
                    "-fPIC", "-shared", "-o", str(so), str(cpp)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))


@pytest.mark.parametrize("case", ["h2-sep-sin", "h3-2d-sin", "h4-sep-rect",
                                  "h2-2d-lin", "h3-sep-sin-hankel"])
def test_kernel_source_on_the_host_matches_plain(host_kernels, case):
    """B4 and B4b as written (their source built for the host) against the
    plain version and its autograd: outputs at rtol 2e-3 / atol 2e-5,
    gradients at rtol 2e-3 with atol 2e-5 of each input's largest (the
    card's tolerances; the table against the sweep, measured within 5e-5
    of the largest), on every lane."""
    half, sep, ins, cot = _case(case, n=2048)
    args = _torch_args(ins)
    f_in = [args[i] for i in (0, 1, 2, 3, 4, 5, 8, 9, 10)]
    lob, gtype = args[6], args[7]
    tab = g.bessel_table("cpu")
    n = args[0].shape[0]
    out = torch.empty((n, 3))
    host_kernels.host_lobe_sum(
        _ptrs(f_in), ctypes.c_void_p(lob.data_ptr()),
        ctypes.c_void_p(gtype.data_ptr()), ctypes.c_void_p(tab.data_ptr()),
        n, half, int(sep), ctypes.c_void_p(out.data_ptr()))
    want = g.grating_lobe_sum_plain(*args, half, sep)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=2e-3,
                               atol=2e-5)
    cot_t = torch.as_tensor(cot)
    names = [k for k in NAMES if k not in ("lobes", "gtype", "a_cone")]
    grads = [torch.empty_like(args[NAMES.index(k)]) for k in names]
    host_kernels.host_lobe_sum_bwd(
        _ptrs(f_in), ctypes.c_void_p(lob.data_ptr()),
        ctypes.c_void_p(gtype.data_ptr()), ctypes.c_void_p(tab.data_ptr()),
        ctypes.c_void_p(cot_t.data_ptr()), n, half, int(sep), _ptrs(grads))
    ref = dict(zip(NAMES, g.grating_lobe_sum_bwd_plain(args, cot_t, half,
                                                       sep)))
    for k, got in zip(names, grads):
        w = ref[k].numpy()
        np.testing.assert_allclose(got.numpy(), w, rtol=2e-3,
                                   atol=2e-5 * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)


# ---------------------------------------------------------------------------
# PLT gradients
# ---------------------------------------------------------------------------

GRT_KEYS = ("materials.grt_inv_period", "materials.grt_height",
            "materials.grt_multiplier", "materials.grt_coherence")
PLT_DEPTH, PLT_RR, PLT_SPP = 3, 8, 8
HEIGHT_EPS = 1e-4


@pytest.fixture(scope="module")
def plt_scenes():
    # moderate coherence, so that the lobes' Gaussian falloff is smooth
    # enough for finite differences (tests/test_ad.py's scene)
    jscene, _ = jgrating_scene(16, 16, coherence=5e3)
    return jscene, grating_scene(16, 16, coherence=5e3, device="cpu")


@pytest.fixture(scope="module")
def plt_jax(plt_scenes):
    """jax.grad of the mean image through the JAX package's PLT."""
    jscene, _ = plt_scenes
    integ = JPLT(max_depth=PLT_DEPTH, rr_depth=PLT_RR)
    loss, grads = jrender.render_loss_grad(
        jscene, integ.sample, jnp.mean, list(GRT_KEYS), seed=0, spp=PLT_SPP,
        cfg=JRGB)
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def _plt_loss(scene, key, idx, delta):
    """The port's mean image with parameter `key`'s entry idx moved by
    delta (the same seed, so the same paths)."""
    integ = PLTIntegrator(max_depth=PLT_DEPTH, rr_depth=PLT_RR)
    params = ad.traverse(scene)
    p = params[key].clone()
    p[idx] += delta
    return float(ad.render_differentiable(
        params.update({key: p}), integ.sample, seed=0,
        spp=PLT_SPP).double().mean())


@pytest.fixture(scope="module")
def plt_port(plt_scenes):
    _, scene = plt_scenes
    integ = PLTIntegrator(max_depth=PLT_DEPTH, rr_depth=PLT_RR)
    return ad.render_loss_grad(scene, integ.sample, torch.mean,
                               list(GRT_KEYS), seed=0, spp=PLT_SPP)


@pytest.mark.parametrize("key", GRT_KEYS)
def test_plt_grating_grads_match_jax(plt_scenes, plt_jax, plt_port, key):
    """The four grating parameters' gradients against jax.grad (the same
    seed, so the same paths): the grating row's within 1e-4. The height's
    runs through the Bessel values, where jax.grad differentiates the
    float32 Miller recurrence: it reads 4.03, while a central difference
    of the JAX package's render reads 6.8945 (step 1e-4) and of the
    port's, whose render equals it, the same. The port's height gradient
    is held to that central difference (within 1e-3, the step's
    curvature) and to jax.grad's sign."""
    jloss, jgrads = plt_jax
    loss, grads = plt_port
    assert abs(float(loss) - jloss) <= 1e-5 * jloss
    got, want = grads[key].numpy(), jgrads[key]
    np.testing.assert_array_equal(got[0], 0.0)  # the diffuse floor's row
    assert np.isfinite(got).all() and np.abs(got[1]).max() > 0
    if key == "materials.grt_height":
        _, scene = plt_scenes
        fd = (_plt_loss(scene, key, 1, HEIGHT_EPS)
              - _plt_loss(scene, key, 1, -HEIGHT_EPS)) / (2 * HEIGHT_EPS)
        assert np.sign(got[1]) == np.sign(want[1])
        assert abs(got[1] - fd) <= 1e-3 * abs(fd), (got[1], fd, want[1])
    else:
        np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=1e-12)


@pytest.mark.parametrize("key,eps", [("materials.grt_inv_period", 1e-3),
                                     ("materials.grt_height", 1e-4)])
def test_plt_grating_grad_sign_matches_fd(plt_scenes, plt_port, key, eps):
    """tests/test_ad.py's check on the port: the grating row's first entry
    against a central difference of the port's own render."""
    _, scene = plt_scenes
    idx = (1, 0) if ad.traverse(scene)[key].dim() == 2 else (1,)
    fd = (_plt_loss(scene, key, idx, eps)
          - _plt_loss(scene, key, idx, -eps)) / (2 * eps)
    got = float(plt_port[1][key][idx])
    assert np.sign(fd) == np.sign(got) and got != 0.0, (key, fd, got)
    assert abs(got) < 50 * abs(fd) + 1e-3, (key, fd, got)


def test_sample_chain_carries_no_gradient(plt_scenes):
    """wbsdf_sample's grating lanes: the sample (wo, pdf) and the lobe carry
    no gradient, and the weight none to the grating's parameters (only
    the conductor Fresnel's eta reaches it)."""
    _, scene = plt_scenes
    params = ad.traverse(scene)
    p0 = {k: params[k].detach().requires_grad_(True)
          for k in GRT_KEYS + ("materials.alpha", "materials.eta_re")}
    sc = params.update(p0)
    n = 64
    rng = np.random.default_rng(3)
    o = torch.tensor([0.0, 0.3, 1.2]).expand(n, 3)
    tgt = torch.as_tensor(rng.uniform(-0.3, 0.3, (n, 3)), dtype=torch.float32)
    tgt[:, 1] = -0.5
    d = tgt - o
    d = d / d.norm(dim=-1, keepdim=True)
    si = sc.ray_intersect(Ray.create(o.contiguous(), d))
    assert si.valid.all()
    midx = torch.clamp_min(si.mat_idx, 0)
    wl = wb.sample_plt_wavelengths(torch.as_tensor(
        rng.uniform(size=(n, 3)), dtype=torch.float32))
    u2 = torch.as_tensor(rng.uniform(size=(n, 2)), dtype=torch.float32)
    lu2 = torch.as_tensor(rng.uniform(size=(n, 2)), dtype=torch.float32)
    sd, weight, ok = wb.wbsdf_sample(sc.materials, midx, si, None, u2, lu2,
                                     wl)
    assert ok.any()
    assert not sd.bs.wo.requires_grad and not sd.bs.pdf.requires_grad
    grads = torch.autograd.grad(weight.sum(), list(p0.values()),
                                allow_unused=True)
    by_key = dict(zip(p0, grads))
    for k in GRT_KEYS + ("materials.alpha",):
        assert by_key[k] is None or not by_key[k].any(), k
    assert by_key["materials.eta_re"] is not None


def test_forward_mode_through_the_lobe_sum_raises(plt_scenes):
    """The lobe sum has a VJP and no JVP (the JAX package's custom_vjp):
    forward mode through it raises, directly and through render_forward."""
    _, scene = plt_scenes
    integ = PLTIntegrator(max_depth=2, rr_depth=PLT_RR)
    with pytest.raises(NotImplementedError, match="forward-mode"):
        ad.render_forward(scene, integ.sample,
                          {"materials.grt_height": 1.0}, spp=1)
    half, sep, ins, _ = _case("h2-sep-sin", n=8)
    args = _torch_args(ins)
    import torch.autograd.forward_ad as fwAD
    with fwAD.dual_level():
        args[5] = fwAD.make_dual(args[5], torch.ones_like(args[5]))
        with pytest.raises(NotImplementedError, match="forward-mode"):
            g.grating_lobe_sum(*args, half=half, separable=sep,
                               n_channels=3)
