"""The PLT gradient path of the port against the JAX package (CPU): the
Bessel sweep's derivative, the lobe sum's vector-Jacobian product (the
plain version's autograd, the `torch.autograd.Function` that holds B4 and
B4b, and a host build of the kernels' own source), the detached sample
chain, the grating-parameter gradients of PLT on grating_scene(16, 16,
coherence=5e3), and forward mode refused through the lobe sum."""
import ctypes
import functools
import importlib.util
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
#include <stdlib.h>
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
static inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
// B4b's gathering (a block's ballots and shared list) runs on the card
// only: the harness below calls its per-item functions
#define __shared__ static
static inline void __syncthreads() { abort(); }
static inline unsigned __ballot_sync(unsigned, bool) { abort(); }
static inline int __shfl_sync(unsigned, int, int) { abort(); }
static inline int __popc(unsigned) { abort(); }
static inline int atomicAdd(int*, int) { abort(); }
"""

_HARNESS = r"""
template <int H, bool S, bool R>
static void fwd_run(const float* const* in, const int* lob, const int* gt,
                    const float* tab, int n, float* out, unsigned* sel) {
  for (int b = 0; b * kBlock < n; ++b)
    for (int t = 0; t < kBlock; ++t) {
      blockIdx.x = b; threadIdx.x = t;
      lobe_sum_kernel<H, S, 3, R>(in[0], in[1], in[2], in[3], in[4], in[5],
                                  lob, gt, in[6], in[7], in[8],
                                  (const float4*)tab, n, out, sel);
    }
}
// B4's recording instance where sel is given, else its plain instance
template <int H, bool S>
static void fwd(const float* const* in, const int* lob, const int* gt,
                const float* tab, int n, float* out, unsigned* sel) {
  if (sel)
    fwd_run<H, S, true>(in, lob, gt, tab, n, out, sel);
  else
    fwd_run<H, S, false>(in, lob, gt, tab, n, out, nullptr);
}
// B4b lane by lane: lobe_sum_bwd_kernel's items (lobe_bwd_channel) of the
// lane's channels with bits, each into its own slot, then lobe_bwd_finish
template <int H, bool S>
static void bwd(const float* const* in, const int* lob, const int* gt,
                const float* tab, const unsigned* sel, const float* g, int n,
                float* const* o) {
  for (int i = 0; i < n; ++i) {
    float adj[3 * kLaneAdj];
    unsigned chans = 0u;
    for (int c = 0; c < 3; ++c) {
      if (!lobe_bwd_has_bits<H, S, 3>(sel, i, c)) continue;
      chans |= 1u << c;
      lobe_bwd_channel<H, S, 3>(i, c, in[0], in[1], in[2], in[3], in[4],
                                in[5], lob, gt, in[6], in[7],
                                (const float4*)tab, sel, g, o[2],
                                adj + c * kLaneAdj, 1);
    }
    lobe_bwd_finish<3>(i, chans, in[0], adj, 1, o[0], o[1], o[2], o[3], o[4],
                       o[5], o[6], o[7]);
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
                              int half, int sep, float* out, unsigned* sel) {
  CASES(fwd, in, lob, gt, tab, n, out, sel)
}
extern "C" void host_lobe_sum_bwd(const float* const* in, const int* lob,
                                  const int* gt, const float* tab,
                                  const unsigned* sel, const float* g, int n,
                                  int half, int sep, float* const* o) {
  CASES(bwd, in, lob, gt, tab, sel, g, n, o)
}
"""


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """grating.cu's lobe-sum section (its helpers, lobe_sum_kernel in both
    instances, lobe_sum_bwd_kernel's per-item functions) built for the host
    with g++ (FMA contraction off, as nvcc's __fmul_rn / __fadd_rn keep the
    card's): B4 each thread of each block in turn, B4b lane by lane (its
    block-level gathering of the (lane, channel)s with bits runs on the
    card only)."""
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


@functools.cache
def _smoke():
    """chip_smoke.py as a module: its `sel_flips` names the lobes whose
    selection bit differs, as on the card."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))


def _vp(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


HOST_CASES = ["h2-sep-sin", "h3-2d-sin", "h4-sep-rect", "h2-2d-lin",
              "h3-sep-sin-hankel"]
GRAD_NAMES = [k for k in NAMES if k not in ("lobes", "gtype", "a_cone")]


def _host_fwd(lib, args, half, sep, record):
    """Host B4 on `args`: (out [N, 3], the selection bits int32 [N, 3,
    words] of the recording instance, or None)."""
    f_in = [args[i] for i in (0, 1, 2, 3, 4, 5, 8, 9, 10)]
    n = args[0].shape[0]
    out = torch.empty((n, 3))
    sel = (torch.full((n, 3, g.lobe_set(half, sep)[1]), -1,
                      dtype=torch.int32) if record else None)
    lib.host_lobe_sum(_ptrs(f_in), _vp(args[6]), _vp(args[7]),
                      _vp(g.bessel_table("cpu")), n, half, int(sep),
                      _vp(out), _vp(sel))
    return out, sel


def _host_bwd(lib, args, cot, sel, half, sep):
    """Host B4b on `args` with the cotangent and B4's bits: {name:
    gradient} of GRAD_NAMES."""
    f_in = [args[i] for i in (0, 1, 2, 3, 4, 5, 8, 9, 10)]
    grads = [torch.full_like(args[NAMES.index(k)], float("nan"))
             for k in GRAD_NAMES]
    lib.host_lobe_sum_bwd(_ptrs(f_in), _vp(args[6]), _vp(args[7]),
                          _vp(g.bessel_table("cpu")), _vp(sel), _vp(cot),
                          args[0].shape[0], half, int(sep), _ptrs(grads))
    return dict(zip(GRAD_NAMES, grads))


@pytest.mark.parametrize("case", HOST_CASES)
def test_kernel_source_on_the_host_matches_plain(host_kernels, case):
    """B4 and B4b as written (their source built for the host) against the
    plain version and its autograd: outputs at rtol 2e-3 / atol 2e-5,
    gradients at rtol 2e-3 with atol 2e-5 of each input's largest (the
    card's tolerances; the table against the sweep, measured within 5e-5
    of the largest), on every lane. B4b reads the bits of host B4's
    recording instance."""
    half, sep, ins, cot = _case(case, n=2048)
    args = _torch_args(ins)
    out, _ = _host_fwd(host_kernels, args, half, sep, record=False)
    want = g.grating_lobe_sum_plain(*args, half, sep)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=2e-3,
                               atol=2e-5)
    _, sel = _host_fwd(host_kernels, args, half, sep, record=True)
    cot_t = torch.as_tensor(cot)
    grads = _host_bwd(host_kernels, args, cot_t, sel, half, sep)
    ref = dict(zip(NAMES, g.grating_lobe_sum_bwd_plain(args, cot_t, half,
                                                       sep)))
    for k, got in grads.items():
        w = ref[k].numpy()
        np.testing.assert_allclose(got.numpy(), w, rtol=2e-3,
                                   atol=2e-5 * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)


@pytest.mark.parametrize("case", HOST_CASES)
def test_host_recording_instance_keeps_the_sum_and_the_plain_gates(
        host_kernels, case):
    """Host B4's recording instance: its sum equals the plain instance's to
    the bit, and its bits equal grating_lobe_sum_sel_plain's but for lobes
    that lie within float rounding of a gate (|ang| within 1e-5 rad of
    a_cone, |aa| or |bb| within 1e-6 of 1), each named; every lane and
    channel gets its words (none left at the fill)."""
    half, sep, ins, _ = _case(case, n=2048)
    args = _torch_args(ins)
    plain, _ = _host_fwd(host_kernels, args, half, sep, record=False)
    out, sel = _host_fwd(host_kernels, args, half, sep, record=True)
    assert torch.equal(out, plain)
    want = g.grating_lobe_sum_sel_plain(args, half, sep)
    assert sel.shape == want.shape == (2048, 3, g.lobe_set(half, sep)[1])
    flips = _smoke().sel_flips(args, half, sep, sel, want)
    assert all(f["rounding"] for f in flips), flips
    n_lobes = len(g.lobe_set(half, sep)[0])
    if n_lobes % 32:
        # the bits past the set's last lobe stay 0
        assert not (sel[..., -1] >> (n_lobes % 32)).any()


@pytest.mark.parametrize("case", HOST_CASES)
def test_host_bwd_gives_lanes_without_bits_exact_zeros(host_kernels, case):
    """A lane with no selection bit gets exact zeros from host B4b, as from
    the plain version's autograd (its output is the constant 0 there); the
    cases hold such lanes and lanes with bits."""
    half, sep, ins, cot = _case(case, n=2048)
    args = _torch_args(ins)
    _, sel = _host_fwd(host_kernels, args, half, sep, record=True)
    none = ~(sel != 0).flatten(1).any(-1)
    assert 0 < int(none.sum()) < none.numel()
    cot_t = torch.as_tensor(cot)
    grads = _host_bwd(host_kernels, args, cot_t, sel, half, sep)
    ref = dict(zip(NAMES, g.grating_lobe_sum_bwd_plain(args, cot_t, half,
                                                       sep)))
    for k, got in grads.items():
        assert torch.isfinite(got).all(), k
        assert not got[none].any(), k
        assert not ref[k][none].any(), k


# lane 602572 of the grating box path's first lobe-sum call
# (cornell_box(512, 512, box_material="grating"), PLT depth 7, 8 spp a
# pass; half 2, separable) with chip_smoke.py's seeded cotangent: in
# channel 2 the selected lobe (-1, 0) points along wo to cd = 1 - 2.6e-8.
# Formed with B4's fused products, cd rounds to 1 in float32, so d = 0 and
# the cone's Gaussian has no derivative there; formed as the plain version
# forms it, cd = 1 - 6e-8 and it has its limit, -2 e expo.
BOX_LANE = dict(
    wi=[-0.9536094665527344, -0.14432963728904724, 0.26419299840927124],
    wo=[0.26505157351493835, 0.4619472026824951, 0.8463761210441589],
    wl_nm=[487.176513671875, 594.8543090820312, 664.7474975585938],
    grating_dir=[1.0, 0.0], inv_period=[1.0, 1.0], q=0.10000000149011612,
    lobes=3, gtype=0, multiplier=1.0, coherence=1.0,
    a_cone=0.20000000298023224)
BOX_LANE_COT = [0.6127704977989197, 1.7992738485336304, -2.2733969688415527]


def _near_lobe_lanes(rng, n):
    """Lanes whose wo is, to float32, the direction of one of their lobes
    (the plain chain's in float64), so that cd lies within a few ulps of 1
    and d at or just above 0: separable half 2, 1D gratings, the three
    profiles, coherence up to 1e3."""
    ins = lobe_inputs(rng, n, 0, 0.0)
    ins["gtype"] = rng.choice([0, 1, 2], n).astype(np.int32)
    ins["lobes"] = np.full(n, 5, np.int32)
    ins["coherence"] = rng.uniform(1.0, 1e3, n).astype(np.float32)
    ins["inv_period"][:, 0] = rng.uniform(0.2, 0.8, n)
    wi = ins["wi"].astype(np.float64)
    sin_ix = wi[:, 0] / np.hypot(wi[:, 0], wi[:, 2])
    sin_iy = wi[:, 1] / np.hypot(wi[:, 1], wi[:, 2])
    lx = rng.choice([-1.0, 0.0, 1.0], n)
    gd = ins["grating_dir"].astype(np.float64)
    aa = ins["wl_nm"][:, 0] * 1e-3 * gd[:, 0] * lx * ins["inv_period"][:, 0]
    aa = aa - sin_ix
    bb = ins["wl_nm"][:, 0] * 1e-3 * gd[:, 1] * lx * 0.0 - sin_iy
    mm = (aa * aa - 1.0) / (aa * aa * bb * bb - 1.0)
    qq = 1.0 - bb * bb * mm
    wo = np.stack([aa * np.sqrt(np.maximum(qq, 0)),
                   bb * np.sqrt(np.maximum(mm, 0)),
                   np.sqrt(np.maximum(1.0 - aa * aa * qq - bb * bb * mm,
                                      0))], -1)
    ins["wo"] = (wo / np.linalg.norm(wo, axis=-1, keepdims=True)).astype(
        np.float32)
    return ins


@pytest.fixture
def rounded_sqrt(monkeypatch):
    """torch.sqrt correctly rounded (taken in float64), as sqrtf is on the
    card and in the host build: torch's CPU float32 sqrt is an ulp off on
    some floats, which moves a cd within an ulp of 1 to 1 or off it."""
    sqrt = torch.sqrt
    monkeypatch.setattr(torch, "sqrt",
                        lambda x: sqrt(x.double()).to(x.dtype))


def test_host_bwd_along_a_lobe_direction_matches_plain(host_kernels,
                                                       rounded_sqrt):
    """Host B4b where wo is a selected lobe's own direction (cd within a few
    ulps of 1: the arccos derivative's d at or just above 0, where the
    plain version's derivative jumps from its limit to 0) against autograd
    of the plain version with correctly rounded square roots, at the
    card's tolerance (rtol 2e-3, atol 2e-5 of each input's largest) on
    every lane: the grating box's lane 602572 (before B4b formed the plain
    chain's rounding, its wo gradient lay outside the tolerance there) and
    4,096 constructed lanes. Every lane's bits equal the plain version's."""
    rng = np.random.default_rng(18)
    ins = _near_lobe_lanes(rng, 4096)
    for k, v in BOX_LANE.items():
        ins[k] = np.concatenate([ins[k], np.asarray([v], ins[k].dtype)])
    cot = np.concatenate([rng.normal(size=(4096, 3)),
                          [BOX_LANE_COT]]).astype(np.float32)
    half, sep = 2, True
    args = _torch_args(ins)
    _, sel = _host_fwd(host_kernels, args, half, sep, record=True)
    assert torch.equal(sel, g.grating_lobe_sum_sel_plain(args, half, sep))
    assert bool((sel[-1] != 0).any())
    cot_t = torch.as_tensor(cot)
    grads = _host_bwd(host_kernels, args, cot_t, sel, half, sep)
    ref = dict(zip(NAMES, g.grating_lobe_sum_bwd_plain(args, cot_t, half,
                                                       sep)))
    for k, got in grads.items():
        w = ref[k].numpy()
        np.testing.assert_allclose(got.numpy(), w, rtol=2e-3,
                                   atol=2e-5 * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)
        w1 = w[-1:]
        np.testing.assert_allclose(got.numpy()[-1:], w1, rtol=2e-3,
                                   atol=2e-5 * max(np.abs(w1).max(), 1e-30),
                                   err_msg=k)


def test_autograd_records_only_where_the_backward_runs():
    """`autograd_records` (the recording launch's condition): off under
    no_grad and for inputs that need no gradient, on where an input
    requires grad, in both runs of a non-reentrant checkpoint (its
    forward and its recomputation in the backward, which then record the
    same bits). On the CPU the lobe sum launches no kernel either way."""
    half, sep, ins, cot = _case("h2-sep-sin", n=64)
    args = _torch_args(ins)
    assert not g.autograd_records(args)
    xs = [t.clone().requires_grad_(t.dtype == torch.float32) for t in args]
    assert g.autograd_records(xs)
    with torch.no_grad():
        assert not g.autograd_records(xs)
    seen = []

    def run(*a):
        seen.append(g.autograd_records(a))
        return g.grating_lobe_sum(*a, half=half, separable=sep,
                                  n_channels=3)

    ops.reset_launch_counts()
    y = torch.utils.checkpoint.checkpoint(run, *xs, use_reentrant=False)
    y.backward(torch.as_tensor(cot))
    assert seen == [True, True]
    assert not any(ops.launch_counts().values())
    out, sel = g.grating_lobe_sum_record(args, half, sep)
    assert torch.equal(out, g.grating_lobe_sum_plain(*args, half, sep))
    assert torch.equal(sel, g.grating_lobe_sum_sel_plain(args, half, sep))


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
