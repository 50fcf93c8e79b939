"""Rough-grating kernels of the PLT wave BSDF: the CUDA kernels of
`csrc/grating.cu` and their plain PyTorch versions.

`grating_lobe_sum` is the NEE wave eval: per lane and sampled wavelength,
the sum over diffraction lobes (lx, ly) in [-half, half]^2 of
multiplier * I(|lx|) * I(|ly|), gated by the grating-equation lobe centre
and the acceptance cone 2 sqrt(alpha_u alpha_v), weighted by the
angular-coherence Gaussian exp(-ang^2 inv_det / 2) (1 for the (0, 0) lobe).
With `separable` (every grating 1D and axis-aligned) the ly axis collapses
to its multiplicity. It is a `torch.autograd.Function`: its backward,
`grating_lobe_sum_bwd`, is the B4b kernel on the card and autograd of the
plain version on the CPU. Where autograd records, the forward launches
B4's recording instance (`grating_lobe_sum_record`), which also keeps the
gates' verdict on every lobe as bits; B4b takes adjoints of those lobes
only (`grating_lobe_sum_sel_plain` packs the plain version's).

`grating_sample` is the roughgrating sample chain: visible-normal sample,
microfacet frame, per-order intensities at the hero wavelength, lobe-CDF
pick, grating equation, pdf and Smith G1 times the lobe intensity.

The plain versions and the sample kernel compute the per-order intensities
with a Miller downward Bessel sweep (M = 64 with a 1e18 rescale guard;
Hankel asymptotics beyond 0.75 M). The lobe-sum kernel reads J_0..J_half
for |a| <= 0.75 M from `bessel_table`, cubic Hermite coefficients of that
sweep taken in float64, built at the first call on a device and kept.
"""
from __future__ import annotations

import math

import torch

from ..core import math as m
from ._check import check_tensors

GRATING_SAMPLE_LAUNCHES = 0
LOBE_SUM_LAUNCHES = 0
LOBE_SUM_RECORD_LAUNCHES = 0
LOBE_SUM_BWD_LAUNCHES = 0

MAX_HALF = 4            # MAX_LOBES = 9 -> at most 4 orders per side
BESSEL_M = 64
ASYMP_SWITCH = 0.75 * BESSEL_M
# the lobe-sum kernel's Bessel table: BESSEL_TABLE_N intervals of
# BESSEL_TABLE_STEP over [0, ASYMP_SWITCH] (csrc/grating.cu: kTableN,
# kTableInvStep)
BESSEL_TABLE_STEP = 1.0 / 32.0
BESSEL_TABLE_N = int(ASYMP_SWITCH / BESSEL_TABLE_STEP)
_bessel_tables = {}


# ---------------------------------------------------------------------------
# shared algebra of the plain versions
# ---------------------------------------------------------------------------

def bessel_sweep(a, half: int):
    """[J_0(|a|), .., J_half(|a|)] (tensors shaped like a).

    Under autograd the values are those of the sweep, and so is their
    derivative in |a|, by the recurrence identity J_nu' = (J_{nu-1} -
    J_{nu+1}) / 2 (J_0' = -J_1) on the same sweep's orders 0..half + 1;
    the Hankel branch differentiates its own expression, the exact 1 and 0
    at 0 have none. The recurrence itself has no usable derivative in
    float32: autograd through its 64 steps turns non-finite from |a| ~
    36.5, and into a lane's other profiles through the selects."""
    if torch.is_grad_enabled() and a.requires_grad:
        return _bessel_sweep_grad(a, half)
    return _bessel_sweep(a, half)


def _hankel(x_abs, nu: int):
    """The two-term Hankel asymptotics of J_nu at x_abs > 0, as the sweep
    forms them."""
    x_safe = torch.clamp_min(x_abs, 1e-6)
    i8x = 1.0 / (8.0 * x_safe)
    sq = torch.sqrt(2.0 / (m.Pi * x_safe))
    mu = 4.0 * nu * nu
    p = 1.0 - (mu - 1.0) * (mu - 9.0) * 0.5 * i8x * i8x
    q = (mu - 1.0) * i8x
    omega = x_abs - (0.5 * nu + 0.25) * m.Pi
    return sq * (torch.cos(omega) * p - torch.sin(omega) * q)


def _bessel_sweep_grad(a, half: int):
    with torch.no_grad():
        J = _bessel_sweep(a, half + 1)
    x_abs = torch.abs(a)
    dx = x_abs - x_abs.detach()
    use_asym = x_abs.detach() > ASYMP_SWITCH
    at_zero = x_abs.detach() < 1e-6
    res = []
    for nu in range(half + 1):
        d = -J[1] if nu == 0 else 0.5 * (J[nu - 1] - J[nu + 1])
        asym = _hankel(x_abs, nu)
        # zero-valued terms that carry the derivative: J[nu] keeps its bits
        term = torch.where(use_asym, asym - asym.detach(), dx * d)
        res.append(J[nu] + torch.where(at_zero, 0.0, term))
    return res


def _bessel_sweep(a, half: int):
    x_abs = torch.abs(a)
    x_safe = torch.clamp_min(x_abs, 1e-6)
    inv_x = 1.0 / x_safe
    jp1 = torch.zeros_like(x_safe)
    jk = torch.full_like(x_safe, 1e-30)
    norm = torch.zeros_like(x_safe)
    outs = [None] * (half + 1)
    for i in range(BESSEL_M):
        k = float(BESSEL_M - i)
        jm1 = (2.0 * k) * inv_x * jk - jp1
        jp1, jk = jk, jm1
        scale = torch.where(torch.abs(jk) > 1e18, 1e-18, 1.0)
        kk = BESSEL_M - i - 1  # jk holds J_kk (unnormalized)
        if kk % 2 == 0:
            norm = norm + (jk if kk == 0 else 2.0 * jk)
        jp1 = jp1 * scale
        jk = jk * scale
        norm = norm * scale
        if kk <= half:
            outs[kk] = jk
            for j in range(kk + 1, half + 1):
                outs[j] = outs[j] * scale
    inv_norm = torch.where(norm >= 0, 1.0, -1.0) / torch.clamp_min(
        torch.abs(norm), 1e-30)
    use_asym = x_abs > ASYMP_SWITCH
    at_zero = x_abs < 1e-6
    res = []
    for nu in range(half + 1):
        r = torch.where(use_asym, _hankel(x_abs, nu), outs[nu] * inv_norm)
        res.append(torch.where(at_zero, 1.0 if nu == 0 else 0.0, r))
    return res


def bessel_table_coefficients():
    """[MAX_HALF + 1, BESSEL_TABLE_N, 4] float64: for order nu and interval
    i the cubic Hermite coefficients (c0, c1, c2, c3) of J_nu on
    [i h, (i + 1) h], h = BESSEL_TABLE_STEP, in t = x / h - i:
    J_nu ~ c0 + t (c1 + t (c2 + t c3)). Values from `bessel_sweep` in
    float64 at the grid points, derivatives from the recurrence
    J_nu' = (J_{nu-1} - J_{nu+1}) / 2 (J_0' = -J_1), so the orders run to
    MAX_HALF + 1. Against the float64 sweep the interpolant is off by at
    most ~1e-9 at the interval midpoints (tests/test_torch_grating_ops.py),
    far below float32 rounding."""
    h = BESSEL_TABLE_STEP
    x = torch.arange(BESSEL_TABLE_N + 1, dtype=torch.float64) * h
    J = torch.stack(bessel_sweep(x, MAX_HALF + 1))
    D = torch.empty_like(J[:-1])
    D[0] = -J[1]
    D[1:] = 0.5 * (J[:-2] - J[2:])
    y0, y1 = J[:-1, :-1], J[:-1, 1:]
    d0, d1 = D[:, :-1] * h, D[:, 1:] * h
    return torch.stack([y0, d0, 3.0 * (y1 - y0) - 2.0 * d0 - d1,
                        2.0 * (y0 - y1) + d0 + d1], dim=-1)


def bessel_table(device) -> torch.Tensor:
    """`bessel_table_coefficients` as float32 on `device`, the lobe-sum
    kernel's table (~120 KB): built at the first call on a device and
    kept."""
    key = str(torch.device(device))
    if key not in _bessel_tables:
        _bessel_tables[key] = bessel_table_coefficients().to(
            device=device, dtype=torch.float32).contiguous()
    return _bessel_tables[key]


def bessel_table_lookup(table, a, half: int):
    """[J_0(|a|), .., J_half(|a|)] read from `table` (float32, as
    `bessel_table`) as the lobe-sum kernel reads it for |a| <= ASYMP_SWITCH:
    t = 32 min(|a|, 48) - i with i = min(floor(.), BESSEL_TABLE_N - 1),
    three fmaf per order (each formed in float64 and rounded once to
    float32: at most an ulp from the card's fmaf), and 1, 0, .. at
    |a| < 1e-6."""
    x = torch.abs(a)
    s = torch.clamp_max(x, ASYMP_SWITCH) * (1.0 / BESSEL_TABLE_STEP)
    fi = torch.clamp_max(torch.floor(s), float(BESSEL_TABLE_N - 1))
    t = (s - fi).double()
    c = table[: half + 1, fi.long()].double()

    def fma(p, q, r):
        return (p * q + r).float().double()

    r = fma(t, fma(t, fma(t, c[..., 3], c[..., 2]), c[..., 1]),
            c[..., 0]).float()
    at_zero = x < 1e-6
    return [torch.where(at_zero, 1.0 if nu == 0 else 0.0, r[nu])
            for nu in range(half + 1)]


def base_intensities(a, is_sin, is_rect, half: int):
    """Per-order intensities 0..half: sinusoidal J_j(a)^2, rectangular
    sin(a/2) sinc(pi j/2), linear 1/sqrt(j); order 0 is 1."""
    J = bessel_sweep(a, half)
    sin_half_a = torch.sin(a * 0.5)
    base = [torch.ones_like(a)]
    for j in range(1, half + 1):
        x = math.pi * 0.5 * j
        base.append(torch.where(
            is_sin, J[j] * J[j],
            torch.where(is_rect, sin_half_a * (math.sin(x) / x),
                        1.0 / float(j) ** 0.5),
        ))
    return base


def _diffract(wl_um, cg, sg, lx, ly, ip_x, ip_y, sin_ix, sin_iy):
    """Grating equation on the reciprocal lattice: (aa, bb, mm, qq, ok)."""
    lob_rx = cg * lx - sg * ly
    lob_ry = sg * lx + cg * ly
    aa = wl_um * lob_rx * ip_x - sin_ix
    bb = wl_um * lob_ry * ip_y - sin_iy
    den = aa * aa * bb * bb - 1.0
    mm = (aa * aa - 1.0) / torch.where(torch.abs(den) > 1e-12, den, 1e-12)
    qq = 1.0 - bb * bb * mm
    ok = (torch.abs(aa) <= 1.0) & (torch.abs(bb) <= 1.0)
    return aa, bb, mm, qq, ok


def _sin_incidence(wx, wy, wz):
    px = torch.sqrt(wx * wx + wz * wz)
    py = torch.sqrt(wy * wy + wz * wz)
    sin_x = torch.where(px > m.Epsilon, wx / torch.clamp_min(px, 1e-20), 0.0)
    sin_y = torch.where(py > m.Epsilon, wy / torch.clamp_min(py, 1e-20), 0.0)
    return sin_x, sin_y


# ---------------------------------------------------------------------------
# lobe sum
# ---------------------------------------------------------------------------

def lobe_set(half: int, separable: bool):
    """The lobes (lx, ly) of a set in the order the kernels number them
    (lx outer, ly inner; ly = 0 when separable) and the 32-bit words of
    a (lane, channel)'s selection bits: lobe k is bit k % 32 of word
    k // 32."""
    ly_range = [0] if separable else range(-half, half + 1)
    lobes = [(lx, ly) for lx in range(-half, half + 1) for ly in ly_range]
    return lobes, (len(lobes) + 31) // 32


def _col(x):
    return x[:, None]  # lane params against [N, C]


def _lane_columns(wi, wo, grating_dir, inv_period, lobes):
    """The lane parameters of the lobe sum's chain as [N, 1] columns:
    (wi_x, wi_y, wi_z, wo_x, wo_y, wo_z, cg, sg, ip_x, ip_y, half_lobes)."""
    wi_x, wi_y, wi_z = (_col(x) for x in wi.unbind(-1))
    wo_x, wo_y, wo_z = (_col(x) for x in wo.unbind(-1))
    cg, sg = (_col(x) for x in grating_dir.unbind(-1))
    ip_x, ip_y = (_col(x) for x in inv_period.unbind(-1))
    half_lobes = torch.floor(_col(lobes.to(torch.float32)) * 0.5)
    return (wi_x, wi_y, wi_z, wo_x, wo_y, wo_z, cg, sg, ip_x, ip_y,
            half_lobes)


def _gates(wl_um, wo_x, wo_y, wo_z, cg, sg, ip_x, ip_y, sin_ix, sin_iy,
           half_lobes, ac_, half, separable):
    for lx, ly in lobe_set(half, separable)[0]:
        live = half_lobes >= float(max(abs(lx), abs(ly)))
        aa, bb, mm, qq, ok = _diffract(wl_um, cg, sg, float(lx), float(ly),
                                       ip_x, ip_y, sin_ix, sin_iy)
        cd_dot_wo = (aa * m.safe_sqrt(qq) * wo_x
                     + bb * m.safe_sqrt(mm) * wo_y
                     + m.safe_sqrt(1.0 - aa * aa * qq - bb * bb * mm) * wo_z)
        ang = m.unit_angle_dot(cd_dot_wo)
        in_cone = torch.abs(ang) < ac_
        yield lx, ly, aa, bb, ang, ok & in_cone & live


def lobe_gates(wi, wo, wl_nm, grating_dir, inv_period, lobes, a_cone,
               half: int, separable: bool):
    """The lobe sum's chain up to its gates, lobe by lobe in `lobe_set`
    order: yields (lx, ly, aa, bb, ang, sel), each [N, C], sel = lobe_ok &
    in_cone & live (the plain version's gates)."""
    (wi_x, wi_y, wi_z, wo_x, wo_y, wo_z, cg, sg, ip_x, ip_y,
     half_lobes) = _lane_columns(wi, wo, grating_dir, inv_period, lobes)
    sin_ix, sin_iy = _sin_incidence(wi_x, wi_y, wi_z)
    yield from _gates(wl_nm * 1e-3, wo_x, wo_y, wo_z, cg, sg, ip_x, ip_y,
                      sin_ix, sin_iy, half_lobes, _col(a_cone), half,
                      separable)


def grating_lobe_sum_plain(wi, wo, wl_nm, grating_dir, inv_period, q, lobes,
                           gtype, multiplier, coherence, a_cone, half: int,
                           separable: bool):
    """Plain version of `grating_lobe_sum`: [N, C] in float32."""
    (wi_x, wi_y, wi_z, wo_x, wo_y, wo_z, cg, sg, ip_x, ip_y,
     half_lobes) = _lane_columns(wi, wo, grating_dir, inv_period, lobes)
    qv, mu_, co_, ac_ = _col(q), _col(multiplier), _col(coherence), \
        _col(a_cone)
    gt = _col(gtype.to(torch.float32))

    sin_ix, sin_iy = _sin_incidence(wi_x, wi_y, wi_z)
    cos_t = torch.abs(wi_z)
    is_1d = ip_y < m.Epsilon
    is_sin = gt < 0.5
    is_rect = torch.abs(gt - 1.0) < 0.5
    ny = 2.0 * half_lobes + 1.0

    wl_um = wl_nm * 1e-3
    kwn = 2.0 * m.Pi / torch.clamp_min(wl_um, 1e-6)
    a = 4.0 * m.Pi * qv / torch.clamp_min(wl_um * cos_t, 1e-12)
    base = base_intensities(a, is_sin, is_rect, half)
    s = co_ * kwn * (1.0 / (2.0 * m.Pi * 1e3))
    inv_det = s * s

    acc = torch.zeros_like(a)
    corr = torch.zeros_like(a)
    for lx, ly, _, _, ang, sel in _gates(wl_um, wo_x, wo_y, wo_z, cg, sg,
                                         ip_x, ip_y, sin_ix, sin_iy,
                                         half_lobes, ac_, half, separable):
        ix = base[abs(lx)]
        iy = torch.where(is_1d, ix, base[abs(ly)])
        lobe_int = mu_ * ix * iy
        ang_coh = torch.exp(-0.5 * ang * ang * inv_det)
        if lx == 0 and ly == 0:
            acc = acc + torch.where(sel, lobe_int, 0.0)
            if separable:
                corr = torch.where(
                    sel, lobe_int * (ang_coh - 1.0) * (ny - 1.0), 0.0)
        else:
            acc = acc + torch.where(sel, lobe_int * ang_coh, 0.0)
    if separable:
        acc = acc * ny + corr
    return acc


def grating_lobe_sum_sel_plain(args, half: int, separable: bool):
    """The selection bits of B4's recording instance, from the plain
    version's gates (`lobe_gates`): int32 [N, C, words], lobe k of
    `lobe_set` at bit k % 32 of word k // 32 (the word's 32 bits as the
    int32 of the same bits). `args` in LOBE_SUM_INPUTS order."""
    wi, wo, wl_nm, gd, ip, _, lobes, _, _, _, a_cone = args
    _, words = lobe_set(half, separable)
    with torch.no_grad():
        bits = torch.zeros((*wl_nm.shape, words), dtype=torch.int64,
                           device=wl_nm.device)
        for k, (*_, sel) in enumerate(lobe_gates(wi, wo, wl_nm, gd, ip,
                                                 lobes, a_cone, half,
                                                 separable)):
            bits[..., k // 32] |= sel.long() << (k % 32)
        bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return bits.to(torch.int32)


# the lobe sum's inputs in order; lobes and gtype (int32) take no gradient,
# a_cone reaches the output only through the cone's mask
LOBE_SUM_INPUTS = ("wi", "wo", "wl_nm", "grating_dir", "inv_period", "q",
                   "lobes", "gtype", "multiplier", "coherence", "a_cone")
_NO_GRAD_INPUTS = ("lobes", "gtype", "a_cone")


def _check_lobe_sum(args, half, n_channels):
    f32, i32 = torch.float32, torch.int32
    wi, wo, wl_nm, gd, ip, q, lobes, gtype, mult, coh, a_cone = args
    dev, n = check_tensors("grating_lobe_sum", {
        "wi": (wi, f32, (3,)), "wo": (wo, f32, (3,)),
        "wl_nm": (wl_nm, f32, (n_channels,)),
        "grating_dir": (gd, f32, (2,)),
        "inv_period": (ip, f32, (2,)), "q": (q, f32, ()),
        "lobes": (lobes, i32, ()), "gtype": (gtype, i32, ()),
        "multiplier": (mult, f32, ()),
        "coherence": (coh, f32, ()), "a_cone": (a_cone, f32, ()),
    })
    if not 0 <= half <= MAX_HALF:
        raise ValueError(f"grating_lobe_sum: half {half} outside 0..{MAX_HALF}")
    if dev.type == "cuda" and n_channels != 3:
        raise ValueError("grating_lobe_sum: the kernel takes 3 channels (RGB)")
    return dev, n


def _lobe_sum_kernel(args, half, separable, n_channels, record=False):
    """B4 on CUDA tensors: (out [N, C], None), or with `record` its
    recording instance: (out, the selection bits int32 [N, C, words])."""
    global LOBE_SUM_LAUNCHES, LOBE_SUM_RECORD_LAUNCHES
    from .build import check, load_library

    dev, n = args[0].device, args[0].shape[0]
    lib = load_library()
    table = bessel_table(dev)
    out = torch.empty((n, n_channels), dtype=torch.float32, device=dev)
    sel = (torch.empty((n, n_channels, lobe_set(half, separable)[1]),
                       dtype=torch.int32, device=dev) if record else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(lib.plt_grating_lobe_sum(
        *(t.data_ptr() for t in args), table.data_ptr(), n, int(half),
        int(bool(separable)), int(n_channels), out.data_ptr(),
        None if sel is None else sel.data_ptr(), stream),
        "grating_lobe_sum")
    if record:
        LOBE_SUM_RECORD_LAUNCHES += 1
    else:
        LOBE_SUM_LAUNCHES += 1
    return out, sel


def grating_lobe_sum_record(args, half: int, separable: bool):
    """B4's recording instance on the inputs `args` (LOBE_SUM_INPUTS
    order): (the lobe sum [N, C], its selection bits int32 [N, C, words],
    `grating_lobe_sum_sel_plain`'s layout), the bits `grating_lobe_sum_bwd`
    takes. Its sum equals the plain instance's to the bit. CPU tensors
    take the plain versions."""
    n_channels = args[2].shape[-1]
    dev, _ = _check_lobe_sum(args, half, n_channels)
    if dev.type == "cpu":
        return (grating_lobe_sum_plain(*args, half, separable),
                grating_lobe_sum_sel_plain(args, half, separable))
    return _lobe_sum_kernel(args, half, separable, n_channels, record=True)


def grating_lobe_sum_bwd_plain(args, g, half: int, separable: bool):
    """Plain version of `grating_lobe_sum_bwd`: autograd of
    `grating_lobe_sum_plain` at the inputs `args` (in LOBE_SUM_INPUTS
    order) with the cotangent g [N, C]. Returns the gradients of the
    inputs (zeros where an input does not reach the output, as q at half
    0), None for lobes, gtype and a_cone."""
    xs = [t.detach().requires_grad_(name not in _NO_GRAD_INPUTS)
          for name, t in zip(LOBE_SUM_INPUTS, args)]
    with torch.enable_grad():
        out = grating_lobe_sum_plain(*xs, half, separable)
        want = [x for name, x in zip(LOBE_SUM_INPUTS, xs)
                if name not in _NO_GRAD_INPUTS]
        grads = iter(torch.autograd.grad(out, want, g,
                                         materialize_grads=True))
    return tuple(None if name in _NO_GRAD_INPUTS else next(grads)
                 for name in LOBE_SUM_INPUTS)


def grating_lobe_sum_bwd(args, g, half: int, separable: bool, sel=None):
    """B4b: the vector-Jacobian product of `grating_lobe_sum` at the inputs
    `args` (in LOBE_SUM_INPUTS order) with the cotangent g [N, C]: the
    gradients of wi, wo, wl_nm, grating_dir, inv_period, q, multiplier
    and coherence, None for lobes, gtype and a_cone. CPU tensors take
    `grating_lobe_sum_bwd_plain` (`sel` unread); CUDA tensors launch the
    kernel on `sel`, the selection bits of B4's recording launch on the
    same inputs (`grating_lobe_sum_record`), and raise without them. It
    differentiates B4's own forward (J and J' from `bessel_table`'s
    Hermite cubic) on the lobes B4 selected, so it agrees with the plain
    version, which differentiates the float32 sweep, within that
    interpolation and rounding, and where a gate flips at float
    rounding."""
    global LOBE_SUM_BWD_LAUNCHES
    n_channels = args[2].shape[-1]
    dev, n = _check_lobe_sum(args, half, n_channels)
    check_tensors("grating_lobe_sum_bwd", {
        "wl_nm": (args[2], torch.float32, (n_channels,)),
        "g": (g, torch.float32, (n_channels,))})
    if dev.type == "cpu":
        return grating_lobe_sum_bwd_plain(args, g, half, separable)
    if sel is None:
        raise ValueError(
            "grating_lobe_sum_bwd: a CUDA call takes `sel`, the selection "
            "bits of B4's recording launch (grating_lobe_sum_record)")
    check_tensors("grating_lobe_sum_bwd", {"sel": (
        sel, torch.int32, (n_channels, lobe_set(half, separable)[1]))}, n)
    from .build import check, load_library

    lib = load_library()
    table = bessel_table(dev)
    grads = {name: torch.empty_like(t) for name, t in zip(LOBE_SUM_INPUTS,
                                                          args)
             if name not in _NO_GRAD_INPUTS}
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(lib.plt_grating_lobe_sum_bwd(
        *(t.data_ptr() for t in args[:10]), table.data_ptr(),
        sel.data_ptr(), g.data_ptr(), n, int(half), int(bool(separable)),
        int(n_channels), *(t.data_ptr() for t in grads.values()), stream),
        "grating_lobe_sum_bwd")
    LOBE_SUM_BWD_LAUNCHES += 1
    return tuple(grads.get(name) for name in LOBE_SUM_INPUTS)


def autograd_records(args) -> bool:
    """Whether autograd records a lobe-sum call on `args`: grad mode is on
    and an input requires grad (then the forward records its selection
    bits for B4b)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in args)


class _LobeSum(torch.autograd.Function):
    """B4 forward, B4b backward (`grating_lobe_sum_bwd`). With `record`
    (`autograd_records`) the forward on CUDA tensors launches B4's
    recording instance and keeps its bits for the backward; a
    checkpoint's recomputation records them again, the same. Forward mode
    raises: the lobe sum has a hand-written VJP and no JVP, as the JAX
    package's custom_vjp has none on its TPU path."""

    @staticmethod
    def forward(ctx, half, separable, n_channels, record, *args):
        ctx.half, ctx.separable = half, separable
        if args[0].device.type == "cpu":
            ctx.save_for_backward(*args, None)
            return grating_lobe_sum_plain(*args, half, separable)
        out, sel = _lobe_sum_kernel(args, half, separable, n_channels,
                                    record)
        ctx.save_for_backward(*args, sel)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        *args, sel = ctx.saved_tensors
        grads = grating_lobe_sum_bwd(args, g.contiguous(), ctx.half,
                                     ctx.separable, sel)
        return (None, None, None, None, *grads)

    @staticmethod
    def jvp(ctx, *tangents):
        raise NotImplementedError(
            "grating_lobe_sum has no forward-mode derivative (a VJP only, "
            "as the JAX package's custom_vjp); differentiate the PLT "
            "render in reverse mode")


def grating_lobe_sum(wi, wo, wl_nm, grating_dir, inv_period, q, lobes, gtype,
                     multiplier, coherence, a_cone, half: int,
                     separable: bool, n_channels: int):
    """Per-sampled-wavelength diffraction intensity [N, C].

    wi, wo [N, 3] local; wl_nm [N, C]; grating_dir, inv_period [N, 2];
    q, multiplier, coherence, a_cone [N] float32; lobes, gtype [N] int32
    (gtype already masked to its profile bits). CPU tensors run the plain
    version; CUDA tensors launch the kernel, which reads J_0..J_half from
    `bessel_table` (so it agrees with the plain version within rounding of
    the table and of the special functions, not to the bit).

    Differentiable (a `torch.autograd.Function`): its backward is
    `grating_lobe_sum_bwd`, the B4b kernel on CUDA tensors and autograd of
    the plain version on CPU tensors. Where autograd records, a CUDA call
    launches B4's recording instance (`launch_counts()`'s
    "grating_lobe_sum_record"), else the plain one ("grating_lobe_sum").
    Forward mode raises."""
    args = (wi, wo, wl_nm, grating_dir, inv_period, q, lobes, gtype,
            multiplier, coherence, a_cone)
    _check_lobe_sum(args, half, n_channels)
    return _LobeSum.apply(int(half), bool(separable), int(n_channels),
                          autograd_records(args), *args)


# ---------------------------------------------------------------------------
# sample chain
# ---------------------------------------------------------------------------

def _smith_g1(vx, vy, vz, mx, my, mz, au, av, ndf: int):
    xy2 = (au * vx) * (au * vx) + (av * vy) * (av * vy)
    tan2 = xy2 / torch.clamp_min(vz * vz, 1e-20)
    if ndf == 1:
        a = torch.rsqrt(torch.clamp_min(tan2, 1e-30))
        a2 = a * a
        approx = (3.535 * a + 2.181 * a2) / (1.0 + 2.276 * a + 2.577 * a2)
        g = torch.clamp_max(torch.where(a >= 1.6, 1.0, approx), 1.0)
    else:
        g = 2.0 / (1.0 + torch.sqrt(1.0 + tan2))
    g = torch.where(xy2 == 0.0, 1.0, g)
    backfacing = (vx * mx + vy * my + vz * mz) * vz <= 0.0
    return torch.where(backfacing, 0.0, g)


def _vndf_beckmann(vhx, vhy, vhz, u1, u2, au, av):
    sin2d = vhx * vhx + vhy * vhy
    inv_l = torch.rsqrt(torch.clamp_min(sin2d, 1e-30))
    near_n = sin2d < 1e-14
    cos_phi = torch.where(near_n, 1.0, vhx * inv_l)
    sin_phi = torch.where(near_n, 0.0, vhy * inv_l)
    ct = torch.clamp(vhz, 1e-6, 1.0)
    tan_t = m.safe_sqrt(1.0 - ct * ct) / ct
    cot_t = 1.0 / torch.clamp_min(tan_t, 1e-12)
    maxval = torch.erf(torch.clamp_max(cot_t, 6.0))
    uxs = torch.clamp(u1, 1e-6, 1.0 - 1e-6)
    uys = torch.clamp(u2, 1e-6, 1.0 - 1e-6)
    inv_sqrt_pi = 0.5641895835477563
    x = maxval - (maxval + 1.0) * torch.erf(torch.sqrt(-torch.log(uxs)))
    uxs = uxs * (1.0 + maxval + inv_sqrt_pi * tan_t * torch.exp(-(cot_t * cot_t)))
    for _ in range(3):
        x = torch.clamp(x, -1.0 + 1e-6, 1.0 - 1e-6)
        slope = torch.erfinv(x)
        value = 1.0 + x + inv_sqrt_pi * tan_t * torch.exp(-(slope * slope)) - uxs
        deriv = 1.0 - slope * tan_t
        x = x - value / torch.where(torch.abs(deriv) > 1e-6, deriv,
                                    torch.where(deriv >= 0, 1e-6, -1e-6))
    x = torch.clamp(x, -1.0 + 1e-6, 1.0 - 1e-6)
    slope_x = torch.erfinv(x)
    slope_y = torch.erfinv(2.0 * uys - 1.0)
    sxs = (cos_phi * slope_x - sin_phi * slope_y) * au
    sys_ = (sin_phi * slope_x + cos_phi * slope_y) * av
    inv_m = torch.rsqrt(torch.clamp_min(sxs * sxs + sys_ * sys_ + 1.0, 1e-24))
    return -sxs * inv_m, -sys_ * inv_m, inv_m


def _vndf_ggx(vhx, vhy, vhz, u1, u2, au, av):
    lensq = vhx * vhx + vhy * vhy
    inv_len = torch.rsqrt(torch.clamp_min(lensq, 1e-30))
    big = lensq > 1e-12
    t1x = torch.where(big, -vhy * inv_len, 1.0)
    t1y = torch.where(big, vhx * inv_len, 0.0)
    t2x = vhy * 0.0 - vhz * t1y
    t2y = vhz * t1x - vhx * 0.0
    t2z = vhx * t1y - vhy * t1x
    r = torch.sqrt(torch.clamp_min(u1, 0.0))
    phi = (2.0 * m.Pi) * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vhz)
    p2 = (1.0 - s) * m.safe_sqrt(1.0 - p1 * p1) + s * p2
    p3 = m.safe_sqrt(1.0 - p1 * p1 - p2 * p2)
    nhx = p1 * t1x + p2 * t2x + p3 * vhx
    nhy = p1 * t1y + p2 * t2y + p3 * vhy
    nhz = p1 * 0.0 + p2 * t2z + p3 * vhz
    mxu, myu, mzu = au * nhx, av * nhy, torch.clamp_min(nhz, 1e-6)
    inv_m = torch.rsqrt(torch.clamp_min(mxu * mxu + myu * myu + mzu * mzu,
                                        1e-24))
    return mxu * inv_m, myu * inv_m, mzu * inv_m


def _pick(u, p_ord, half: int):
    """Folded-uniform lobe pick: (order index, sign, per-axis pdf)."""
    rn = (u - 0.5) * 2.0
    sgn = torch.where(rn >= 0, 1.0, -1.0)
    arn = torch.abs(rn)
    cdf_excl = torch.zeros_like(arn)
    count = torch.zeros_like(arn)
    for j in range(half + 1):
        count = count + torch.where(arn > cdf_excl, 1.0, 0.0)
        cdf_excl = cdf_excl + p_ord[j]
    idx = torch.clamp(count - 1.0, 0.0, float(half))
    pj = torch.zeros_like(arn)
    for j in range(half + 1):
        pj = torch.where(idx == float(j), p_ord[j], pj)
    return idx, sgn, torch.where(idx == 0.0, pj, pj * 0.5)


def grating_sample_plain(wi, u2, lobe_u2, wl_um, alpha, grating_dir,
                         inv_period, q, lobes, gtype, multiplier, half: int,
                         ndf: int):
    """Plain version of `grating_sample` (same outputs)."""
    wi_x, wi_y, wi_z = wi.unbind(-1)
    u1, u2v = u2.unbind(-1)
    lu1, lu2 = lobe_u2.unbind(-1)
    au, av = alpha.unbind(-1)
    cg, sg = grating_dir.unbind(-1)
    ip_x, ip_y = inv_period.unbind(-1)
    lob = lobes.to(torch.float32)
    gt = gtype.to(torch.float32)

    cos_i = wi_z
    flip = cos_i < 0
    wux = torch.where(flip, -wi_x, wi_x)
    wuy = torch.where(flip, -wi_y, wi_y)
    wuz = torch.where(flip, -wi_z, wi_z)

    vx, vy, vz = au * wux, av * wuy, wuz
    inv_n = torch.rsqrt(torch.clamp_min(vx * vx + vy * vy + vz * vz, 1e-24))
    vh = (vx * inv_n, vy * inv_n, vz * inv_n)
    vndf = _vndf_beckmann if ndf == 1 else _vndf_ggx
    mx, my, mz = vndf(*vh, u1, u2v, au, av)

    ct2 = mz * mz
    cos4 = ct2 * ct2
    inv_ct = 1.0 / torch.clamp_min(torch.abs(mz), 1e-12)
    su = (-mx * inv_ct) / au
    sv = (-my * inv_ct) / av
    s2 = su * su + sv * sv
    if ndf == 1:
        d_ndf = torch.exp(-s2) / (m.Pi * au * av * torch.clamp_min(cos4, 1e-20))
    else:
        tmp = 1.0 + s2
        d_ndf = 1.0 / (m.Pi * au * av * tmp * tmp * torch.clamp_min(cos4, 1e-20))
    d_ndf = torch.where(mz > 0, d_ndf, 0.0)
    g1_wi = _smith_g1(wux, wuy, wuz, mx, my, mz, au, av, ndf)
    dot_wm = wux * mx + wuy * my + wuz * mz
    mpdf = g1_wi * torch.abs(dot_wm) * d_ndf / torch.clamp_min(
        torch.abs(wuz), 1e-12)

    dwm = wi_x * mx + wi_y * my + wi_z * mz
    rx = 2.0 * dwm * mx - wi_x
    ry = 2.0 * dwm * my - wi_y
    rz = 2.0 * dwm * mz - wi_z

    pos = mz >= 0
    sgn = torch.where(pos, 1.0, -1.0)
    a_c = -1.0 / (sgn + mz)
    b_c = mx * my * a_c
    msx = torch.where(pos, mx * mx * a_c, -(mx * mx * a_c)) + 1.0
    msy = torch.where(pos, b_c, -b_c)
    msz = torch.where(pos, -mx, mx)
    mtx, mty, mtz = b_c, my * my * a_c + sgn, -my
    wmx = wi_x * msx + wi_y * msy + wi_z * msz
    wmy = wi_x * mtx + wi_y * mty + wi_z * mtz
    wmz = wi_x * mx + wi_y * my + wi_z * mz

    is_sin = gt < 0.5
    is_rect = torch.abs(gt - 1.0) < 0.5
    a_b = 4.0 * m.Pi * q / torch.clamp_min(wl_um * torch.abs(wmz), 1e-12)
    base = base_intensities(a_b, is_sin, is_rect, half)

    half_lobes = torch.floor(lob * 0.5)
    ints = []
    for j in range(half + 1):
        v = base[j] * multiplier
        if j == 0:
            v = v * 0.5
        ints.append(torch.where(half_lobes >= float(j), v, 0.0))
    total = ints[0]
    for j in range(1, half + 1):
        total = total + ints[j]
    inv_tot = 1.0 / torch.clamp_min(total, 1e-30)
    p_ord = [x * inv_tot for x in ints]
    ix_o, sgx, pdf_x = _pick(lu1, p_ord, half)
    iy_o, sgy, pdf_y = _pick(lu2, p_ord, half)
    lx = ix_o * sgx
    ly = iy_o * sgy

    bx = torch.zeros_like(wl_um)
    by = torch.zeros_like(wl_um)
    for j in range(half + 1):
        bx = torch.where(ix_o == float(j), base[j], bx)
        by = torch.where(iy_o == float(j), base[j], by)
    is_1d = ip_y < m.Epsilon
    inten = multiplier * bx * torch.where(is_1d, bx, by)

    sin_ix, sin_iy = _sin_incidence(wmx, wmy, wmz)
    aa, bb, mm_, qq_, diff_ok = _diffract(wl_um, cg, sg, lx, ly, ip_x, ip_y,
                                          sin_ix, sin_iy)
    womx = aa * m.safe_sqrt(qq_)
    womy = bb * m.safe_sqrt(mm_)
    womz = m.safe_sqrt(1.0 - aa * aa * qq_ - bb * bb * mm_)
    wox = msx * womx + mtx * womy + mx * womz
    woy = msy * womx + mty * womy + my * womz
    woz = msz * womx + mtz * womy + mz * womz

    dot_rm = rx * mx + ry * my + rz * mz
    pdf = mpdf * (pdf_x * pdf_y) / torch.clamp_min(4.0 * torch.abs(dot_rm),
                                                  1e-12)
    ok = (cos_i > 0) & (mpdf > 0) & (woz > 0) & diff_ok
    g1_r = _smith_g1(rx, ry, rz, mx, my, mz, au, av, ndf)
    return {
        "wo": torch.stack([wox, woy, woz], dim=-1),
        "pdf": pdf,
        "lobe": torch.stack([lx, ly], dim=-1).to(torch.int32),
        "w_g1_int": g1_r * inten,
        "reflection_dir": torch.stack([rx, ry, rz], dim=-1),
        "mvec": torch.stack([mx, my, mz], dim=-1),
        "ok": ok,
    }


def grating_sample(wi, u2, lobe_u2, wl_um, alpha, grating_dir, inv_period, q,
                   lobes, gtype, multiplier, half: int, ndf: int = 0):
    """Fused roughgrating sample chain.

    wi [N, 3] local; u2, lobe_u2 [N, 2] uniforms; wl_um [N] hero wavelength
    in um; alpha, grating_dir, inv_period [N, 2]; q, multiplier [N];
    lobes, gtype [N] int32; ndf 0 = GGX, 1 = Beckmann. Returns a dict of
    separate tensors: wo [N, 3], pdf [N], lobe [N, 2] int32, w_g1_int [N]
    (G1 of the specular direction times the lobe intensity),
    reflection_dir [N, 3], mvec [N, 3], ok [N] bool. CPU tensors run the
    plain version; CUDA tensors launch the kernel."""
    global GRATING_SAMPLE_LAUNCHES
    f32, i32 = torch.float32, torch.int32
    dev, n = check_tensors("grating_sample", {
        "wi": (wi, f32, (3,)), "u2": (u2, f32, (2,)),
        "lobe_u2": (lobe_u2, f32, (2,)), "wl_um": (wl_um, f32, ()),
        "alpha": (alpha, f32, (2,)), "grating_dir": (grating_dir, f32, (2,)),
        "inv_period": (inv_period, f32, (2,)), "q": (q, f32, ()),
        "lobes": (lobes, i32, ()), "gtype": (gtype, i32, ()),
        "multiplier": (multiplier, f32, ()),
    })
    if not 0 <= half <= MAX_HALF or ndf not in (0, 1):
        raise ValueError(f"grating_sample: unsupported half={half} ndf={ndf}")
    if dev.type == "cpu":
        return grating_sample_plain(wi, u2, lobe_u2, wl_um, alpha,
                                    grating_dir, inv_period, q, lobes, gtype,
                                    multiplier, half, ndf)
    from .build import check, load_library

    lib = load_library()
    out = {
        "wo": torch.empty((n, 3), dtype=f32, device=dev),
        "pdf": torch.empty((n,), dtype=f32, device=dev),
        "lobe": torch.empty((n, 2), dtype=i32, device=dev),
        "w_g1_int": torch.empty((n,), dtype=f32, device=dev),
        "reflection_dir": torch.empty((n, 3), dtype=f32, device=dev),
        "mvec": torch.empty((n, 3), dtype=f32, device=dev),
        "ok": torch.empty((n,), dtype=torch.bool, device=dev),
    }
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(lib.plt_grating_sample(
        wi.data_ptr(), u2.data_ptr(), lobe_u2.data_ptr(), wl_um.data_ptr(),
        alpha.data_ptr(), grating_dir.data_ptr(), inv_period.data_ptr(),
        q.data_ptr(), lobes.data_ptr(), gtype.data_ptr(),
        multiplier.data_ptr(), n, int(half), int(ndf),
        *(out[k].data_ptr() for k in ("wo", "pdf", "lobe", "w_g1_int",
                                      "reflection_dir", "mvec", "ok")),
        stream), "grating_sample")
    GRATING_SAMPLE_LAUNCHES += 1
    return out
