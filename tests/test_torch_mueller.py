"""The port's polarized building blocks against the JAX package (CPU),
element-wise on identical numpy inputs from a seed: the complex helpers and
the polarized Fresnel amplitudes (both sides of the boundary, total
internal reflection, the index-matched boundary), every Mueller
constructor, the Stokes bases and their rotation, the specular basis
alignment (normal incidence included) and the turn to world bases, the
BSDFs' and the wave BSDF's Mueller values, the coherence state and the
beam, and the render modes.

Tolerances. XLA on the CPU contracts multiply-adds into FMAs and rounds
the complex divisions otherwise, so the two packages' float32 amplitudes
differ by up to ~1e-5 (dielectric) and ~1e-4 (conductor, |eta| to 5.8)
where their terms cancel. Near normal incidence the conductor's m01 =
(r_s - r_p) / 2 cancels: each package's float32 value lies up to 2.5e-4
m00 from a float64 evaluation (`test_conductor_mueller_vs_analytic`), so
Mueller matrices are held to each other entry by entry within 5e-4 of the
lane's largest entry (`mueller_close`)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mitsuba3_plt_tpu.config import RGB_POLARIZED as JPOL
from mitsuba3_plt_tpu.core import frame as jfr
from mitsuba3_plt_tpu.core import math as jm
from mitsuba3_plt_tpu.integrators.plt import PLTIntegrator as JPLT
from mitsuba3_plt_tpu.librender import bsdfs as jbsdfs
from mitsuba3_plt_tpu.librender import fresnel as jfres
from mitsuba3_plt_tpu.librender import mueller as jmu
from mitsuba3_plt_tpu.librender.bsdf import BSDFContext
from mitsuba3_plt_tpu.plt import beam as jbeam
from mitsuba3_plt_tpu.plt import coherence as jcoh
from mitsuba3_plt_tpu.plt import wbsdf as jwb
from mitsuba3_plt_tpu_torch import config
from mitsuba3_plt_tpu_torch.core import frame as tfr
from mitsuba3_plt_tpu_torch.core import math as tm
from mitsuba3_plt_tpu_torch.integrators.plt import PLTIntegrator
from mitsuba3_plt_tpu_torch.librender import bsdfs as tbsdfs
from mitsuba3_plt_tpu_torch.librender import fresnel as tfres
from mitsuba3_plt_tpu_torch.librender import mueller as tmu
from mitsuba3_plt_tpu_torch.plt import beam as tbeam
from mitsuba3_plt_tpu_torch.plt import coherence as tcoh
from mitsuba3_plt_tpu_torch.plt import wbsdf as twb
from test_torch_golden_specular import one_torch_thread  # noqa: F401
from test_torch_plt import _jax_sd, _torch_sd, lanes  # noqa: F401
from test_torch_specular import BOX, N, _dirs, _lanes, _scenes, _u1_at_F

REL = 5e-4


def T(x):
    return torch.as_tensor(np.array(x))


def lanes_of(M):
    """The port's Mueller [4, 4, ...] as numpy [..., 4, 4]."""
    return tmu.to_lanes(M).numpy()


def jmueller(P, n, C):
    """JAX's planar MuellerP -> [n, C, 4, 4]."""
    return np.moveaxis(np.asarray(P.stack(n, C)), -1, 1)


def mueller_close(got, want, rel=REL, atol=1e-6, mask=None):
    """Entry by entry within rel of each lane's largest |entry|."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max(axis=(-1, -2), keepdims=True)
    ok = np.abs(got - want) <= rel * scale + atol
    if mask is not None:
        ok = ok | ~mask.reshape(mask.shape + (1,) * (ok.ndim - 1))
    assert ok.all(), (np.abs(got - want).max(), int((~ok).sum()))


def _cos_cases(rng, n=N):
    """cos_theta_i on both sides, the normal and grazing incidence and the
    transmission's |cos| <= 1e-8 guard."""
    return np.concatenate([rng.uniform(-1, 1, n),
                           [0.0, -0.0, 1.0, -1.0, 1e-7, -1e-7, 1e-9,
                            -1e-9]]).astype(np.float32)


def test_unit_angle_and_cross_match_jax():
    rng = np.random.default_rng(20)
    u, v = _dirs(rng, N), _dirs(rng, N)
    v[:16] = u[:16]           # angle 0
    v[16:32] = -u[16:32]      # angle pi
    np.testing.assert_allclose(tm.unit_angle(T(u), T(v)).numpy(),
                               np.asarray(jm.unit_angle(u, v)), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tfr.cross(T(u), T(v)).numpy(),
                               np.asarray(jfr.cross(u, v)), rtol=1e-6,
                               atol=1e-7)


def test_complex_helpers_match_jax():
    rng = np.random.default_rng(21)
    a = tuple(rng.normal(size=(2, N)).astype(np.float32))
    b = tuple(rng.normal(size=(2, N)).astype(np.float32))
    b[0][:8] = 0.0
    b[1][:8] = 0.0            # a zero divisor, a zero phase product
    ta, tb = (T(a[0]), T(a[1])), (T(b[0]), T(b[1]))
    for name in ("c_add", "c_sub", "c_mul", "c_div"):
        got = getattr(tfres, name)(ta, tb)
        want = getattr(jfres, name)(a, b)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-6, err_msg=name)
    # c_sqrt within 3e-5: sqrt(0.5 (r - |re|)) cancels where im is small
    for name, atol in (("c_rcp", 1e-6), ("c_sqrt", 3e-5), ("c_conj", 0)):
        for g, w in zip(getattr(tfres, name)(ta), getattr(jfres, name)(a)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=atol, err_msg=name)
    np.testing.assert_allclose(tfres.c_abs2(ta).numpy(),
                               np.asarray(jfres.c_abs2(a)), rtol=1e-6)
    for g, w in zip(tfres.sincos_arg_diff(ta, tb),
                    jfres.sincos_arg_diff(a, b)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    s, c = tfres.sincos_arg_diff(ta, tb)
    assert (s.numpy()[:8] == 0).all() and (c.numpy()[:8] == 1).all()


@pytest.mark.parametrize("eta", [1.5046, 1.0 / 1.5046, 1.0, 2.4])
def test_fresnel_polarized_dielectric_matches_jax(eta):
    """a_s, a_p (re, im) within 2e-5, cos_theta_t, eta_it, eta_ti within
    1e-5 on every lane: both sides of the boundary, past the critical
    angle (a_s, a_p of modulus 1, a phase between them), the grazing and
    the index-matched (a_s = a_p = 0) lanes."""
    ct = _cos_cases(np.random.default_rng(22))
    e = np.full_like(ct, eta)
    want = jax.jit(jfres.fresnel_polarized_dielectric)(ct, e)
    got = tfres.fresnel_polarized_dielectric(T(ct), T(e))
    for i, name in enumerate(("a_s", "a_p")):
        for k in range(2):
            np.testing.assert_allclose(got[i][k].numpy(),
                                       np.asarray(want[i][k]), rtol=0,
                                       atol=2e-5, err_msg=name)
    for i, name in ((2, "cos_theta_t"), (3, "eta_it"), (4, "eta_ti")):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    eta_ti = got[4].numpy()
    tir = 1 - eta_ti * eta_ti * (1 - ct * ct) < 0
    a_s = got[0][0].numpy() ** 2 + got[0][1].numpy() ** 2
    if eta == 1.0:
        assert not tir.any() and (a_s == 0).all()
    else:
        assert tir.any() and (got[2].numpy()[tir] == 0).all()
        np.testing.assert_allclose(a_s[tir], 1.0, atol=1e-5)
        assert (np.abs(got[0][1].numpy()[tir]) > 1e-3).any()


def test_fresnel_polarized_conductor_matches_jax():
    """Complex indices eta_re in [0.1, 3], eta_im in [0, 5] (eta_im > 0
    taken as negative), cos_i on both sides: a_s, a_p within 2e-4, the
    complex eta_it, eta_ti within 1e-6 relative."""
    rng = np.random.default_rng(23)
    ct = _cos_cases(rng)
    er = rng.uniform(0.1, 3.0, ct.shape).astype(np.float32)
    ei = rng.uniform(0.0, 5.0, ct.shape).astype(np.float32)
    ei[:16] = 0.0
    want = jax.jit(jfres.fresnel_polarized_conductor)(ct, er, ei)
    got = tfres.fresnel_polarized_conductor(T(ct), T(er), T(ei))
    for i in (0, 1):
        for k in range(2):
            np.testing.assert_allclose(got[i][k].numpy(),
                                       np.asarray(want[i][k]), rtol=0,
                                       atol=2e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-5, atol=1e-5)
    for i in (3, 4):
        for k in range(2):
            np.testing.assert_allclose(got[i][k].numpy(),
                                       np.asarray(want[i][k]), rtol=1e-6,
                                       atol=1e-7)


def _constructor_cases(name, rng):
    """(port args, JAX args, C) of a Mueller constructor."""
    if name == "rotator":
        th = rng.uniform(-4, 4, N).astype(np.float32)
        return (T(th),), (jnp.asarray(th),), None
    if name == "depolarizer":
        v = rng.uniform(0, 2, (N, 3)).astype(np.float32)
        return (T(v),), (jnp.asarray(v),), 3
    ct = _cos_cases(rng)[:, None]
    if name == "specular_reflection_conductor":
        er = rng.uniform(0.1, 3.0, (ct.shape[0], 3)).astype(np.float32)
        ei = rng.uniform(0.0, 5.0, (ct.shape[0], 3)).astype(np.float32)
        return (T(ct), T(er), T(ei)), (ct, er, ei), 3
    eta = np.where(rng.random(ct.shape) < 0.5, 1.5046, 1 / 1.5046).astype(
        np.float32)
    eta[:4] = 1.0
    return (T(ct), T(eta)), (ct, eta), 1


@pytest.mark.parametrize("name", ["rotator", "depolarizer",
                                  "specular_reflection_conductor",
                                  "specular_reflection_dielectric",
                                  "specular_transmission"])
def test_mueller_constructors_match_jax(name):
    """Every constructor on both sides of the boundary, past the critical
    angle and at the transmission's |cos_i| <= 1e-8 guard (whose lanes are
    zero), within `mueller_close`."""
    targs, jargs, _ = _constructor_cases(name, np.random.default_rng(24))
    got = lanes_of(getattr(tmu, name)(*targs))
    want = np.asarray(jax.jit(getattr(jmu, name))(*jargs))
    assert got.shape == want.shape
    mueller_close(got, want)
    if name == "specular_transmission":
        grazing = np.abs(jargs[0][..., 0]) <= 1e-8
        assert grazing.sum() == 4 and (got[grazing] == 0).all()
    if name == "rotator":
        np.testing.assert_allclose(got @ np.swapaxes(got, -1, -2),
                                   np.broadcast_to(np.eye(4), got.shape),
                                   atol=1e-6)
    ident = lanes_of(tmu.identity((3, 2)))
    np.testing.assert_array_equal(ident,
                                  np.asarray(jmu.identity((3, 2))))


def test_mueller_algebra_matches_numpy():
    """The block-first products, the matrix-vector apply, the unpolarized
    apply, the transpose and the lane select against numpy on [..., 4, 4]
    views, a per-lane rotator [4, 4, N, 1] broadcast over the channels."""
    rng = np.random.default_rng(32)
    n, C = 64, 3
    A = rng.normal(size=(4, 4, n, C)).astype(np.float32)
    B = rng.normal(size=(4, 4, n, C)).astype(np.float32)
    R = rng.normal(size=(4, 4, n, 1)).astype(np.float32)
    s = rng.normal(size=(4, n, C)).astype(np.float32)
    v = rng.normal(size=(n, C)).astype(np.float32)
    mask = rng.random(n) < 0.5
    lanes = lambda M: np.moveaxis(M, (0, 1), (-2, -1))  # noqa: E731
    np.testing.assert_allclose(lanes_of(tmu.matmul(T(A), T(B))),
                               lanes(A) @ lanes(B), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lanes_of(tmu.matmul(T(R), T(B))),
                               lanes(R) @ lanes(B), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        np.moveaxis(tmu.apply(T(A), T(s)).numpy(), 0, -1),
        (lanes(A) @ np.moveaxis(s, 0, -1)[..., None])[..., 0], rtol=1e-5,
        atol=1e-5)
    np.testing.assert_array_equal(
        tmu.apply_unpolarized(T(A), T(v)).numpy(), A[:, 0] * v)
    np.testing.assert_array_equal(lanes_of(tmu.transpose(T(A))),
                                  np.swapaxes(lanes(A), -1, -2))
    np.testing.assert_array_equal(
        tmu.where(T(mask), T(A), T(B)).numpy(),
        np.where(mask[:, None], A, B))
    dep = lanes_of(tmu.depolarizer(T(v)))
    assert (dep[..., 0, 0] == v).all() and np.count_nonzero(dep) == v.size


def test_reflection_mueller_zero_c_guard():
    """Where r_s r_p = 0 the phase terms are 0, as JAX's: a_s = 0 lanes."""
    rng = np.random.default_rng(25)
    a_s = tuple(rng.normal(size=(2, 64)).astype(np.float32))
    a_p = tuple(rng.normal(size=(2, 64)).astype(np.float32))
    a_s[0][:16] = 0.0
    a_s[1][:16] = 0.0
    got = lanes_of(tmu._reflection_mueller((T(a_s[0]), T(a_s[1])),
                                           (T(a_p[0]), T(a_p[1]))))
    mueller_close(got, np.asarray(jmu._reflection_mueller(a_s, a_p)))
    assert (got[:16, 2:, 2:] == 0).all()


def test_conductor_mueller_vs_analytic():
    """JAX tests/test_stokes.py's check at 45 degrees (eta 0.2 + 3.9i), and
    both packages within 2.5e-4 m00 of a float64 evaluation of m00 and
    m01 over cos_i in (0, 1]: the cancellation in m01 near normal
    incidence that bounds `mueller_close`."""
    M = lanes_of(tmu.specular_reflection_conductor(
        torch.tensor([np.cos(np.deg2rad(45.0))], dtype=torch.float32),
        torch.tensor([0.2]), torch.tensor([3.9])))[0]
    n_c = 0.2 + 3.9j
    th = np.deg2rad(45)
    cos_t = np.sqrt(1 - (np.sin(th) / n_c) ** 2)
    r_s = (np.cos(th) - n_c * cos_t) / (np.cos(th) + n_c * cos_t)
    r_p = (n_c * np.cos(th) - cos_t) / (n_c * np.cos(th) + cos_t)
    Rs, Rp = abs(r_s) ** 2, abs(r_p) ** 2
    assert abs(M[0, 0] - 0.5 * (Rs + Rp)) < 1e-4
    assert abs(abs(M[0, 1]) - 0.5 * (Rs - Rp)) < 1e-4

    ct = np.linspace(1e-3, 1.0, 20000).astype(np.float32)
    er, ei = np.full_like(ct, 0.2), np.full_like(ct, 3.9)
    c = ct.astype(np.float64)
    n = 0.2 - 3.9j
    ctt = np.sqrt(1 - (1 - c * c) / (n * n))
    ctt = np.where(ctt.imag > 0, np.conj(ctt), ctt)
    rs = (c - n * ctt) / (c + n * ctt)
    rp = (n * c - ctt) / (n * c + ctt)
    a, b = 0.5 * (abs(rs) ** 2 + abs(rp) ** 2), 0.5 * (abs(rs) ** 2
                                                       - abs(rp) ** 2)
    for M in (lanes_of(tmu.specular_reflection_conductor(T(ct), T(er),
                                                          T(ei))),
              np.asarray(jmu.specular_reflection_conductor(ct, er, ei))):
        assert (np.abs(M[:, 0, 0] - a) <= 2.5e-4 * a).all()
        assert (np.abs(M[:, 0, 1] - b) <= 2.5e-4 * a).all()


def test_stokes_bases_and_rotation_match_jax():
    """stokes_basis on every direction (the poles included) and the
    rotator between two bases normal to forward, theta's sign flipped
    where forward . (current x target) < 0. Where the bases nearly agree
    rounding decides the sign, but the rotator is then the identity: held
    at atol 1e-5 per entry."""
    rng = np.random.default_rng(26)
    fwd = _dirs(rng, N)
    fwd[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, -1, 0]]
    np.testing.assert_allclose(tmu.stokes_basis(T(fwd)).numpy(),
                               np.asarray(jmu.stokes_basis(fwd)), rtol=1e-6,
                               atol=1e-6)
    cur = np.asarray(jmu.stokes_basis(fwd))
    alt = np.cross(fwd, cur)
    th = rng.uniform(-np.pi, np.pi, N)
    th[:64] = rng.normal(scale=1e-4, size=64)  # near-identical bases
    tgt = (np.cos(th)[:, None] * cur + np.sin(th)[:, None] * alt).astype(
        np.float32)
    got = lanes_of(tmu.rotate_stokes_basis(T(fwd), T(cur), T(tgt)))
    want = np.asarray(jmu.rotate_stokes_basis(fwd, cur, tgt))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the rotator takes the current basis to the target one: S1 of light
    # polarized along tgt reads +1 after the rotation
    s_tgt = np.stack([np.ones(N), np.cos(2 * th), np.sin(2 * th),
                      np.zeros(N)], -1)
    np.testing.assert_allclose((got @ s_tgt[..., None])[..., 1, 0], 1.0,
                               atol=1e-4)


def _hemi(rng, n):
    v = _dirs(rng, n)
    v[:, 2] = np.abs(v[:, 2])
    return v


def test_spec_reflect_mueller_matches_jax():
    """The specular basis alignment R_out @ M @ R_in^T about the local z and
    about random microfacet normals, at normal incidence (wo_hat = z, the
    [1, 0, 0] fallback) and at grazing incidence, per entry on every lane;
    S1/S2 signs come from the frame order, which S0 alone would not
    test."""
    rng = np.random.default_rng(27)
    wi = _hemi(rng, N)
    wo = _hemi(rng, N)
    wo[:32] = [0.0, 0.0, 1.0]            # normal incidence
    wi[:32] = [0.0, 0.0, 1.0]
    wo[32:40, 2] = 0.0                   # grazing
    wo[32:40] /= np.linalg.norm(wo[32:40], axis=-1, keepdims=True)
    nrm = np.where((np.arange(N) % 2 == 0)[:, None], [0.0, 0.0, 1.0],
                   tfr.normalize(T(wi + wo)).numpy()).astype(np.float32)
    ct = np.sum(wo * nrm, -1)[:, None]
    er = rng.uniform(0.1, 3.0, (N, 3)).astype(np.float32)
    ei = rng.uniform(0.0, 5.0, (N, 3)).astype(np.float32)
    M_t = tmu.specular_reflection_conductor(T(ct), T(er), T(ei))
    got = lanes_of(tbsdfs._spec_reflect_mueller(T(wo), T(wi), M_t, T(nrm)))
    M_j = jmu.p_specular_reflection_conductor(ct, er, ei)
    want = jmueller(jbsdfs._spec_reflect_mueller(
        jnp.asarray(wo), jnp.asarray(wi), lambda: M_j, jnp.asarray(nrm),
        JPOL), N, 3)
    mueller_close(got, want)
    # the fallback lanes: unrotated, the Fresnel Mueller turned only by
    # the implicit bases' own frames
    assert np.isfinite(got).all()
    assert np.abs(got[:32, :, 0, 1]).max() < 1e-3 * np.abs(
        got[:32, :, 0, 0]).max() + 1e-3


def test_to_world_mueller_matches_jax():
    """Local-basis Mueller matrices of random entries turned to world
    bases through random shading frames, per entry."""
    rng = np.random.default_rng(28)
    jsi, tsi, _ = _lanes(rng, N)
    M = rng.normal(size=(N, 3, 4, 4)).astype(np.float32)
    fin, fout = _dirs(rng, N), _dirs(rng, N)
    fin[:8] = [0.0, 0.0, -1.0]
    got = lanes_of(tbsdfs.to_world_mueller(
        tsi, T(np.moveaxis(M, (-2, -1), (0, 1))), T(fin), T(fout)))
    MP = jmu.MuellerP(m=tuple(jnp.asarray(M[:, :, i, j]) for i in range(4)
                              for j in range(4)))
    want = jmueller(jbsdfs.to_world_mueller(jsi, MP, jnp.asarray(fin),
                                            jnp.asarray(fout)), N, 3)
    mueller_close(got, want)
    # rotations on both sides keep m00 and the Frobenius norm
    np.testing.assert_allclose(got[..., 0, 0], M[..., 0, 0], rtol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=(-1, -2)),
                               np.linalg.norm(M, axis=(-1, -2)), rtol=1e-5)


@pytest.mark.parametrize("box_material", ["diffuse", "conductor",
                                          "roughconductor", "dielectric"])
def test_bsdf_mueller_sample_eval_match_jax(box_material):
    """The classic dispatch under a polarized config on the box's table:
    sample's Mueller weight (the dielectric's divided by its lobe's
    probability: its S0 on unpolarized light equals the unpolarized
    weight) on identical u1, u2 and wi, then eval at random wo, per entry
    where both packages took the same lobe."""
    jscene, tscene = _scenes(box_material)
    jmat, tmat = jscene.materials, tscene.materials
    rng = np.random.default_rng(29)
    jsi, tsi, midx = _lanes(rng, N)
    u1, F = _u1_at_F(rng, np.asarray(jsi.wi), np.full(N, 1.5046, np.float32))
    u2 = rng.random((N, 2)).astype(np.float32)
    ctx = BSDFContext()
    jmi, tmi = jnp.asarray(midx), torch.as_tensor(midx).long()
    jbs, jval, jok = jbsdfs.sample(jmat, jmi, jsi, jnp.asarray(u1),
                                   jnp.asarray(u2), ctx, JPOL)
    tu1 = torch.as_tensor(u1) if tbsdfs.reads_u1(tmat) else None
    tbs, tval, tok = tbsdfs.sample(tmat, tmi, tsi, tu1, torch.as_tensor(u2),
                                   3, pol=True)
    tval = tmu.to_lanes(tval)
    same = tbs.sampled_type.numpy() == np.asarray(jbs.sampled_type)
    assert same.mean() > 0.99
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    mueller_close(tval.numpy(), jmueller(jval, N, 3), mask=same)
    # m00 is the unpolarized weight: at rtol 2e-4 where the lobe's
    # probability is above 0.1, at 2e-3 on every lane (a grazing lane's
    # transmission Mueller, taken from the far side, divided by a small
    # 1 - F, magnifies the rounding of its cos_theta_t)
    _, wu, _ = tbsdfs.sample(tmat, tmi, tsi, tu1, torch.as_tensor(u2), 3)
    lobe_ok = tbs.pdf.numpy() > 0.1
    np.testing.assert_allclose(tval.numpy()[lobe_ok][..., 0, 0],
                               wu.numpy()[lobe_ok], rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(tval.numpy()[..., 0, 0], wu.numpy(),
                               rtol=2e-3, atol=1e-6)
    box = midx == BOX
    pol = np.abs(tval.numpy()[box][..., 0, 1:]).max(-1)
    if box_material == "diffuse":
        assert (tval.numpy()[..., 1:, :] == 0).all()
    else:
        assert (pol > 1e-3).any()
    wo = _dirs(rng, N)
    got = lanes_of(tbsdfs.eval_(tmat, tmi, tsi, torch.as_tensor(wo), 3,
                                pol=True))
    want = jmueller(jbsdfs.eval_(jmat, jmi, jsi, jnp.asarray(wo), ctx, JPOL),
                    N, 3)
    mueller_close(got, want)


@pytest.mark.parametrize("box_material", ["diffuse", "conductor",
                                          "roughconductor", "dielectric",
                                          "grating"])
def test_wbsdf_weight_polarized_matches_jax(box_material):
    """The PLT replay weight under a polarized config: the depolarized
    albedo, the conductor's Mueller, the dielectric's reflection or
    transmission replayed from wo's side divided by F or 1 - F, eval /
    pdf else (0 on the grating rows)."""
    jscene, tscene = _scenes(box_material)
    rng = np.random.default_rng(30)
    jsi, tsi, midx = _lanes(rng, N)
    wo = _dirs(rng, N)
    wl = rng.uniform(360, 680, (N, 3)).astype(np.float32)
    jsd = jwb.PLTSamplePhaseData(
        bs=None, lobe=jnp.zeros((N, 2), jnp.int32),
        internal_frame=jnp.zeros((N, 3)),
        coherence=jcoh.Coherence.isotropic(jnp.zeros((N,)), jnp.zeros((N,))),
        sampling_wavelengths=jnp.asarray(wl))
    tsd = twb.PLTSamplePhaseData(bs=None,
                                 lobe=torch.zeros((N, 2), dtype=torch.int32),
                                 sampling_wavelengths=torch.as_tensor(wl))
    want = jmueller(jwb.wbsdf_weight(
        jscene.materials, jnp.asarray(midx), jsi, jnp.asarray(wo), jsd,
        BSDFContext(), JPOL), N, 3)
    got = lanes_of(twb.wbsdf_weight(
        tscene.materials, torch.as_tensor(midx).long(), tsi,
        torch.as_tensor(wo), tsd, pol=True))
    mueller_close(got, want)
    unpol = twb.wbsdf_weight(tscene.materials, torch.as_tensor(midx).long(),
                             tsi, torch.as_tensor(wo), tsd).numpy()
    if box_material != "dielectric":
        np.testing.assert_allclose(got[..., 0, 0], unpol, rtol=2e-4,
                                   atol=1e-6)


def test_wbsdf_grating_polarized_matches_jax(lanes):  # noqa: F811
    """The grating's wave sample and eval under a polarized config on
    test_torch_plt's lanes: the scalar lobe sum and sample chain (B3, B4's
    plain versions) times the conductor's Mueller at the microfacet normal
    (sample) or the half vector (eval), where both picked the same lobe."""
    L = lanes
    ctx = BSDFContext()
    mats_j, mats_t = L["jscene"].materials, L["tscene"].materials
    jm, tmi = jnp.asarray(L["midx"]), torch.as_tensor(L["midx"]).long()
    jsd, jw, jok = jwb.wbsdf_sample(
        mats_j, jm, L["jsi"], jnp.zeros(N), jnp.asarray(L["u2"]),
        jnp.asarray(L["lobe_u2"]), ctx, JPOL, jnp.asarray(L["wl"]))
    tsd, tw, tok = twb.wbsdf_sample(
        mats_t, tmi, L["tsi"], None, torch.as_tensor(L["u2"]),
        torch.as_tensor(L["lobe_u2"]), torch.as_tensor(L["wl"]), pol=True)
    tw = tmu.to_lanes(tw)
    n = tw.shape[0]
    same = ((tok.numpy() == np.asarray(jok))
            & (tsd.lobe.numpy() == np.asarray(jsd.lobe)).all(-1))
    assert same.mean() >= 0.999
    # rtol 2e-3 of the unpolarized sample weight (test_torch_plt)
    mueller_close(tw.numpy(), jmueller(jw, n, 3), rel=2e-3, mask=same)
    lobe = np.zeros((n, 2), np.int32)
    je = jmueller(jwb.wbsdf_eval(mats_j, jm, L["jsi"], jnp.asarray(L["wo"]),
                                 _jax_sd(L, jnp.asarray(lobe)), ctx, JPOL),
                  n, 3)
    te = lanes_of(twb.wbsdf_eval(mats_t, tmi, L["tsi"],
                                 torch.as_tensor(L["wo"]),
                                 _torch_sd(L, torch.as_tensor(lobe)),
                                 pol=True))
    # rtol 1e-3: the unpolarized lobe sum's (test_torch_plt)
    mueller_close(te, je, rel=1e-3)
    grating = L["midx"] == 1
    assert (np.abs(te[grating][..., 0, 0]) > 0).any()
    assert (np.abs(te[grating][..., 2, 3]) > 0).any()  # a phase


def test_coherence_and_beam_match_jax():
    """Coherence (rmm, propagate, the inverse matrix and its determinant,
    transform), GeneralizedRadiance, both mutual coherences, the beam's
    sources, propagation and frame turn, and the PLT integrator's
    source_beam, measure and measured_beam."""
    rng = np.random.default_rng(31)
    n = 512
    d = rng.uniform(1e-9, 1e-3, n).astype(np.float32)
    o = rng.uniform(0, 2, n).astype(np.float32)
    k = rng.uniform(8, 17, (n, 3)).astype(np.float32)
    U = rng.normal(size=(n, 2, 2)).astype(np.float32)
    mask = rng.random(n) < 0.5
    jc = jcoh.Coherence.isotropic(d, o)
    tc = tcoh.Coherence.isotropic(T(d), T(o))
    pairs = [
        (tc.rmm(), jc.rmm()),
        (tc.propagate(T(o), T(mask)).opl, jc.propagate(o, mask).opl),
        (tc.inv_coherence_matrix(T(k)), jc.inv_coherence_matrix(k)),
        (tc.inv_coherence_det(T(k)), jc.inv_coherence_det(k)),
        (tc.transform(T(U), T(mask)).dmat, jc.transform(U, mask).dmat),
    ]
    dxy = rng.normal(scale=1e-3, size=(n, 2)).astype(np.float32)
    d1, d2 = _dirs(rng, n), _dirs(rng, n)
    pairs += [
        (tcoh.mutual_coherence(tc, T(dxy), T(k[:, 0])),
         jcoh.mutual_coherence(jc, dxy, k[:, 0])),
        (tcoh.mutual_coherence_angular(tc, T(d1), T(d2)),
         jcoh.mutual_coherence_angular(jc, d1, d2)),
    ]
    S = rng.normal(size=(n, 4, 3)).astype(np.float32)
    gt = tcoh.GeneralizedRadiance.from_stokes(T(S), tc)
    gj = jcoh.GeneralizedRadiance.from_stokes(S, jc)
    pairs += [(gt.stokes(), gj.stokes()),
              (tcoh.GeneralizedRadiance.from_value(T(S[:, 0])).coherence.dmat,
               jcoh.GeneralizedRadiance.from_value(S[:, 0]).coherence.dmat)]

    Le = rng.uniform(0, 5, (n, 3)).astype(np.float32)
    p = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    dist = rng.uniform(0.1, 5, n).astype(np.float32)
    bt = [tbeam.PLTBeam.source_distant(T(d1), T(d), T(Le), 1e-7),
          tbeam.PLTBeam.source_area(T(p), T(d1), T(d), T(dist), T(Le), 1e-7)]
    bj = [jbeam.PLTBeam.source_distant(d1, d, Le, 1e-7),
          jbeam.PLTBeam.source_area(p, d1, d, dist, Le, 1e-7)]
    sensor_p = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    for t_, j_ in zip(bt, bj):
        t_ = t_.propagate(T(sensor_p)).rotate_frame(T(d2))
        j_ = j_.propagate(sensor_p).rotate_frame(d2)
        for f in ("sp", "origin", "dir", "tangent", "distant", "active"):
            pairs.append((getattr(t_, f), getattr(j_, f)))
        pairs += [(t_.coherence.dmat, j_.coherence.dmat),
                  (t_.coherence.opl, j_.coherence.opl),
                  (t_.mutual_coherence(T(k[:, 0]), T(d1 - d2)),
                   j_.mutual_coherence(k[:, 0], d1 - d2)),
                  (t_.mutual_coherence_angular(T(d1), T(d2)),
                   j_.mutual_coherence_angular(d1, d2))]
    for i, (g, w) in enumerate(pairs):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                   rtol=2e-5, atol=1e-6, err_msg=str(i))

    # the integrator's beam: an area light's and the constant emitter's
    from mitsuba3_plt_tpu.scene import presets as jpresets
    from mitsuba3_plt_tpu_torch.scene import presets as tpresets

    for jscene, tscene, e_idx in (
            (jpresets.cornell_box(8, 8)[0],
             tpresets.cornell_box(8, 8, device="cpu"), 0),
            (jpresets.grating_scene(8, 8)[0],
             tpresets.grating_scene(8, 8, device="cpu"), 1)):
        ei = np.full(n, e_idx, np.int32)
        jb = dataclasses.make_dataclass("B", ["p", "emitter_idx"])(
            jnp.asarray(p), jnp.asarray(ei))
        tb = dataclasses.make_dataclass("B", ["p", "emitter_idx"])(
            T(p), T(ei).long())
        jbm = JPLT().source_beam(jscene.emitters, jb, jnp.asarray(d1),
                                 jnp.asarray(dist), jnp.asarray(Le))
        tbm = PLTIntegrator().source_beam(tscene.emitters, tb, T(d1),
                                          T(dist), T(Le))
        Li = T(S)
        assert PLTIntegrator().measure(tbm, T(sensor_p), Li) is Li
        jmb = JPLT().measured_beam(jbm, sensor_p, jscene.sensor)
        tmb = PLTIntegrator().measured_beam(tbm, T(sensor_p), tscene.sensor)
        for f in ("sp", "origin", "dir", "tangent", "distant"):
            np.testing.assert_allclose(
                getattr(tmb, f).numpy().astype(np.float64),
                np.asarray(getattr(jmb, f)).astype(np.float64), rtol=2e-5,
                atol=1e-6, err_msg=f)
        for f in ("dmat", "opl"):
            np.testing.assert_allclose(
                getattr(tmb.coherence, f).numpy(),
                np.asarray(getattr(jmb.coherence, f)), rtol=2e-5, atol=1e-9)
        assert bool(tmb.distant.all()) == (e_idx == 1)


def test_render_modes():
    assert config.variant("rgb") is config.RGB
    assert config.variant("rgb_polarized").polarized
    assert config.RGB_POLARIZED.name == "rgb_polarized"
    assert config.RGB.name == "rgb" and config.RGB_POLARIZED.n_channels == 3
    assert set(config.VARIANTS) == {"rgb", "rgb_polarized"}
    for name in ("spectral", "spectral_polarized", "mono", "mono_polarized"):
        with pytest.raises(NotImplementedError):
            config.variant(name)
    with pytest.raises(KeyError):
        config.variant("cmyk")
