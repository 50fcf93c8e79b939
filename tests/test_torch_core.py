"""Core math, frames, warps, colour, microfacet and Fresnel of the port
against the JAX package on identical numpy inputs (CPU)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mitsuba3_plt_tpu.core import frame as jfr
from mitsuba3_plt_tpu.core import math as jm
from mitsuba3_plt_tpu.core import spectrum as jspec
from mitsuba3_plt_tpu.core import warp as jwarp
from mitsuba3_plt_tpu.integrators.common import mis_weight as j_mis
from mitsuba3_plt_tpu.librender import fresnel as jfres
from mitsuba3_plt_tpu.librender import microfacet as jmf
from mitsuba3_plt_tpu.plt.coherence import Coherence as JCoherence
from mitsuba3_plt_tpu_torch.core import frame as tfr
from mitsuba3_plt_tpu_torch.core import math as tm
from mitsuba3_plt_tpu_torch.core import spectrum as tspec
from mitsuba3_plt_tpu_torch.core import warp as twarp
from mitsuba3_plt_tpu_torch.integrators.common import mis_weight as t_mis
from mitsuba3_plt_tpu_torch.librender import fresnel as tfres
from mitsuba3_plt_tpu_torch.librender import microfacet as tmf
from mitsuba3_plt_tpu_torch.plt.coherence import Coherence as TCoherence

N = 4096


def _pair(x):
    x = np.asarray(x, np.float32)
    return jnp.asarray(x), torch.as_tensor(x)


def _dirs(rng, n, upper=False):
    v = rng.normal(size=(n, 3))
    if upper:
        v[:, 2] = np.abs(v[:, 2]) + 0.05
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("n_max", [0, 3, 4])
def test_bessel_jn_fast(n_max):
    rng = np.random.default_rng(n_max)
    # below, across and beyond the asymptotic switch, plus exact zero
    x = np.concatenate([rng.uniform(0, 2, 1000), rng.uniform(2, 40, 2000),
                        rng.uniform(40, 200, 500), [0.0, 1e-7, -3.5]])
    jx, tx = _pair(x)
    got = tm.bessel_jn_fast(tx, n_max).numpy()
    want = np.asarray(jm.bessel_jn_fast(jx, n_max))
    asym = np.abs(x) > 32.0
    _close(got[~asym], want[~asym], rtol=1e-4, atol=1e-6)
    # Hankel branch: float32 cos/sin of arguments up to 200 rad differ
    # between the two libraries by up to ~1e-6 after argument reduction
    _close(got[asym], want[asym], rtol=1e-4, atol=5e-6)


def test_unit_angle_dot_and_sinc():
    rng = np.random.default_rng(1)
    d = np.concatenate([rng.uniform(-1, 1, N), [-1.0, 1.0, 0.0, 0.9999999]])
    jd, td = _pair(d)
    _close(tm.unit_angle_dot(td).numpy(), jm.unit_angle_dot(jd))
    x = np.concatenate([rng.uniform(-20, 20, N), [0.0, 1e-9]])
    jx, tx = _pair(x)
    _close(tm.sinc(tx).numpy(), jm.sinc(jx))
    _close(tm.safe_sqrt(tx).numpy(), jm.safe_sqrt(jx))


def test_frame():
    rng = np.random.default_rng(2)
    n = _dirs(rng, N)
    n[:2] = [[0, 0, 1], [0, 0, -1]]
    jn, tn = _pair(n)
    js, jt = jfr.coordinate_system(jn)
    ts, tt = tfr.coordinate_system(tn)
    _close(ts.numpy(), js)
    _close(tt.numpy(), jt)
    v = _dirs(rng, N)
    jv, tv = _pair(v)
    _close(tfr.reflect_n(tv, tn).numpy(), jfr.reflect_n(jv, jn))
    _close(tfr.normalize(tv * 3.0).numpy(), jfr.normalize(jv * 3.0))


def test_warps():
    rng = np.random.default_rng(3)
    u = rng.uniform(0, 1, (N, 2))
    u[:3] = [[0.5, 0.5], [0.0, 0.0], [1.0, 0.25]]
    ju, tu = _pair(u)
    # atol 1e-5: z = sqrt(1 - x^2 - y^2) near the rim amplifies the ulp
    # differences between the two libraries' sin and cos
    w = twarp.square_to_cosine_hemisphere(tu)
    _close(w.numpy(), jwarp.square_to_cosine_hemisphere(ju), atol=1e-5)
    _close(twarp.square_to_cosine_hemisphere_pdf(w).numpy(),
           jwarp.square_to_cosine_hemisphere_pdf(jnp.asarray(w.numpy())))
    _close(twarp.square_to_uniform_sphere(tu).numpy(),
           jwarp.square_to_uniform_sphere(ju), atol=1e-5)


def test_cie_and_srgb():
    rng = np.random.default_rng(4)
    wl = np.concatenate([rng.uniform(350, 840, (N, 3)).ravel(),
                         [360.0, 830.0, 359.0, 831.0]])
    jw, tw = _pair(wl.reshape(-1, 1))
    jx = jspec.cie1931_xyz(jw)
    tx = tspec.cie1931_xyz(tw)
    _close(tx.numpy(), jx)
    _close(tspec.xyz_to_srgb(tx).numpy(), jspec.xyz_to_srgb(jx))


@pytest.mark.parametrize("ndf", [jmf.GGX, jmf.BECKMANN])
def test_microfacet(ndf):
    rng = np.random.default_rng(10 + ndf)
    wi = _dirs(rng, N, upper=True)
    mvec = _dirs(rng, N, upper=True)
    au = rng.uniform(0.03, 0.5, N).astype(np.float32)
    av = rng.uniform(0.03, 0.5, N).astype(np.float32)
    u = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    (jwi, twi), (jm_, tm_) = _pair(wi), _pair(mvec)
    (jau, tau), (jav, tav), (ju, tu) = _pair(au), _pair(av), _pair(u)
    _close(tmf.ndf_eval(tm_, tau, tav, ndf).numpy(),
           jmf.ndf_eval(jm_, jau, jav, ndf), rtol=1e-5, atol=1e-5)
    _close(tmf.smith_g1(twi, tm_, tau, tav, ndf).numpy(),
           jmf.smith_g1(jwi, jm_, jau, jav, ndf))
    _close(tmf.pdf_vndf(twi, tm_, tau, tav, ndf).numpy(),
           jmf.pdf_vndf(jwi, jm_, jau, jav, ndf), rtol=1e-5, atol=1e-5)
    tm2, tp = tmf.sample_vndf(twi, tu, tau, tav, ndf)
    jm2, jp = jmf.sample_vndf(jwi, ju, jau, jav, ndf)
    _close(tm2.numpy(), jm2, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.minimum(tp.numpy(), 1e6),
                               np.minimum(np.asarray(jp), 1e6),
                               rtol=2e-3, atol=1e-5)


def test_fresnel_conductor():
    rng = np.random.default_rng(5)
    ct = np.concatenate([rng.uniform(-1, 1, N), [0.0, 1.0, -1.0]])
    eta = rng.uniform(0.1, 3.0, (ct.size, 3)).astype(np.float32)
    k = rng.uniform(0.0, 5.0, (ct.size, 3)).astype(np.float32)
    (jct, tct), (je, te), (jk, tk) = _pair(ct[:, None]), _pair(eta), _pair(k)
    _close(tfres.fresnel_conductor(tct, te, tk).numpy(),
           jfres.fresnel_conductor(jct, je, jk))


def test_coherence_and_mis():
    rng = np.random.default_rng(6)
    d = rng.uniform(0.5, 1e3, N).astype(np.float32)
    opl = rng.uniform(0.0, 2.0, N).astype(np.float32)
    k = rng.uniform(8.0, 18.0, (N, 3)).astype(np.float32)
    (jd, td), (jo, to), (jk, tk) = _pair(d), _pair(opl), _pair(k)
    _close(TCoherence.isotropic(td, to).inv_coherence_det(tk).numpy(),
           JCoherence.isotropic(jd, jo).inv_coherence_det(jk), rtol=1e-5)
    a = np.concatenate([rng.uniform(0, 10, N), [0.0, np.inf, 1e30]])
    b = np.concatenate([rng.uniform(0, 10, N), [1.0, 1.0, np.nan]])
    (ja, ta), (jb, tb) = _pair(a), _pair(b)
    _close(t_mis(ta, tb).numpy(), j_mis(ja, jb))
