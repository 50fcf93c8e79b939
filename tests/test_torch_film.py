"""The port's film against the JAX package's: the six reconstruction
filters, the scatter `put` (box and filtered), the ordered filtered splat
on 3 channels and on 15 as the Stokes film's, and the two other layouts
that `chip_smoke.py` times beside it, `merge`, the
ordered splat against the port's own scatter (the JAX package's
`tests/test_film.py`), the magnitude splat (`abs_weights`) that bounds the
sum's rounding, and `render(rfilter=)` of the Cornell box against JAX's
render, pixel by pixel."""
import importlib.util
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mitsuba3_plt_tpu.config import RGB as JRGB
from mitsuba3_plt_tpu.integrators.common import render as j_render
from mitsuba3_plt_tpu.integrators.path import PathIntegrator as JPath
from mitsuba3_plt_tpu.librender import film as jfilm
from mitsuba3_plt_tpu.scene import presets as jpresets
from mitsuba3_plt_tpu_torch.integrators.common import render
from mitsuba3_plt_tpu_torch.integrators.path import PathIntegrator
from mitsuba3_plt_tpu_torch.librender import film as tfilm
from mitsuba3_plt_tpu_torch.scene import presets as tpresets
from test_torch_golden_specular import one_torch_thread  # noqa: F401

FILTERS = sorted(tfilm.FILTER_NAMES.items(), key=lambda kv: kv[1])


def test_filter_tables_match_jax():
    assert tfilm.FILTER_NAMES == jfilm.FILTER_NAMES
    assert tfilm.FILTER_RADIUS == jfilm.FILTER_RADIUS


@pytest.mark.parametrize("name,fid", FILTERS)
def test_filter_eval_matches_jax(name, fid):
    """On offsets across and past each filter's support, the knots and
    zero included: to 1 ulp (the gaussian's exp and lanczos' sin are each
    library's own)."""
    x = np.concatenate([np.linspace(-3.5, 3.5, 7001),
                        [0.0, -0.0, 0.5, -0.5, 1.0, 2.0, 3.0, 1e-7, -1e-7]]
                       ).astype(np.float32)
    want = np.asarray(jfilm.filter_eval(fid, jnp.asarray(x)))
    got = tfilm.filter_eval(fid, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=1e-7,
                               err_msg=name)
    assert (got[np.abs(x) >= tfilm.FILTER_RADIUS[fid]] == 0).all() or \
        fid == tfilm.FILTER_BOX
    with pytest.raises(ValueError):
        tfilm.filter_id("blackman")


def _samples(w, h, spp, C, seed=0, lit_edges=True):
    """Pixel-ordered film positions, values and active mask (a tenth of
    the lanes off, a few non-finite values); the border pixels carry the
    largest values, so a tap that lands on the wrong side shows."""
    rng = np.random.default_rng(seed)
    n = w * h * spp
    lane = np.arange(n) // spp
    jit2 = rng.random((n, 2))
    uv = np.stack([(lane % w + jit2[:, 0]) / w,
                   (lane // w + jit2[:, 1]) / h], -1).astype(np.float32)
    vals = rng.random((n, C)).astype(np.float32)
    if lit_edges:
        x, y = lane % w, lane // w
        edge = (x == 0) | (y == 0) | (x == w - 1) | (y == h - 1)
        vals[edge] *= 20.0
    vals[5, 0] = np.nan
    vals[17, -1] = np.inf
    act = rng.random(n) > 0.1
    return uv, vals, act


def _pair(uv, vals, act):
    return ((jnp.asarray(uv), jnp.asarray(vals), jnp.asarray(act)),
            (torch.as_tensor(uv), torch.as_tensor(vals),
             torch.as_tensor(act)))


@pytest.mark.parametrize("name,fid", FILTERS)
@pytest.mark.parametrize("C", [3, 15])
def test_splats_match_jax(name, fid, C):
    """put, put_ordered_filtered and merge at rtol 1e-5 (sums in another
    order), on 3 channels and on 15 (the JAX package's plain layout for
    wide films), and the ordered splat equal to the port's scatter over
    the whole image, borders included."""
    w, h, spp = 11, 9, 4
    uv, vals, act = _samples(w, h, spp, C, seed=fid)
    (ju, jv, ja), (tu, tv, ta) = _pair(uv, vals, act)
    jb = jfilm.ImageBlock.create(w, h, C, fid)
    j_put = jb.put(ju, jv, ja)
    t_put = tfilm.ImageBlock.create(w, h, C, "cpu", fid).put(tu, tv, ta)
    np.testing.assert_allclose(t_put.data.numpy(), np.asarray(j_put.data),
                               rtol=1e-5, atol=1e-6, err_msg="put")
    if fid == tfilm.FILTER_BOX:
        j_ord = jb.put_ordered(jv, ja, spp)
        t_ord = tfilm.ImageBlock.create(w, h, C, "cpu").put_ordered(
            tv, ta, spp)
    else:
        j_ord = jb.put_ordered_filtered(ju, jv, ja, spp)
        t_ord = tfilm.ImageBlock.create(w, h, C, "cpu", fid)
        t_ord.put_ordered_filtered(tu, tv, ta, spp)
    np.testing.assert_allclose(t_ord.data.numpy(), np.asarray(j_ord.data),
                               rtol=1e-5, atol=1e-6, err_msg="ordered")
    np.testing.assert_allclose(t_ord.data.numpy(), t_put.data.numpy(),
                               rtol=1e-5, atol=1e-6, err_msg="ordered/put")
    merged = t_ord.merge(t_put)
    np.testing.assert_allclose(
        merged.data.numpy(), np.asarray(j_ord.merge(j_put).data), rtol=1e-5,
        atol=1e-6, err_msg="merge")
    np.testing.assert_allclose(merged.develop().numpy(),
                               np.asarray(j_ord.merge(j_put).develop()),
                               rtol=1e-5, atol=1e-6, err_msg="develop")
    assert merged.data is not t_ord.data


def _chip_smoke():
    """chip_smoke.py as a module: its `splat_other_layout`, the layouts
    it times beside the port's."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ordered_filtered_accumulates_and_both_layouts_agree():
    """Two passes into one block equal the sum of two blocks, and the two
    layouts `chip_smoke.py` times beside the port's
    (`splat_other_layout`: channel-major, and the port's with each tap's
    weights evaluated at the tap) equal it."""
    w, h, spp, C = 8, 6, 3, 4
    uv, vals, act = _samples(w, h, spp, C, seed=9)
    _, (tu, tv, ta) = _pair(uv, vals, act)
    g = tfilm.FILTER_GAUSSIAN
    one = tfilm.ImageBlock.create(w, h, C, "cpu", g)
    one.put_ordered_filtered(tu, tv, ta, spp)
    one.put_ordered_filtered(tu, 2 * tv, ta, spp)
    a = tfilm.ImageBlock.create(w, h, C, "cpu", g).put_ordered_filtered(
        tu, tv, ta, spp)
    b = tfilm.ImageBlock.create(w, h, C, "cpu", g).put_ordered_filtered(
        tu, 2 * tv, ta, spp)
    torch.testing.assert_close(one.data, a.merge(b).data, rtol=1e-6,
                               atol=1e-6)
    smoke = _chip_smoke()
    for layout in smoke.SPLAT_LAYOUTS:
        other = smoke.splat_other_layout(
            tfilm.ImageBlock.create(w, h, C, "cpu", g), tu, tv, ta, spp,
            layout)
        torch.testing.assert_close(other.data, a.data, rtol=1e-5, atol=1e-6,
                                   msg=layout)


@pytest.mark.parametrize("name", ["gaussian", "mitchell", "lanczos"])
def test_abs_weights_splat_bounds_the_sum(name):
    """put_ordered_filtered(abs_weights=True) of |values| is the sum of the
    terms' magnitudes: at least |splat| everywhere, equal to the splat of
    a filter without negative lobes (gaussian), and above it where a
    negative lobe cancels (mitchell, lanczos)."""
    w, h, spp, C = 9, 7, 4, 3
    uv, vals, act = _samples(w, h, spp, C, seed=11)
    _, (tu, tv, ta) = _pair(uv, vals, act)
    fid = tfilm.FILTER_NAMES[name]
    plain = tfilm.ImageBlock.create(w, h, C, "cpu", fid)
    plain.put_ordered_filtered(tu, tv, ta, spp)
    mag = tfilm.ImageBlock.create(w, h, C, "cpu", fid)
    mag.put_ordered_filtered(tu, tv.abs(), ta, spp, abs_weights=True)
    assert bool((mag.data >= plain.data.abs() * (1 - 1e-6)).all())
    if name == "gaussian":
        torch.testing.assert_close(mag.data, plain.data, rtol=1e-6,
                                   atol=0.0)
    else:
        assert bool((mag.data > plain.data.abs() * (1 + 1e-3)).any())


@pytest.mark.parametrize("name", ["gaussian", "mitchell"])
def test_render_filtered_matches_jax(name):
    """render(rfilter=) of cornell_box(16, 16), 8 spp in two passes, pixel
    by pixel against JAX's render of the same seed, at the per-lane
    tolerance of the path tracer's tests (rtol 1e-3 / atol 1e-5): every
    lane of this scene agrees."""
    W = H = 16
    fid = tfilm.FILTER_NAMES[name]
    jscene = jpresets.cornell_box(W, H)[0]
    tscene = tpresets.cornell_box(W, H, device="cpu")
    kw = dict(seed=5, spp=8, spp_per_pass=4)
    want = np.asarray(j_render(jscene, JPath(4, 9).sample, cfg=JRGB,
                               rfilter=fid, **kw))
    got = render(tscene, PathIntegrator(4, 9), rfilter=name, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
    box = render(tscene, PathIntegrator(4, 9), **kw).numpy()
    assert np.abs(got - box).max() > 1e-3  # the filter did something


def test_morton_with_a_filter_raises():
    scene = tpresets.cornell_box(8, 8, device="cpu")
    with pytest.raises(ValueError, match="morton"):
        render(scene, PathIntegrator(2, 9), spp=1, pixel_order="morton",
               rfilter="gaussian")
    with pytest.raises(ValueError, match="filter"):
        render(scene, PathIntegrator(2, 9), spp=1, rfilter="sinc")
