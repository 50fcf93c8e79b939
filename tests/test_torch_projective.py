"""The port's silhouette boundary gradients (`ad/projective.py`) against
the JAX package on the CPU, on `tests/test_projective.py`'s scenes at
48x48 (`presets.boundary_scene_dict`) loaded by both packages'
`load_dict` from the same dicts.

- `build_edges` equals JAX's arrays to the bit (and on a soup with a
  degenerate and a three-face edge), `_project_px` within 1e-6 relative.
- Each estimator at 4,096 samples and the same key gives cotangents
  within 1e-3 of the largest entry of JAX's. Sample by sample, the
  recorded cotangents agree but on lanes whose pixel differs by rounding:
  a shadow or silhouette projected onto a pixel border reads one pixel's
  loss weight in one package and its neighbour's in the other. Those
  lanes are named, and with JAX's values on them the sums agree.
- `render_loss_grad(..., geometry_boundary=True)` equals JAX's at the
  same seed; without the boundary the vertex rows' gradient is zero.

A scene without an area light and `test_projective.py`'s
finite-difference checks are in `test_torch_projective_fd.py`.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mitsuba3_plt_tpu as mi
from mitsuba3_plt_tpu.ad import projective as jp
from mitsuba3_plt_tpu.ad import render as jrender
from mitsuba3_plt_tpu.integrators import make_integrator as jmake
from mitsuba3_plt_tpu.scene.presets import cornell_box as jcornell_box
import mitsuba3_plt_tpu_torch as tmi
from mitsuba3_plt_tpu_torch import ad
from mitsuba3_plt_tpu_torch.ad import projective as tp
from mitsuba3_plt_tpu_torch.integrators import make_integrator as tmake
from mitsuba3_plt_tpu_torch.scene.presets import (BOUNDARY_SCENES,
                                                  boundary_scene_dict,
                                                  cornell_box)
from test_torch_golden_specular import one_torch_thread  # noqa: F401

W = H = 48
WMAP = np.tile((np.arange(W, dtype=np.float32) / W)[None, :, None],
               (H, 1, 3))
KEYS = ["geo.tri_p0", "geo.tri_p1", "geo.tri_p2"]
N = 1 << 12


SCENES = {name: (lambda delta=0.0, name=name: boundary_scene_dict(
    name, W, H, delta)) for name in BOUNDARY_SCENES}


def both(name, delta=0.0):
    """(JAX scene, port scene, JAX integrator, port integrator)."""
    d = SCENES[name](delta)
    js, jmeta = mi.load_dict(d)
    ts, tmeta = tmi.load_dict(d, device="cpu")
    return (js, ts, jmake(jmeta["integrator"]),
            tmake(tmeta["integrator"]))


def loss(img):
    return (img * torch.as_tensor(WMAP)).sum()


# ---------------------------------------------------------------------------
# edges and projection
# ---------------------------------------------------------------------------

class Soup:
    def __init__(self, p0, p1, p2):
        self.tri_p0, self.tri_p1, self.tri_p2 = p0, p1, p2


@pytest.mark.parametrize("name", list(SCENES) + ["cbox"])
def test_build_edges_equals_jax(name):
    if name == "cbox":
        jgeo = jcornell_box(16, 16)[0].geo
        tgeo = cornell_box(16, 16, device="cpu").geo
    else:
        jgeo = mi.load_dict(SCENES[name]())[0].geo
        tgeo = tmi.load_dict(SCENES[name](), device="cpu")[0].geo
    want, got = jp.build_edges(jgeo), tp.build_edges(tgeo)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (want["f2"] >= 0).any()


def test_build_edges_degenerate_and_shared_edges_equal_jax():
    """A soup with a degenerate face, a three-face edge, duplicated rows
    and coordinates within the 1e-5 quantum: the same arrays."""
    rng = np.random.default_rng(5)
    v = rng.normal(size=(12, 3)).astype(np.float32)
    v[7] = v[3] + 2e-6          # quantizes with vertex 3
    faces = np.array([[0, 1, 2], [1, 0, 3], [0, 1, 4], [2, 2, 5],
                      [5, 6, 7], [7, 6, 8], [9, 10, 11], [0, 1, 2],
                      [6, 5, 3]])
    p = [v[faces[:, c]] for c in range(3)]
    want = jp.build_edges(Soup(*p))
    got = tp.build_edges(Soup(*(torch.as_tensor(x) for x in p)))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(want["f1"]) < 3 * len(faces)


def test_project_px_equals_jax():
    js, ts, _, _ = both("shadow")
    rng = np.random.default_rng(0)
    x = rng.uniform(-3.0, 3.0, (4096, 3)).astype(np.float32)
    jpx, jz = jp._project_px(js.sensor, jnp.asarray(x))
    tpx, tz = tp._project_px(ts.sensor, torch.as_tensor(x))
    np.testing.assert_allclose(tpx.numpy(), np.asarray(jpx), rtol=1e-6,
                               atol=1e-6 * np.abs(np.asarray(jpx)).max())
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the estimators against JAX's, sample by sample
# ---------------------------------------------------------------------------

def run_jax(monkeypatch, fn):
    """fn() of the JAX package under `jax.jit` (the scene a constant: one
    compiled program instead of hundreds of op-by-op ones), and each
    estimator call's per-sample pixel position, slots and cotangents,
    returned from the trace: its first `_project_px` of three on [N, 3]
    rows (the sample's pixel, then the edge's ends or the shadow curve's
    two points; the per-sample gradients project single rows) and its
    `jnp.concatenate` of the slots and of the cotangents."""
    calls = {"px": [], "slots": [], "cots": []}
    real_cat, real_proj = jnp.concatenate, jp._project_px

    class Jnp:
        def __getattr__(self, name):
            return getattr(jnp, name)

        @staticmethod
        def concatenate(xs, axis=0):
            out = real_cat(xs, axis=axis)
            if out.ndim == 1 and jnp.issubdtype(out.dtype, jnp.integer):
                calls["slots"].append(out)
            elif out.ndim == 2 and out.shape[1] == 3:
                calls["cots"].append(out)
            return out

    def project(sensor, x):
        out = real_proj(sensor, x)
        if out[0].ndim == 2:
            calls["px"].append(out[0])
        return out

    monkeypatch.setattr(jp, "jnp", Jnp())
    monkeypatch.setattr(jp, "_project_px", project)

    def traced():
        return fn(), {k: v[:] for k, v in calls.items()}

    out, rec = jax.jit(traced)()
    rec["px"] = rec["px"][0::3]
    return out, {k: [np.asarray(x) for x in v] for k, v in rec.items()}


def record_port(monkeypatch):
    """The same of each port estimator call, from `_pixel_weight` and
    `_scatter`."""
    calls = {"px": [], "slots": [], "cots": []}
    real_w, real_scatter = tp._pixel_weight, tp._scatter

    def pixel_weight(sensor, grad_image, px):
        calls["px"].append(px.numpy().copy())
        return real_w(sensor, grad_image, px)

    def scatter(scene, ed, e_idx, cot_a, cot_b):
        calls["slots"].append(torch.cat([
            ed["a_face"][e_idx] * 3 + ed["a_corner"][e_idx],
            ed["b_face"][e_idx] * 3 + ed["b_corner"][e_idx]]).numpy())
        calls["cots"].append(torch.cat([cot_a, cot_b]).numpy())
        return real_scatter(scene, ed, e_idx, cot_a, cot_b)

    monkeypatch.setattr(tp, "_pixel_weight", pixel_weight)
    monkeypatch.setattr(tp, "_scatter", scatter)
    return calls


def pixel_of(px):
    return np.clip(px.astype(np.int32), 0, [W - 1, H - 1])


def tie_lanes(jcalls, tcalls):
    """Per call, the samples whose cotangents differ beyond rounding
    (rtol 1e-3 of the row plus 1e-5 of the call's largest), each required
    to be a pixel tie: its pixel index differs between the packages.
    Returns [(call, lanes)]; the edges drawn must be the same."""
    assert len(jcalls["cots"]) == len(tcalls["cots"]) > 0
    out = []
    for i, (js, ts, jc, tc, jx, tx) in enumerate(zip(
            jcalls["slots"], tcalls["slots"], jcalls["cots"],
            tcalls["cots"], jcalls["px"], tcalls["px"])):
        np.testing.assert_array_equal(ts, js)
        n = len(jx)
        np.testing.assert_allclose(tx, jx, rtol=1e-5, atol=1e-3)
        tie = (pixel_of(jx) != pixel_of(tx)).any(-1)
        err = np.abs(tc - jc).max(-1)
        tol = 1e-3 * np.abs(jc).max(-1) + 1e-5 * np.abs(jc).max()
        bad = np.flatnonzero(err > tol)
        bad = np.unique(bad % n)
        assert tie[bad].all(), (i, bad[~tie[bad]])
        out.append((i, bad))
    return out


def hold_to_jax(jcots, tcots, jcalls, tcalls, rows=slice(None)):
    """The port's cotangents within 1e-3 of the largest of JAX's; where
    pixel ties make them differ, named, and with JAX's samples on the
    tie lanes the sums agree."""
    ties = tie_lanes(jcalls, tcalls)
    F = tcots[KEYS[0]].shape[0]
    swap = np.zeros((3 * F, 3))
    for i, lanes in ties:
        n = len(tcalls["px"][i])
        idx = np.r_[lanes, lanes + n]
        np.add.at(swap, jcalls["slots"][i][idx],
                  jcalls["cots"][i][idx] - tcalls["cots"][i][idx])
    named = {i: lanes.tolist() for i, lanes in ties if len(lanes)}
    print("pixel-tie lanes by call:", named)
    want = np.stack([np.asarray(jcots[k]) for k in KEYS], 1)[rows]
    got = np.stack([tcots[k].numpy() for k in KEYS], 1)[rows]
    fixed = got + swap.reshape(F, 3, 3)[rows]
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(fixed, want, rtol=0, atol=1e-3 * scale)
    if not named:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * scale)
    return named


@pytest.mark.parametrize("name", ["rectangle", "cube"])
def test_primary_boundary_grad_matches_jax(name, monkeypatch):
    """The rectangle's edges are open, the cube's shared by two faces."""
    js, ts, ji, ti = both(name)
    tcalls = record_port(monkeypatch)
    want, jcalls = run_jax(monkeypatch, lambda: jp.primary_boundary_grad(
        js, ji.sample, jnp.asarray(WMAP), key=3, n_samples=N,
        cfg=mi.config()))
    got = tp.primary_boundary_grad(ts, ti.sample, torch.as_tensor(WMAP),
                                   key=3, n_samples=N)
    hold_to_jax(want, got, jcalls, tcalls)


def test_nee_boundary_grad_matches_jax(monkeypatch):
    """The blocker's left edge casts its shadow onto the border of pixel
    columns 23 and 24: those lanes are pixel ties."""
    js, ts, ji, ti = both("shadow")
    tcalls = record_port(monkeypatch)
    want, jcalls = run_jax(monkeypatch, lambda: jp.nee_boundary_grad(
        js, ji.sample, jnp.asarray(WMAP), key=3, n_samples=N,
        cfg=mi.config()))
    got = tp.nee_boundary_grad(ts, ti.sample, torch.as_tensor(WMAP), key=3,
                               n_samples=N)
    hold_to_jax(want, got, jcalls, tcalls)


def test_area_nee_boundary_grad_matches_jax(monkeypatch):
    """The guided estimator: its pilot pass (1,024 samples, the edge
    masses) and its second (3,072, edges drawn by those masses)."""
    js, ts, _, _ = both("penumbra")
    tcalls = record_port(monkeypatch)
    want, jcalls = run_jax(monkeypatch, lambda: (
        jp.area_nee_boundary_grad_guided(js, jnp.asarray(WMAP), key=3,
                                         n_samples=N, cfg=mi.config()),
        jp.area_nee_boundary_grad(js, jnp.asarray(WMAP), key=3,
                                  n_samples=N // 4, cfg=mi.config(),
                                  return_edge_mass=True)[1]))
    want, mass_j = want
    # the mass call's records are the pilot's again
    jcalls = {k: v[:2] for k, v in jcalls.items()}
    got = tp.area_nee_boundary_grad_guided(ts, torch.as_tensor(WMAP), key=3,
                                           n_samples=N)
    assert [len(x) for x in tcalls["px"]] == [N // 4, N - N // 4]
    hold_to_jax(want, got, jcalls, tcalls)
    _, mass_t = tp.area_nee_boundary_grad(
        ts, torch.as_tensor(WMAP), key=3, n_samples=N // 4,
        return_edge_mass=True)
    mass_j = np.asarray(mass_j)
    np.testing.assert_allclose(mass_t.numpy(), mass_j, rtol=0,
                               atol=1e-3 * mass_j.max())


def test_render_loss_grad_boundary_matches_jax(monkeypatch):
    """The whole pipeline on the penumbra scene: the interior term (zero
    on the vertex rows: the render reads the tables, which are not rebuilt
    from the rows; JAX's total holds its own to zero too) plus the camera
    and penumbra terms, same seed (no point light: the shadow term is
    zero)."""
    js, ts, ji, ti = both("penumbra")
    kw = dict(seed=5, spp=2, boundary_samples=N)
    _, interior = ad.render_loss_grad(ts, ti.sample, loss, KEYS, seed=5,
                                      spp=2)
    for k in KEYS:
        assert not interior[k].any(), k
    tcalls = record_port(monkeypatch)
    (jl, want), jcalls = run_jax(monkeypatch, lambda: jrender.render_loss_grad(
        js, ji.sample, lambda im: jnp.sum(im * WMAP), KEYS,
        cfg=mi.config(), geometry_boundary=True, **kw))
    tl, got = ad.render_loss_grad(ts, ti.sample, loss, KEYS,
                                  geometry_boundary=True, **kw)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    hold_to_jax(want, got, jcalls, tcalls)
