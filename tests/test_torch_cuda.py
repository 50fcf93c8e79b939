"""The port's CUDA kernels against their plain PyTorch versions on a card.

Marked `cuda`: without a card these skip. On a machine with one (which has
no JAX), run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest configures JAX). This file imports no
JAX."""
import functools
import importlib.util
import itertools
import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@functools.cache
def _module(path):
    """The Python file at `path` (from the repository's root) as a
    module."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), path)
    spec = importlib.util.spec_from_file_location(
        os.path.splitext(os.path.basename(path))[0], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smoke():
    """chip_smoke.py as a module: its `q_close`, `q_groups` and `b1_groups`
    hold the sweep's closest hits here as in its kernels phase."""
    return _module("chip_smoke.py")


def _sweep_held(name, got, want, q, rays, rows, nacc, step=1):
    """A closest hit of the sweep (B11a, B11c: B1's row test) on `rays`,
    held as chip_smoke.py holds it: at every step-th lane near its plain
    version `want` on those lanes (`q_close`), and on every lane equal to
    B1 over each of its nacc groups of the table's first `rows` rows to
    the bit (`q_groups`; q: the table and anchor)."""
    smoke = _smoke()
    smoke.q_close(name, [x[::step] for x in got], want, sweep=True)
    smoke.q_groups(name, got, smoke.b1_groups(q, rays, rows, nacc))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _dirs(rng, n):
    v = rng.normal(size=(n, 3))
    v[:, 2] = np.abs(v[:, 2]) + 0.1
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def test_intersect_kernels_match_plain(card):
    from mitsuba3_plt_tpu_torch.core.rng import Sampler
    from mitsuba3_plt_tpu_torch.integrators.common import sample_rays
    from mitsuba3_plt_tpu_torch.ops import intersect as isect
    from mitsuba3_plt_tpu_torch.scene.presets import grating_scene

    scene = grating_scene(64, 48, device=card)
    g = scene.geo
    ray, _ = sample_rays(scene, Sampler.create(0, 64 * 48 * 2, device=card),
                         64, 48, 2)
    args = (g.tri_q, g.tri_anchor, ray.o, ray.d, ray.maxt, g.n_faces)
    got, want = isect.intersect_q(*args), isect.intersect_q_plain(*args)
    torch.cuda.synchronize()
    assert (got[1] == want[1]).float().mean() >= 1 - 1e-3
    same = (got[1] == want[1]) & (want[1] >= 0)
    for a, b in zip(got[::2], want[::2]):
        torch.testing.assert_close(a[same], b[same], rtol=1e-5, atol=1e-5)
    rng = np.random.default_rng(1)
    n = 8192
    o = torch.as_tensor(rng.uniform(-2, 2, (n, 3)).astype(np.float32),
                        device=card)
    d = torch.as_tensor(_dirs(rng, n) * -1.0, device=card)
    mt = torch.as_tensor(rng.uniform(0, 5, n).astype(np.float32), device=card)
    sargs = (g.tri_q, g.tri_anchor, o, d, mt, g.n_faces)
    occ, occ_plain = isect.occluded_q(*sargs), isect.occluded_q_plain(*sargs)
    assert (occ == occ_plain).float().mean() >= 1 - 1e-3


def test_grating_kernels_match_plain(card):
    from mitsuba3_plt_tpu_torch.ops import grating as gops

    rng = np.random.default_rng(2)
    n, f32 = 16384, np.float32
    common = dict(
        grating_dir=np.tile([[1.0, 0.0]], (n, 1)).astype(f32),
        inv_period=np.tile([[0.6, 0.0]], (n, 1)).astype(f32),
        q=rng.uniform(0.02, 0.3, n).astype(f32),
        lobes=rng.choice([3, 5, 7], n).astype(np.int32),
        gtype=np.zeros(n, np.int32), multiplier=np.full(n, 10.0, f32),
    )
    t = lambda x: torch.as_tensor(x, device=card)  # noqa: E731
    lobe_in = {k: t(v) for k, v in dict(
        common, wi=_dirs(rng, n), wo=_dirs(rng, n),
        wl_nm=rng.uniform(380, 680, (n, 3)).astype(f32),
        coherence=rng.uniform(1, 120, n).astype(f32),
        a_cone=rng.uniform(0.05, 0.4, n).astype(f32)).items()}
    got = gops.grating_lobe_sum(**lobe_in, half=3, separable=True,
                                n_channels=3)
    want = gops.grating_lobe_sum_plain(**lobe_in, half=3, separable=True)
    ok = torch.isclose(got, want, rtol=2e-3, atol=2e-5).all(-1)
    assert ok.float().mean() >= 1 - 1e-3

    for ndf in (0, 1):
        s_in = {k: t(v) for k, v in dict(
            common, wi=_dirs(rng, n),
            u2=rng.uniform(0, 1, (n, 2)).astype(f32),
            lobe_u2=rng.uniform(0, 1, (n, 2)).astype(f32),
            wl_um=rng.uniform(0.38, 0.68, n).astype(f32),
            alpha=rng.uniform(0.03, 0.3, (n, 2)).astype(f32)).items()}
        got = gops.grating_sample(**s_in, half=3, ndf=ndf)
        want = gops.grating_sample_plain(**s_in, half=3, ndf=ndf)
        same = (got["lobe"] == want["lobe"]).all(-1) & (got["ok"] == want["ok"])
        assert same.float().mean() >= 1 - 1e-3
        live = same & want["ok"]
        close = torch.isclose(got["wo"][live], want["wo"][live],
                              rtol=1e-4, atol=1e-5).all(-1)
        assert close.float().mean() >= 1 - 1e-3


def test_render_launches_each_kernel_once_per_bounce(card):
    from mitsuba3_plt_tpu_torch import ops
    from mitsuba3_plt_tpu_torch.integrators.common import render
    from mitsuba3_plt_tpu_torch.integrators.plt import PLTIntegrator
    from mitsuba3_plt_tpu_torch.scene.presets import grating_scene

    scene = grating_scene(32, 24, device=card)
    ops.reset_launch_counts()
    img = render(scene, PLTIntegrator(max_depth=4, rr_depth=2), spp=4,
                 spp_per_pass=2)
    torch.cuda.synchronize()
    assert img.device.type == "cuda" and torch.isfinite(img).all()
    assert ops.launch_counts() == {"intersect_q": 8, "occluded_q": 8,
                                   "intersect_clu2": 0, "occluded_clu2": 0,
                                   "intersect_bvh": 0, "occluded_bvh": 0,
                                   "intersect_classic": 0,
                                   "occluded_classic": 0, "intersect_mxu": 0,
                                   "intersect_clu": 0, "occluded_clu": 0,
                                   "intersect_q_variant": 0,
                                   "occluded_q_variant": 0,
                                   "intersect_q_macc": 0, "fma_roof": 0,
                                   "grating_sample": 8, "grating_lobe_sum": 8,
                                   "grating_lobe_sum_bwd": 0,
                                   "grating_lobe_sum_record": 0}


def test_lobe_sum_bwd_kernel_matches_plain(card):
    """B4b, fed the bits of B4's recording launch, against autograd of the
    plain version on chip_smoke.py's four lobe-sum cases and a separable
    half-2 case, at chip_smoke.py's tolerance (`hold_lobe_sum_bwd`), one
    launch a call; the recording instance's sum equals the plain
    instance's to the bit and its bits the plain version's but for
    rounding flips (`hold_record`); a CUDA call without bits raises.
    Through the autograd.Function the forward launches the recording
    instance and the backward B4b, never the plain version."""
    from mitsuba3_plt_tpu_torch import ops
    from mitsuba3_plt_tpu_torch.ops import grating as gops

    smoke = _smoke()
    rng = np.random.default_rng(5)
    for half, sep, gtype, ip_y in ((3, True, 0, 0.0), (3, False, 0, 1.5),
                                   (4, True, 1, 0.0), (2, True, 2, 0.0),
                                   (2, True, 0, 0.0)):
        ins = smoke.lobe_sum_inputs(rng, 20000, gtype, ip_y, card)
        args = [ins[k] for k in gops.LOBE_SUM_INPUTS]
        cot = torch.as_tensor(rng.normal(size=(20000, 3)).astype(np.float32),
                              device=card)
        plain_out = gops.grating_lobe_sum(*args, half=half, separable=sep,
                                          n_channels=3)
        ops.reset_launch_counts()
        sel, _ = smoke.hold_record(str((half, sep, gtype)), args, half, sep,
                                   plain_out)
        with pytest.raises(ValueError, match="sel"):
            gops.grating_lobe_sum_bwd(args, cot, half, sep)
        got = gops.grating_lobe_sum_bwd(args, cot, half, sep, sel)
        torch.cuda.synchronize()
        assert ops.launch_counts()["grating_lobe_sum_record"] == 1
        assert ops.launch_counts()["grating_lobe_sum_bwd"] == 1
        want = gops.grating_lobe_sum_bwd_plain(args, cot, half, sep)
        smoke.explain_lobe_sum_bwd(str((half, sep, gtype)), args, cot,
                                   dict(half=half, separable=sep), sel, got,
                                   want)
        smoke.hold_lobe_sum_bwd(str((half, sep, gtype)), got, want)
        xs = [t.clone().requires_grad_(t.dtype == torch.float32)
              for t in args]
        ops.reset_launch_counts()
        y = gops.grating_lobe_sum(*xs, half=half, separable=sep,
                                  n_channels=3)
        y.backward(cot)
        torch.cuda.synchronize()
        assert ops.launch_counts()["grating_lobe_sum"] == 0
        assert ops.launch_counts()["grating_lobe_sum_record"] == 1
        assert ops.launch_counts()["grating_lobe_sum_bwd"] == 1
        assert torch.equal(y.detach(), plain_out)
        for name, x, g in zip(gops.LOBE_SUM_INPUTS, xs, got):
            if g is not None:
                assert torch.equal(x.grad, g), name
        assert xs[10].grad is None  # a_cone


def test_grad_phases_at_small_size(card):
    """chip_smoke.py's gradient phases on small scenes: the grating's four
    parameters through PLT (finite, non-zero, B1-B4 twice a bounce and
    pass, B4b once, the finite-difference signs) and the Cornell box's
    PRB primal and gradient against the path tracer's, and Adam's falling
    loss."""
    from mitsuba3_plt_tpu_torch.integrators.plt import PLTIntegrator
    from mitsuba3_plt_tpu_torch.scene.presets import cornell_box, grating_scene

    smoke = _smoke()
    launches = smoke.grad_grating(grating_scene(160, 120, device=card),
                                  PLTIntegrator(max_depth=7, rr_depth=50))
    assert launches["grating_lobe_sum_bwd"] > 0
    smoke.grad_cbox(cornell_box(64, 64, device=card))


def test_camera_and_film_phases_at_small_size(card):
    """chip_smoke.py's camera and film phases on a small Cornell box: the
    ordered filtered splat against the scatter (three filters, 3 and 15
    channels), every sampler on every sensor against the CPU's rays, and
    the analytic scene's path (B1, B2 once a bounce)."""
    from mitsuba3_plt_tpu_torch import ops
    from mitsuba3_plt_tpu_torch.integrators.common import render
    from mitsuba3_plt_tpu_torch.integrators.path import PathIntegrator
    from mitsuba3_plt_tpu_torch.scene.presets import (analytic_scene,
                                                      cornell_box)

    smoke = _smoke()
    integ = PathIntegrator(max_depth=3, rr_depth=9)
    smoke.film(cornell_box(64, 64, device=card), integ, 4)
    smoke.cameras()
    scene, meta = analytic_scene(64, 64, device=card)
    ops.reset_launch_counts()
    img = render(scene, integ, spp=4, sampler_type=meta["sampler"])
    launches = ops.launch_counts()
    assert torch.isfinite(img).all() and img.max() > 4.0
    assert launches["intersect_q"] == launches["occluded_q"] == 3


def test_boundary_polarized_and_tf32_phases_at_small_size(card,
                                                         monkeypatch):
    """chip_smoke.py's new gradient phases at a small size: the boundary
    terms on the rectangle at 128x128 (B1, B2; the central difference
    within 0.12), polarized PLT's grating gradient at 160x120 (B1-B3, B4's
    recording instance, B4b; the height within 5e-2 of its central
    difference), the Stokes boxes at 64x64 and the TF32 flags."""
    from mitsuba3_plt_tpu_torch.integrators.plt import PLTIntegrator
    from mitsuba3_plt_tpu_torch.scene.presets import cornell_box, grating_scene

    smoke = _smoke()
    for name, value in (("BOUNDARY_W", 128), ("BOUNDARY_SAMPLES", 1 << 16),
                        ("CBOX_W", 64), ("CBOX_H", 64)):
        monkeypatch.setattr(smoke, name, value)
    smoke.grad_boundary("rectangle", 0.05, 0.12)
    smoke.grad_grating_polarized(grating_scene(160, 120, device=card),
                                 PLTIntegrator(max_depth=7, rr_depth=50))
    smoke.grad_cbox_stokes()
    smoke.tf32_grad_cbox(cornell_box(64, 64, device=card))


def test_gradients_match_cpu(card):
    """The same gradients on the card and on the CPU: PLT's four grating
    parameters (B4b on the card, the plain version's autograd on the CPU)
    and the path tracer's and PRB's base_color and radiance, within 1e-3
    of each key's largest entry (the kernels against the plain versions,
    float32 sums in another order)."""
    from mitsuba3_plt_tpu_torch import ad
    from mitsuba3_plt_tpu_torch.integrators.path import PathIntegrator
    from mitsuba3_plt_tpu_torch.integrators.plt import PLTIntegrator
    from mitsuba3_plt_tpu_torch.integrators.prb import PRBIntegrator
    from mitsuba3_plt_tpu_torch.scene.presets import cornell_box, grating_scene

    smoke = _smoke()
    cases = [(grating_scene, dict(coherence=5e3), PLTIntegrator(3, 8),
              smoke.GRAD_KEYS),
             (cornell_box, {}, PathIntegrator(3, 8),
              ("materials.base_color", "emitters.radiance")),
             (cornell_box, {}, PRBIntegrator(3, 8),
              ("materials.base_color", "emitters.radiance"))]
    for make, kw, integ, keys in cases:
        out = {}
        for dev in (card, torch.device("cpu")):
            scene = make(32, 32, device=dev, **kw)
            _, g = ad.render_loss_grad(scene, integ.sample, torch.mean,
                                       list(keys), seed=0, spp=4)
            out[dev.type] = {k: v.cpu() for k, v in g.items()}
        for k in keys:
            a, b = out["cuda"][k], out["cpu"][k]
            assert torch.isfinite(a).all()
            assert (a - b).abs().max() <= 1e-3 * b.abs().max(), k


def _mesh_rays(scene, rng, card):
    """Camera rays of the scene, bounce-like rays (origins on the unit
    sphere pushed off along the normal, cosine-hemisphere directions) and
    shadow rays from those origins toward the point light."""
    from mitsuba3_plt_tpu_torch.core.rng import Sampler
    from mitsuba3_plt_tpu_torch.integrators.common import sample_rays

    W, H = scene.sensor.resolution
    cam, _ = sample_rays(scene, Sampler.create(0, W * H * 2, device=card),
                         W, H, 2)
    n = cam.o.shape[0]
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    org = nrm * (1.0 + 1e-4)
    a = np.cross(nrm, np.where(np.abs(nrm[:, :1]) > 0.9, [[0, 1, 0]],
                               [[1, 0, 0]]))
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    b = np.cross(nrm, a)
    u1, u2 = rng.random(n), rng.random(n)
    r, phi = np.sqrt(u1), 2 * np.pi * u2
    dirs = (a * (r * np.cos(phi))[:, None] + b * (r * np.sin(phi))[:, None]
            + nrm * np.sqrt(1 - u1)[:, None])
    to_l = scene.emitters.position[0].cpu().numpy().astype(np.float64) - org
    dist = np.linalg.norm(to_l, axis=-1)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=card)  # noqa: E731
    return (cam.o, cam.d, cam.maxt), (t(org), t(dirs), t(np.full(n, np.inf))), \
        (t(org), t(to_l / dist[:, None]), t(dist * (1 - 1e-4)))


def test_clu2_kernels_match_plain(card):
    """B5 and B6 equal their plain walk to the bit (prim, t, u, v; the
    flags) on camera, bounce, shadow and all-dead rays: the kernels round as
    the plain walk does and walk in its order."""
    from mitsuba3_plt_tpu_torch.ops import intersect as isect
    from mitsuba3_plt_tpu_torch.scene.presets import mesh_scene

    scene = mesh_scene(64, 48, subdiv=5, device=card)
    assert scene.intersect_route() == "clu2"
    cam, bounce, shadow = _mesh_rays(scene, np.random.default_rng(3), card)
    n = cam[0].shape[0]
    dead_o = torch.full((n, 3), 1e8, device=card)
    dead_d = torch.tensor([[0.0, 0.0, 1.0]], device=card).repeat(n, 1)
    inf = torch.full((n,), float("inf"), device=card)
    for o, d, mt in (cam, bounce, (dead_o, dead_d, inf)):
        got = isect.intersect_clu2(scene.ctab2, o, d, mt)
        want = isect.intersect_clu2_plain(scene.ctab2, o, d, mt)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    # bounce rays leave the convex mesh
    hit = isect.intersect_clu2(scene.ctab2, *bounce)[1] >= 0
    assert hit.float().mean() < 0.01
    for o, d, mt, share in ((*shadow, True),
                            (cam[0], cam[1], torch.full_like(cam[2], 5.),
                             True),
                            (dead_o, dead_d, torch.zeros_like(inf), False)):
        occ = isect.occluded_clu2(scene.ctab2, o, d, mt)
        occ_plain = isect.occluded_clu2_plain(scene.ctab2, o, d, mt)
        torch.cuda.synchronize()
        assert torch.equal(occ, occ_plain)
        if share:
            assert 0.05 < occ_plain.float().mean() < 0.95
        else:
            assert not occ_plain.any()


def test_path_render_launches_clu2_once_per_bounce(card):
    from mitsuba3_plt_tpu_torch import ops
    from mitsuba3_plt_tpu_torch.integrators.common import render
    from mitsuba3_plt_tpu_torch.integrators.path import PathIntegrator
    from mitsuba3_plt_tpu_torch.scene.presets import mesh_scene

    scene = mesh_scene(32, 24, subdiv=5, device=card)
    ops.reset_launch_counts()
    img = render(scene, PathIntegrator(max_depth=4, rr_depth=3), spp=4,
                 spp_per_pass=2)
    torch.cuda.synchronize()
    assert img.device.type == "cuda" and torch.isfinite(img).all()
    assert img.mean() > 0
    assert ops.launch_counts() == {"intersect_q": 0, "occluded_q": 0,
                                   "intersect_clu2": 8, "occluded_clu2": 8,
                                   "intersect_bvh": 0, "occluded_bvh": 0,
                                   "intersect_classic": 0,
                                   "occluded_classic": 0, "intersect_mxu": 0,
                                   "intersect_clu": 0, "occluded_clu": 0,
                                   "intersect_q_variant": 0,
                                   "occluded_q_variant": 0,
                                   "intersect_q_macc": 0, "fma_roof": 0,
                                   "grating_sample": 0, "grating_lobe_sum": 0,
                                   "grating_lobe_sum_bwd": 0,
                                   "grating_lobe_sum_record": 0}


def test_bvh_kernels_match_plain(card):
    """B7a and B7b against their plain walks over the WideBVH, to the bit:
    camera, bounce-like and shadow rays, unsorted and through the route's
    coherence sort."""
    from mitsuba3_plt_tpu_torch.librender.records import Ray
    from mitsuba3_plt_tpu_torch.ops import intersect as isect
    from mitsuba3_plt_tpu_torch.scene.presets import mesh_scene

    scene = mesh_scene(64, 48, subdiv=5, accel="packet", device=card)
    assert scene.intersect_route() == "packet"
    pb, wb = scene.pbvh, scene.wbvh
    cam, bounce, shadow = _mesh_rays(scene, np.random.default_rng(3), card)
    # the camera rays once more with a finite maxt past the near surface
    for o, d, mt in (cam, bounce, (cam[0], cam[1],
                                   torch.full_like(cam[2], 3.5))):
        got = isect.intersect_bvh(wb, o, d, mt)
        want = isect.intersect_bvh_plain(wb, o, d, mt)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1])
        for k in (0, 2, 3):  # t, u, v
            assert torch.equal(got[k], want[k])
    assert (got[1] >= 0).float().mean() > 0.1
    # B7b over the WideBVH: its plain walk, and the skip-link walk over the
    # PacketBVH, to the bit
    for o, d, mt in (shadow, (cam[0], cam[1], torch.full_like(cam[2], 5.))):
        occ = isect.occluded_bvh(wb, o, d, mt)
        assert torch.equal(occ, isect.occluded_bvh_plain(wb, o, d, mt))
        assert torch.equal(occ, isect._bvh_walk(pb, o, d, mt, True, None)[4])
        assert 0.05 < occ.float().mean() < 0.95
    # the route sorts, launches and unsorts
    si = scene.ray_intersect(Ray.create(cam[0], cam[1]))
    assert torch.equal(si.prim_idx, isect.intersect_bvh(wb, *cam)[1])
    o, d, mt = shadow
    assert torch.equal(scene.ray_test(Ray(o=o, d=d, maxt=mt)),
                       isect.occluded_bvh(wb, o, d, mt))


def test_wide_bvh_kernel_matches_plain_on_ties(card):
    """B7a to the bit on a sphere whose every face appears twice (every hit
    an exact tie, which the lower PacketBVH row wins) and on the 5,120-face
    sphere with rays from inside and outside, maxt inf and finite."""
    from mitsuba3_plt_tpu_torch.ops import intersect as isect
    from mitsuba3_plt_tpu_torch.scene.bvh import (
        build_bvh, pack_packet_bvh, pack_wide_bvh)
    from mitsuba3_plt_tpu_torch.scene.shape import make_sphere

    rng = np.random.default_rng(9)
    m = make_sphere(4)
    v, f = np.asarray(m.vertices, np.float32), np.asarray(m.faces)
    n = 16384
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * rng.uniform(
        0.2, 3.0, (n, 1))
    d = rng.normal(size=(n, 3))
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    mt = np.where(rng.random(n) < 0.3, rng.uniform(0.1, 3.0, n), np.inf)
    o, d, mt = (torch.as_tensor(x.astype(np.float32), device=card)
                for x in (o, d, mt))
    single = None
    for faces in (f, np.concatenate([f, f])):
        p = [v[faces[:, k]] for k in range(3)]
        wb = pack_wide_bvh(pack_packet_bvh(build_bvh(v, faces), *p,
                                           device=card))
        got = isect.intersect_bvh(wb, o, d, mt)
        want = isect.intersect_bvh_plain(wb, o, d, mt)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert 0.3 < (got[1] >= 0).float().mean() < 1.0
        if single is None:
            single = got
        else:
            # either copy of a face answers as the face alone (another
            # tree: a box may cull by rounding on a rare lane)
            same = ((got[0] == single[0]) & (got[2] == single[2])
                    & (got[3] == single[3])
                    & (torch.where(got[1] >= 0, got[1] % len(f), -1)
                       == single[1]))
            assert same.float().mean() >= 0.999


def test_wide_anyhit_kernel_matches_plain_at_edges(card):
    """B7b to the bit against its plain walk and the skip-link walk on the
    5,120-face sphere, rays from inside and outside, with maxt one ulp short
    of the closest hit, at it, one ulp past it, inf, 0 and from a dead ray,
    and ray counts that leave the last block's tiles empty (n = 1, 13)."""
    from mitsuba3_plt_tpu_torch.ops import intersect as isect
    from mitsuba3_plt_tpu_torch.scene.bvh import (
        build_bvh, pack_packet_bvh, pack_wide_bvh)
    from mitsuba3_plt_tpu_torch.scene.shape import make_sphere

    rng = np.random.default_rng(10)
    m = make_sphere(4)
    v, f = np.asarray(m.vertices, np.float32), np.asarray(m.faces)
    p = [v[f[:, k]] for k in range(3)]
    pb = pack_packet_bvh(build_bvh(v, f), *p, device=card)
    wb = pack_wide_bvh(pb)
    n = 16384
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * rng.uniform(
        0.2, 3.0, (n, 1))
    d = rng.normal(size=(n, 3))
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o[::9], d[::9] = 1e8, (0.0, 0.0, 1.0)
    o, d = (torch.as_tensor(x.astype(np.float32), device=card)
            for x in (o, d))
    inf = torch.full((n,), float("inf"), device=card)
    t0 = isect.intersect_bvh_plain(wb, o, d, inf)[0]
    hit = torch.isfinite(t0)
    cases = [torch.where(hit, torch.nextafter(t0, torch.zeros_like(t0)), 1.),
             torch.where(hit, t0, 1.),
             torch.where(hit, torch.nextafter(t0, inf), 1.), inf,
             torch.zeros_like(inf)]
    for mt in cases:
        for k in (n, 13, 1):
            got = isect.occluded_bvh(wb, o[:k], d[:k], mt[:k])
            torch.cuda.synchronize()
            assert torch.equal(got, isect.occluded_bvh_plain(
                wb, o[:k], d[:k], mt[:k]))
            assert torch.equal(got, isect._bvh_walk(
                pb, o[:k], d[:k], mt[:k], True, None)[4])
    assert 0.3 < isect.occluded_bvh(wb, o, d, inf).float().mean() < 1.0


def test_lobe_sum_kernel_matches_plain_at_grazing_lanes(card):
    """B4 within rtol 2e-3 / atol 2e-5 of its plain version on 1 - 1e-3 of
    lanes in all four cases of chip_smoke.py, on random lanes with a set of
    grazing ones (|wi.z| in [0.005, 0.05]: most of their channels have
    x = 4 pi q / (lambda cos) above 48, the asymptotic branch)."""
    from mitsuba3_plt_tpu_torch.ops import grating as gops

    rng = np.random.default_rng(4)
    n, f32 = 16384, np.float32
    for half, sep, gtype, ip_y in ((3, True, 0, 0.0), (3, False, 0, 1.5),
                                   (4, True, 1, 0.0), (2, True, 2, 0.0)):
        wi = _dirs(rng, n)
        g = rng.normal(size=(n // 4, 2))
        g = g / np.linalg.norm(g, axis=-1, keepdims=True)
        z = rng.uniform(0.005, 0.05, n // 4)
        wi[: n // 4] = np.stack([g[:, 0] * np.sqrt(1 - z * z),
                                 g[:, 1] * np.sqrt(1 - z * z), z], -1)
        ins = {k: torch.as_tensor(x, device=card) for k, x in dict(
            wi=wi.astype(f32), wo=_dirs(rng, n),
            wl_nm=rng.uniform(380, 680, (n, 3)).astype(f32),
            grating_dir=np.tile([[1.0, 0.0]], (n, 1)).astype(f32),
            inv_period=np.tile([[2.0, ip_y]], (n, 1)).astype(f32),
            q=rng.uniform(0.02, 0.3, n).astype(f32),
            lobes=rng.choice([3, 5, 7, 9], n).astype(np.int32),
            gtype=np.full(n, gtype, np.int32),
            multiplier=np.full(n, 1.3, f32),
            coherence=rng.uniform(1.0, 120.0, n).astype(f32),
            a_cone=rng.uniform(0.05, 0.4, n).astype(f32)).items()}
        got = gops.grating_lobe_sum(**ins, half=half, separable=sep,
                                    n_channels=3)
        want = gops.grating_lobe_sum_plain(**ins, half=half, separable=sep)
        torch.cuda.synchronize()
        ok = torch.isclose(got, want, rtol=2e-3, atol=2e-5).all(-1)
        assert ok.float().mean() >= 1 - 1e-3, (half, sep, gtype)
        assert ok[: n // 4].float().mean() >= 1 - 1e-3, (half, sep, gtype)
        x = (4 * np.pi * ins["q"][:, None] / (ins["wl_nm"] * 1e-3
                                              * ins["wi"][:, 2:3].abs()))
        assert (x[: n // 4] > 48).float().mean() > 0.5


def test_special_function_probes_have_fast_paths(card):
    """The SASS of the one-function probes gives each special function of
    the lobe sum a fast path of a few to a few tens of instructions."""
    from mitsuba3_plt_tpu_torch.ops import mfu

    counts = mfu.special_fn_counts(mfu.library_sass())
    assert set(counts) == set(mfu.SPECIAL_FNS)
    for name, c in counts.items():
        assert 2 <= c["slots"] <= 80 and 0 <= c["ffma"] <= c["slots"], (
            name, c)


def test_regen_render_launches_bvh_once_per_iteration(card):
    from mitsuba3_plt_tpu_torch import ops
    from mitsuba3_plt_tpu_torch.integrators.common import render
    from mitsuba3_plt_tpu_torch.integrators.path import PathIntegrator
    from mitsuba3_plt_tpu_torch.scene.presets import mesh_scene

    scene = mesh_scene(128, 128, subdiv=5, accel="packet", device=card)
    integ = PathIntegrator(max_depth=4, rr_depth=3)
    ops.reset_launch_counts()
    stats = {}
    img = render(scene, integ, seed=2, spp=8, spp_per_pass=4, regen=True,
                 pixel_order="morton", stats=stats)
    torch.cuda.synchronize()
    assert stats["lanes_per_pass"] == 128 * 128 * 4 // 8
    iters = sum(stats["regen_iterations"])
    assert len(stats["regen_iterations"]) == 2 and iters >= 2 * 8
    counts = ops.launch_counts()
    assert counts.pop("intersect_bvh") == iters
    assert counts.pop("occluded_bvh") == iters
    assert not any(counts.values())
    assert img.device.type == "cuda" and torch.isfinite(img).all()
    fixed = render(scene, integ, seed=2, spp=8, spp_per_pass=4,
                   pixel_order="morton")
    torch.testing.assert_close(img, fixed, rtol=2e-5, atol=2e-6)


def _brute_sets(card):
    """The bench tool's ray sets on the Cornell box (coherent, incoherent,
    camera, bounce and shadow rays) and on a 1,280-face icosphere."""
    from mitsuba3_plt_tpu_torch.scene.presets import cornell_box, mesh_scene
    from mitsuba3_plt_tpu_torch.tools import bench_isect as bi

    cbox = cornell_box(32, 32, device=card)
    mesh = mesh_scene(32, 32, subdiv=3, device=card)
    return [(cbox, {**bi.ray_sets(cbox, 8192, 1),
                    **bi.cbox_ray_sets(cbox, 8, 1)}),
            (mesh, bi.ray_sets(mesh, 8192, 2))]


def test_classic_kernels_match_plain(card):
    """B8a and B8b equal their plain versions to the bit."""
    from mitsuba3_plt_tpu_torch.ops import intersect as isect

    for scene, sets in _brute_sets(card):
        g = scene.geo
        for label, (o, d, mt) in sets.items():
            args = (g.tri_isect, o, d, mt, g.n_faces)
            got = isect.intersect_classic(*args)
            want = isect.intersect_classic_plain(*args)
            occ = isect.occluded_classic(*args)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert torch.equal(a, b), label
            assert torch.equal(occ, isect.occluded_classic_plain(*args)), \
                label
            if label in ("incoherent", "depth1"):
                assert 0.05 < (got[1] >= 0).float().mean() < 1.0, label


def test_mxu_kernel_matches_plain(card):
    """B9 against its plain version (the product by torch.matmul in full
    float32): hit masks and prims equal on >= 99.99% of lanes, t within
    rtol 1e-4 where both hit; over the whole padded table and over the
    mesh's faces alone."""
    from mitsuba3_plt_tpu_torch.ops import intersect as isect

    for scene, sets in _brute_sets(card):
        F = scene.geo.n_faces
        p = scene.geo.tri_isect[:F].cpu().numpy()
        w = torch.as_tensor(isect.regroup_tri_mxu(isect.pack_tri_mxu(
            p[:, 0:3], p[:, 3:6], p[:, 6:9])), device=card)
        for (label, (o, d, mt)), nt in itertools.product(sets.items(),
                                                          (None, F)):
            got = isect.intersect_mxu(w, o, d, mt, nt)
            want = isect.intersect_mxu_plain(w, o, d, mt, nt)
            torch.cuda.synchronize()
            hit, whit = got[1] >= 0, want[1] >= 0
            assert (hit == whit).float().mean() >= 1 - 1e-4, label
            assert (got[1] == want[1]).float().mean() >= 1 - 1e-4, label
            both = hit & whit
            torch.testing.assert_close(got[0][both], want[0][both],
                                       rtol=1e-4, atol=0)
            assert torch.isinf(got[0][~hit]).all()


def _sphere_rays(tri, rng, n):
    """(o, d) numpy float32 that graze the icosphere of tri [F, 9] (p0, e1,
    e2): tangent to its circumscribed sphere at one of its vertices, some
    pushed in toward the centre by 1e-7 to 1e-3 of the radius, and aimed
    at its vertices (shared by five or six faces) from outside."""
    v = np.concatenate([tri[:, 0:3], tri[:, 0:3] + tri[:, 3:6],
                        tri[:, 0:3] + tri[:, 6:9]]).astype(np.float64)
    c = v.mean(0)
    radius = float(np.linalg.norm(v - c, axis=-1).mean())
    p = v[rng.integers(0, len(v), n)]
    nrm = (p - c) / np.linalg.norm(p - c, axis=-1, keepdims=True)
    t = np.cross(nrm, rng.normal(size=(n, 3)))
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    inward = np.where(rng.random((n, 1)) < 0.5, 0.0,
                      10.0 ** rng.uniform(-7, -3, (n, 1))) * radius
    graze_o = p - inward * nrm - 2 * radius * t
    aim_o = p + 2 * radius * nrm + 0.01 * radius * rng.normal(size=(n, 3))
    aim_d = p - aim_o
    aim_d /= np.linalg.norm(aim_d, axis=-1, keepdims=True)
    return (np.concatenate([graze_o, aim_o]).astype(np.float32),
            np.concatenate([t, aim_d]).astype(np.float32))


def _mxu_sets(card):
    """[(F, w, sets)]: B9's table (`pack_tri_mxu`, regrouped) of each scene
    of `_brute_sets` and its ray sets {label: (o, d, maxt)}: the bench
    tool's, and rays where a slack too tight would drop a hit: aimed at
    the midpoints of the icosphere's shared edges and at the Cornell box's
    ("aimed 0"), grazing the icosphere's silhouette and aimed at its
    vertices ("aimed 1"), each with maxt inf, just past and just short of
    the hit ("maxt 0 / 1 / 2")."""
    from mitsuba3_plt_tpu_torch.ops import intersect as isect

    rng = np.random.default_rng(13)
    out = []
    for scene, sets in _brute_sets(card):
        F = scene.geo.n_faces
        tri = scene.geo.tri_isect[:F].cpu().numpy()
        w = torch.as_tensor(isect.regroup_tri_mxu(isect.pack_tri_mxu(
            tri[:, 0:3], tri[:, 3:6], tri[:, 6:9])), device=card)
        size = float(np.ptp(tri[:, 0:3], 0).max())
        faces = rng.integers(0, F, 2048)
        extra = [_aimed(tri, faces, rng, 0.05 * size, edge=True)]
        if F > 36:
            extra.append(_sphere_rays(tri, rng, 2048))
        for k, (o, d) in enumerate(extra):
            o, d = (torch.as_tensor(x, device=card) for x in (o, d))
            inf = torch.full((o.shape[0],), float("inf"), device=card)
            t = isect.intersect_mxu(w, o, d, inf, F)[0]
            for j, mt in enumerate((inf, torch.where(
                    torch.isfinite(t), torch.nextafter(t, inf), 1.0),
                    torch.where(torch.isfinite(t), t, 1.0))):
                sets[f"aimed {k} maxt {j}"] = (o, d, mt)
        out.append((F, w, sets))
    return out


def test_mxu_kernel_equals_its_filter_off_instance(card):
    """B9 (3xTF32 on the tensor cores finds the pairs that could hit, FP32
    decides) equals its filter-off instance (every pair through the FP32
    test; `chip_smoke.mxu_unfiltered`) to the bit, and the filter drops no
    hit: on the sets of `_mxu_sets` (the bench tool's, and rays at shared
    edges, grazing the icosphere's silhouette and aimed at its vertices,
    with maxt at the hit), over the mesh's faces and over the whole padded
    table, at ray counts that leave the last tile part-filled."""
    from mitsuba3_plt_tpu_torch.ops import intersect as isect

    smoke = _smoke()
    for F, w, sets in _mxu_sets(card):
        for (label, (o, d, mt)), nt in itertools.product(sets.items(),
                                                          (F, None)):
            for m in (o.shape[0], 13):
                args = (w, o[:m], d[:m], mt[:m], F if nt else w.shape[0] // 4)
                got = isect.intersect_mxu(*args)
                want, counts = smoke.mxu_unfiltered(*args)
                torch.cuda.synchronize()
                assert counts["dropped"] == 0, (label, nt, m)
                for a, b in zip(got, want):
                    assert torch.equal(a, b), (label, nt, m)
            if label == "aimed 0 maxt 0":  # the edges' rays hit
                hit = isect.intersect_mxu(w, o, d, mt, F)[1] >= 0
                assert hit.float().mean() > 0.25, label


def test_mxu_kernel_equals_the_first_ports_fp32_test(card):
    """B9 on 2,048 lanes spread over each set of `_mxu_sets` equals, to the
    bit (t, prim, u, v), a plain numpy emulation of the first port's FP32
    test that shares no code with the kernel
    (`tests/test_torch_mxu_split.py::fp32_closest`: each quantity a chain
    of 16 fmaf rounded once each, the guarded division, the smallest t
    with the lowest triangle on ties, u = us inv, v = vs inv): so the
    ring, the drain, the (t, prim) key and the u, v taken again from the
    winner, which the filter-off instance shares, are held too. The
    aimed sets hit shared edges, where two triangles tie."""
    from mitsuba3_plt_tpu_torch.ops import intersect as isect

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "test_torch_mxu_split.py")
    spec = importlib.util.spec_from_file_location("mxu_split", path)
    split = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(split)
    for F, w, sets in _mxu_sets(card):
        W = w.view(4, -1, 16)[:, :F].cpu().numpy()
        for label, (o, d, mt) in sets.items():
            step = max(1, o.shape[0] // 2048)
            got = [x[::step].cpu().numpy()
                   for x in isect.intersect_mxu(w, o, d, mt, F)]
            want = split.fp32_closest(W, *(x[::step].cpu().numpy()
                                           for x in (o, d, mt)))
            # maxt at the hit ("maxt 2") leaves none
            assert (want[1] >= 0).any() != label.endswith("maxt 2"), label
            for a, b in zip(got, want):
                assert np.array_equal(a.view(np.int32), b.view(np.int32)), \
                    (label, int((a != b).sum()))


def test_cbox_render_matches_cpu_render(card):
    """cornell_box(32, 32), path depth 4 / rr 9, 4 seeds x 16 spp on the
    card and on the CPU: the same samples, so the images agree within the
    golden z-test; B1 and B2 launch once per bounce on the card."""
    from scipy.stats import norm

    from mitsuba3_plt_tpu_torch import ops
    from mitsuba3_plt_tpu_torch.integrators.common import render
    from mitsuba3_plt_tpu_torch.integrators.path import PathIntegrator
    from mitsuba3_plt_tpu_torch.scene.presets import cornell_box

    integ = PathIntegrator(max_depth=4, rr_depth=9)
    imgs = {}
    for dev in (card, "cpu"):
        scene = cornell_box(32, 32, device=dev)
        ops.reset_launch_counts()
        imgs[str(dev)] = np.stack([
            render(scene, integ, seed=s, spp=16).cpu().numpy()
            for s in range(4)])
        counts = ops.launch_counts()
        if dev == card:
            assert counts.pop("intersect_q") == 16
            assert counts.pop("occluded_q") == 16
        assert not any(counts.values())
    a, b = imgs[str(card)], imgs["cpu"]
    assert np.isfinite(a).all() and a.mean() > 0.05
    z = np.abs(a.mean(0) - b.mean(0)) / np.sqrt(
        (a.var(0, ddof=1) + b.var(0, ddof=1)) / 4 + 1e-8)
    alpha = 1.0 - (1.0 - 0.01) ** (1.0 / z.size)
    assert int((z > norm.isf(alpha / 2)).sum()) == 0, z.max()


def _tool_scenes(card):
    """The Cornell box (one cluster) and a 5,120-face icosphere (K > 32)."""
    from mitsuba3_plt_tpu_torch.scene.presets import cornell_box, mesh_scene

    return [cornell_box(32, 32, device=card),
            mesh_scene(32, 32, subdiv=4, device=card)]


def test_clu_kernels_match_plain(card):
    """B10a and B10b equal their plain versions to the bit on the mask-sort
    tool's sets, over both tables of each scene."""
    from mitsuba3_plt_tpu_torch.ops import intersect as isect
    from mitsuba3_plt_tpu_torch.tools import isect_mask_sort as ms

    for scene in _tool_scenes(card):
        sets = ms.ray_sets(scene, 4, seed=2)
        for ctab in ms.tables(scene).values():
            for label, (o, d, mt) in sets.items():
                if label.startswith("shadow"):
                    occ = isect.occluded_clu(ctab, o, d, mt)
                    assert torch.equal(
                        occ, isect.occluded_clu_plain(ctab, o, d, mt)), label
                    continue
                got = isect.intersect_clu(ctab, o, d, mt)
                want = isect.intersect_clu_plain(ctab, o, d, mt)
                torch.cuda.synchronize()
                for a, b in zip(got, want):
                    assert torch.equal(a, b), label
                # bounce rays leave the convex icosphere
                if label in ("incoherent", "depth0"):
                    assert (got[1] >= 0).any(), label


def _soup_rows(subdiv):
    """tri [F, 9] (p0, e1, e2) of the unit icosphere of `subdiv`, numpy."""
    from mitsuba3_plt_tpu_torch.scene.shape import make_sphere

    m = make_sphere(subdiv)
    v, f = np.asarray(m.vertices, np.float32), np.asarray(m.faces)
    p0, p1, p2 = (v[f[:, k]] for k in range(3))
    return np.concatenate([p0, p1 - p0, p2 - p0], 1).astype(np.float32)


def _aimed(tri, faces, rng, off, edge=False):
    """(o, d) numpy float32: rays along the normal of each of `faces` of
    tri [F, 9] (p0, e1, e2) from `off` off a point of the face (inside it,
    or the midpoint of its edge p0 -> p0 + e1 where `edge`), from either
    side at random."""
    p0, e1, e2 = tri[faces, 0:3], tri[faces, 3:6], tri[faces, 6:9]
    if edge:
        p = p0 + 0.5 * e1
    else:
        a, b = rng.uniform(0.2, 0.4, (2, len(faces), 1))
        p = p0 + a * e1 + b * e2
    nrm = np.cross(e1, e2)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    side = np.where(rng.random((len(faces), 1)) < 0.5, 1.0, -1.0)
    return ((p + side * off * nrm).astype(np.float32),
            (-side * nrm).astype(np.float32))


def test_clu_closest_kernel_matches_plain_at_edges(card):
    """B10a to the bit against its plain walk, with clusters that many
    lanes of a warp enter (a lane a ray) and that few do (a tile a ray):
    on the Cornell box's incoherent rays (the box bottoms and the floor
    are coplanar and tie exactly), on rays at the last row of a trip or
    the first of the next and at an edge such a row shares with a
    neighbour, over each table and the same table cut to 1, 5, 13 and
    K - 3 boxes, on all-dead and all-miss rays, and at ray counts that
    leave the last warp part-filled (n = 1, 13)."""
    from mitsuba3_plt_tpu_torch.ops import intersect as isect
    from mitsuba3_plt_tpu_torch.scene.bvh import ClusterTable
    from mitsuba3_plt_tpu_torch.scene.presets import cornell_box, mesh_scene
    from mitsuba3_plt_tpu_torch.tools import bench_isect as bi
    from mitsuba3_plt_tpu_torch.tools import isect_mask_sort as ms

    rng = np.random.default_rng(12)
    for scene in (cornell_box(32, 32, device=card),
                  mesh_scene(32, 32, subdiv=3, device=card)):
        tri = scene.geo.tri_isect[: scene.geo.n_faces].cpu().numpy()
        p = np.concatenate([tri[:, 0:3], tri[:, 0:3] + tri[:, 3:6]])
        centre, size = p.mean(0), float(np.ptp(p, 0).max())
        inc = bi.ray_sets(scene, 4096, 3)["incoherent"]
        u = rng.normal(size=(512, 3))
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        out_o, out_d = centre + 2 * size * u, u
        for ct in ms.tables(scene).values():
            face = ct.rows[:, 16].cpu().numpy().astype(np.int64)
            k = np.arange(len(face))
            # the faces of rows that end a trip or start one
            edge_rows = ((k % 8 == 7) | (k % 8 == 0)) & (face >= 0)
            faces = np.repeat(face[edge_rows], 4)
            rays = [_aimed(tri, faces, rng, 0.05 * size),
                    _aimed(tri, faces, rng, 0.05 * size, edge=True),
                    (out_o, out_d),
                    (np.full((300, 3), 1e8), np.tile([0.0, 0.0, 1.0],
                                                     (300, 1)))]
            sets = [inc] + [
                tuple(torch.as_tensor(x, dtype=torch.float32, device=card)
                      for x in (o, d, np.full(len(o), np.inf)))
                for o, d in rays]
            n_boxes = ct.boxes.shape[0]
            for cut in sorted({n_boxes, 1, 5, 13, max(1, n_boxes - 3)}):
                if cut > n_boxes:
                    continue
                tab = ClusterTable(boxes=ct.boxes[:cut].contiguous(),
                                   rows=ct.rows, anchor=ct.anchor)
                for label, (o, d, mt) in enumerate(sets):
                    want = isect.intersect_clu_plain(tab, o, d, mt)
                    for n in (o.shape[0], 13, 1):
                        got = isect.intersect_clu(tab, o[:n], d[:n], mt[:n])
                        torch.cuda.synchronize()
                        assert all(torch.equal(a, b[:n])
                                   for a, b in zip(got, want)), \
                            (cut, label, n)
                    if label >= 3:  # rays away from the scene, dead rays
                        assert (want[1] < 0).all(), label
                if cut == n_boxes:
                    # the aimed rays hit (their face or, at an edge, its
                    # neighbour)
                    hits = isect.intersect_clu(tab, *sets[1])[1]
                    assert (hits >= 0).all()


def test_occluded_classic_matches_plain_at_edges(card):
    """B8b to the bit against its plain version on a table of each class
    (the Cornell box, a lane a ray; the 5,120-face icosphere, a warp a ray,
    resident; the 20,480-face one, chunked) and on the icosphere's first
    64 and 65 rows: rays whose only occluder is row 0, 1, 31-33, 63-65,
    511-513 or the last; n_tris cut by 13 (no width divides it); maxt one
    ulp below, at and above the hit; a run of 2,048 rays that all hit row
    0 first (whole blocks done at once); all-dead rays; and ray counts that
    leave the last block part-filled (n = 1, 13)."""
    from mitsuba3_plt_tpu_torch.ops import intersect as isect
    from mitsuba3_plt_tpu_torch.scene.presets import cornell_box

    rng = np.random.default_rng(11)
    g = cornell_box(32, 32, device=card).geo
    for tri_np in (g.tri_isect[: g.n_faces].cpu().numpy(), _soup_rows(4),
                   _soup_rows(5)):
        F = tri_np.shape[0]
        off = 0.001 * float(np.ptp(tri_np[:, 0:3], 0).max())
        faces = np.array([k for k in (0, 1, 31, 32, 33, 63, 64, 65, 511, 512,
                                      513, F - 1) if k < F])
        faces = np.concatenate([np.zeros(2048, np.int64),
                                np.repeat(faces, 40)])
        o, d = _aimed(tri_np, faces, rng, off)
        tri = torch.as_tensor(tri_np, device=card)
        O, D = (torch.as_tensor(x, device=card) for x in (o, d))
        ok, t, _, _ = isect._classic_terms(tri[torch.as_tensor(faces)], O, D)
        assert ok.all()
        inf = torch.full_like(t, float("inf"))
        dead = 300
        O = torch.cat([O.repeat(4, 1), torch.full((dead, 3), 1e8,
                                                  device=card)])
        D = torch.cat([D.repeat(4, 1), torch.tensor(
            [[0.0, 0.0, 1.0]], device=card).repeat(dead, 1)])
        M = torch.cat([torch.full_like(t, 2 * off),
                       torch.nextafter(t, torch.zeros_like(t)), t,
                       torch.nextafter(t, inf), inf[:dead]])
        counts = sorted({F, F - 13} | ({64, 65, 37, 1} if F >= 65 else set()))
        for n_tris in counts:
            want = isect.occluded_classic_plain(tri, O, D, M, n_tris)
            for a, b in ((0, O.shape[0]), (0, 13), (0, 1),
                         (2048, 2061), (O.shape[0] - 13, O.shape[0])):
                got = isect.occluded_classic(tri, O[a:b], D[a:b], M[a:b],
                                             n_tris)
                torch.cuda.synchronize()
                assert torch.equal(got, want[a:b]), (F, n_tris, a, b)
            if n_tris == F:
                # maxt past the hit, one ulp short of it, at it, one past;
                # on the icosphere the aimed face is the only occluder (in
                # the Cornell box the floor and the box bottoms tie)
                n = len(faces)
                assert want[:n].all() and want[3 * n: 4 * n].all()
                assert F < 65 or not want[n: 3 * n].any()
                assert not want[-dead:].any()


def _classic_filter():
    """tests/test_torch_classic_filter.py as a module: its `cases`, the
    rays the CPU emulation of B8a's filter runs on."""
    return _module("tests/test_torch_classic_filter.py")


def test_classic_kernel_matches_plain_at_edges(card):
    """B8a (the filter on every pair, the exact test on its candidates; on
    tables of at most kDenseRows rows the exact test on every pair)
    equals its plain version to the bit (t, prim, u, v, -0 included) on the
    rays of the CPU filter test (`test_torch_classic_filter.cases`: the
    Cornell box's and a 1,280-face icosphere's bench rays, rays at their
    faces' vertices and edges with maxt at, above and below the hit, and
    the constructed rows: det at +-1e-12 and one ulp around it, u = -0
    under a huge det, ties, NaN and zero directions, maxt <= 0 and tiny,
    zero rows), at 1 and 13 lanes and all of them (one tile part-filled),
    each table as it is and padded with zero rows past kDenseRows (the
    filter's path; the Cornell box's and the constructed 64 rows take the
    exact test on every pair), and repeated to twice the lanes the largest
    grid covers in one pass (kWaves grids of 8 blocks an SM, the most the
    card holds: every block loops over two tiles or more) against its
    audit instance (the filter, then every pair through the exact test),
    which counts no hit the filter dropped, and against the plain version
    on every lane."""
    from mitsuba3_plt_tpu_torch.ops import intersect as isect

    smoke = _smoke()
    c = _classic_filter().constants()
    dense = c["kDenseRows"]
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    lanes = 2 * c["kWaves"] * sms * (2048 // c["kBlock"]) * c["kBlock"]
    for name, (tri, sets) in _classic_filter().cases().items():
        tri = tri.to(card)
        o, d, mt = (torch.cat(x).to(card) for x in zip(*sets.values()))
        want = isect.intersect_classic_plain(tri, o, d, mt)
        # the table as it is and, where small, padded with zero rows past
        # kDenseRows: the kernel's two paths
        pad = tri.new_zeros((max(0, dense + 64 - tri.shape[0]), 9))
        for table in {tri.shape[0]: tri, -1: torch.cat([tri, pad])}.values():
            for n in (1, 13, o.shape[0]):
                got = isect.intersect_classic(table, o[:n], d[:n], mt[:n])
                torch.cuda.synchronize()
                for a, b in zip(got, want):
                    assert torch.equal(a.view(torch.int32),
                                       b[:n].view(torch.int32)), \
                        (name, table.shape[0], n)
        reps = -(-lanes // o.shape[0])
        big = tuple(x.repeat(reps, *([1] * (x.dim() - 1)))
                    for x in (o, d, mt))
        got = isect.intersect_classic(tri, *big)
        ref, counts = smoke.classic_audit(tri, *big, tri.shape[0])
        torch.cuda.synchronize()
        assert counts["dropped"] == 0, name
        assert counts["candidates"] >= int((ref[1] >= 0).sum()), name
        for a, b, w in zip(got, ref, want):
            assert torch.equal(a, b), name
            # the plain version's answer on every repeat, the last tiles
            # of each block's loop included
            assert torch.equal(a.view(reps, -1), w.expand(reps, -1)), name


def _entrants(ctab, o, d, mt):
    """(warp, cluster) pairs by how many lanes of the warp (32 consecutive)
    pass the cluster's slab test with near < maxt, the any hit's gate
    before any ray is occluded (at least its entrants): (pairs with 1 to 8,
    the any hit's tile mode, pairs with more)."""
    from mitsuba3_plt_tpu_torch.ops import intersect as isect

    walk = isect._CluWalk(ctab, o, d, mt, None)
    few = many = 0
    for c in range(ctab.boxes.shape[0]):
        if not walk.spans[c][1]:
            continue
        near, far = walk.slab(ctab.boxes[c], walk.o, walk.inv)
        enter = (near <= far) & (far > 0.0) & (near < walk.mt)
        per = torch.bincount(enter.nonzero().squeeze(1) // 32)
        few += int(((per > 0) & (per <= 8)).sum())
        many += int((per > 8).sum())
    return few, many


def test_clu_anyhit_kernel_matches_plain_in_both_modes(card):
    """B10b to the bit against its plain walk over both tables of the
    Cornell box and of the 5,120-face icosphere: on the mask-sort tool's
    shadow rays and incoherent rays with maxt 1, three lanes in four dead
    (away from the scene), whose warps enter every cluster with at most 8
    lanes (a tile a ray), and on coherent rays from one origin in the
    order of a grid of their directions, whose warps enter most with more
    (a lane a ray), with maxt inf, 0.99 and 1.01 of the hit, one ulp short
    of it and at it; over the tables cut to 1, 5 and K - 3 boxes; at 1, 13
    and all lanes."""
    from mitsuba3_plt_tpu_torch.ops import intersect as isect
    from mitsuba3_plt_tpu_torch.scene.bvh import ClusterTable
    from mitsuba3_plt_tpu_torch.tools import bench_isect as bi
    from mitsuba3_plt_tpu_torch.tools import isect_mask_sort as ms

    for scene in _tool_scenes(card):
        shadow = ms.ray_sets(scene, 2, seed=9)
        inc = bi.ray_sets(scene, 4096, 9)["incoherent"]
        coh = bi.ray_sets(scene, 4096, 9)["coherent"]
        # in lane order of a 16 x 16 grid of their directions (d = (a, b,
        # 1) normalised): a warp's rays are neighbours
        a, b = (coh[1][:, k] / coh[1][:, 2] for k in (0, 1))
        key = ((b + 0.35) * 16 / 0.7).long() * 16 + ((a + 0.35) * 16 / 0.7
                                                       ).long()
        coh = tuple(x[torch.argsort(key, stable=True)] for x in coh)
        # three lanes in four dead (o = 1e8, d = +z, maxt -1: they enter
        # no box), so a warp enters any cluster with at most 8 lanes
        o, d, mt = (torch.cat(x) for x in zip(
            shadow["shadow0"], shadow["shadow1"],
            (inc[0], inc[1], torch.ones_like(inc[2]))))
        live = (torch.arange(mt.shape[0], device=card) % 4 == 0)[:, None]
        few = (torch.where(live, o, 1e8),
               torch.where(live, d, d.new_tensor([0.0, 0.0, 1.0])),
               torch.where(live[:, 0], mt, -1.0))
        t = isect.intersect_classic(scene.geo.tri_isect, *coh,
                                    scene.geo.n_faces)[0]
        fin = torch.isfinite(t)
        o, d = (x.repeat(6, 1) for x in coh[:2])
        many = (o, d, torch.cat([
            coh[2], torch.where(fin, 0.99 * t, 1.0),
            torch.where(fin, 1.01 * t, 1.0),
            torch.where(fin, torch.nextafter(t, torch.zeros_like(t)), 1.0),
            torch.where(fin, t, 1.0), torch.full_like(t, -1.0)]))
        for ct in ms.tables(scene).values():
            n_boxes = ct.boxes.shape[0]
            tile_pairs, lane_pairs = _entrants(ct, *few)
            assert tile_pairs and not lane_pairs, (tile_pairs, lane_pairs)
            tile_pairs, lane_pairs = _entrants(ct, *many)
            assert lane_pairs > tile_pairs, (tile_pairs, lane_pairs)
            for cut in sorted({n_boxes, 1, 5, max(1, n_boxes - 3)}):
                tab = ClusterTable(boxes=ct.boxes[:cut].contiguous(),
                                   rows=ct.rows, anchor=ct.anchor)
                for label, (o, d, mt) in (("few", few), ("many", many)):
                    want = isect.occluded_clu_plain(tab, o, d, mt)
                    for n in (o.shape[0], 13, 1):
                        got = isect.occluded_clu(tab, o[:n], d[:n], mt[:n])
                        torch.cuda.synchronize()
                        assert torch.equal(got, want[:n]), (cut, label, n)
                    if cut == n_boxes:
                        assert 0.02 < want.float().mean() < 0.98, label


def test_q_variant_kernels_match_plain(card):
    """B11a at every unroll, with one and two accumulators, near its plain
    version and equal to B1 over each group's rows to the bit
    (`_sweep_held`: B11a runs B1's row test, FMAs and all), so with one
    accumulator equal to B1 to the bit in t and prim (the same test in the
    same row order; the rows past the scene's are zero and never hit);
    B11b at every unroll equal to B2 over the same rows with an infinite
    maxt taken as -1, to the bit (B11b runs B2's row test), and to its
    plain version on 1 - 1e-4 of lanes (B2's tolerance, `check_q`). On the
    sweep's rays (maxt inf; for the any hit 0.99 or 1.01 of B1's t on
    alternate lanes, inf on every third, and the tool's maxt, 0.99 of B1's
    t, which occludes no lane)."""
    from mitsuba3_plt_tpu_torch.ops import intersect as isect
    from mitsuba3_plt_tpu_torch.tools import isect_unroll_sweep as us

    for scene in _tool_scenes(card):
        g = scene.geo
        q = (g.tri_q, g.tri_anchor)
        o, d, mt = us.sweep_rays(scene, 8192, seed=4)
        t0, p0 = isect.intersect_q(*q, o, d, mt, g.n_faces)[:2]
        lane = torch.arange(t0.shape[0], device=card)
        msh = torch.where(torch.isfinite(t0),
                          t0 * torch.where(lane % 2 == 0, 0.99, 1.01), 2.0)
        msh[::3] = float("inf")
        plain = {}  # the plain versions depend on the unroll by its rows
        for unroll in isect.Q_VARIANT_UNROLLS:
            rows = isect.q_variant_rows(g.tri_q.shape[0], g.n_faces, unroll)
            for dual in (False, True):
                got = isect.intersect_q_variant(*q, o, d, mt, g.n_faces,
                                                unroll, dual)
                if (rows, dual) not in plain:
                    plain[rows, dual] = isect.intersect_q_variant_plain(
                        *q, o, d, mt, g.n_faces, unroll, dual)
                _sweep_held(f"unroll {unroll} dual {dual}", got,
                            plain[rows, dual], q, (o, d, mt), rows,
                            2 if dual else 1)
                if not dual:
                    assert torch.equal(got[0], t0), unroll
                    assert torch.equal(got[1], p0), unroll
            occ = isect.occluded_q_variant(*q, o, d, msh, g.n_faces, unroll)
            if rows not in plain:
                plain[rows] = isect.occluded_q_variant_plain(
                    *q, o, d, msh, g.n_faces, unroll)
            b2 = isect.occluded_q(*q, o, d, torch.where(
                torch.isfinite(msh), msh, -1.0), rows)
            assert torch.equal(occ, b2), unroll
            assert (occ == plain[rows]).float().mean() >= 1 - 1e-4, unroll
            assert occ.any() and not occ[::3].any()
            tool = torch.where(torch.isfinite(t0), t0 * 0.99, 2.0)
            assert torch.equal(
                isect.occluded_q_variant(*q, o, d, tool, g.n_faces, unroll),
                isect.occluded_q(*q, o, d, tool, rows)), unroll


def test_tools_launch_their_kernels(card):
    """The mask-sort tool's sorted and Morton pipelines equal the unsorted
    kernel on every lane; one run of each tool launches its kernels as
    many times as it has routes or variants."""
    from mitsuba3_plt_tpu_torch import ops
    from mitsuba3_plt_tpu_torch.tools import isect_mask_sort as ms
    from mitsuba3_plt_tpu_torch.tools import isect_unroll_sweep as us

    scene = _tool_scenes(card)[1]
    sets = ms.ray_sets(scene, 4, seed=3)
    pick = {k: sets[k] for k in ("depth1", "shadow1")}
    fns = ms.route_fns(scene)
    for label, (o, d, mt) in pick.items():
        any_hit = label.startswith("shadow")
        base = fns["clu"][any_hit](o, d, mt)
        for name in ("m64", "m128", "clu-morton"):
            got = fns[name][any_hit](o, d, mt)
            same = (torch.equal(got, base) if any_hit
                    else all(torch.equal(a, b) for a, b in zip(got, base)))
            assert same, (label, name)
    ops.reset_launch_counts()
    rows = ms.run(scene, pick)
    counts = ops.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        "intersect_q": 1, "occluded_q": 1, "intersect_clu": 4,
        "occluded_clu": 4}
    for r in rows:
        assert r["prim_agree" if r["kind"] == "closest"
                 else "occ_agree"] >= 0.999, r
    ops.reset_launch_counts()
    us.run(scene, us.sweep_rays(scene, 8192))
    counts = ops.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        "intersect_q": 1, "occluded_q": 1,
        "intersect_q_variant": len(us.CLOSEST),
        "occluded_q_variant": len(us.ANYHIT)}


def test_q_macc_kernel_matches_plain(card):
    """B11c at nacc 2, 4 and 8 near its plain version and equal to B1 over
    each group's rows to the bit (t, prim, u, v: `_sweep_held`, it runs
    B1's row test) on the sweep's rays of both tool scenes, with maxt inf
    and on every fifth lane 0.5; at nacc 2 it answers as B11a's two
    accumulators do, to the bit."""
    from mitsuba3_plt_tpu_torch.ops import intersect as isect
    from mitsuba3_plt_tpu_torch.tools import isect_unroll_sweep as us

    for scene in _tool_scenes(card):
        g = scene.geo
        q = (g.tri_q, g.tri_anchor)
        o, d, mt = us.sweep_rays(scene, 8192, seed=6)
        mt[::5] = 0.5
        rows = isect.q_variant_rows(g.tri_q.shape[0], g.n_faces,
                                    isect.Q_MACC_UNROLL)
        for nacc in isect.Q_MACC_NACCS:
            got = isect.intersect_q_macc(*q, o, d, mt, g.n_faces, nacc)
            _sweep_held(f"nacc {nacc}", got,
                        isect.intersect_q_macc_plain(*q, o, d, mt,
                                                     g.n_faces, nacc),
                        q, (o, d, mt), rows, nacc)
            assert (got[1] >= 0).any() and (got[1] < 0).any()
            if nacc == 2:
                dual = isect.intersect_q_variant(*q, o, d, mt, g.n_faces,
                                                 16, True)
                assert torch.equal(dual[0], got[0])
                assert torch.equal(dual[1], got[1])


def test_sweep_kernels_match_plain_at_size(card):
    """B11a (every unroll, one and two accumulators) and B11c (every nacc)
    on 1,048,579 sweep rays of the 5,120-face icosphere: more tiles than
    the grid's 4 waves of resident blocks hold (at most 528 blocks a wave
    at 4 an SM on 132 SMs), so blocks take several tiles and re-stage the
    table in 512-row chunks for each. Held on every lane to B1 over each
    group's rows to the bit and on every 64th lane near the plain version
    (`_sweep_held`), with maxt inf and 0.5 on every fifth lane; B11c at
    nacc 2 equal to B11a's two accumulators to the bit."""
    from mitsuba3_plt_tpu_torch.ops import intersect as isect
    from mitsuba3_plt_tpu_torch.tools import isect_unroll_sweep as us

    scene = _tool_scenes(card)[1]
    g = scene.geo
    q = (g.tri_q, g.tri_anchor)
    n, step = 1_048_579, 64
    o, d, mt = us.sweep_rays(scene, n, seed=8)
    mt[::5] = 0.5
    assert n > 4 * 528 * 256 and g.n_faces > 512
    part = tuple(x[::step].contiguous() for x in (o, d, mt))
    for unroll in isect.Q_VARIANT_UNROLLS:
        rows = isect.q_variant_rows(g.tri_q.shape[0], g.n_faces, unroll)
        for dual in (False, True):
            got = isect.intersect_q_variant(*q, o, d, mt, g.n_faces, unroll,
                                            dual)
            want = isect.intersect_q_variant_plain(*q, *part, g.n_faces,
                                                   unroll, dual)
            _sweep_held(f"unroll {unroll} dual {dual}", got, want, q,
                        (o, d, mt), rows, 2 if dual else 1, step)
            assert (got[1] >= 0).any() and (got[1] < 0).any()
    dual = isect.intersect_q_variant(*q, o, d, mt, g.n_faces, 16, True)
    rows = isect.q_variant_rows(g.tri_q.shape[0], g.n_faces,
                                isect.Q_MACC_UNROLL)
    for nacc in isect.Q_MACC_NACCS:
        got = isect.intersect_q_macc(*q, o, d, mt, g.n_faces, nacc)
        want = isect.intersect_q_macc_plain(*q, *part, g.n_faces, nacc)
        _sweep_held(f"nacc {nacc}", got, want, q, (o, d, mt), rows, nacc,
                    step)
        if nacc == 2:
            assert torch.equal(dual[0], got[0])
            assert torch.equal(dual[1], got[1])


def test_fma_roof_kernel_matches_plain(card):
    """B11d within 1 ulp of its plain version (the plain version's double
    rounding) on random inputs with clamped chains, and its SASS: one FFMA
    and one FMNMX a chain a step."""
    from mitsuba3_plt_tpu_torch.ops import mfu

    rng = np.random.default_rng(7)
    x = rng.uniform(0.5, 2.0, (256, 128)).astype(np.float32)
    a = rng.uniform(0.98, 1.02, (8, 128)).astype(np.float32)
    x[3, :8] = 1e38
    a[5, :4] = 1.5
    x, a = torch.as_tensor(x, device=card), torch.as_tensor(a, device=card)
    got = mfu.fma_roof(x, a)
    want = mfu.fma_roof_plain(x, a)
    torch.cuda.synchronize()
    ulps = (got.view(torch.int32).long() - want.view(torch.int32)).abs()
    assert int(ulps.max()) <= 1
    assert torch.isinf(got).any() and torch.isfinite(got).float().mean() > 0.9
    sass = mfu.fma_roof_sass()
    assert sass["ffma"] == mfu.FMA_ITERS + 3, sass
    assert sass["fmnmx"] == mfu.FMA_ITERS, sass


def test_macc_and_mfu_tools_launch_their_kernels(card):
    """One run of the multi-accumulator tool launches B1 once and B11c
    once per nacc; the MFU tool's probes launch B11d, B1, B2, B5 and B4
    once each, and its HBM probe none of the port's kernels."""
    from mitsuba3_plt_tpu_torch import ops
    from mitsuba3_plt_tpu_torch.tools import isect_q_multiacc as qm
    from mitsuba3_plt_tpu_torch.tools import isect_unroll_sweep as us
    from mitsuba3_plt_tpu_torch.tools import kernel_mfu as km

    scene = _tool_scenes(card)[0]
    rays = us.sweep_rays(scene, 8192)
    ops.reset_launch_counts()
    rows = qm.run(scene, rays)
    counts = ops.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        "intersect_q": 1, "intersect_q_macc": len(qm.NACCS)}
    assert all(r["prim_agree"] >= 0.99 for r in rows), rows
    ops.reset_launch_counts()
    assert km.hbm_probe(card, n=1 << 20)["correct"]
    assert km.fma_roof_probe(card, rows=64)["finite"]
    km.q_probe(scene, rays)
    km.clu2_probe(*km.clu2_setup(card, 64, 5), samples=16)
    assert km.lobe_sum_probe(card, n=4096)["finite"]
    counts = ops.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        "fma_roof": 1, "intersect_q": 1, "occluded_q": 1,
        "intersect_clu2": 1, "grating_lobe_sum": 1}


def _q_agree(isect, tab, anchor, o, d, mt, n_tris):
    """B1 and B2 against their plain versions on (o, d, mt): prim and the
    flag equal on all but 1 lane in 10,000 (a ray within float rounding of
    an edge, of 0 or of maxt: the kernel contracts multiply-adds into FMAs,
    the plain version does not), as chip_smoke.py's check_q holds them;
    t, u, v where the prims agree at check_q's rtol 1e-5 (atol 1e-6 for t,
    1e-5 for u, v) on all but 1 lane in 10,000, and within rtol 1e-3 on
    every lane. These sets start rays anywhere in the box: a lane whose
    origin lies near a triangle's plane loses digits of t|det| to
    cancellation, where the FMAs move t by more than 1e-5 relative (3 of
    547,807 lanes, the largest 7e-5, on the first design of this kernel);
    check_q's path and grating rays start on surfaces or at the camera.
    Returns the kernel's closest hit and flags."""
    got = isect.intersect_q(tab, anchor, o, d, mt, n_tris)
    want = isect.intersect_q_plain(tab, anchor, o, d, mt, n_tris)
    occ = isect.occluded_q(tab, anchor, o, d, mt, n_tris)
    occ_plain = isect.occluded_q_plain(tab, anchor, o, d, mt, n_tris)
    torch.cuda.synchronize()
    same = got[1] == want[1]
    assert same.double().mean() >= 1 - 1e-4
    both = same & (want[1] >= 0)
    for a, b, atol in zip(got, want, (1e-6, 0, 1e-5, 1e-5)):
        a, b = a[both], b[both]
        close = torch.isclose(a, b, rtol=1e-5, atol=atol)
        assert close.double().mean() >= 1 - 1e-4 or not both.any()
        torch.testing.assert_close(a, b, rtol=1e-3, atol=atol)
    assert torch.isinf(got[0][got[1] < 0]).all()
    assert (occ == occ_plain).double().mean() >= 1 - 1e-4
    return got, occ


def test_q_kernels_match_plain_at_edges(card):
    """B1 and B2 (blocks looping over tiles of rays, the table staged with
    zero rows up to a multiple of kStep) against their plain versions:
    N = 1, 1,000,003 (not a multiple of any tile) and 2,097,151; n_tris 0,
    36 (the Cornell box, resident) and 4,096 (the brute cap, staged in 8
    chunks); maxt 0 and inf on some lanes, zero and NaN direction
    components on others."""
    from mitsuba3_plt_tpu_torch.ops import intersect as isect
    from mitsuba3_plt_tpu_torch.scene.presets import cornell_box
    from mitsuba3_plt_tpu_torch.scene.shape import make_sphere
    from mitsuba3_plt_tpu_torch.tools import bench_isect as bi

    scene = cornell_box(32, 32, device=card)
    g = scene.geo
    q = (g.tri_q, g.tri_anchor)
    for n in (1, 1_000_003, 2_097_151):
        o, d, mt = bi.ray_sets(scene, n, seed=n % 7)["incoherent"]
        if n == 1:  # the box's open side lets a random ray out: aim down
            d = torch.tensor([[0.0, -1.0, 0.0]], device=card)
        mt = mt.clone()
        mt[1::5] = 0.0
        mt[2::5] = torch.rand(mt[2::5].shape, device=card) * 2
        d = d.clone()
        d[3::7, 0] = 0.0
        d[4::7, 1] = 0.0
        d[5::11, 2] = float("nan")
        got, occ = _q_agree(isect, *q, o, d, mt, g.n_faces)
        assert (got[1][1::5] < 0).all() and not occ[1::5].any()
        assert (got[1][5::11] < 0).all() and not occ[5::11].any()
        assert (got[1] >= 0).double().mean() > 0.5
        none = isect.intersect_q(*q, o, d, mt, 0)
        assert (none[1] == -1).all() and torch.isinf(none[0]).all()
        assert not isect.occluded_q(*q, o, d, mt, 0).any()

    # 4,096 faces of an icosphere: a table of 8 shared stages
    mesh = make_sphere(4)
    f = mesh.faces[:4096]
    v = mesh.vertices.astype(np.float64)
    rows, anchor = isect.pack_tri_q(v[f[:, 0]], v[f[:, 1]], v[f[:, 2]])
    assert rows.shape == (4096, 16)
    tab = torch.as_tensor(rows, device=card)
    anc = torch.as_tensor(anchor, device=card)
    rng = np.random.default_rng(5)
    n = 20_000
    o = torch.as_tensor(rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32),
                        device=card)
    d = torch.as_tensor(_dirs(rng, n) * np.where(
        rng.random((n, 1)) < 0.5, 1.0, -1.0).astype(np.float32), device=card)
    mt = torch.full((n,), float("inf"), device=card)
    mt[::3] = 0.9
    got, occ = _q_agree(isect, tab, anc, o, d, mt, 4096)
    assert (got[1] >= 0).double().mean() > 0.5
    assert (got[1] >= 3584).any() and occ.any() and not occ.all()


def test_q_kernels_first_of_tied_rows_wins(card):
    """The Cornell box's table with every row repeated (rows k and k + 36
    equal): each duplicate's test is the same instructions on the same
    values, so B1 must keep the first (the strict pair compare in row
    order) and equal its answer on the table without the repeats to the
    bit, and B2 flag the same rays; N = 1,000,003 incoherent rays with
    maxt inf."""
    from mitsuba3_plt_tpu_torch.ops import intersect as isect
    from mitsuba3_plt_tpu_torch.scene.presets import cornell_box
    from mitsuba3_plt_tpu_torch.tools import bench_isect as bi

    scene = cornell_box(32, 32, device=card)
    g = scene.geo
    F = g.n_faces
    twice = torch.cat([g.tri_q[:F], g.tri_q[:F]])
    o, d, mt = bi.ray_sets(scene, 1_000_003, seed=2)["incoherent"]
    once = isect.intersect_q(g.tri_q, g.tri_anchor, o, d, mt, F)
    got = isect.intersect_q(twice, g.tri_anchor, o, d, mt, 2 * F)
    torch.cuda.synchronize()
    assert (got[1] < F).all() and (got[1] >= 0).any()
    for a, b in zip(got, once):
        assert torch.equal(a, b)
    shadow = torch.where(torch.isfinite(once[0]), once[0] * 1.01, 1.0)
    assert torch.equal(
        isect.occluded_q(twice, g.tri_anchor, o, d, shadow, 2 * F),
        isect.occluded_q(g.tri_q, g.tri_anchor, o, d, shadow, F))
