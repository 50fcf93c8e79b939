"""The port's CUDA kernels against their plain PyTorch versions on a card.

Marked `cuda`: without a card these skip. On a machine with one (which has
no JAX), run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest configures JAX). This file imports no
JAX."""
import itertools

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


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
                                   "grating_sample": 8, "grating_lobe_sum": 8}


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
    from mitsuba3_plt_tpu_torch.ops import intersect as isect
    from mitsuba3_plt_tpu_torch.scene.presets import mesh_scene

    scene = mesh_scene(64, 48, subdiv=5, device=card)
    assert scene.intersect_route() == "clu2"
    cam, bounce, shadow = _mesh_rays(scene, np.random.default_rng(3), card)
    for o, d, mt in (cam, bounce):
        got = isect.intersect_clu2(scene.ctab2, o, d, mt)
        want = isect.intersect_clu2_plain(scene.ctab2, o, d, mt)
        torch.cuda.synchronize()
        assert (got[1] == want[1]).float().mean() >= 1 - 1e-3
        same = (got[1] == want[1]) & (want[1] >= 0)
        for k in (0, 2, 3):  # t, u, v
            torch.testing.assert_close(got[k][same], want[k][same],
                                       rtol=1e-5, atol=1e-6)
    # bounce rays leave the convex mesh
    assert (got[1] >= 0).float().mean() < 0.01
    for o, d, mt in (shadow, (cam[0], cam[1], torch.full_like(cam[2], 5.))):
        occ = isect.occluded_clu2(scene.ctab2, o, d, mt)
        occ_plain = isect.occluded_clu2_plain(scene.ctab2, o, d, mt)
        torch.cuda.synchronize()
        assert (occ == occ_plain).float().mean() >= 1 - 1e-3
        assert 0.05 < occ_plain.float().mean() < 0.95


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
                                   "grating_sample": 0, "grating_lobe_sum": 0}


def test_bvh_kernels_match_plain(card):
    """B7 against its plain walk, to the bit: camera, bounce-like and shadow
    rays, unsorted and through the route's coherence sort."""
    from mitsuba3_plt_tpu_torch.librender.records import Ray
    from mitsuba3_plt_tpu_torch.ops import intersect as isect
    from mitsuba3_plt_tpu_torch.scene.presets import mesh_scene

    scene = mesh_scene(64, 48, subdiv=5, accel="packet", device=card)
    assert scene.intersect_route() == "packet"
    pb = scene.pbvh
    cam, bounce, shadow = _mesh_rays(scene, np.random.default_rng(3), card)
    # the camera rays once more with a finite maxt past the near surface
    for o, d, mt in (cam, bounce, (cam[0], cam[1],
                                   torch.full_like(cam[2], 3.5))):
        got = isect.intersect_bvh(pb, o, d, mt)
        want = isect.intersect_bvh_plain(pb, o, d, mt)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1])
        for k in (0, 2, 3):  # t, u, v
            assert torch.equal(got[k], want[k])
    assert (got[1] >= 0).float().mean() > 0.1
    for o, d, mt in (shadow, (cam[0], cam[1], torch.full_like(cam[2], 5.))):
        occ = isect.occluded_bvh(pb, o, d, mt)
        assert torch.equal(occ, isect.occluded_bvh_plain(pb, o, d, mt))
        assert 0.05 < occ.float().mean() < 0.95
    # the route sorts, launches and unsorts
    si = scene.ray_intersect(Ray.create(cam[0], cam[1]))
    assert torch.equal(si.prim_idx, isect.intersect_bvh(pb, *cam)[1])
    o, d, mt = shadow
    assert torch.equal(scene.ray_test(Ray(o=o, d=d, maxt=mt)),
                       isect.occluded_bvh(pb, o, d, mt))


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


def test_q_variant_kernels_match_plain(card):
    """B11a at every unroll, with one and two accumulators, and B11b at
    every unroll equal their plain versions to the bit on the sweep's rays
    (maxt inf; for the any hit 0.99 or 1.01 of B1's t on alternate lanes,
    inf on every third)."""
    from mitsuba3_plt_tpu_torch.ops import intersect as isect
    from mitsuba3_plt_tpu_torch.tools import isect_unroll_sweep as us

    for scene in _tool_scenes(card):
        g = scene.geo
        q = (g.tri_q, g.tri_anchor)
        o, d, mt = us.sweep_rays(scene, 8192, seed=4)
        t0 = isect.intersect_q(*q, o, d, mt, g.n_faces)[0]
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
                want = plain[rows, dual]
                torch.cuda.synchronize()
                assert all(torch.equal(a, b) for a, b in zip(got, want)), \
                    (unroll, dual)
            occ = isect.occluded_q_variant(*q, o, d, msh, g.n_faces, unroll)
            if rows not in plain:
                plain[rows] = isect.occluded_q_variant_plain(
                    *q, o, d, msh, g.n_faces, unroll)
            assert torch.equal(occ, plain[rows]), unroll
            assert occ.any() and not occ[::3].any()


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
    """B11c at nacc 2, 4 and 8 equals its plain version to the bit (t,
    prim, u, v) on the sweep's rays of both tool scenes, with maxt inf and
    on every fifth lane 0.5; at nacc 2 it answers as B11a's two
    accumulators do."""
    from mitsuba3_plt_tpu_torch.ops import intersect as isect
    from mitsuba3_plt_tpu_torch.tools import isect_unroll_sweep as us

    for scene in _tool_scenes(card):
        g = scene.geo
        q = (g.tri_q, g.tri_anchor)
        o, d, mt = us.sweep_rays(scene, 8192, seed=6)
        mt[::5] = 0.5
        for nacc in isect.Q_MACC_NACCS:
            got = isect.intersect_q_macc(*q, o, d, mt, g.n_faces, nacc)
            want = isect.intersect_q_macc_plain(*q, o, d, mt, g.n_faces,
                                                nacc)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, want)), nacc
            assert (got[1] >= 0).any() and (got[1] < 0).any()
            if nacc == 2:
                dual = isect.intersect_q_variant(*q, o, d, mt, g.n_faces,
                                                 16, True)
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
