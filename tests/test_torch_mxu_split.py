"""The tensor-core design of B9 (`ops/csrc/intersect_mxu.cu`) on the CPU: a
plain emulation of its TF32 split, of its 3xTF32 product and of its
candidate filter, on the Cornell box's and a 1,280-face icosphere's bench
rays; and B11b's plain version against B2's with an infinite maxt taken
as -1 (the rule B11b's kernel now keeps by running B2's row test)."""
import os
import re

import numpy as np
import pytest
import torch

from mitsuba3_plt_tpu_torch.ops import intersect as isect
from mitsuba3_plt_tpu_torch.scene.presets import cornell_box, mesh_scene
from mitsuba3_plt_tpu_torch.tools import bench_isect as bi
from mitsuba3_plt_tpu_torch.tools import isect_unroll_sweep as us

MXU_CU = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "mitsuba3_plt_tpu_torch", "ops", "csrc",
    "intersect_mxu.cu")


def _slack():
    """The kernel's filter constant eps (kSlack), read from its source."""
    with open(MXU_CU) as f:
        m = re.search(r"constexpr float kSlack = (0x[0-9a-fp.+-]+)f;",
                      f.read())
    return float.fromhex(m.group(1))


def tf32(x):
    """x float32 rounded to TF32 as cvt.rna rounds it: to 10 mantissa bits,
    ties away from zero, by integer ops on the float's bits."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((b + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def split(x):
    """(big, small, small as TF32): the kernel's split, small = x - big."""
    x = np.asarray(x, np.float32)
    big = tf32(x)
    small = x - big
    return big, small, tf32(small)


def test_tf32_split_is_exact():
    """big + small == x exactly, big has at most 10 mantissa bits, and
    small and its TF32 rounding are within 2^-11 of their inputs, over
    floats from 1e-30 to 1e30 of both signs, zeros and ties."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=20000) * 10.0 ** rng.uniform(-30, 30, 20000))
    ties = np.array([1 + 2.0 ** -11, -(1 + 3 * 2.0 ** -11), 1 - 2.0 ** -12])
    x = np.concatenate([x, [0.0, -0.0, 1.0, -1.0, 3.4e38], ties])
    x = x.astype(np.float32)
    big, small, small_t = split(x)
    assert np.array_equal(big.astype(np.float64) + small.astype(np.float64),
                          x.astype(np.float64))
    assert not (big.view(np.uint32) & 0x1FFF).any()
    assert not (small_t.view(np.uint32) & 0x1FFF).any()
    assert (np.abs(small) <= 2.0 ** -11 * np.abs(x)).all()
    assert (np.abs(small_t - small) <= 2.0 ** -11 * np.abs(small)).all()
    # ties go away from zero
    assert big[-3] == np.float32(1 + 2.0 ** -10)
    assert big[-2] == np.float32(-(1 + 2 * 2.0 ** -10))


def _mxu_case(scene, n, seed, which):
    """(W [4, F, 16] float32, phi [N, 16] float32, maxt [N]) of the bench
    tool's `which` rays: the kernel's inputs."""
    F = scene.geo.n_faces
    p = scene.geo.tri_isect[:F].numpy()
    W = isect.pack_tri_mxu(p[:, 0:3], p[:, 3:6], p[:, 6:9]).reshape(4, F, 16)
    o, d, mt = bi.ray_sets(scene, n, seed)[which]
    return W, isect.mxu_features(o, d).numpy(), mt.numpy()


def _three_tf32(W, phi):
    """The 3xTF32 product of each (ray, triangle, quantity) [Q, N, F] of W
    [Q, F, 16]: small.big, big.small, big.big of each term (exact
    products), summed in the kernel's order, k-step by k-step, into an FP32
    accumulator."""
    wb, _, ws = split(W)
    pb, _, ps = split(phi)
    acc = np.zeros((W.shape[0], phi.shape[0], W.shape[1]), np.float32)
    for s in range(2):
        for a, b in ((ps, wb), (pb, ws), (pb, wb)):
            for k in range(8 * s, 8 * s + 8):
                term = a[None, :, k, None].astype(np.float64) \
                    * b[:, None, :, k].astype(np.float64)
                acc = (acc + term).astype(np.float32)
    return acc


def fmaf(a, b, c):
    """float32 fma(a, b, c) of float32 arrays, rounded once: a b is exact
    in float64 and a b + c rounds there; where that lands on a midpoint of
    two float32s (its 29 bits below float32's are 1 and zeros, or it is
    below float32's normal range), the sign of its rounding error (TwoSum)
    takes the side the exact sum lies on."""
    p = np.asarray(a, np.float32).astype(np.float64) \
        * np.asarray(b, np.float32).astype(np.float64)
    p, c = np.broadcast_arrays(p, np.asarray(c, np.float32).astype(
        np.float64))
    s = p + c
    near = (s.view(np.uint64) & 0x1FFFFFFF) == 0x10000000
    near |= (np.abs(s) < 2.0 ** -125) & (s != 0)
    if near.any():
        p, c, m = p[near], c[near], s[near]
        bb = m - p
        err = (p - (m - bb)) + (c - bb)
        r = m.astype(np.float32)
        other = np.nextafter(r, np.where(m > r, np.float32(np.inf),
                                         np.float32(-np.inf)))
        mid = (r.astype(np.float64) + other.astype(np.float64)) * 0.5
        s = s.copy()
        s[near] = np.where((m == mid) & (err != 0), np.nextafter(
            m, np.where(err > 0, np.inf, -np.inf)), m)
    return s.astype(np.float32)


def _dot16(W, phi):
    """The FP32 test's quantities [Q, N, F] of W [Q, F, 16]: dot16, 16
    fmaf in term order from 0."""
    acc = np.zeros((W.shape[0], phi.shape[0], W.shape[1]), np.float32)
    for k in range(16):
        acc = fmaf(W[:, None, :, k], phi[None, :, k, None], acc)
    return acc


def _fp32_test(q, maxt):
    """The first port's FP32 test on dot16's quantities q [4, N, F]: (hit,
    t, us, vs, inv), each [N, F]."""
    det, up, vp, tp = q
    ok = np.abs(det) > np.float32(1e-12)
    sd = np.where(det >= 0, np.float32(1), np.float32(-1))
    adet = np.abs(det)
    us, vs, ts = up * sd, vp * sd, tp * sd
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(ok, np.float32(1), np.float32(0)) / np.where(
            ok, adet, np.float32(1))
    t = (ts * inv).astype(np.float32)
    tmax = np.where(np.isfinite(maxt), maxt, np.float32(3.4e38))[:, None]
    hit = (ok & (us >= 0) & (vs >= 0) & ((us + vs) <= adet) & (ts > 0)
           & (t < tmax))
    return hit, t, us, vs, inv


def _fp32_hit(q, maxt):
    """The first port's FP32 test on dot16's quantities: [N, F] bool."""
    return _fp32_test(q, maxt)[0]


def fp32_closest(W, o, d, maxt, chunk=256):
    """B9's result by a plain emulation of the first port (numpy, sharing
    no code with the kernel; phi from the plain `mxu_features`, the
    kernel's products): for each ray, the FP32 test of every
    triangle of W [4, F, 16] on dot16's chains, the smallest t with the
    lowest triangle on ties, and u = us inv, v = vs inv of it; t inf, prim
    -1, u = v = 0 where none hits. Returns (t, prim int32, u, v)."""
    phi = isect.mxu_features(*(torch.as_tensor(np.asarray(x, np.float32))
                               for x in (o, d))).numpy()
    maxt = np.asarray(maxt, np.float32)
    outs = []
    for s in range(0, phi.shape[0], chunk):
        hit, t, us, vs, inv = _fp32_test(_dot16(W, phi[s:s + chunk]),
                                         maxt[s:s + chunk])
        t = np.where(hit, t, np.float32(np.inf))
        j = np.argmin(t, axis=1)  # the first of equal minima
        rows = np.arange(len(j))
        some = hit[rows, j]
        outs.append((np.where(some, t[rows, j], np.float32(np.inf)),
                     np.where(some, j, -1).astype(np.int32),
                     np.where(some, us[rows, j] * inv[rows, j],
                              np.float32(0)),
                     np.where(some, vs[rows, j] * inv[rows, j],
                              np.float32(0))))
    return tuple(np.concatenate(x) for x in zip(*outs))


def test_fmaf_rounds_once():
    """fmaf equals a b + c rounded once to float32 (checked exactly with
    fractions: no float32 is nearer, ties to even) on random operands and
    where a b + c lies just off a float32 midpoint by less than float64
    resolves, which a float64 sum rounded again would miss."""
    from fractions import Fraction

    rng = np.random.default_rng(8)
    a = (rng.normal(size=3000) * 10.0 ** rng.uniform(-6, 6, 3000))
    b = (rng.normal(size=3000) * 10.0 ** rng.uniform(-6, 6, 3000))
    c = -(a * b) * (1 + rng.normal(size=3000) * 10.0 ** rng.uniform(
        -9, 0, 3000))
    m = np.float32(1 + 2.0 ** -12)  # m m = 1 + 2^-11 + 2^-24, a midpoint
    tiny = np.float32(2.0 ** -80)
    a = np.concatenate([a, [m, m, -m]]).astype(np.float32)
    b = np.concatenate([b, [m, m, m]]).astype(np.float32)
    c = np.concatenate([c, [tiny, -tiny, -tiny]]).astype(np.float32)
    got = fmaf(a, b, c)
    assert got[-3] == np.float32(1 + 2.0 ** -11 + 2.0 ** -23)
    assert got[-2] == np.float32(1 + 2.0 ** -11)
    assert got[-1] == -np.float32(1 + 2.0 ** -11 + 2.0 ** -23)
    for x, y, z, r in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        err = abs(exact - Fraction(float(r)))
        for nb in (np.nextafter(r, np.float32(np.inf)),
                   np.nextafter(r, np.float32(-np.inf))):
            other = abs(exact - Fraction(float(nb)))
            assert err < other or (err == other and not (
                r.view(np.uint32) & 1))


def test_fp32_closest_keeps_the_lowest_of_equal_hits(mxu_scenes):
    """The emulation of the first port (`fp32_closest`, which the card
    tests hold B9 to) on the Cornell box's bench rays: near the plain
    version (hits and prims on >= 99% of lanes, t within rtol 1e-4 where
    the prims agree), and with every triangle given again after the
    scene's equal to the bit to the scene alone (the first copy wins)."""
    scene = mxu_scenes["cbox"]
    F = scene.geo.n_faces
    p = scene.geo.tri_isect[:F].numpy()
    W = isect.pack_tri_mxu(p[:, 0:3], p[:, 3:6], p[:, 6:9]).reshape(4, F, 16)
    for which in ("coherent", "incoherent"):
        o, d, mt = bi.ray_sets(scene, 1024, 4)[which]
        got = fp32_closest(W, o.numpy(), d.numpy(), mt.numpy())
        w = torch.as_tensor(isect.regroup_tri_mxu(W.reshape(4 * F, 16)))
        want = [x.numpy() for x in isect.intersect_mxu_plain(w, o, d, mt, F)]
        assert (got[1] == want[1]).mean() >= 0.99
        same = (got[1] == want[1]) & (got[1] >= 0)
        assert same.any()
        np.testing.assert_allclose(got[0][same], want[0][same], rtol=1e-4)
        twice = fp32_closest(np.concatenate([W, W], axis=1), o.numpy(),
                             d.numpy(), mt.numpy())
        for x, y in zip(got, twice):
            assert np.array_equal(x.view(np.uint32), y.view(np.uint32))


@pytest.fixture(scope="module")
def mxu_scenes():
    return {"cbox": cornell_box(32, 32, device="cpu"),
            "ico1280": mesh_scene(32, 32, subdiv=3, device="cpu")}


@pytest.mark.parametrize("which", ["coherent", "incoherent"])
@pytest.mark.parametrize("name", ["cbox", "ico1280"])
def test_three_tf32_filter_keeps_every_hit(mxu_scenes, name, which):
    """The emulated 3xTF32 product of u' and v' (the kernel's) differs from
    the float64 product and from the FP32 test's fmaf chain by less than
    eps |w|_1 max|phi| on every (ray, triangle), a tenth of the kernel's
    slack constant or less; and the kernel's filter (det from the chain,
    which its three non-zero terms give exactly; S1, S2, S3 of
    intersect_mxu.cu) keeps every pair that the FP32 test passes, with
    about two candidates a ray."""
    scene = mxu_scenes[name]
    W, phi, maxt = _mxu_case(scene, 1024 if name == "cbox" else 384, 5,
                             which)
    assert not W[0, :, 3:].any()  # det's row: three non-zero terms
    eps = _slack()
    three = _three_tf32(W[1:3], phi)
    exact = np.einsum("qfk,nk->qnf", W[1:3].astype(np.float64),
                      phi.astype(np.float64))
    chain = _dot16(W, phi)
    norm = np.abs(W).astype(np.float64).sum(-1)            # [4, F]
    scale = np.abs(phi).max(-1).astype(np.float64)         # [N]
    bound = norm[1:3, None, :] * scale[None, :, None]
    for ref in (exact, chain[1:3]):
        err = np.abs(three.astype(np.float64) - ref)
        assert (err <= eps / 10 * bound).all()
    # the filter, in float32 as the kernel takes it
    s1 = np.float32(eps) * norm[1].astype(np.float32)
    s2 = np.float32(eps) * norm[2].astype(np.float32)
    s3 = np.float32(1.25) * (s1 + s2)
    sc = np.abs(phi).max(-1)[:, None]
    det, U, V = chain[0], three[0], three[1]
    neg = np.signbit(det)
    us, vs = np.where(neg, -U, U), np.where(neg, -V, V)
    ad = np.abs(det)
    cand = ~((ad <= np.float32(1e-12)) | (us + s1 * sc < 0)
             | (vs + s2 * sc < 0) | (us + vs > ad + s3 * sc))
    hit = _fp32_hit(chain, maxt)
    assert hit.any()
    assert not (hit & ~cand).any()
    per_ray = cand.sum() / len(phi)
    assert hit.sum() / len(phi) <= per_ray < 4


@pytest.mark.parametrize("unroll", isect.Q_VARIANT_UNROLLS)
def test_occluded_q_variant_plain_takes_inf_as_b2s_minus_one(unroll):
    """`occluded_q_variant_plain` with maxt inf equals `occluded_q_plain`
    with maxt -1 over `q_variant_rows` rows, on the sweep's Cornell box
    rays with maxt 0.99 or 1.01 of the closest hit on alternate lanes and
    inf on every third: the function B11b's kernel now computes with B2's
    row test."""
    scene = cornell_box(16, 16, device="cpu")
    g = scene.geo
    q = (g.tri_q, g.tri_anchor)
    o, d, mt = us.sweep_rays(scene, 2048, seed=6)
    t0 = isect.intersect_q_plain(*q, o, d, mt, g.n_faces)[0]
    lane = torch.arange(t0.shape[0])
    mix = torch.where(torch.isfinite(t0),
                      t0 * torch.where(lane % 2 == 0, 0.99, 1.01), 2.0)
    mix[::3] = float("inf")
    rows = isect.q_variant_rows(g.tri_q.shape[0], g.n_faces, unroll)
    got = isect.occluded_q_variant_plain(*q, o, d, mix, g.n_faces, unroll)
    want = isect.occluded_q_plain(
        *q, o, d, torch.where(torch.isfinite(mix), mix, -1.0), rows)
    assert torch.equal(got, want)
    assert got.any() and not got[::3].any()
