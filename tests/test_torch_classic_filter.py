"""The closest hit's filter of B8a (`ops/csrc/intersect_classic.cu`,
`candidate`) on the CPU: a float32 emulation of the kernel, every
operation rounded as there and its constants read from its source, on the
Cornell box's and a 1,280-face icosphere's bench rays, on rays aimed at
their faces' vertices and edges (u = 0, v = 0, u + v = 1) with maxt at,
one ulp above and one below the hit, and on constructed rows and rays:
u, v and u + v exactly at their bounds, det at +-1e-12 and one ulp
around it, a tiny numerator over a huge det (u = -0, a hit), two rows
tying in t, NaN and zero directions, maxt <= 0 and tiny, and the zero rows
that pad a table. The filter must keep every pair the exact test
(`_classic_terms`) accepts at the running best, and the filter with the
exact test on its candidates, in trips of the kernel's rows, must
equal `intersect_classic_plain` to the bit. The kernel runs the filter on
tables above kDenseRows rows, and takes the exact test on every pair of a
smaller one (the Cornell box's); its audit instance runs the filter on
every table. `tests/test_torch_cuda.py` holds the kernel to the plain
version on the same rays (`cases`), the tables as they are and padded
past kDenseRows."""
import functools
import os
import re

import numpy as np
import pytest
import torch

from mitsuba3_plt_tpu_torch.ops import intersect as isect
from mitsuba3_plt_tpu_torch.scene.presets import cornell_box, mesh_scene
from mitsuba3_plt_tpu_torch.tools import bench_isect as bi

CLASSIC_CU = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "mitsuba3_plt_tpu_torch", "ops", "csrc",
    "intersect_classic.cu")


@functools.cache
def constants():
    """{"kSlack", "kUnderflow", "kTinyBest", "kStep", "kChunk",
    "kDenseRows", "kBlock", "kWaves"}: the filter's constants, the row
    loop's trip and stage, the largest table the kernel runs without the
    filter, and its block and the resident grids its grid holds at most,
    read from the kernel's source."""
    with open(CLASSIC_CU) as f:
        src = f.read()
    out = {k: float.fromhex(re.search(
        rf"constexpr float {k} = (0x[0-9a-fp.+-]+)f;", src).group(1))
        for k in ("kSlack", "kUnderflow", "kTinyBest")}
    out["kStep"] = int(re.search(r"constexpr int kStep = (\d+)",
                                 src).group(1))
    out["kChunk"] = int(re.search(r"constexpr int kChunk = (\d+);",
                                  src).group(1))
    for k in ("kDenseRows", "kBlock", "kWaves"):
        out[k] = int(re.search(rf"\b{k} = (\d+)[;,]", src).group(1))
    return out


def _flip(x, sign):
    """x with its sign bit flipped where sign's is set (int32 views)."""
    return (x.view(torch.int32) ^ (sign & -2 ** 31)).view(torch.float32)


def terms(tr, o, d):
    """(det, un, vn, tn) of rows tr [L, 9] for rays o, d [..., 3] (o, d [N,
    1, 3]: [N, L]), as the kernel's classic_terms rounds them (the plain
    version's order)."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = tr[:, :9].unbind(-1)
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    return (e1x * pvx + e1y * pvy + e1z * pvz,
            tvx * pvx + tvy * pvy + tvz * pvz,
            dx * qvx + dy * qvy + dz * qvz,
            e2x * qvx + e2y * qvy + e2z * qvz)


def best_bound(t_b, c):
    """The kernel's best_bound: t_b kSlack, inf where 0 < t_b < kTinyBest."""
    return torch.where((t_b > 0) & (t_b < c["kTinyBest"]), float("inf"),
                       t_b * c["kSlack"])


def candidate(det, un, vn, tn, tb_s, c):
    """The kernel's `candidate`: det's sign folded in by its sign bit."""
    sign = det.view(torch.int32)
    ad = det.abs()
    us, vs, ts = _flip(un, sign), _flip(vn, sign), _flip(tn, sign)
    lim = ad * c["kUnderflow"]
    return ((ad > 1e-12) & (us >= -lim) & (vs >= -lim)
            & (us + vs <= ad * c["kSlack"]) & (ts > 0) & (ts <= ad * tb_s))


def emulate(tri, o, d, maxt, c=None):
    """The kernel on CPU tensors: rows in trips of kStep (zero rows padding
    the last), each trip's filter at the best as the trip starts, then the
    exact test (`_classic_terms`, strict t < best) on its candidates in
    row order, as the kernel takes them: each lane its own candidates of
    the trip, in row order, before the next trip's filter. Returns ((t, prim, u, v), {"candidates":
    pairs kept a lane, "dropped": pairs the exact test accepts at the
    running best that the filter dropped, a lane}) over n_tris = the
    table."""
    c = constants() if c is None else c
    step = c["kStep"]
    assert c["kChunk"] % step == 0  # a stage's padding only ends the table
    nt = isect._closest_rows(tri, tri.shape[0])
    rows = torch.cat([tri[:nt], tri.new_zeros(((-nt) % step, 9))])
    t_b = torch.where(torch.isfinite(maxt), maxt, isect._BIG)
    u_b, v_b = torch.zeros_like(t_b), torch.zeros_like(t_b)
    prim = torch.full(t_b.shape, -1, dtype=torch.int32)
    kept = torch.zeros(t_b.shape, dtype=torch.int64)
    dropped = torch.zeros_like(kept)
    o1, d1 = o[:, None, :], d[:, None, :]
    for base in range(0, rows.shape[0], step):
        trip = rows[base: base + step]
        # [N, kStep]: the trip's filter at the best as it starts
        cand = candidate(*terms(trip, o1, d1),
                         best_bound(t_b, c)[:, None], c)
        ok, t, u, v = isect._classic_terms(trip, o1, d1)
        kept += cand.sum(1)
        for j in range(step):
            hit = ok[:, j] & (t[:, j] < t_b)
            dropped += hit & ~cand[:, j]
            take = hit & cand[:, j]
            t_b = torch.where(take, t[:, j], t_b)
            u_b = torch.where(take, u[:, j], u_b)
            v_b = torch.where(take, v[:, j], v_b)
            prim = torch.where(take, base + j, prim)
    return ((torch.where(prim >= 0, t_b, float("inf")), prim, u_b, v_b),
            {"candidates": kept, "dropped": dropped})


def _aimed(tri, faces, off):
    """(o, d) float64: rays along each face's normal from `off` off its
    vertices p0, p0 + e1, p0 + e2 and the midpoints of its three edges (u
    or v at 0 or 1, u + v = 1), from alternate sides."""
    p0, e1, e2 = tri[faces, 0:3], tri[faces, 3:6], tri[faces, 6:9]
    p0, e1, e2 = (x.astype(np.float64) for x in (p0, e1, e2))
    targets = [p0, p0 + e1, p0 + e2, p0 + 0.5 * (e1 + e2), p0 + 0.5 * e1,
               p0 + 0.5 * e2]
    nrm = np.cross(e1, e2)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    side = np.where(np.arange(len(faces))[:, None] % 2 == 0, 1.0, -1.0)
    o = np.concatenate([p + side * off * nrm for p in targets])
    d = np.concatenate([-side * nrm] * len(targets))
    return o, d


def _at_hit(tri, o, d):
    """{label: (o, d, maxt)}: the rays with maxt inf, at their hit, one ulp
    above it and one below (1 where they miss)."""
    inf = torch.full((o.shape[0],), float("inf"))
    t = isect.intersect_classic_plain(tri, o, d, inf)[0]
    fin = torch.isfinite(t)
    at = torch.where(fin, t, 1.0)
    return {"maxt inf": (o, d, inf), "maxt at hit": (o, d, at),
            "maxt above": (o, d, torch.where(fin, torch.nextafter(t, inf),
                                             1.0)),
            "maxt below": (o, d, torch.where(fin, torch.nextafter(
                t, torch.zeros_like(t)), 1.0))}


def _scene_case(scene, rng, n_bench=1024, n_faces=256):
    """(tri [T_pad, 9], sets) of a scene: its bench rays and rays aimed at
    its faces' vertices and edges at four maxt."""
    tri = scene.geo.tri_isect.cpu()
    F = scene.geo.n_faces
    tri_np = tri[:F].numpy()
    sets = dict(bi.ray_sets(scene, n_bench, 5))
    size = float(np.ptp(tri_np[:, 0:3], 0).max())
    o, d = _aimed(tri_np, rng.integers(0, F, n_faces), 0.05 * size)
    o, d = (torch.as_tensor(x, dtype=torch.float32) for x in (o, d))
    sets.update({f"aimed {k}": v for k, v in _at_hit(tri, o, d).items()})
    return tri, sets


def _constructed():
    """(tri [64, 9], sets): constructed rows and rays. Row 0 (and its copy,
    row 1: every hit a tie, which row 0 must win) is the unit right
    triangle p0 = 0, e1 = x, e2 = y, hit along +-z at u = a, v = b exactly;
    rows 2-5 have e1 = (a, 0, 0) with det = -a at +-1e-12 and one ulp
    around it, at y = 10 k; row 6 has e1 = (-1e30, 0, 0): det = 1e30 and a
    ray with u's numerator -2^-149 hits it at u = -0; the rest are zero
    rows."""
    f32 = np.float32
    eps = f32(1e-12)
    rows = np.zeros((64, 9), f32)
    rows[0] = rows[1] = [0, 0, 0, 1, 0, 0, 0, 1, 0]
    dets = [eps, np.nextafter(eps, f32(1)), np.nextafter(eps, f32(0)),
            -np.nextafter(eps, f32(1))]
    for k, det in enumerate(dets, start=2):
        rows[k] = [0, 10 * k, 0, -det, 0, 0, 0, 1, 0]
    rows[6] = [0, 60, 0, -1e30, 0, 0, 0, 1, 0]
    o, d = [], []
    ab = [(0, 0), (1, 0), (0, 1), (0.25, 0.75), (0.5, 0.5), (0.75, 0.25),
          (0.125, 0.875), (1 - 2 ** -24, 2 ** -24), (0.3, 0.7), (0.7, 0.3),
          (0.1, 0.2), (-2 ** -149, 0.5), (0.5, -2 ** -149),
          (0.5, 0.5 + 2 ** -24), (1 + 2 ** -23, 0), (0.6, 0.4)]
    for a, b in ab:
        for side in (1.0, -1.0):
            o.append([a, b, -side])
            d.append([0, 0, side])
    for k, det in enumerate(dets, start=2):
        for side in (1.0, -1.0):
            o.append([0.25 * -det, 10 * k + 0.25, -side])
            d.append([0, 0, side])
    o.append([2.0 ** -149, 60.25, -1.0])
    d.append([0, 0, 1])
    # zero, NaN and infinite directions and a NaN origin
    for oo, dd in (([0.25, 0.25, -1], [0, 0, 0]),
                   ([0.25, 0.25, -1], [np.nan, 0, 1]),
                   ([0.25, 0.25, -1], [0, 0, np.inf]),
                   ([np.nan, 0.25, -1], [0, 0, 1])):
        o.append(oo)
        d.append(dd)
    tri = torch.as_tensor(rows)
    o, d = (torch.as_tensor(np.asarray(x, np.float64).astype(f32))
            for x in (o, d))
    sets = _at_hit(tri, o, d)
    n = o.shape[0]
    for label, mt in (("maxt 0", 0.0), ("maxt -1", -1.0),
                      ("maxt tiny", 2.0 ** -70), ("maxt nan", float("nan"))):
        sets[label] = (o, d, torch.full((n,), mt))
    return tri, sets


@functools.cache
def cases():
    """{name: (tri [T, 9] float32 CPU tensor, {label: (o, d, maxt) CPU
    tensors})}: the Cornell box, the 1,280-face icosphere and the
    constructed rows (`_constructed`)."""
    rng = np.random.default_rng(17)
    return {"cbox": _scene_case(cornell_box(8, 8, device="cpu"), rng),
            "mesh1280": _scene_case(mesh_scene(8, 8, subdiv=3,
                                               device="cpu"), rng),
            "constructed": _constructed()}


@functools.cache
def _emulated(name):
    """{label: ((got, stats), want)}: `emulate` and the plain version on
    every set of the case, run once on the sets' rays together."""
    tri, sets = cases()[name]
    o, d, mt = (torch.cat(x) for x in zip(*sets.values()))
    got, stats = emulate(tri, o, d, mt)
    want = isect.intersect_classic_plain(tri, o, d, mt)
    out, at = {}, 0
    for label, ray in sets.items():
        part = slice(at, at + ray[0].shape[0])
        at = part.stop
        out[label] = ((tuple(x[part] for x in got),
                       {k: v[part] for k, v in stats.items()}),
                      tuple(x[part] for x in want))
    return out


def _same_bits(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def test_constants_are_the_proofs():
    """The constants the filter's argument in the source needs: a slack of
    four times the error bound 2^-22, the underflow share 2^-148, the
    tiny best 2^-60; the tables the cases use are 1,280 and 36 faces, the
    first above kDenseRows (the filter's path)."""
    c = constants()
    assert c["kSlack"] == 1 + 2 ** -20
    assert c["kUnderflow"] == 2 ** -148 and c["kTinyBest"] == 2 ** -60
    assert c["kStep"] >= 1 and c["kChunk"] % c["kStep"] == 0
    tri = {k: v[0] for k, v in cases().items()}
    assert tri["mesh1280"].shape[0] >= 1280 > c["kDenseRows"]
    assert tri["cbox"].shape[0] >= 36
    assert not tri["cbox"][36:].any() and not tri["constructed"][7:].any()


@pytest.mark.parametrize("name", ["cbox", "mesh1280", "constructed"])
def test_filter_keeps_every_pair_the_exact_test_accepts(name):
    """No pair that `_classic_terms` accepts at the running best is dropped
    by the filter, on every set of the case; some pairs are candidates and
    some lanes hit."""
    for label, ((_, stats), want) in _emulated(name).items():
        assert not stats["dropped"].any(), (label, int(stats["dropped"].sum()))
        assert (stats["candidates"] >= (want[1] >= 0)).all(), label
    hits = sum(int((w[1] >= 0).sum()) for _, w in _emulated(name).values())
    assert hits > 0


@pytest.mark.parametrize("name", ["cbox", "mesh1280", "constructed"])
def test_filter_and_exact_test_equal_the_plain_version(name):
    """The filter, then the exact test on its candidates in row order,
    equals `intersect_classic_plain` to the bit (t, prim, u, v), -0 and
    all; on the bench sets the filter keeps a few pairs a ray."""
    for label, ((got, stats), want) in _emulated(name).items():
        for a, b in zip(got, want):
            assert _same_bits(a, b), label
        if label in ("coherent", "incoherent"):
            assert stats["candidates"].double().mean() <= 4, label


def test_constructed_rays_reach_the_bounds():
    """The constructed rays hit where they should: u + v = 1 exactly and u,
    v = 0 are hits, det at 1e-12 and one ulp below it never is, one ulp
    above is; the huge det's ray hits row 6 at u = -0; row 0 wins every tie
    with its copy; NaN and zero directions and maxt <= 0 miss."""
    tri, sets = cases()["constructed"]
    (t, prim, u, v), _ = _emulated("constructed")["maxt inf"][0]
    prim = prim.tolist()
    # (a, b) pairs 0-6 hit row 0 from both sides; 11, 12 (a or b = -2^-149
    # from one side) miss there
    assert all(p == 0 for p in prim[:14])
    assert prim[3 * 2] == 0 and float(u[6]) + float(v[6]) == 1.0
    k = 32  # the det rays: 1e-12, one ulp above, one below, -above
    assert prim[k: k + 8] == [-1, -1, 3, 3, -1, -1, 5, 5]
    assert prim[k + 8] == 6
    assert u[k + 8].item() == 0.0 and torch.signbit(u[k + 8]).item()
    assert prim[k + 9:] == [-1] * 4
    for label in ("maxt 0", "maxt -1", "maxt tiny", "maxt at hit"):
        assert (_emulated("constructed")[label][0][0][1] < 0).all(), label
