"""Closest-hit and any-hit ray/triangle queries: brute force over the
precomputed-quantities ("q") triangle table (`csrc/intersect_q.cu`, and
its unroll-sweep and multi-accumulator variants in
`csrc/intersect_sweep.cu`), over the classic
(p0, e1, e2) soup (`csrc/intersect_classic.cu`) and as one product of ray
features with a weight table (`csrc/intersect_mxu.cu`), the treelet walks
over a flat ClusterTable (`csrc/intersect_clu.cu`) and a two-level
ClusterTable2 (`csrc/intersect_clu2.cu`), the per-ray skip-link walk over a
PacketBVH (`csrc/intersect_bvh.cu`), their plain PyTorch versions, and the
host-side q and MXU table packers.

Möller-Trumbore re-associated around per-triangle constants so the
triangle loop does no cross product and no division:
    det = -d.n2,  u*det = (o x d).e2 + d.m2,  v*det = -[(o x d).e1 + d.m1],
    t*det = o.n2 - k,
with rays and triangles relative to a scene anchor (the geometry's AABB
centre) for float32 conditioning.
"""
from __future__ import annotations

import numpy as np
import torch

from ._check import check_tensors

INTERSECT_Q_LAUNCHES = 0
OCCLUDED_Q_LAUNCHES = 0
INTERSECT_CLU2_LAUNCHES = 0
OCCLUDED_CLU2_LAUNCHES = 0
INTERSECT_BVH_LAUNCHES = 0
OCCLUDED_BVH_LAUNCHES = 0
INTERSECT_CLASSIC_LAUNCHES = 0
OCCLUDED_CLASSIC_LAUNCHES = 0
INTERSECT_MXU_LAUNCHES = 0
INTERSECT_CLU_LAUNCHES = 0
OCCLUDED_CLU_LAUNCHES = 0
INTERSECT_Q_VARIANT_LAUNCHES = 0
OCCLUDED_Q_VARIANT_LAUNCHES = 0
INTERSECT_Q_MACC_LAUNCHES = 0

# Möller-Trumbore needs |det| above this to count a hit
_DET_EPS = 1e-12
# an infinite maxt is carried as this finite bound
_BIG = 3.4e38


def pack_tri_q(p0, p1, p2, anchor=None):
    """Host-side: [T, 3] vertex arrays -> ([T_pad, 16] rows, anchor [3]).

    Rows: e1(3) e2(3) m1(3) m2(3) n2(3) k(1), with m1 = a0 x e1,
    m2 = a0 x e2, n2 = e1 x e2, k = a0 . n2 and a0 = p0 - anchor, built in
    float64 and stored as float32. Zero rows pad T to a multiple of 64
    (n2 = 0 -> det = 0 -> never hit)."""
    p0 = np.asarray(p0, np.float64).reshape(-1, 3)
    p1 = np.asarray(p1, np.float64).reshape(-1, 3)
    p2 = np.asarray(p2, np.float64).reshape(-1, 3)
    if anchor is None:
        if p0.shape[0] == 0:
            anchor = np.zeros(3)
        else:
            lo = np.minimum(p0.min(0), np.minimum(p1.min(0), p2.min(0)))
            hi = np.maximum(p0.max(0), np.maximum(p1.max(0), p2.max(0)))
            anchor = (lo + hi) * 0.5
    a0 = p0 - anchor
    e1 = p1 - p0
    e2 = p2 - p0
    n2 = np.cross(e1, e2)
    m1 = np.cross(a0, e1)
    m2 = np.cross(a0, e2)
    k = np.einsum("ij,ij->i", a0, n2)
    rows = np.concatenate([e1, e2, m1, m2, n2, k[:, None]], axis=-1)
    pad = (-rows.shape[0]) % 64
    rows = np.concatenate([rows, np.zeros((pad, 16))], axis=0)
    return rows.astype(np.float32), np.asarray(anchor, np.float32)


def _check(name, tri_q, anchor, o, d, maxt, n_tris):
    dev, n = check_tensors(name, {
        "o": (o, torch.float32, (3,)), "d": (d, torch.float32, (3,)),
        "maxt": (maxt, torch.float32, ()), "tri_q": (tri_q, torch.float32,
                                                     None),
        "anchor": (anchor, torch.float32, None),
    }, n=o.shape[0] if o.dim() == 2 else -1)
    if tri_q.dim() != 2 or tri_q.shape[1] != 16:
        raise ValueError(f"{name}: tri_q must be [T, 16], got {tuple(tri_q.shape)}")
    if tuple(anchor.shape) != (3,):
        raise ValueError(f"{name}: anchor must be [3]")
    n_tris = tri_q.shape[0] if n_tris is None else int(n_tris)
    if not 0 <= n_tris <= tri_q.shape[0]:
        raise ValueError(f"{name}: n_tris {n_tris} outside the table")
    return dev, n, n_tris


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _ray_terms(anchor, o, d, maxt):
    o = o - anchor
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    c = (oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx)
    mt = torch.where(torch.isfinite(maxt), maxt, _BIG)
    return (ox, oy, oz), (dx, dy, dz), c, mt


def _q_terms(tr, o, d, c):
    """(|det|, u|det|, v|det|, t|det|, inside) of one table row."""
    (ox, oy, oz), (dx, dy, dz), (cx, cy, cz) = o, d, c
    det = -(dx * tr[12] + dy * tr[13] + dz * tr[14])
    up = (cx * tr[3] + cy * tr[4] + cz * tr[5]
          + dx * tr[9] + dy * tr[10] + dz * tr[11])
    vp = -(cx * tr[0] + cy * tr[1] + cz * tr[2]
           + dx * tr[6] + dy * tr[7] + dz * tr[8])
    tp = ox * tr[12] + oy * tr[13] + oz * tr[14] - tr[15]
    s = torch.where(det >= 0.0, 1.0, -1.0)
    ad, us, vs, ts = det * s, up * s, vp * s, tp * s
    inside = ((ad > _DET_EPS) & (us >= 0.0) & (vs >= 0.0)
              & (ad - us - vs >= 0.0) & (ts > 0.0))
    return ad, us, vs, ts, inside


def _q_best(tri_q, rows, o3, d3, c, mt):
    """(t|det|, |det|, u|det|, v|det|, prim) of the nearest of the table
    `rows`, taken in their order with the strict-less pair comparison, so
    the first of two tied rows wins; (mt, 1, 0, 0, -1) on a miss."""
    ts_b = mt
    ad_b = torch.ones_like(mt)
    us_b = torch.zeros_like(mt)
    vs_b = torch.zeros_like(mt)
    prim = torch.full(mt.shape, -1, dtype=torch.int32, device=mt.device)
    for ti in rows:
        ad, us, vs, ts, inside = _q_terms(tri_q[ti], o3, d3, c)
        hit = inside & (ts * ad_b < ts_b * ad)
        ts_b = torch.where(hit, ts, ts_b)
        ad_b = torch.where(hit, ad, ad_b)
        us_b = torch.where(hit, us, us_b)
        vs_b = torch.where(hit, vs, vs_b)
        prim = torch.where(hit, ti, prim)
    return ts_b, ad_b, us_b, vs_b, prim


def intersect_q_plain(tri_q, anchor, o, d, maxt, n_tris=None):
    """Plain version of `intersect_q`: rows in order, strict-less pair
    comparison, so the first of two tied rows wins."""
    n_tris = tri_q.shape[0] if n_tris is None else n_tris
    ts_b, ad_b, us_b, vs_b, prim = _q_best(
        tri_q, range(n_tris), *_ray_terms(anchor, o, d, maxt))
    inv = 1.0 / ad_b
    t = torch.where(prim >= 0, ts_b * inv, float("inf"))
    return t, prim, us_b * inv, vs_b * inv


def occluded_q_plain(tri_q, anchor, o, d, maxt, n_tris=None):
    """Plain version of `occluded_q`: any row with 0 < t < maxt."""
    n_tris = tri_q.shape[0] if n_tris is None else n_tris
    o3, d3, c, mt = _ray_terms(anchor, o, d, maxt)
    occ = torch.zeros(mt.shape, dtype=torch.bool, device=mt.device)
    for ti in range(n_tris):
        ad, _, _, ts, inside = _q_terms(tri_q[ti], o3, d3, c)
        occ = occ | (inside & (ts < mt * ad))
    return occ


def _classic_terms(tr, o, d):
    """(ok, t, u, v) of classic Moeller-Trumbore on table rows tr [L, >= 9]
    (p0, e1, e2; L = 1 broadcasts one row over the rays), every product and
    sum rounded on its own, left to right, and the division folded into
    inv_det = [ok] / det."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = tr[:, :9].unbind(-1)
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = det.abs() > _DET_EPS
    inv_det = torch.where(ok, 1.0, 0.0) / torch.where(ok, det, 1.0)
    tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    ok = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    return ok, t, u, v


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def intersect_q(tri_q, anchor, o, d, maxt, n_tris=None):
    """Closest hit over the first n_tris rows of the pack_tri_q table.

    o, d [N, 3], maxt [N] float32. Returns (t [N], prim [N] int32 (-1 on a
    miss), u [N], v [N]); t is inf on a miss. CPU tensors run the plain
    version; CUDA tensors launch the kernel."""
    global INTERSECT_Q_LAUNCHES
    dev, n, n_tris = _check("intersect_q", tri_q, anchor, o, d, maxt, n_tris)
    if dev.type == "cpu":
        return intersect_q_plain(tri_q, anchor, o, d, maxt, n_tris)
    from .build import check, load_library

    lib = load_library()
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    u = torch.empty((n,), dtype=torch.float32, device=dev)
    v = torch.empty((n,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(lib.plt_intersect_q(
        tri_q.data_ptr(), n_tris, anchor.data_ptr(), o.data_ptr(),
        d.data_ptr(), maxt.data_ptr(), n, t.data_ptr(), prim.data_ptr(),
        u.data_ptr(), v.data_ptr(), stream), "intersect_q")
    INTERSECT_Q_LAUNCHES += 1
    return t, prim, u, v


def occluded_q(tri_q, anchor, o, d, maxt, n_tris=None):
    """Any hit with 0 < t < maxt over the first n_tris rows: [N] bool."""
    global OCCLUDED_Q_LAUNCHES
    dev, n, n_tris = _check("occluded_q", tri_q, anchor, o, d, maxt, n_tris)
    if dev.type == "cpu":
        return occluded_q_plain(tri_q, anchor, o, d, maxt, n_tris)
    from .build import check, load_library

    lib = load_library()
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(lib.plt_occluded_q(
        tri_q.data_ptr(), n_tris, anchor.data_ptr(), o.data_ptr(),
        d.data_ptr(), maxt.data_ptr(), n, occ.data_ptr(), stream),
        "occluded_q")
    OCCLUDED_Q_LAUNCHES += 1
    return occ


# ---------------------------------------------------------------------------
# the q brute force of the unroll sweep (tools/isect_unroll_sweep.py): a
# row loop unrolled UNROLL deep, optionally with two accumulators
# ---------------------------------------------------------------------------

Q_VARIANT_UNROLLS = (2, 8, 16, 32)  # the depths the kernels are built for


def q_variant_rows(n_rows, n_tris, unroll):
    """Rows the sweep's kernels run: n_tris rounded up to a multiple of
    `unroll`, capped at the largest such multiple within the table's n_rows
    rows (the JAX tool's rule); rows past the scene's are zero (never
    hit)."""
    return min(-(-n_tris // unroll) * unroll, n_rows - n_rows % unroll)


def _check_variant(name, tri_q, anchor, o, d, maxt, n_tris, unroll):
    dev, n, n_tris = _check(name, tri_q, anchor, o, d, maxt, n_tris)
    if unroll not in Q_VARIANT_UNROLLS:
        raise ValueError(f"{name}: unroll {unroll} not in "
                         f"{Q_VARIANT_UNROLLS}")
    return dev, n, q_variant_rows(tri_q.shape[0], n_tris, unroll)


def _q_groups(tri_q, rows, nacc, o3, d3, c, mt):
    """`_q_best` of `rows` rows split into nacc groups (row r in group
    r % nacc), merged in order 1..nacc-1 into group 0: group g is taken
    where it hit and group 0 missed or ts_g |det|0 < ts0 |det|g, so an
    exact tie across groups goes to the lower group."""
    return _merge_groups([_q_best(tri_q, range(g, rows, nacc), o3, d3, c, mt)
                          for g in range(nacc)])


def _merge_groups(groups):
    """`_q_groups`' merge of its groups' (ts, |det|, us, vs, prim)."""
    ts_b, ad_b, us_b, vs_b, prim = groups[0]
    for ts2, ad2, us2, vs2, p2 in groups[1:]:
        win = (p2 >= 0) & ((prim < 0) | (ts2 * ad_b < ts_b * ad2))
        ts_b = torch.where(win, ts2, ts_b)
        ad_b = torch.where(win, ad2, ad_b)
        us_b = torch.where(win, us2, us_b)
        vs_b = torch.where(win, vs2, vs_b)
        prim = torch.where(win, p2, prim)
    return ts_b, ad_b, us_b, vs_b, prim


def intersect_q_variant_plain(tri_q, anchor, o, d, maxt, n_tris, unroll=2,
                              dual=False):
    """Plain version of `intersect_q_variant`: `intersect_q_plain` over the
    rounded row count; with `dual`, the even and the odd rows in two groups
    merged as `_q_groups` merges them. The JAX tool's merge,
    ts2 |det|1 < ts1 |det|2 with no test of which group hit, is the same
    wherever no group's best hit lies within rounding of maxt: a group that
    reached its best through more than one update can fail ts |det|0 <
    maxt |det| against a group that missed (a rounded compare is not
    transitive), and there the JAX merge drops the hit where this one keeps
    it (`tests/test_torch_macc.py::test_dual_merge_differs_only_at_maxt`)."""
    rows = q_variant_rows(tri_q.shape[0], n_tris, unroll)
    ts_b, ad_b, _, _, prim = _q_groups(tri_q, rows, 2 if dual else 1,
                                       *_ray_terms(anchor, o, d, maxt))
    return torch.where(prim >= 0, ts_b * (1.0 / ad_b), float("inf")), prim


def occluded_q_variant_plain(tri_q, anchor, o, d, maxt, n_tris, unroll=2):
    """Plain version of `occluded_q_variant`: `occluded_q_plain` over the
    rounded row count, with an infinite maxt taken as -1 (never
    occluded)."""
    rows = q_variant_rows(tri_q.shape[0], n_tris, unroll)
    mt = torch.where(torch.isfinite(maxt), maxt, -1.0)
    return occluded_q_plain(tri_q, anchor, o, d, mt, rows)


def intersect_q_variant(tri_q, anchor, o, d, maxt, n_tris, unroll=2,
                        dual=False):
    """Closest hit over the q table with the row loop unrolled `unroll`
    deep (one of Q_VARIANT_UNROLLS) and, with `dual`, two accumulators
    (even and odd rows) merged at the end; the rows run are
    `q_variant_rows`. Returns (t [N], prim [N] int32), t inf on a miss.
    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    global INTERSECT_Q_VARIANT_LAUNCHES
    dev, n, rows = _check_variant("intersect_q_variant", tri_q, anchor, o,
                                  d, maxt, n_tris, unroll)
    if dev.type == "cpu":
        return intersect_q_variant_plain(tri_q, anchor, o, d, maxt, n_tris,
                                         unroll, dual)
    from .build import check, load_library

    lib = load_library()
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(lib.plt_intersect_q_variant(
        tri_q.data_ptr(), rows, anchor.data_ptr(), o.data_ptr(),
        d.data_ptr(), maxt.data_ptr(), n, t.data_ptr(), prim.data_ptr(),
        unroll, int(bool(dual)), stream), "intersect_q_variant")
    INTERSECT_Q_VARIANT_LAUNCHES += 1
    return t, prim


def occluded_q_variant(tri_q, anchor, o, d, maxt, n_tris, unroll=2):
    """Any hit with 0 < t < maxt over the q table, the row loop unrolled
    `unroll` deep: [N] bool. An infinite maxt is taken as -1, so such a
    lane is never occluded (the JAX tool's rule; `occluded_q` takes it as
    3.4e38)."""
    global OCCLUDED_Q_VARIANT_LAUNCHES
    dev, n, rows = _check_variant("occluded_q_variant", tri_q, anchor, o, d,
                                  maxt, n_tris, unroll)
    if dev.type == "cpu":
        return occluded_q_variant_plain(tri_q, anchor, o, d, maxt, n_tris,
                                        unroll)
    from .build import check, load_library

    lib = load_library()
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(lib.plt_occluded_q_variant(
        tri_q.data_ptr(), rows, anchor.data_ptr(), o.data_ptr(),
        d.data_ptr(), maxt.data_ptr(), n, occ.data_ptr(), unroll, stream),
        "occluded_q_variant")
    OCCLUDED_Q_VARIANT_LAUNCHES += 1
    return occ


# ---------------------------------------------------------------------------
# the multi-accumulator q closest hit (tools/isect_q_multiacc.py): the row
# loop unrolled Q_MACC_UNROLL deep, row r updating group r % nacc
# ---------------------------------------------------------------------------

Q_MACC_UNROLL = 16        # the JAX tool's UNROLL
Q_MACC_NACCS = (2, 4, 8)  # the group counts the kernel is built for


def intersect_q_macc_plain(tri_q, anchor, o, d, maxt, n_tris, nacc):
    """Plain version of `intersect_q_macc`: the rounded row count in nacc
    groups (`_q_groups`), t, u and v as the pairs times 1/|det|."""
    rows = q_variant_rows(tri_q.shape[0], n_tris, Q_MACC_UNROLL)
    ts_b, ad_b, us_b, vs_b, prim = _q_groups(
        tri_q, rows, nacc, *_ray_terms(anchor, o, d, maxt))
    inv = 1.0 / ad_b
    t = torch.where(prim >= 0, ts_b * inv, float("inf"))
    return t, prim, us_b * inv, vs_b * inv


def intersect_q_macc(tri_q, anchor, o, d, maxt, n_tris, nacc):
    """Closest hit over the q table with nacc (one of Q_MACC_NACCS)
    accumulator groups, row r updating group r % nacc, merged at the end
    (an exact tie across groups goes to the lower group); the rows run are
    `q_variant_rows(T, n_tris, 16)`. Returns (t [N], prim [N] int32, u [N],
    v [N]), t inf on a miss. CPU tensors run the plain version; CUDA
    tensors launch the kernel."""
    global INTERSECT_Q_MACC_LAUNCHES
    dev, n, rows = _check_variant("intersect_q_macc", tri_q, anchor, o, d,
                                  maxt, n_tris, Q_MACC_UNROLL)
    if nacc not in Q_MACC_NACCS:
        raise ValueError(f"intersect_q_macc: nacc {nacc} not in "
                         f"{Q_MACC_NACCS}")
    if dev.type == "cpu":
        return intersect_q_macc_plain(tri_q, anchor, o, d, maxt, n_tris,
                                      nacc)
    from .build import check, load_library

    lib = load_library()
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    u = torch.empty((n,), dtype=torch.float32, device=dev)
    v = torch.empty((n,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(lib.plt_intersect_q_macc(
        tri_q.data_ptr(), rows, anchor.data_ptr(), o.data_ptr(),
        d.data_ptr(), maxt.data_ptr(), n, t.data_ptr(), prim.data_ptr(),
        u.data_ptr(), v.data_ptr(), nacc, stream), "intersect_q_macc")
    INTERSECT_Q_MACC_LAUNCHES += 1
    return t, prim, u, v


# ---------------------------------------------------------------------------
# classic brute force over the (p0, e1, e2) soup (Geometry.tri_isect)
# ---------------------------------------------------------------------------

def _check_classic(name, tri, o, d, maxt, n_tris):
    dev, n = check_tensors(name, {
        "o": (o, torch.float32, (3,)), "d": (d, torch.float32, (3,)),
        "maxt": (maxt, torch.float32, ()), "tri": (tri, torch.float32, None),
    }, n=o.shape[0] if o.dim() == 2 else -1)
    if tri.dim() != 2 or tri.shape[1] != 9:
        raise ValueError(f"{name}: tri must be [T, 9], got {tuple(tri.shape)}")
    n_tris = tri.shape[0] if n_tris is None else int(n_tris)
    if not 0 <= n_tris <= tri.shape[0]:
        raise ValueError(f"{name}: n_tris {n_tris} outside the table")
    return dev, n, n_tris


def _closest_rows(tri, n_tris):
    """Rows the closest-hit loop runs: n_tris rounded up to even (the TPU
    kernel takes two triangles a step), capped at the table."""
    return min(n_tris + n_tris % 2, tri.shape[0])


def intersect_classic_plain(tri, o, d, maxt, n_tris=None):
    """Plain version of `intersect_classic`: rows in order, the kernel's
    arithmetic (`_classic_terms`), strict t < best."""
    n_tris = _closest_rows(tri, tri.shape[0] if n_tris is None else n_tris)
    t_b = torch.where(torch.isfinite(maxt), maxt, _BIG)
    u_b = torch.zeros_like(t_b)
    v_b = torch.zeros_like(t_b)
    prim = torch.full(t_b.shape, -1, dtype=torch.int32, device=t_b.device)
    for ti in range(n_tris):
        ok, t, u, v = _classic_terms(tri[ti: ti + 1], o, d)
        hit = ok & (t < t_b)
        t_b = torch.where(hit, t, t_b)
        u_b = torch.where(hit, u, u_b)
        v_b = torch.where(hit, v, v_b)
        prim = torch.where(hit, ti, prim)
    return torch.where(prim >= 0, t_b, float("inf")), prim, u_b, v_b


def occluded_classic_plain(tri, o, d, maxt, n_tris=None, counts=None):
    """Plain version of `occluded_classic`: any row with 0 < t < maxt.
    `counts` (a dict, or None) accumulates the triangle tests a kernel
    thread makes, each up to its first hit."""
    n_tris = tri.shape[0] if n_tris is None else n_tris
    mt = torch.where(torch.isfinite(maxt), maxt, _BIG)
    occ = torch.zeros(mt.shape, dtype=torch.bool, device=mt.device)
    tests = 0
    for ti in range(n_tris):
        if counts is not None:
            tests += int((~occ).sum())
        ok, t, _, _ = _classic_terms(tri[ti: ti + 1], o, d)
        occ = occ | (ok & (t < mt))
    if counts is not None:
        counts["triangle_tests"] = counts.get("triangle_tests", 0) + tests
    return occ


def intersect_classic(tri, o, d, maxt, n_tris=None):
    """Closest hit over the first n_tris rows of tri [T, 9] (p0, e1, e2).

    o, d [N, 3], maxt [N] float32. Returns (t [N], prim [N] int32 (-1 on a
    miss), u [N], v [N]); t is inf and u = v = 0 on a miss. CPU tensors run
    the plain version; CUDA tensors launch the kernel."""
    global INTERSECT_CLASSIC_LAUNCHES
    dev, n, n_tris = _check_classic("intersect_classic", tri, o, d, maxt,
                                    n_tris)
    if dev.type == "cpu":
        return intersect_classic_plain(tri, o, d, maxt, n_tris)
    from .build import check, load_library

    lib = load_library()
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    u = torch.empty((n,), dtype=torch.float32, device=dev)
    v = torch.empty((n,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(lib.plt_intersect_classic(
        tri.data_ptr(), _closest_rows(tri, n_tris), o.data_ptr(),
        d.data_ptr(), maxt.data_ptr(), n, t.data_ptr(), prim.data_ptr(),
        u.data_ptr(), v.data_ptr(), stream), "intersect_classic")
    INTERSECT_CLASSIC_LAUNCHES += 1
    return t, prim, u, v


def occluded_classic(tri, o, d, maxt, n_tris=None):
    """Any hit with 0 < t < maxt over the first n_tris rows: [N] bool."""
    global OCCLUDED_CLASSIC_LAUNCHES
    dev, n, n_tris = _check_classic("occluded_classic", tri, o, d, maxt,
                                    n_tris)
    if dev.type == "cpu":
        return occluded_classic_plain(tri, o, d, maxt, n_tris)
    from .build import check, load_library

    lib = load_library()
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(lib.plt_occluded_classic(
        tri.data_ptr(), n_tris, o.data_ptr(), d.data_ptr(), maxt.data_ptr(),
        n, occ.data_ptr(), stream), "occluded_classic")
    OCCLUDED_CLASSIC_LAUNCHES += 1
    return occ


# ---------------------------------------------------------------------------
# the soup as one product: U = W phi (the TPU's MXU formulation)
#
# Moller-Trumbore's four quantities are affine in the ray features
# phi = [d(3), o(3), vec(d o^T)(9), 1]:
#   det = -d . n2,  u det = d^T [e2]x o - d . (e2 x p0),
#   v det = -d^T [e1]x o + d . (e1 x p0),  t det = o . n2 - p0 . n2,
# with n2 = e1 x e2, so each triangle is four rows of W [4 T_pad, 16].
# ---------------------------------------------------------------------------

MXU_ALIGN = 128  # T_pad is a multiple of this (the TPU's MXU tile)
MXU_CHUNK = 65536  # rays per product in the plain version


def pack_tri_mxu(p0, e1, e2):
    """Host-side: W [4 T, 16] float32, rows grouped [det | u' | v' | t'],
    built in float64 (the JAX package's `pack_tri_mxu`)."""
    p0 = np.asarray(p0, np.float64)
    e1 = np.asarray(e1, np.float64)
    e2 = np.asarray(e2, np.float64)
    T = p0.shape[0]
    n2 = np.cross(e1, e2)

    def cross_mat(v):  # [T, 3, 3] with M @ o = v x o
        z = np.zeros(T)
        return np.stack([np.stack([z, -v[:, 2], v[:, 1]], -1),
                         np.stack([v[:, 2], z, -v[:, 0]], -1),
                         np.stack([-v[:, 1], v[:, 0], z], -1)], -2)

    W = np.zeros((T, 4, 16), np.float64)
    W[:, 0, 0:3] = -n2
    W[:, 1, 0:3] = -np.cross(e2, p0)
    W[:, 1, 6:15] = cross_mat(e2).reshape(T, 9)  # d_i o_k coefficient
    W[:, 2, 0:3] = np.cross(e1, p0)
    W[:, 2, 6:15] = -cross_mat(e1).reshape(T, 9)
    W[:, 3, 3:6] = n2
    W[:, 3, 15] = -np.einsum("ij,ij->i", p0, n2)
    Wg = np.concatenate([W[:, 0], W[:, 1], W[:, 2], W[:, 3]], axis=0)
    return np.ascontiguousarray(Wg.astype(np.float32))


def regroup_tri_mxu(wg, align=MXU_ALIGN):
    """[4 T, 16] -> [4 T_pad, 16]: each of the four row groups padded with
    zero rows to T_pad, the next multiple of `align` (zero rows: det = 0,
    never a hit)."""
    wg = np.asarray(wg, np.float32)
    T = wg.shape[0] // 4
    t_pad = -(-T // align) * align
    out = np.zeros((4 * t_pad, 16), np.float32)
    for c in range(4):
        out[c * t_pad: c * t_pad + T] = wg[c * T: (c + 1) * T]
    return out


def _check_mxu(name, tri_mxu, o, d, maxt, n_tris):
    dev, n = check_tensors(name, {
        "o": (o, torch.float32, (3,)), "d": (d, torch.float32, (3,)),
        "maxt": (maxt, torch.float32, ()),
        "tri_mxu": (tri_mxu, torch.float32, None),
    }, n=o.shape[0] if o.dim() == 2 else -1)
    if (tri_mxu.dim() != 2 or tri_mxu.shape[1] != 16
            or tri_mxu.shape[0] % 4):
        raise ValueError(f"{name}: tri_mxu must be [4 T_pad, 16], got "
                         f"{tuple(tri_mxu.shape)}")
    t_pad = tri_mxu.shape[0] // 4
    n_tris = t_pad if n_tris is None else int(n_tris)
    if not 0 <= n_tris <= t_pad:
        raise ValueError(f"{name}: n_tris {n_tris} outside the table")
    return dev, n, n_tris


def mxu_features(o, d):
    """phi [N, 16] = (d, o, dx o, dy o, dz o, 1)."""
    return torch.cat([d, o, d[:, 0:1] * o, d[:, 1:2] * o, d[:, 2:3] * o,
                      torch.ones_like(o[:, :1])], dim=1)


def intersect_mxu_plain(tri_mxu, o, d, maxt, n_tris=None):
    """Plain version of `intersect_mxu`: U = phi W^T by `torch.matmul` in
    full float32 (TF32 off) over the first n_tris rows of each group,
    MXU_CHUNK rays at a time, then the kernel's sign logic and `torch.min`
    (the first index among equal minima)."""
    t_pad, chunk = tri_mxu.shape[0] // 4, MXU_CHUNK
    n_tris = t_pad if n_tris is None else n_tris
    rows = tri_mxu.reshape(4, t_pad, 16)[:, :n_tris].reshape(4 * n_tris, 16)
    mt = torch.where(torch.isfinite(maxt), maxt, _BIG)
    if n_tris == 0:
        z = torch.zeros_like(mt)
        return (torch.full_like(mt, float("inf")),
                torch.full(mt.shape, -1, dtype=torch.int32, device=mt.device),
                z, z.clone())
    outs = []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for s in range(0, o.shape[0], chunk):
            mt_c = mt[s: s + chunk, None]
            U = torch.matmul(mxu_features(o[s: s + chunk], d[s: s + chunk]),
                             rows.T)
            det, up, vp, tp = U.split(n_tris, dim=1)
            ok = det.abs() > _DET_EPS
            sd = torch.where(det >= 0.0, 1.0, -1.0)
            adet = det.abs()
            us, vs, ts = up * sd, vp * sd, tp * sd
            inv = torch.where(ok, 1.0, 0.0) / torch.where(ok, adet, 1.0)
            t = ts * inv
            hit = (ok & (us >= 0.0) & (vs >= 0.0) & (us + vs <= adet)
                   & (ts > 0.0) & (t < mt_c))
            t_best, best = torch.where(hit, t, _BIG).min(dim=1)
            found = t_best < mt_c[:, 0]
            pick = lambda x: x.gather(1, best[:, None])[:, 0]  # noqa: E731
            outs.append((
                torch.where(found, t_best, float("inf")),
                torch.where(found, best, -1).to(torch.int32),
                torch.where(found, pick(us) * pick(inv), 0.0),
                torch.where(found, pick(vs) * pick(inv), 0.0)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if not outs:
        e = torch.empty((0,), device=o.device)
        return e, e.to(torch.int32), e, e
    return tuple(torch.cat(x) for x in zip(*outs))


def intersect_mxu(tri_mxu, o, d, maxt, n_tris=None):
    """Closest hit over the first n_tris triangles (all T_pad where None) of
    the regrouped MXU table tri_mxu [4 T_pad, 16]
    (`regroup_tri_mxu(pack_tri_mxu(...))`); the zero rows past the mesh's
    triangles never hit, so n_tris = its face count skips them.

    o, d [N, 3], maxt [N] float32. Returns (t [N], prim [N] int32 (-1 on a
    miss), u [N], v [N]); t is inf and u = v = 0 on a miss. CPU tensors run
    the plain version; CUDA tensors launch the kernel."""
    global INTERSECT_MXU_LAUNCHES
    dev, n, n_tris = _check_mxu("intersect_mxu", tri_mxu, o, d, maxt,
                                n_tris)
    if dev.type == "cpu":
        return intersect_mxu_plain(tri_mxu, o, d, maxt, n_tris)
    from .build import check, load_library

    lib = load_library()
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    u = torch.empty((n,), dtype=torch.float32, device=dev)
    v = torch.empty((n,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(lib.plt_intersect_mxu(
        tri_mxu.data_ptr(), tri_mxu.shape[0] // 4, n_tris, o.data_ptr(),
        d.data_ptr(), maxt.data_ptr(), n, t.data_ptr(), prim.data_ptr(), u.data_ptr(),
        v.data_ptr(), stream), "intersect_mxu")
    INTERSECT_MXU_LAUNCHES += 1
    return t, prim, u, v


# ---------------------------------------------------------------------------
# treelet walks: the two-level ClusterTable2 (scene/bvh.py::pack_clusters2)
# and the flat ClusterTable (scene/bvh.py::pack_clusters)
# ---------------------------------------------------------------------------

# a lane whose two smallest candidate distances lie within this relative gap
# is resolved by the sequential strict compare, triangle by triangle
_TIE_GAP = 1e-5
# triangle rows per trip of a flat cluster (its row count pads to this)
CLU_UNROLL = 8
_CLU2_WIDTHS = {"supers": 16, "boxes": 16, "rows": 128}
_CLU_WIDTHS = {"boxes": 16, "rows": 32}


def _check_clu(name, ctab, o, d, maxt, widths):
    """Checks of the treelet wrappers; `widths` gives the table's arrays
    and their row widths."""
    tables = {arg: (getattr(ctab, arg), torch.float32, None)
              for arg in (*widths, "anchor")}
    dev, n = check_tensors(name, {
        "o": (o, torch.float32, (3,)), "d": (d, torch.float32, (3,)),
        "maxt": (maxt, torch.float32, ()), **tables,
    }, n=o.shape[0] if o.dim() == 2 else -1)
    for arg, width in widths.items():
        t = getattr(ctab, arg)
        if t.dim() != 2 or t.shape[1] != width:
            raise ValueError(f"{name}: {arg} must be [*, {width}], got "
                             f"{tuple(t.shape)}")
    if tuple(ctab.anchor.shape) != (3,):
        raise ValueError(f"{name}: anchor must be [3]")
    return dev, n


def _signed_eps(x):
    return torch.where(x.abs() > _DET_EPS, x,
                       torch.where(x >= 0, _DET_EPS, -_DET_EPS))


class _CluWalk:
    """Per-lane gated walk of the plain treelet versions. Over a
    ClusterTable2: the supers in order, then the clusters of each super a
    lane enters; over a flat ClusterTable (no supers): every cluster in
    order. Each entered cluster's triangles come as one [lanes, T] block in
    table order. `counts` (a dict, or None) accumulates the slab tests and
    triangle tests performed."""

    def __init__(self, ctab, o, d, maxt, counts):
        o3, d3, c3, self.mt = _ray_terms(ctab.anchor, o, d, maxt)
        self.o = torch.stack(o3, -1)
        self.d = torch.stack(d3, -1)
        self.c = torch.stack(c3, -1)
        self.inv = 1.0 / _signed_eps(self.d)
        self.supers = getattr(ctab, "supers", None)
        self.boxes = ctab.boxes
        self.tri = ctab.rows.reshape(-1, 32)  # one triangle a row
        meta = ctab.boxes[:, 6:8].to(torch.int64).tolist()
        keys = ("cluster_tests", "triangle_tests")
        if self.supers is None:
            # (first row, trips of CLU_UNROLL rows)
            self.spans = [(f, CLU_UNROLL * k) for f, k in meta]
        else:
            # (first row, rows) of rows that hold 4 triangles each
            self.spans = [(4 * f, 4 * k) for f, k in meta]
            self.sup_meta = self.supers[:, 6:8].to(torch.int64).tolist()
            keys = ("super_tests",) + keys
        self.counts = counts
        if counts is not None:
            for key in keys:
                counts.setdefault(key, 0)

    def _count(self, key, k):
        if self.counts is not None:
            self.counts[key] += int(k)

    @staticmethod
    def slab(box, o, inv):
        t0 = (box[0:3] - o) * inv
        t1 = (box[3:6] - o) * inv
        near = torch.minimum(t0, t1).amax(-1)
        far = torch.maximum(t0, t1).amin(-1)
        return near, far

    def _groups(self, gate, all_lanes):
        """(lanes, clusters) of every super some lane enters; the flat
        table is one group of every lane and every cluster."""
        if self.supers is None:
            yield all_lanes, range(self.boxes.shape[0])
            return
        for s, (c0, ncl) in enumerate(self.sup_meta):
            near, far = self.slab(self.supers[s], self.o, self.inv)
            self._count("super_tests", self.o.shape[0])
            ent = (near <= far) & (far > 0.0) & gate(near, all_lanes)
            lanes_s = all_lanes[ent]
            if ncl and lanes_s.numel():
                yield lanes_s, range(c0, c0 + ncl)

    def walk(self, gate):
        """Yield (lanes, box index) for every cluster with triangles that a
        lane enters; gate(near, lanes) -> bool mask is evaluated when a box
        is tested, so it sees the caller's updates from earlier clusters."""
        all_lanes = torch.arange(self.o.shape[0], device=self.o.device)
        for lanes_s, clusters in self._groups(gate, all_lanes):
            o_s, inv_s = self.o[lanes_s], self.inv[lanes_s]
            for cl in clusters:
                near, far = self.slab(self.boxes[cl], o_s, inv_s)
                self._count("cluster_tests", lanes_s.numel())
                ent = (near <= far) & (far > 0.0) & gate(near, lanes_s)
                lanes = lanes_s[ent]
                if lanes.numel() and self.spans[cl][1]:
                    yield lanes, cl

    def triangles(self, lanes, cl):
        """(ad, us, vs, ts, inside) [lanes, T] of cluster cl's triangles and
        their face indices [T] (-1 on padding)."""
        first, nt = self.spans[cl]
        tri = self.tri[first: first + nt]
        qt = tri[:, :16].T.unsqueeze(1)  # [16, 1, T]
        split = lambda x: tuple(x[lanes, k: k + 1] for k in range(3))  # noqa: E731
        terms = _q_terms(qt, split(self.o), split(self.d), split(self.c))
        return terms, tri[:, 16]


def _walk_closest(walk):
    """Closest hit along a _CluWalk with per-lane box gating. Within a
    cluster the nearest triangle is found on t = t|det| / |det|; a lane whose
    two nearest candidates (the incoming best included) lie within 1e-5 of
    each other is decided by the kernels' sequential strict compare of
    cross-multiplied pairs, so the first of two tied triangles in table
    order wins as in the kernels."""
    ts_b = walk.mt.clone()
    ad_b = torch.ones_like(ts_b)
    us_b = torch.zeros_like(ts_b)
    vs_b = torch.zeros_like(ts_b)
    prim_b = torch.full_like(ts_b, -1.0)

    def gate(near, lanes):
        return near * ad_b[lanes] < ts_b[lanes]

    for lanes, cl in walk.walk(gate):
        (ad, us, vs, ts, inside), prim = walk.triangles(lanes, cl)
        walk._count("triangle_tests", ad.numel())
        t_in = ts_b[lanes] / ad_b[lanes]
        t = torch.where(inside, ts / torch.where(inside, ad, 1.0),
                        float("inf"))
        cand, pos = torch.topk(torch.cat([t_in[:, None], t], 1), 2, dim=1,
                               largest=False)
        tied = torch.isfinite(cand[:, 1]) & (
            cand[:, 1] <= cand[:, 0] * (1.0 + _TIE_GAP))
        # clear winners: the nearest triangle, unless the incoming best is
        take = ~tied & (pos[:, 0] > 0)
        if take.any():
            rows = take.nonzero().squeeze(1)
            j = pos[rows, 0] - 1
            sel = lanes[rows]
            ts_b[sel] = ts[rows, j]
            ad_b[sel] = ad[rows, j]
            us_b[sel] = us[rows, j]
            vs_b[sel] = vs[rows, j]
            prim_b[sel] = prim[j]
        if tied.any():
            rows = tied.nonzero().squeeze(1)
            sel = lanes[rows]
            b = [x[sel] for x in (ts_b, ad_b, us_b, vs_b, prim_b)]
            for j in range(ad.shape[1]):
                hit = inside[rows, j] & (ts[rows, j] * b[1] < b[0] * ad[rows, j])
                for k, x in enumerate((ts, ad, us, vs)):
                    b[k] = torch.where(hit, x[rows, j], b[k])
                b[4] = torch.where(hit, prim[j], b[4])
            for dst, src in zip((ts_b, ad_b, us_b, vs_b, prim_b), b):
                dst[sel] = src
    prim_i = prim_b.to(torch.int32)
    inv = 1.0 / ad_b
    t = torch.where(prim_i >= 0, ts_b * inv, float("inf"))
    return t, prim_i, us_b * inv, vs_b * inv


def _walk_anyhit(walk):
    """Any hit along a _CluWalk with per-lane box gating; a lane's triangle
    tests are counted up to its first hit, where the kernels' lane stops."""
    occ = torch.zeros(walk.mt.shape, dtype=torch.bool, device=walk.mt.device)

    def gate(near, lanes):
        return (near < walk.mt[lanes]) & ~occ[lanes]

    for lanes, cl in walk.walk(gate):
        (ad, _, _, ts, inside), _ = walk.triangles(lanes, cl)
        hit = inside & (ts < walk.mt[lanes, None] * ad)
        any_hit = hit.any(1)
        if walk.counts is not None:
            n_tri = hit.shape[1]
            first = torch.where(any_hit, hit.to(torch.int8).argmax(1) + 1,
                                n_tri)
            walk._count("triangle_tests", first.sum().item())
        occ[lanes] = any_hit
    return occ


def intersect_clu2_plain(ctab2, o, d, maxt, counts=None):
    """Plain version of `intersect_clu2` (`_walk_closest`)."""
    return _walk_closest(_CluWalk(ctab2, o, d, maxt, counts))


def occluded_clu2_plain(ctab2, o, d, maxt, counts=None):
    """Plain version of `occluded_clu2` (`_walk_anyhit`)."""
    return _walk_anyhit(_CluWalk(ctab2, o, d, maxt, counts))


def intersect_clu_plain(ctab, o, d, maxt, counts=None):
    """Plain version of `intersect_clu`: every cluster in table order, a
    lane entering a box where near <= far, far > 0 and near * |det|_best <
    (t |det|)_best (`_walk_closest`)."""
    return _walk_closest(_CluWalk(ctab, o, d, maxt, counts))


def occluded_clu_plain(ctab, o, d, maxt, counts=None):
    """Plain version of `occluded_clu`: a lane enters a box where near <=
    far, far > 0, near < maxt and it is not yet occluded
    (`_walk_anyhit`)."""
    return _walk_anyhit(_CluWalk(ctab, o, d, maxt, counts))


def intersect_clu2(ctab2, o, d, maxt):
    """Closest hit over a ClusterTable2 (scene/bvh.py).

    o, d [N, 3], maxt [N] float32 on the table's device. Returns (t [N],
    prim [N] int32 face index (-1 on a miss), u [N], v [N]); t is inf on a
    miss. CPU tensors run the plain version; CUDA tensors launch the
    kernel."""
    global INTERSECT_CLU2_LAUNCHES
    dev, n = _check_clu("intersect_clu2", ctab2, o, d, maxt, _CLU2_WIDTHS)
    if dev.type == "cpu":
        return intersect_clu2_plain(ctab2, o, d, maxt)
    from .build import check, load_library

    lib = load_library()
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    u = torch.empty((n,), dtype=torch.float32, device=dev)
    v = torch.empty((n,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(lib.plt_intersect_clu2(
        ctab2.supers.data_ptr(), ctab2.supers.shape[0],
        ctab2.boxes.data_ptr(), ctab2.rows.data_ptr(),
        ctab2.anchor.data_ptr(), o.data_ptr(), d.data_ptr(), maxt.data_ptr(),
        n, t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(),
        stream), "intersect_clu2")
    INTERSECT_CLU2_LAUNCHES += 1
    return t, prim, u, v


def occluded_clu2(ctab2, o, d, maxt):
    """Any hit with 0 < t < maxt over a ClusterTable2: [N] bool."""
    global OCCLUDED_CLU2_LAUNCHES
    dev, n = _check_clu("occluded_clu2", ctab2, o, d, maxt, _CLU2_WIDTHS)
    if dev.type == "cpu":
        return occluded_clu2_plain(ctab2, o, d, maxt)
    from .build import check, load_library

    lib = load_library()
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(lib.plt_occluded_clu2(
        ctab2.supers.data_ptr(), ctab2.supers.shape[0],
        ctab2.boxes.data_ptr(), ctab2.rows.data_ptr(),
        ctab2.anchor.data_ptr(), o.data_ptr(), d.data_ptr(), maxt.data_ptr(),
        n, occ.data_ptr(), stream), "occluded_clu2")
    OCCLUDED_CLU2_LAUNCHES += 1
    return occ


def intersect_clu(ctab, o, d, maxt):
    """Closest hit over a flat ClusterTable (scene/bvh.py::pack_clusters).

    o, d [N, 3], maxt [N] float32 on the table's device. Returns (t [N],
    prim [N] int32 face index (-1 on a miss), u [N], v [N]); on a miss t is
    inf and u = v = 0. Each lane gates each box on its own (the TPU kernel
    gates a whole ray tile on the union of its lanes; the two differ only
    where a lane's own slab test fails by rounding on a box that holds its
    hit). CPU tensors run the plain version; CUDA tensors launch the
    kernel."""
    global INTERSECT_CLU_LAUNCHES
    dev, n = _check_clu("intersect_clu", ctab, o, d, maxt, _CLU_WIDTHS)
    if dev.type == "cpu":
        return intersect_clu_plain(ctab, o, d, maxt)
    from .build import check, load_library

    lib = load_library()
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    u = torch.empty((n,), dtype=torch.float32, device=dev)
    v = torch.empty((n,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(lib.plt_intersect_clu(
        ctab.boxes.data_ptr(), ctab.boxes.shape[0], ctab.rows.data_ptr(),
        ctab.anchor.data_ptr(), o.data_ptr(), d.data_ptr(), maxt.data_ptr(),
        n, t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(),
        stream), "intersect_clu")
    INTERSECT_CLU_LAUNCHES += 1
    return t, prim, u, v


def occluded_clu(ctab, o, d, maxt):
    """Any hit with 0 < t < maxt over a flat ClusterTable: [N] bool, each
    lane gating each box on its own."""
    global OCCLUDED_CLU_LAUNCHES
    dev, n = _check_clu("occluded_clu", ctab, o, d, maxt, _CLU_WIDTHS)
    if dev.type == "cpu":
        return occluded_clu_plain(ctab, o, d, maxt)
    from .build import check, load_library

    lib = load_library()
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(lib.plt_occluded_clu(
        ctab.boxes.data_ptr(), ctab.boxes.shape[0], ctab.rows.data_ptr(),
        ctab.anchor.data_ptr(), o.data_ptr(), d.data_ptr(), maxt.data_ptr(),
        n, occ.data_ptr(), stream), "occluded_clu")
    OCCLUDED_CLU_LAUNCHES += 1
    return occ


# ---------------------------------------------------------------------------
# per-ray skip-link walk (PacketBVH, scene/bvh.py::pack_packet_bvh)
# ---------------------------------------------------------------------------

def _check_bvh(name, pbvh, o, d, maxt):
    dev, n = check_tensors(name, {
        "o": (o, torch.float32, (3,)), "d": (d, torch.float32, (3,)),
        "maxt": (maxt, torch.float32, ()),
        "nodes": (pbvh.nodes, torch.float32, None),
        "tri": (pbvh.tri, torch.float32, None),
    }, n=o.shape[0] if o.dim() == 2 else -1)
    for arg in ("nodes", "tri"):
        t = getattr(pbvh, arg)
        if t.dim() != 2 or t.shape[1] != 16 or t.shape[0] == 0:
            raise ValueError(f"{name}: {arg} must be [>0, 16], got "
                             f"{tuple(t.shape)}")
    return dev, n


def _bvh_walk(pbvh, o, d, maxt, any_hit, counts):
    """The walk of both plain versions: one node index per lane, a loop
    until every lane's index is -1. A lane tests a node's box against its
    own best distance, runs an entered leaf's rows [first, first + count)
    in order, and follows `first` (entered inner node) or `miss`. `counts`
    (a dict, or None) accumulates the slab and triangle tests performed and
    the loop's steps."""
    n, dev = o.shape[0], o.device
    mt = torch.where(torch.isfinite(maxt), maxt, _BIG)
    inv = 1.0 / _signed_eps(d)
    t_b = mt.clone()
    prim_b = torch.full_like(mt, -1.0)
    u_b = torch.zeros_like(mt)
    v_b = torch.zeros_like(mt)
    occ = torch.zeros((n,), dtype=torch.bool, device=dev)
    if counts is not None:
        for key in ("slab_tests", "triangle_tests", "steps"):
            counts.setdefault(key, 0)
    lanes = torch.arange(n, device=dev)
    node = torch.zeros((n,), dtype=torch.int64, device=dev)
    while lanes.numel():
        nd = pbvh.nodes[node]
        o_l, inv_l = o[lanes], inv[lanes]
        t0 = (nd[:, 0:3] - o_l) * inv_l
        t1 = (nd[:, 3:6] - o_l) * inv_l
        near = torch.minimum(t0, t1).amax(-1)
        far = torch.maximum(t0, t1).amin(-1)
        # an occluded lane has already left the walk
        enter = (near <= far) & (far > 0.0) & (near < t_b[lanes])
        first, count, miss = (nd[:, k].to(torch.int64) for k in (6, 7, 8))
        leaf = count > 0
        if counts is not None:
            counts["slab_tests"] += lanes.numel()
            counts["steps"] += 1
        in_leaf = enter & leaf
        l_k, f_k, c_k = lanes[in_leaf], first[in_leaf], count[in_leaf]
        k = 0
        while l_k.numel():
            ok, t, u, v = _classic_terms(pbvh.tri[f_k + k], o[l_k], d[l_k])
            hit = ok & (t < t_b[l_k])
            if counts is not None:
                counts["triangle_tests"] += l_k.numel()
            sel = l_k[hit]
            if any_hit:
                occ[sel] = True
            else:
                t_b[sel] = t[hit]
                u_b[sel] = u[hit]
                v_b[sel] = v[hit]
                prim_b[sel] = pbvh.tri[f_k[hit] + k, 9]
            k += 1
            # the any-hit lane stops at its first hit
            go = (c_k > k) & ~hit if any_hit else c_k > k
            l_k, f_k, c_k = l_k[go], f_k[go], c_k[go]
        node = torch.where(enter & ~leaf, first, miss)
        keep = (node >= 0) & ~occ[lanes] if any_hit else node >= 0
        lanes, node = lanes[keep], node[keep]
    return t_b, prim_b, u_b, v_b, occ


def intersect_bvh_plain(pbvh, o, d, maxt, counts=None):
    """Plain version of `intersect_bvh`: the kernel's walk and arithmetic in
    the kernel's order (strict t < best, leaves in DFS order, so the first
    of two equal hits wins)."""
    t, prim_f, u, v, _ = _bvh_walk(pbvh, o, d, maxt, False, counts)
    prim = prim_f.to(torch.int32)
    return torch.where(prim >= 0, t, float("inf")), prim, u, v


def occluded_bvh_plain(pbvh, o, d, maxt, counts=None):
    """Plain version of `occluded_bvh`: a lane leaves the walk at its first
    hit with 0 < t < maxt."""
    return _bvh_walk(pbvh, o, d, maxt, True, counts)[4]


def intersect_bvh(pbvh, o, d, maxt):
    """Closest hit over a PacketBVH (scene/bvh.py), rays in world space.

    o, d [N, 3], maxt [N] float32 on the tables' device. Returns (t [N],
    prim [N] int32 face index (-1 on a miss), u [N], v [N]); on a miss t is
    inf and u = v = 0. CPU tensors run the plain version; CUDA tensors
    launch the kernel."""
    global INTERSECT_BVH_LAUNCHES
    dev, n = _check_bvh("intersect_bvh", pbvh, o, d, maxt)
    if dev.type == "cpu":
        return intersect_bvh_plain(pbvh, o, d, maxt)
    from .build import check, load_library

    lib = load_library()
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    u = torch.empty((n,), dtype=torch.float32, device=dev)
    v = torch.empty((n,), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(lib.plt_intersect_bvh(
        pbvh.nodes.data_ptr(), pbvh.tri.data_ptr(), o.data_ptr(),
        d.data_ptr(), maxt.data_ptr(), n, t.data_ptr(), prim.data_ptr(),
        u.data_ptr(), v.data_ptr(), stream), "intersect_bvh")
    INTERSECT_BVH_LAUNCHES += 1
    return t, prim, u, v


def occluded_bvh(pbvh, o, d, maxt):
    """Any hit with 0 < t < maxt over a PacketBVH: [N] bool."""
    global OCCLUDED_BVH_LAUNCHES
    dev, n = _check_bvh("occluded_bvh", pbvh, o, d, maxt)
    if dev.type == "cpu":
        return occluded_bvh_plain(pbvh, o, d, maxt)
    from .build import check, load_library

    lib = load_library()
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    check(lib.plt_occluded_bvh(
        pbvh.nodes.data_ptr(), pbvh.tri.data_ptr(), o.data_ptr(),
        d.data_ptr(), maxt.data_ptr(), n, occ.data_ptr(), stream),
        "occluded_bvh")
    OCCLUDED_BVH_LAUNCHES += 1
    return occ
