"""Brute-force closest-hit and any-hit over the precomputed-quantities ("q")
triangle table: the CUDA kernels of `csrc/intersect_q.cu`, their plain
PyTorch versions, and the host-side table packer.

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


def intersect_q_plain(tri_q, anchor, o, d, maxt, n_tris=None):
    """Plain version of `intersect_q`: rows in order, strict-less pair
    comparison, so the first of two tied rows wins."""
    n_tris = tri_q.shape[0] if n_tris is None else n_tris
    o3, d3, c, mt = _ray_terms(anchor, o, d, maxt)
    ts_b = mt
    ad_b = torch.ones_like(mt)
    us_b = torch.zeros_like(mt)
    vs_b = torch.zeros_like(mt)
    prim = torch.full(mt.shape, -1, dtype=torch.int32, device=mt.device)
    for ti in range(n_tris):
        ad, us, vs, ts, inside = _q_terms(tri_q[ti], o3, d3, c)
        hit = inside & (ts * ad_b < ts_b * ad)
        ts_b = torch.where(hit, ts, ts_b)
        ad_b = torch.where(hit, ad, ad_b)
        us_b = torch.where(hit, us, us_b)
        vs_b = torch.where(hit, vs, vs_b)
        prim = torch.where(hit, ti, prim)
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
