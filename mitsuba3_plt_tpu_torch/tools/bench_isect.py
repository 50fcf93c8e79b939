"""Intersection bench: every brute-force and packet-BVH route of the port
on the same ray sets, with their agreement against the classic brute force.

One module for the JAX package's two intersection tools:
`tools/bench_isect.py` (brute VPU, brute MXU and the packet walk, sorted
and unsorted, on coherent and incoherent rays) and
`tools/experiments/isect_q_vs_classic.py` (classic against q, closest and
any hit, on the Cornell box's camera, bounce and shadow rays). Routes:

    brute-classic    intersect_classic (B8a) on Geometry.tri_isect
    brute-q          intersect_q (B1) on Geometry.tri_q
    brute-mxu        intersect_mxu (B9) on the regrouped pack_tri_mxu table
    packet-sorted    intersect_bvh (B7a) on rays in `_packet_perm` order
    packet-unsorted  intersect_bvh (B7a) on rays as they come
    anyhit-classic   occluded_classic (B8b)
    anyhit-q         occluded_q (B2)

The closest-hit routes run on every set but the shadow sets (labels that
start with "shadow"), the any-hit routes on every set, with each set's
maxt. The packet routes walk the WideBVH of a PacketBVH built here from
the scene's (p0, e1, e2) rows (`build_bvh`, `pack_packet_bvh`; the Scene
packs its WideBVH), so any scene can take them. The module has no timing
loop: `run` takes a timer (a function of a callable that returns its
device ms) or reports no times.

Random numbers come from numpy's `default_rng(seed)`. The JAX tools drew
theirs from `jax.random`, whose streams numpy cannot reproduce, so the ray
sets are alike in kind and size, not lane for lane.

On the CPU (plain versions; ms are None):

    from mitsuba3_plt_tpu_torch.scene.presets import cornell_box
    from mitsuba3_plt_tpu_torch.tools import bench_isect as bi
    scene = cornell_box(32, 32, device="cpu")
    sets = {**bi.ray_sets(scene, 4096, 0), **bi.cbox_ray_sets(scene, 4, 0)}
    for row in bi.run(scene, sets):
        print(row)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import intersect as isect
from ..scene.bvh import build_bvh, pack_packet_bvh

CLOSEST = ("brute-classic", "brute-q", "brute-mxu", "packet-sorted",
           "packet-unsorted")
ANYHIT = ("anyhit-classic", "anyhit-q")
ROUTES = CLOSEST + ANYHIT
KERNEL = {"brute-classic": "intersect_classic", "brute-q": "intersect_q",
          "brute-mxu": "intersect_mxu", "packet-sorted": "intersect_bvh",
          "packet-unsorted": "intersect_bvh",
          "anyhit-classic": "occluded_classic", "anyhit-q": "occluded_q"}
# the point light of the Cornell box's shadow rays (isect_q_vs_classic.py)
CBOX_LIGHT = (0.0, 0.99, 0.0)


def _soup(scene):
    """(p0, e1, e2) [F, 3] numpy float32 of the scene's faces."""
    rows = scene.geo.tri_isect[: scene.geo.n_faces].cpu().numpy()
    return rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]


def _tensors(scene, *xs):
    return tuple(torch.as_tensor(np.asarray(x, np.float32),
                                 device=scene.device) for x in xs)


def _unit(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)


def ray_sets(scene, n, seed=0):
    """{"coherent", "incoherent"}: (o, d, maxt) of n rays each, maxt = inf
    (`tools/bench_isect.py:27-40`). Coherent: one origin 1.5 z-extents in
    front of the scene box's centre (toward -z), directions (a, b, 1)
    normalised with a, b uniform in +-0.35. Incoherent: origins uniform in
    the box, directions uniform on the sphere."""
    rng = np.random.default_rng(seed)
    p0, e1, e2 = _soup(scene)
    p = np.concatenate([p0, p0 + e1, p0 + e2]).astype(np.float64)
    lo, hi = p.min(0), p.max(0)
    o_coh = np.tile((lo + hi) / 2 + np.array([0.0, 0.0, -(hi - lo)[2] * 1.5]),
                    (n, 1))
    ang = rng.uniform(-0.35, 0.35, (n, 2))
    d_coh = _unit(np.stack([ang[:, 0], ang[:, 1], np.ones(n)], -1))
    o_inc = rng.uniform(lo, hi, (n, 3))
    d_inc = _unit(rng.normal(size=(n, 3)))
    maxt = np.full(n, np.inf)
    return {"coherent": _tensors(scene, o_coh, d_coh, maxt),
            "incoherent": _tensors(scene, o_inc, d_inc, maxt)}


def cbox_ray_sets(scene, spp, seed=0, kill=0.0, light=CBOX_LIGHT):
    """The path's ray sets on a scene's camera (`isect_q_vs_classic.py`):
    "depth0" the camera rays of W x H x spp lanes (lane // spp is the
    pixel, jittered), "depth1".."depth3" the cosine-sampled bounces from
    the previous set's hits (found by intersect_classic), each hit lane
    killed with probability `kill` (as roulette would; 0 draws nothing),
    dead lanes at o = 1e8, d = +z; "shadow0".."shadow3" the shadow rays
    from each set's hits toward the point `light`, maxt 0.999 of the
    distance (-1 on lanes without a hit)."""
    rng = np.random.default_rng(seed)
    W, H = scene.sensor.resolution
    N = W * H * spp
    pix = np.arange(N) // spp
    jit = rng.random((N, 2))
    uv = np.stack([(pix % W + jit[:, 0]) / W, (pix // W + jit[:, 1]) / H],
                  -1)
    o, d = (x.cpu().numpy().astype(np.float64)
            for x in scene.sensor.sample_ray(_tensors(scene, uv)[0]))
    _, e1, e2 = _soup(scene)
    geo = scene.geo
    light = np.asarray(light, np.float64)
    alive = np.ones(N, bool)
    sets = {}
    for depth in range(4):
        ray = _tensors(scene, o, d, np.full(N, np.inf))
        sets[f"depth{depth}"] = ray
        t, prim = (x.cpu().numpy() for x in isect.intersect_classic(
            geo.tri_isect, *ray, n_tris=geo.n_faces)[:2])
        hit = np.isfinite(t) & (prim >= 0) & alive
        hp = o + np.where(np.isfinite(t), t, 2.0)[:, None] * d
        dsh = light - hp
        dist = np.linalg.norm(dsh, axis=-1, keepdims=True)
        dsh = dsh / np.maximum(dist, 1e-9)
        sets[f"shadow{depth}"] = _tensors(
            scene, np.where(hit[:, None], hp + 1e-4 * dsh, 1e8), dsh,
            np.where(hit, dist[:, 0] * 0.999, -1.0))
        # the next bounce: cosine-weighted about the normal facing the ray
        fi = np.maximum(prim, 0)
        nrm = _unit(np.cross(e1[fi], e2[fi]).astype(np.float64))
        nrm *= -np.sign(np.einsum("ij,ij->i", nrm, d))[:, None]
        cu = rng.random((N, 2))
        r, ph = np.sqrt(cu[:, 0]), 2 * np.pi * cu[:, 1]
        tn = np.where(np.abs(nrm[:, 0:1]) < 0.9, [[1.0, 0, 0]], [[0, 1.0, 0]])
        tx = _unit(np.cross(nrm, tn))
        ty = np.cross(nrm, tx)
        nd = ((r * np.cos(ph))[:, None] * tx + (r * np.sin(ph))[:, None] * ty
              + np.sqrt(np.maximum(1 - cu[:, 0], 0))[:, None] * nrm)
        alive = hit & (rng.random(N) < 1.0 - kill) if kill else hit
        o = np.where(alive[:, None], hp + 1e-4 * nd, 1e8)
        d = np.where(alive[:, None], nd, [[0.0, 0.0, 1.0]])
    return sets


def soup_bvh(scene):
    """(BVH, p0, p1, p2) of the scene's faces as a triangle soup."""
    p0, e1, e2 = _soup(scene)
    p1, p2 = p0 + e1, p0 + e2
    F = len(p0)
    faces = np.arange(3 * F, dtype=np.int32).reshape(3, F).T.copy()
    return build_bvh(np.concatenate([p0, p1, p2]), faces), p0, p1, p2


def packet_scene(scene):
    """A copy of the scene that carries a PacketBVH of its faces and its
    WideBVH (the packet routes' tables and `Scene._packet_perm`'s root
    box)."""
    return dataclasses.replace(scene, pbvh=pack_packet_bvh(
        *soup_bvh(scene), device=scene.device))


def route_fns(scene):
    """{route: fn(o, d, maxt)} over tables built from the scene: closest
    routes return (t, prim, u, v), any-hit routes the occlusion flags."""
    geo, F = scene.geo, scene.geo.n_faces
    p0, e1, e2 = _soup(scene)
    tri_mxu = _tensors(scene, isect.regroup_tri_mxu(
        isect.pack_tri_mxu(p0, e1, e2)))[0]
    packet = packet_scene(scene)
    wbvh = packet.wbvh

    def sorted_walk(o, d, mt):
        perm, inv = packet._packet_perm(o, d)
        return tuple(x[inv] for x in isect.intersect_bvh(
            wbvh, o[perm], d[perm], mt[perm]))

    return {
        "brute-classic": lambda o, d, mt: isect.intersect_classic(
            geo.tri_isect, o, d, mt, n_tris=F),
        "brute-q": lambda o, d, mt: isect.intersect_q(
            geo.tri_q, geo.tri_anchor, o, d, mt, n_tris=F),
        "brute-mxu": lambda o, d, mt: isect.intersect_mxu(
            tri_mxu, o, d, mt, n_tris=F),
        "packet-sorted": sorted_walk,
        "packet-unsorted": lambda o, d, mt: isect.intersect_bvh(
            wbvh, o, d, mt),
        "anyhit-classic": lambda o, d, mt: isect.occluded_classic(
            geo.tri_isect, o, d, mt, n_tris=F),
        "anyhit-q": lambda o, d, mt: isect.occluded_q(
            geo.tri_q, geo.tri_anchor, o, d, mt, n_tris=F),
    }


def _share(mask):
    """The share of True lanes, in float64 (a float32 mean of a million
    ones can come out below 1)."""
    return mask.double().mean().item()


def agreement(ref, got):
    """The report of `tools/bench_isect.py:103-107` for a closest-hit route
    against brute-classic: the share of lanes whose hit/miss agree, and
    the largest |t - t_ref| / max(t_ref, 1e-3) where both hit; plus the
    share of equal prims."""
    a, b = ref[0], got[0]
    both = torch.isfinite(a) & torch.isfinite(b)
    rel = (a - b).abs()[both] / torch.clamp_min(a[both], 1e-3)
    return {"hit_agree": _share(torch.isfinite(a) == torch.isfinite(b)),
            "max_rel_t_err": rel.max().item() if rel.numel() else 0.0,
            "prim_agree": _share(ref[1] == got[1])}


def run(scene, sets, routes=ROUTES, timer=None):
    """One row per (ray set, route of `routes`, in their order): the
    route's kernel, the lanes, its agreement with the classic brute force
    on the same rays (closest hit: `agreement`; any hit: the share of
    equal flags) and, with a timer, its ms and M rays/s. Each route is
    called once per set (brute-classic and anyhit-classic also give the
    reference), then `timer(fn)` where given."""
    fns = route_fns(scene)
    rows = []
    for label, (o, d, mt) in sets.items():
        n = o.shape[0]
        shadow = label.startswith("shadow")
        ref_c = None if shadow else fns["brute-classic"](o, d, mt)
        ref_a = fns["anyhit-classic"](o, d, mt)
        for name in routes:
            any_hit = name in ANYHIT
            if shadow and not any_hit:
                continue
            fn = fns[name]
            if name == "brute-classic":
                out = ref_c
            elif name == "anyhit-classic":
                out = ref_a
            else:
                out = fn(o, d, mt)
            row = {"set": label, "route": name, "kernel": KERNEL[name],
                   "n": n, "faces": scene.geo.n_faces}
            if any_hit:
                row.update(occ_agree=_share(out == ref_a),
                           occluded_share=_share(out))
            else:
                row.update(agreement(ref_c, out),
                           hit_share=_share(torch.isfinite(out[0])))
            ms = timer(lambda: fn(o, d, mt)) if timer is not None else None
            row.update(ms=ms, mrays_per_s=None if ms is None
                       else n / ms / 1e3)
            rows.append(row)
    return rows
