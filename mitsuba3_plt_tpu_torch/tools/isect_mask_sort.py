"""Cluster-mask-sorted treelet gating: the flat cluster kernels (B10) on the
path's rays, unsorted, sorted by the treelet boxes each ray enters, and in
the packet route's coherence order, against the q brute force.

Port of `tools/experiments/isect_mask_sort.py`. The TPU cluster kernel
gates a whole 8,192-ray tile on the union of its lanes' needs, which
degenerates on bounce rays whose neighbours need unrelated treelets; the
tool's question is whether sorting rays by their cluster-hit mask makes
the tiles homogeneous enough to pay for the sort. On this card a warp of
32 lanes votes where the TPU's tile did. Routes (closest hit on every set
but the shadow sets, any hit on the shadow sets):

    q           intersect_q / occluded_q (B1/B2) over the scene's faces
    clu         intersect_clu / occluded_clu (B10) over ctab64, rays as
                they come
    m64, m128   the same over ctab64 / ctab128, rays in `cluster_mask`
                order (stable argsort, the kernel, then unsorted)
    clu-morton  the same over ctab64, rays in `Scene._packet_perm` order

ctab64 and ctab128 are `pack_clusters` of the scene's faces at max_leaf 64
and 128. The rays are `ray_sets`: bench_isect's incoherent set (origins
inside the scene box, where the JAX record found interior rays entering
~40% of the treelets) and the path's camera, bounce and shadow rays. The
module has no timing loop: `run` takes a timer (a function of a callable
that returns its device ms) or reports no times.

On the CPU (plain versions; ms are None):

    from mitsuba3_plt_tpu_torch.scene.presets import cornell_box
    from mitsuba3_plt_tpu_torch.tools import isect_mask_sort as ms
    scene = cornell_box(16, 16, device="cpu")
    for row in ms.run(scene, ms.ray_sets(scene, 1)):
        print(row)
"""
from __future__ import annotations

import torch

from ..ops import intersect as isect
from ..scene.bvh import pack_clusters
from ..scene.emitters import EMITTER_POINT
from . import bench_isect as bi

ROUTES = ("q", "clu", "m64", "m128", "clu-morton")
KILL = 0.15          # share of a bounce's live lanes killed (roulette)
MASK_ELEMS = 1 << 22  # (ray, box) pairs a chunk of cluster_mask holds
_M32 = 0xFFFFFFFF


def scene_light(scene):
    """The shadow rays' point: the scene's first point light, else the JAX
    tool's point in the Cornell box (bench_isect.CBOX_LIGHT)."""
    em = scene.emitters
    if EMITTER_POINT in em.present_types:
        first = int((em.etype == EMITTER_POINT).nonzero()[0, 0])
        return tuple(em.position[first].cpu().double().tolist())
    return bi.CBOX_LIGHT


def ray_sets(scene, spp, seed=0):
    """{"incoherent", "depth0".."depth3", "shadow0".."shadow3"}: (o, d,
    maxt) of W x H x spp lanes each; `bench_isect.cbox_ray_sets` with KILL
    and `scene_light`, and bench_isect's incoherent set (maxt inf)."""
    sets = bi.cbox_ray_sets(scene, spp, seed, kill=KILL,
                            light=scene_light(scene))
    n = sets["depth0"][0].shape[0]
    return {"incoherent": bi.ray_sets(scene, n, seed)["incoherent"], **sets}


def tables(scene):
    """{"ctab64", "ctab128"}: the scene's flat cluster tables."""
    bvh, p0, p1, p2 = bi.soup_bvh(scene)
    return {f"ctab{k}": pack_clusters(bvh, p0, p1, p2, max_leaf=k,
                                      device=scene.device)
            for k in (64, 128)}


def cluster_mask(ctab, o, d, maxt):
    """[N] int64 sort key in [0, 2^32) from the boxes of ctab (padding
    boxes included) that the segment [0, maxt] of each ray enters: with K
    <= 32 boxes the bitmask of them; above, (first entered box << 24) |
    (hash of the set & 0xFFFFFF), in uint32 arithmetic
    (`isect_mask_sort.py:48-77`; int64 masked to 32 bits stands in for
    uint32). Computed MASK_ELEMS (ray, box) pairs at a time."""
    K = ctab.boxes.shape[0]
    lo, hi = ctab.boxes[:, 0:3], ctab.boxes[:, 3:6]
    idx = torch.arange(K, dtype=torch.int64, device=o.device)
    if K <= 32:
        weight = 1 << idx
    else:
        weight = ((idx * 2654435761) & _M32) ^ ((idx << 7) & _M32)
    keys = []
    step = max(1, MASK_ELEMS // K)
    for s in range(0, o.shape[0], step):
        oc = o[s: s + step] - ctab.anchor
        inv = 1.0 / isect._signed_eps(d[s: s + step])
        t0 = (lo[None] - oc[:, None]) * inv[:, None]
        t1 = (hi[None] - oc[:, None]) * inv[:, None]
        near = torch.minimum(t0, t1).amax(-1)
        far = torch.maximum(t0, t1).amin(-1)
        mt = maxt[s: s + step]
        mt = torch.where(torch.isfinite(mt), mt, 3.4e38)
        hit = (near <= far) & (far > 0.0) & (near < mt[:, None])
        wsum = torch.where(hit, weight, 0).sum(-1)
        if K <= 32:
            keys.append(wsum)
            continue
        first = torch.where(hit, idx, K).amin(-1)
        keys.append(((first << 24) & _M32) | (wsum & 0xFFFFFF))
    if not keys:
        return torch.zeros((0,), dtype=torch.int64, device=o.device)
    return torch.cat(keys)


def _permuted(fn, perm, inv, any_hit, o, d, mt):
    """fn on the rays in `perm` order, its answer in lane order."""
    out = fn(o[perm], d[perm], mt[perm])
    return out[inv] if any_hit else tuple(x[inv] for x in out)


def _inverse(perm):
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return inv


def _clu_fn(ctab, any_hit):
    kernel = isect.occluded_clu if any_hit else isect.intersect_clu
    return lambda o, d, mt: kernel(ctab, o, d, mt)


def sorted_pipeline(ctab, any_hit=False):
    """fn(o, d, maxt): the cluster kernel on the rays in stable
    `cluster_mask` order, answered in lane order."""
    fn = _clu_fn(ctab, any_hit)

    def run(o, d, mt):
        perm = torch.argsort(cluster_mask(ctab, o, d, mt), stable=True)
        return _permuted(fn, perm, _inverse(perm), any_hit, o, d, mt)

    return run


def morton_pipeline(packet, ctab, any_hit=False):
    """fn(o, d, maxt): the cluster kernel on the rays in the coherence
    order of `packet._packet_perm` (a scene that carries a PacketBVH:
    `bench_isect.packet_scene`), answered in lane order."""
    fn = _clu_fn(ctab, any_hit)

    def run(o, d, mt):
        perm, inv = packet._packet_perm(o, d)
        return _permuted(fn, perm, inv, any_hit, o, d, mt)

    return run


def route_fns(scene, tabs=None):
    """{route: (closest fn, any-hit fn)}, each fn(o, d, maxt), over the
    scene's faces and its `tables` (built here where None)."""
    geo, F = scene.geo, scene.geo.n_faces
    tabs = tables(scene) if tabs is None else tabs
    c64, c128 = tabs["ctab64"], tabs["ctab128"]
    packet = bi.packet_scene(scene)
    return {
        "q": (lambda o, d, mt: isect.intersect_q(
                  geo.tri_q, geo.tri_anchor, o, d, mt, n_tris=F),
              lambda o, d, mt: isect.occluded_q(
                  geo.tri_q, geo.tri_anchor, o, d, mt, n_tris=F)),
        "clu": (_clu_fn(c64, False), _clu_fn(c64, True)),
        "m64": (sorted_pipeline(c64), sorted_pipeline(c64, True)),
        "m128": (sorted_pipeline(c128), sorted_pipeline(c128, True)),
        "clu-morton": (morton_pipeline(packet, c64),
                       morton_pipeline(packet, c64, True)),
    }


def run(scene, sets, routes=ROUTES, timer=None, tabs=None):
    """One row per (ray set, route of `routes`, in their order): closest
    hit on every set but the shadow sets (labels that start with
    "shadow"), any hit on those. Each row has the share of lanes whose prim
    (closest) or flag (any hit) equals the q route's on the same rays (the
    JAX tool's check is >= 0.9999) and, for the closest hit, the share
    whose prim is the same or whose hit lies at the same distance (rtol
    1e-5: coplanar faces tie, and a cluster table orders the faces
    otherwise than the q table), the boxes of the route's table and, with
    a timer, ms and ms per million rays. Each route is called once per set
    (q also gives the reference), then `timer(fn)` where given."""
    tabs = tables(scene) if tabs is None else tabs
    fns = route_fns(scene, tabs)
    boxes = {"clu": "ctab64", "m64": "ctab64", "m128": "ctab128",
             "clu-morton": "ctab64"}
    rows = []
    for label, (o, d, mt) in sets.items():
        n = o.shape[0]
        any_hit = label.startswith("shadow")
        ref = fns["q"][any_hit](o, d, mt)
        for name in routes:
            fn = fns[name][any_hit]
            out = ref if name == "q" else fn(o, d, mt)
            row = {"set": label, "route": name,
                   "kind": "any hit" if any_hit else "closest", "n": n,
                   "faces": scene.geo.n_faces,
                   "boxes": (tabs[boxes[name]].boxes.shape[0]
                             if name in boxes else None)}
            if any_hit:
                row.update(occ_agree=bi._share(out == ref),
                           occluded_share=bi._share(out))
            else:
                same_t = (torch.isfinite(ref[0]) & torch.isfinite(out[0])
                          & ((out[0] - ref[0]).abs() <= 1e-5 * ref[0]))
                row.update(prim_agree=bi._share(out[1] == ref[1]),
                           same_hit=bi._share((out[1] == ref[1]) | same_t),
                           hit_share=bi._share(out[1] >= 0))
            ms = timer(lambda: fn(o, d, mt)) if timer is not None else None
            row.update(ms=ms, ms_per_mrays=None if ms is None
                       else ms / (n / 1e6))
            rows.append(row)
    return rows
