"""Host-side BVH, the flat and the two-level treelet tables of the clu and
clu2 kernels, and the packet tables of the skip-link BVH walk.

`build_bvh` gives the SAH tree of the native builder in its flat skip-link
layout (DFS pre-order):
  node_lo/hi [NN, 3]  AABB
  node_first [NN]     inner: left child (node + 1); leaf: offset into the
                      padded prim-index array (multiple of LEAF_SIZE)
  node_count [NN]     0 for inner nodes, #prims (<= LEAF_SIZE) for leaves
  node_miss  [NN]     next node after the subtree, -1 at the end
`pack_clusters` cuts that tree into treelets of at most `max_leaf`
triangles with one q row per triangle (see ClusterTable);
`pack_clusters2` cuts it into treelets of at most CLU2_MAX_LEAF
triangles, groups CLU2_SUPER consecutive treelets under a super box, and
packs the triangles 4 to a row (see ClusterTable2). `pack_packet_bvh`
collapses every subtree of at most PACKET_LEAF triangles into one leaf
and stores each leaf's triangles as contiguous rows (see PacketBVH);
`pack_wide_bvh` collapses a PacketBVH into nodes of up to WIDE children
whose boxes sit in the parent (see WideBVH), the table of the closest-hit
walk.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops.intersect import (CLU_UNROLL, PACKET_LEAF, WIDE, clu2_gates,
                             pack_tri_q)
from .native import build_bvh_native

CLU2_SUPER = 16     # DFS-consecutive clusters per super box
CLU2_MAX_LEAF = 64  # triangles per cluster at most


@dataclasses.dataclass(frozen=True)
class BVH:
    node_lo: np.ndarray     # [NN, 3] f32
    node_hi: np.ndarray     # [NN, 3] f32
    node_first: np.ndarray  # [NN] i32
    node_count: np.ndarray  # [NN] i32
    node_miss: np.ndarray   # [NN] i32
    prim_idx: np.ndarray    # [P] i32 padded triangle indices (-1 = empty)


def build_bvh(vertices: np.ndarray, faces: np.ndarray) -> BVH:
    """SAH BVH of a triangle mesh through the native builder."""
    v = np.asarray(vertices)
    f = np.asarray(faces)
    if len(f) == 0:
        raise ValueError("build_bvh: the mesh has no faces")
    lo, hi, first, count, miss, prim = build_bvh_native(
        v[f[:, 0]], v[f[:, 1]], v[f[:, 2]])
    return BVH(node_lo=lo, node_hi=hi, node_first=first, node_count=count,
               node_miss=miss, prim_idx=prim)


@dataclasses.dataclass(frozen=True)
class ClusterTable:
    """Flat treelet tables, relative to `anchor` (the root box centre):

    boxes [K_pad, 16]: lo(3) hi(3) first_row trips pad(8); the cluster's
      triangles are rows [first_row, first_row + CLU_UNROLL * trips).
    rows [R_pad, 32]: one triangle a row, the pack_tri_q quantities e1 e2
      m1 m2 n2 k in columns 0..15 and its original face index (as f32) in
      column 16. A cluster's rows pad to a multiple of CLU_UNROLL and the
      table to a multiple of 8 with zero rows (n2 = 0, so det = 0 and they
      never hit) of face index -1.
    Padding boxes (`_pad8`) hold no rows.
    """

    boxes: torch.Tensor
    rows: torch.Tensor
    anchor: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ClusterTable2:
    """Two-level treelet tables, relative to `anchor` (the root box centre):

    supers [S_pad, 16]: lo(3) hi(3) first_cluster n_clusters pad(8)
    boxes  [K_pad, 16]: lo(3) hi(3) first_row n_rows pad(8)
    rows   [R, 128]: 4 triangles x 32 columns; triangle j of a row holds the
      pack_tri_q quantities e1 e2 m1 m2 n2 k in columns 32j..32j+15 and its
      original face index (as f32) in column 32j+16. Padding triangles
      have n2 = 0 (so det = 0 and they never hit) and face index -1.
    Padding supers and boxes (`_pad8`) hold no clusters or rows.
    Beside the fields (which mirror the JAX package's table), `root` [8]
    and `groups` [G, 8] are the boxes of the clu2 walks' gates above the
    supers (`ops/intersect.py::clu2_gates`), taken from `supers` whenever a
    table is made.
    """

    supers: torch.Tensor
    boxes: torch.Tensor
    rows: torch.Tensor
    anchor: torch.Tensor

    def __post_init__(self):
        root, groups = clu2_gates(self.supers)
        object.__setattr__(self, "root", root)
        object.__setattr__(self, "groups", groups)


def _clusters(bvh: BVH, max_leaf: int):
    """Treelets in DFS order: a pre-order walk emits one at the first node
    whose subtree holds <= max_leaf prims (or at a leaf), then jumps its
    skip link. Returns [(node, face indices)]."""
    first, count, miss = bvh.node_first, bvh.node_count, bvh.node_miss
    prim = bvh.prim_idx
    nn = len(first)
    end = np.where(miss >= 0, miss, nn)
    csum = np.concatenate([[0], np.cumsum(count)]).astype(np.int64)
    sub_prims = csum[end] - csum[np.arange(nn)]
    out = []
    i = 0
    while i < nn:
        if count[i] > 0 or sub_prims[i] <= max_leaf:
            seg = np.arange(i, end[i])
            seg = seg[count[seg] > 0]
            ids = (np.concatenate([prim[first[j]: first[j] + count[j]]
                                   for j in seg])
                   if len(seg) else np.zeros(0, np.int32))
            ids = ids[ids >= 0]
            if len(ids):
                out.append((i, ids))
            i = end[i]
        else:
            i += 1
    return out


def _pad8(a):
    """Pad box rows to a multiple of 8 with empty boxes (lo = 1e30 > hi =
    -1e30: the slab test's min and max swap the planes, so every ray
    enters them, but they hold no clusters or rows)."""
    p = (-len(a)) % 8
    if p:
        pad = np.zeros((p, a.shape[1]), np.float32)
        pad[:, 0:3] = 1e30
        pad[:, 3:6] = -1e30
        a = np.concatenate([a, pad], axis=0)
    return a


def _treelets(name, bvh: BVH, tri_p0, tri_p1, tri_p2, max_leaf):
    """(node AABBs lo, hi, the anchor (root box centre), p0, p1, p2 as
    float32, `_clusters`) of a treelet table; raises when the mesh has no
    triangles."""
    lo = np.asarray(bvh.node_lo, np.float32)
    hi = np.asarray(bvh.node_hi, np.float32)
    p = [np.asarray(x, np.float32) for x in (tri_p0, tri_p1, tri_p2)]
    clusters = _clusters(bvh, max_leaf)
    if not clusters:
        raise ValueError(f"{name}: the BVH holds no triangles")
    return lo, hi, (lo[0] + hi[0]) * 0.5, *p, clusters


def pack_clusters_arrays(bvh: BVH, tri_p0, tri_p1, tri_p2,
                         max_leaf: int = 64) -> dict:
    """The ClusterTable arrays as numpy: {"boxes", "rows", "anchor"}, one
    cluster per treelet of at most `max_leaf` triangles. Raises when the
    mesh has no triangles."""
    lo, hi, anchor, p0, p1, p2, clusters = _treelets(
        "pack_clusters", bvh, tri_p0, tri_p1, tri_p2, max_leaf)
    boxes, row_parts, n_rows = [], [], 0
    for ni, ids in clusters:
        q, _ = pack_tri_q(p0[ids], p1[ids], p2[ids], anchor=anchor)
        t_pad = -(-len(ids) // CLU_UNROLL) * CLU_UNROLL
        rows = np.zeros((t_pad, 32), np.float32)
        rows[:, :16] = q[:t_pad]
        rows[: len(ids), 16] = ids.astype(np.float32)
        rows[len(ids):, 16] = -1.0
        boxes.append(np.concatenate([
            lo[ni] - anchor, hi[ni] - anchor,
            [np.float32(n_rows), np.float32(t_pad // CLU_UNROLL)],
            np.zeros(8, np.float32),
        ]))
        row_parts.append(rows)
        n_rows += t_pad
    rows = np.concatenate(row_parts, axis=0)
    r_pad = (-rows.shape[0]) % 8
    if r_pad:
        pad = np.zeros((r_pad, 32), np.float32)
        pad[:, 16] = -1.0
        rows = np.concatenate([rows, pad], axis=0)
    return {"boxes": _pad8(np.stack(boxes).astype(np.float32)),
            "rows": rows, "anchor": anchor.astype(np.float32)}


def pack_clusters(bvh: BVH, tri_p0, tri_p1, tri_p2, max_leaf: int = 64,
                  device="cuda") -> ClusterTable:
    """ClusterTable of the triangles (p0, p1, p2) [F, 3] cut from `bvh` into
    treelets of at most `max_leaf` triangles, as float32 tensors on
    `device`."""
    dev = resolve_device(device)
    arrays = pack_clusters_arrays(bvh, tri_p0, tri_p1, tri_p2, max_leaf)
    return ClusterTable(**{k: torch.as_tensor(v, device=dev)
                           for k, v in arrays.items()})


def pack_clusters2_arrays(bvh: BVH, tri_p0, tri_p1, tri_p2) -> dict:
    """The ClusterTable2 arrays as numpy: {"supers", "boxes", "rows",
    "anchor"}. Raises when the mesh has no triangles."""
    lo, hi, anchor, p0, p1, p2, clusters = _treelets(
        "pack_clusters2", bvh, tri_p0, tri_p1, tri_p2, CLU2_MAX_LEAF)
    boxes, row_parts, n_rows = [], [], 0
    for ni, ids in clusters:
        q, _ = pack_tri_q(p0[ids], p1[ids], p2[ids], anchor=anchor)
        q = q[: len(ids)]
        nr = -(-len(ids) // 4)
        rows = np.zeros((nr, 128), np.float32)
        for j in range(4):
            sel = q[j::4]
            rows[: len(sel), 32 * j: 32 * j + 16] = sel
            pr = ids[j::4].astype(np.float32)
            rows[: len(pr), 32 * j + 16] = pr
            rows[len(pr):, 32 * j + 16] = -1.0
        boxes.append(np.concatenate([
            lo[ni] - anchor, hi[ni] - anchor,
            [np.float32(n_rows), np.float32(nr)], np.zeros(8, np.float32),
        ]))
        row_parts.append(rows)
        n_rows += nr
    boxes = np.stack(boxes).astype(np.float32)

    supers = []
    for s0 in range(0, len(boxes), CLU2_SUPER):
        seg = boxes[s0: s0 + CLU2_SUPER]
        supers.append(np.concatenate([
            seg[:, 0:3].min(0), seg[:, 3:6].max(0),
            [np.float32(s0), np.float32(len(seg))], np.zeros(8, np.float32),
        ]))
    supers = np.stack(supers).astype(np.float32)

    rows = np.concatenate(row_parts, axis=0)
    r_pad = (-rows.shape[0]) % 8
    if r_pad:
        pad = np.zeros((r_pad, 128), np.float32)
        pad[:, 16::32] = -1.0
        rows = np.concatenate([rows, pad], axis=0)
    return {"supers": _pad8(supers), "boxes": _pad8(boxes), "rows": rows,
            "anchor": anchor.astype(np.float32)}


def pack_clusters2(bvh: BVH, tri_p0, tri_p1, tri_p2,
                   device="cuda") -> ClusterTable2:
    """ClusterTable2 of the triangles (p0, p1, p2) [F, 3] cut from `bvh`,
    as float32 tensors on `device`."""
    dev = resolve_device(device)
    arrays = pack_clusters2_arrays(bvh, tri_p0, tri_p1, tri_p2)
    return ClusterTable2(**{k: torch.as_tensor(v, device=dev)
                            for k, v in arrays.items()})


@dataclasses.dataclass(frozen=True)
class PacketBVH:
    """Skip-link BVH with merged node rows and leaf-contiguous triangles, in
    world coordinates (no anchor):

    nodes [NN_pad, 16]: lo(3) hi(3) first count miss pad(7), DFS pre-order.
      Inner node (count = 0): `first` is the left child (node + 1). Leaf:
      its triangles are rows [first, first + count) of `tri`. `miss` is the
      next node after the subtree, -1 at the end. first, count and miss are
      exact as f32 (below 2^24).
    tri [P_pad, 16]: p0(3) e1(3) e2(3) face index (as f32) pad(6), in leaf
      DFS order.
    Both are padded to a multiple of 8 rows; padding node rows have
    miss = -1 and no node links to them.
    """

    nodes: torch.Tensor
    tri: torch.Tensor

    @functools.cached_property
    def wide(self) -> "WideBVH":
        """The WideBVH of these tables, built on first use and kept: every
        scene that holds this PacketBVH walks the same one."""
        return pack_wide_bvh(self)


def pack_packet_bvh_arrays(bvh: BVH, tri_p0, tri_p1, tri_p2) -> dict:
    """The PacketBVH arrays as numpy: {"nodes", "tri"}. Any subtree holding
    at most PACKET_LEAF triangles becomes one leaf."""
    lo = np.asarray(bvh.node_lo, np.float32)
    hi = np.asarray(bvh.node_hi, np.float32)
    first = np.asarray(bvh.node_first, np.int32)
    count = np.asarray(bvh.node_count, np.int32)
    miss = np.asarray(bvh.node_miss, np.int32)
    prim = np.asarray(bvh.prim_idx, np.int32)
    p0 = np.asarray(tri_p0, np.float32)
    p1 = np.asarray(tri_p1, np.float32)
    p2 = np.asarray(tri_p2, np.float32)

    nn = lo.shape[0]
    # DFS pre-order with skip links: subtree(i) is the node range [i, end[i])
    end = np.where(miss >= 0, miss, nn)
    csum = np.concatenate([[0], np.cumsum(count)]).astype(np.int64)
    sub_prims = csum[end] - csum[np.arange(nn)]
    make_leaf = (count > 0) | (sub_prims <= PACKET_LEAF)

    # sizes of the collapsed subtrees (children sit at i + 1 and miss[i + 1])
    new_size = np.ones(nn, np.int64)
    for i in range(nn - 1, -1, -1):
        if not make_leaf[i]:
            left = i + 1
            new_size[i] = 1 + new_size[left] + new_size[miss[left]]

    n_new = int(new_size[0])
    nodes = np.zeros((n_new + (-n_new) % 8, 16), np.float32)
    nodes[:, 8] = -1.0
    ids_list, n_rows, counter = [], 0, 0
    stack = [(0, -1)]
    while stack:
        i, m = stack.pop()
        ni = counter
        counter += 1
        nodes[ni, 0:3] = lo[i]
        nodes[ni, 3:6] = hi[i]
        nodes[ni, 8] = m
        if make_leaf[i]:
            seg = np.arange(i, end[i])
            seg = seg[count[seg] > 0]
            ids = (np.concatenate([prim[first[j]: first[j] + count[j]]
                                   for j in seg])
                   if len(seg) else np.zeros(0, np.int32))
            nodes[ni, 6] = n_rows
            nodes[ni, 7] = len(ids)
            ids_list.append(ids)
            n_rows += len(ids)
        else:
            left = i + 1
            nodes[ni, 6] = ni + 1
            stack.append((miss[left], m))
            stack.append((left, ni + 1 + int(new_size[left])))

    if n_rows == 0:
        raise ValueError("pack_packet_bvh: the BVH holds no triangles")
    ids = np.concatenate(ids_list)
    tri = np.zeros((n_rows + (-n_rows) % 8, 16), np.float32)
    tri[:n_rows, 0:3] = p0[ids]
    tri[:n_rows, 3:6] = p1[ids] - p0[ids]
    tri[:n_rows, 6:9] = p2[ids] - p0[ids]
    tri[:n_rows, 9] = ids
    return {"nodes": nodes, "tri": tri}


def pack_packet_bvh(bvh: BVH, tri_p0, tri_p1, tri_p2,
                    device="cuda") -> PacketBVH:
    """PacketBVH of the triangles (p0, p1, p2) [F, 3] from `bvh`, as float32
    tensors on `device`."""
    dev = resolve_device(device)
    arrays = pack_packet_bvh_arrays(bvh, tri_p0, tri_p1, tri_p2)
    return PacketBVH(**{k: torch.as_tensor(v, device=dev)
                        for k, v in arrays.items()})


@dataclasses.dataclass(frozen=True)
class WideBVH:
    """A PacketBVH collapsed to nodes of up to WIDE children, each child's
    box stored in its parent:

    nodes [NW, 8 WIDE]: child slot j in columns 8j..8j+7: lo(3) hi(3)
      first count. count -1: an empty slot; 0: an inner child, the wide
      node `first`; > 0: a PacketBVH leaf, rows [first, first + count) of
      `tri`. Node 0 is the root, the children of a node are consecutive
      nodes (breadth-first order), and a node's slots keep the PacketBVH's
      DFS order, so the lower slot holds the lower rows. first and count
      are exact as f32 (below 2^24).
    tri: the PacketBVH's rows (the same tensor).
    stack: the most (child, near) entries a walk's stack holds when it
      pushes every child its ray enters and pops them nearest first.
    """

    nodes: torch.Tensor
    tri: torch.Tensor
    stack: int


def pack_wide_bvh_arrays(pnodes) -> tuple:
    """(the WideBVH nodes as numpy, its stack bound) from PacketBVH node
    rows [NN, 16] (`pack_packet_bvh_arrays`). A wide node starts from the
    two children of a PacketBVH inner node and, while it has fewer than
    WIDE children, replaces the inner child of largest box surface (the
    first of equal ones) by its two children, in place; a PacketBVH whose
    root is a leaf gives a root with that one child."""
    pn = np.asarray(pnodes, np.float32)
    lo, hi = pn[:, 0:3], pn[:, 3:6]
    first, count, miss = (pn[:, k].astype(np.int64) for k in (6, 7, 8))
    ext = (hi - lo).astype(np.float64)
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]

    def split(b):  # the two children of PacketBVH inner node b
        return [int(first[b]), int(miss[first[b]])]

    def collapse(b):
        kids = split(b) if count[b] == 0 else [b]
        while len(kids) < WIDE:
            inner = [k for k in kids if count[k] == 0]
            if not inner:
                break
            pick = max(inner, key=lambda k: area[k])
            j = kids.index(pick)
            kids[j: j + 1] = split(pick)
        return kids

    rows, links = [collapse(0)], []
    i = 0
    while i < len(rows):
        link = []
        for k in rows[i]:
            if count[k] == 0:
                link.append(len(rows))
                rows.append(collapse(k))
            else:
                link.append(-1)
        links.append(link)
        i += 1

    nodes = np.zeros((len(rows), 8 * WIDE), np.float32)
    nodes[:, 7::8] = -1.0
    for w, (kids, link) in enumerate(zip(rows, links)):
        for j, (k, c) in enumerate(zip(kids, link)):
            s = nodes[w, 8 * j: 8 * j + 8]
            s[0:3], s[3:6] = lo[k], hi[k]
            s[6], s[7] = (c, 0) if c >= 0 else (first[k], count[k])
    if count.max() > PACKET_LEAF:
        raise ValueError(f"pack_wide_bvh: a leaf holds more than "
                         f"{PACKET_LEAF} rows")
    # the peak of the stack below node w: k - 1 + max(1, the children's)
    peak = np.zeros(len(rows), np.int64)
    for w in range(len(rows) - 1, -1, -1):
        inner = [peak[c] for c in links[w] if c >= 0]
        peak[w] = len(rows[w]) - 1 + max([1] + inner)
    return nodes, int(peak[0])


def pack_wide_bvh(pbvh: PacketBVH) -> WideBVH:
    """The WideBVH of a PacketBVH, on the PacketBVH's device and sharing
    its triangle rows."""
    nodes, stack = pack_wide_bvh_arrays(pbvh.nodes.cpu().numpy())
    return WideBVH(nodes=torch.as_tensor(nodes, device=pbvh.nodes.device),
                   tri=pbvh.tri, stack=stack)
