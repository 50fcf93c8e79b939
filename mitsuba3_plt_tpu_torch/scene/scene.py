"""Scene: triangle tables, materials, emitters and sensor as tensors, with
ray_intersect building SurfaceInteraction records and ray_test answering
shadow rays. Routing is by face count and the tables the scene holds: up
to 4096 triangles every ray goes to the brute-force q kernels; above that
to the two-level treelet (clu2) kernels over the scene's ClusterTable2 or,
where it has none, to the packet route on rays sorted for coherence: the
closest hit walks the WideBVH built from the scene's PacketBVH, shadow rays
the PacketBVH's skip links (`ops/intersect.py`). A scene's few analytic
spheres, disks and cylinders are intersected after the triangles on every
route, each family as one [N, K] broadcast, and take a lane where they are
nearer."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import frame as fr
from ..core import math as m
from ..core.math import take_rows
from ..librender.bsdf import MaterialTable
from ..librender.records import Ray, SurfaceInteraction
from ..librender.sensor import Sensor
from ..ops import intersect as isect
from .bvh import ClusterTable2, PacketBVH, WideBVH
from .emitters import EmitterTable, env_emitter_index

BRUTE_FORCE_MAX_FACES = 4096


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Triangle soup: its vertex rows, the q table for intersection, the
    (p0, e1, e2) rows (area-light sampling, the classic and MXU brute
    force) and one packed row of shading attributes per face.

    The vertex rows are what the silhouette boundary gradients
    (`ad/projective.py`) read and differentiate. As in the JAX package,
    the render reads the tables, not the rows: the tables are not rebuilt
    from the rows, so a render's own gradient on them is zero."""

    tri_p0: torch.Tensor      # [F, 3] corner 0 of each face
    tri_p1: torch.Tensor      # [F, 3]
    tri_p2: torch.Tensor      # [F, 3]
    tri_q: torch.Tensor       # [F_pad, 16] (ops.intersect.pack_tri_q)
    tri_anchor: torch.Tensor  # [3] scene-centre anchor
    # [F_pad, 9]: p0(3) e1(3) e2(3), zero rows padding F to a multiple of 64
    tri_isect: torch.Tensor
    # [F, 24]: ng(3) n0(3) n1(3) n2(3) uv0(2) uv1(2) uv2(2) mat emitter shape
    tri_attr: torch.Tensor
    # analytic primitives, intersected exactly after the triangles: each
    # family's rows and its (mat, emitter, shape) rows [K, 3] as float32;
    # None where the scene has none
    sph_center: Optional[torch.Tensor] = None  # [S, 3]
    sph_radius: Optional[torch.Tensor] = None  # [S]
    sph_attr: Optional[torch.Tensor] = None    # [S, 3]
    dsk_center: Optional[torch.Tensor] = None  # [D, 3]
    dsk_n: Optional[torch.Tensor] = None       # [D, 3] unit normal
    dsk_s: Optional[torch.Tensor] = None       # [D, 3] in-plane u axis
    dsk_radius: Optional[torch.Tensor] = None  # [D]
    dsk_attr: Optional[torch.Tensor] = None    # [D, 3]
    cyl_p0: Optional[torch.Tensor] = None      # [C, 3] base centre
    cyl_axis: Optional[torch.Tensor] = None    # [C, 3] unit
    cyl_len: Optional[torch.Tensor] = None     # [C]
    cyl_radius: Optional[torch.Tensor] = None  # [C]
    cyl_attr: Optional[torch.Tensor] = None    # [C, 3]

    @property
    def n_faces(self) -> int:
        return self.tri_attr.shape[0]

    @property
    def n_spheres(self) -> int:
        return 0 if self.sph_center is None else self.sph_center.shape[0]

    @property
    def n_disks(self) -> int:
        return 0 if self.dsk_center is None else self.dsk_center.shape[0]

    @property
    def n_cylinders(self) -> int:
        return 0 if self.cyl_p0 is None else self.cyl_p0.shape[0]

    @property
    def n_analytic(self) -> int:
        return self.n_spheres + self.n_disks + self.n_cylinders


@dataclasses.dataclass(frozen=True)
class Scene:
    geo: Geometry
    materials: MaterialTable
    emitters: EmitterTable
    sensor: Sensor
    ctab2: Optional[ClusterTable2] = None  # treelet tables of big meshes
    pbvh: Optional[PacketBVH] = None  # packet tables of big meshes
    # index of the environment (constant) emitter, -1 if none, read on
    # the host; set from the emitters when the scene is built
    env_emitter: int = dataclasses.field(init=False, compare=False)
    # the table of the packet route's walks, built once for each pbvh
    wbvh: Optional[WideBVH] = dataclasses.field(init=False, repr=False,
                                                compare=False)

    def __post_init__(self):
        object.__setattr__(self, "env_emitter",
                           env_emitter_index(self.emitters))
        object.__setattr__(self, "wbvh", None if self.pbvh is None
                           else self.pbvh.wide)

    @property
    def device(self) -> torch.device:
        return self.geo.tri_q.device

    def intersect_route(self) -> str:
        """"brute" (q kernels) up to BRUTE_FORCE_MAX_FACES faces; above,
        "clu2" where the scene has a ClusterTable2, else "packet" where it
        has a PacketBVH; a big mesh with neither raises."""
        if self.geo.n_faces <= BRUTE_FORCE_MAX_FACES:
            return "brute"
        if self.ctab2 is not None:
            return "clu2"
        if self.pbvh is not None:
            return "packet"
        raise ValueError(f"{self.geo.n_faces} faces need the clu2 or the "
                         "packet route, but the scene has no ClusterTable2 "
                         "and no PacketBVH")

    def _packet_perm(self, o, d):
        """Coherence sort for the packet route: (perm, inverse) of the rays
        ordered by direction octant, then the 8^3 Morton cell of the origin
        in the root box, then the 64^3 Morton cell of the direction. The
        sort is stable, so equal keys keep lane order."""
        lo, hi = self.pbvh.nodes[0, 0:3], self.pbvh.nodes[0, 3:6]
        rel = torch.clamp((o - lo) / torch.clamp_min(hi - lo, 1e-9),
                          0.0, 0.999)
        cell = (rel * 8.0).to(torch.int64)

        def spread3(x):  # 3 bits -> every third bit
            x = (x | (x << 4)) & 0x0C3
            return (x | (x << 2)) & 0x249

        def spread6(x):  # 6 bits -> every third bit
            x = (x | (x << 8)) & 0x00F00F
            x = (x | (x << 4)) & 0x0C30C3
            return (x | (x << 2)) & 0x249249

        morton = (spread3(cell[:, 0]) | (spread3(cell[:, 1]) << 1)
                  | (spread3(cell[:, 2]) << 2))
        neg = (d < 0).to(torch.int64)
        octant = neg[:, 0] | (neg[:, 1] << 1) | (neg[:, 2] << 2)
        dcell = torch.clamp((d * 0.5 + 0.5) * 64.0, 0.0,
                            63.999).to(torch.int64)
        dmorton = (spread6(dcell[:, 0]) | (spread6(dcell[:, 1]) << 1)
                   | (spread6(dcell[:, 2]) << 2))
        key = (octant << 27) | (morton << 18) | dmorton
        perm = torch.argsort(key, stable=True)
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(perm.shape[0], device=perm.device)
        return perm, inv

    # -- analytic primitives: [N, K] broadcasts over the few of a scene ----

    @staticmethod
    def _nearest(t_hit):
        """(t, index or -1) of each row's nearest finite hit of [N, K]."""
        t_best, best = torch.min(t_hit, dim=-1)
        return t_best, torch.where(torch.isfinite(t_best), best, -1)

    def _sphere_intersect(self, ray: Ray):
        """Nearest sphere hit beyond eps = 1e-4: (t [N], sphere or -1)."""
        geo = self.geo
        r = geo.sph_radius
        oc = ray.o[:, None, :] - geo.sph_center[None]        # [N, S, 3]
        b = fr.dot(oc, ray.d[:, None, :])                     # [N, S]
        cc = fr.dot(oc, oc) - (r * r)[None]
        disc = b * b - cc
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        t0, t1 = -b - sq, -b + sq
        eps, inf = 1e-4, float("inf")
        t_hit = torch.where(t0 > eps, t0, torch.where(t1 > eps, t1, inf))
        t_hit = torch.where(disc >= 0, t_hit, inf)
        t_hit = torch.where(t_hit < ray.maxt[:, None], t_hit, inf)
        return self._nearest(t_hit)

    def _disk_intersect(self, ray: Ray):
        """Nearest disk hit: the plane's, within the radius."""
        geo = self.geo
        c, nrm, r = geo.dsk_center, geo.dsk_n, geo.dsk_radius
        dn = fr.dot(ray.d[:, None, :], nrm[None])             # [N, D]
        facing = torch.abs(dn) > 1e-9
        t = fr.dot(c[None] - ray.o[:, None, :], nrm[None]) / torch.where(
            facing, dn, 1e-9)
        rel = ray.o[:, None, :] + ray.d[:, None, :] * t[..., None] - c[None]
        ok = facing & (t > 1e-4) & (fr.dot(rel, rel) <= (r * r)[None])
        return self._nearest(torch.where(ok & (t < ray.maxt[:, None]), t,
                                         float("inf")))

    def _cyl_intersect(self, ray: Ray):
        """Nearest open-cylinder hit: the infinite cylinder's quadratic,
        clipped to [0, len] along the axis."""
        geo = self.geo
        ax, ln, r = geo.cyl_axis, geo.cyl_len, geo.cyl_radius
        oc = ray.o[:, None, :] - geo.cyl_p0[None]             # [N, C, 3]
        d_a = fr.dot(ray.d[:, None, :], ax[None])
        oc_a = fr.dot(oc, ax[None])
        d_perp = ray.d[:, None, :] - d_a[..., None] * ax[None]
        oc_perp = oc - oc_a[..., None] * ax[None]
        A = fr.dot(d_perp, d_perp)
        B = fr.dot(d_perp, oc_perp)
        Cc = fr.dot(oc_perp, oc_perp) - (r * r)[None]
        disc = B * B - A * Cc
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        ok_a = A > 1e-12
        A_safe = torch.where(ok_a, A, 1e-12)
        inf = float("inf")

        def clipped(t):
            h = oc_a + t * d_a
            return torch.where((t > 1e-4) & (h >= 0.0) & (h <= ln[None]), t,
                               inf)

        t_hit = torch.minimum(clipped((-B - sq) / A_safe),
                              clipped((-B + sq) / A_safe))
        t_hit = torch.where((disc >= 0) & ok_a, t_hit, inf)
        t_hit = torch.where(t_hit < ray.maxt[:, None], t_hit, inf)
        return self._nearest(t_hit)

    def _analytic_intersect(self, ray: Ray):
        """(t, index or -1) of the nearest analytic hit over the families,
        numbered spheres, then disks, then cylinders; a later family takes
        a lane only at a strictly smaller t."""
        geo = self.geo
        n, dev = ray.o.shape[0], ray.o.device
        t_best = torch.full((n,), float("inf"), device=dev)
        idx_best = torch.full((n,), -1, dtype=torch.int64, device=dev)
        off = 0
        for count, hit in ((geo.n_spheres, self._sphere_intersect),
                           (geo.n_disks, self._disk_intersect),
                           (geo.n_cylinders, self._cyl_intersect)):
            if count:
                t_k, i_k = hit(ray)
                win = (i_k >= 0) & (t_k < t_best)
                t_best = torch.where(win, t_k, t_best)
                idx_best = torch.where(win, i_k + off, idx_best)
            off += count
        return t_best, idx_best

    def _analytic_shading(self, prim, valid, p, ng, ns, uv, attr3):
        """Each analytic family's exact normal, uv and (mat, emitter,
        shape) over the triangle values on the lanes whose prim is one of
        its members (prims from n_faces on: spheres, disks, cylinders)."""
        geo = self.geo
        base = geo.n_faces

        def override(count, fn):
            nonlocal base, ng, ns, uv, attr3
            if count:
                mine = valid & (prim >= base) & (prim < base + count)
                k = torch.clamp(prim - base, 0, count - 1)
                n_k, uv_k, a_k = fn(k)
                m3 = mine[..., None]
                ng = torch.where(m3, n_k, ng)
                ns = torch.where(m3, n_k, ns)
                uv = torch.where(m3, uv_k, uv)
                attr3 = torch.where(m3, a_k, attr3)
            base += count

        def sphere(k):
            n_s = fr.normalize(p - take_rows(geo.sph_center, k))
            phi = torch.atan2(n_s[..., 1], n_s[..., 0])
            theta = m.safe_acos(n_s[..., 2])
            uv_s = torch.stack([phi * (0.5 / m.Pi) + 0.5, theta / m.Pi], -1)
            return n_s, uv_s, take_rows(geo.sph_attr, k)

        def disk(k):
            n_d, s_d = take_rows(geo.dsk_n, k), take_rows(geo.dsk_s, k)
            rel = p - take_rows(geo.dsk_center, k)
            x = fr.dot(rel, s_d)
            y = fr.dot(rel, fr.cross(n_d, s_d))
            r_frac = torch.sqrt(torch.clamp_min(x * x + y * y, 0.0)) / (
                torch.clamp_min(take_rows(geo.dsk_radius, k), 1e-9))
            uv_d = torch.stack(
                [r_frac, torch.atan2(y, x) * (0.5 / m.Pi) + 0.5], -1)
            return n_d, uv_d, take_rows(geo.dsk_attr, k)

        def cylinder(k):
            ax = take_rows(geo.cyl_axis, k)
            rel = p - take_rows(geo.cyl_p0, k)
            h = fr.dot(rel, ax)
            n_c = fr.normalize(rel - h[..., None] * ax)
            s_ax, t_ax = fr.coordinate_system(ax)
            phi = torch.atan2(fr.dot(n_c, t_ax), fr.dot(n_c, s_ax))
            uv_c = torch.stack(
                [phi * (0.5 / m.Pi) + 0.5,
                 h / torch.clamp_min(take_rows(geo.cyl_len, k), 1e-9)], -1)
            return n_c, uv_c, take_rows(geo.cyl_attr, k)

        override(geo.n_spheres, sphere)
        override(geo.n_disks, disk)
        override(geo.n_cylinders, cylinder)
        return ng, ns, uv, attr3

    def ray_intersect(self, ray: Ray) -> SurfaceInteraction:
        """Closest hit -> SurfaceInteraction (wi in the shading frame).
        Every route takes the detached ray, as the JAX package's kernels
        do: t, u and v carry no gradient (the kernels read the ray's
        storage, out of autograd's sight); p, wi and the frames stay
        attached to the ray and the scene's tables. The analytic
        primitives take the attached ray, as in the JAX package; their
        prims number on from n_faces (spheres, disks, cylinders)."""
        geo = self.geo
        route = self.intersect_route()
        o, d, maxt = ray.o.detach(), ray.d.detach(), ray.maxt.detach()
        if route == "clu2":
            t, prim, u, v = isect.intersect_clu2(self.ctab2, o, d, maxt)
        elif route == "packet":
            perm, inv = self._packet_perm(o, d)
            t, prim, u, v = (x[inv] for x in isect.intersect_bvh(
                self.wbvh, o[perm], d[perm], maxt[perm]))
        else:
            t, prim, u, v = isect.intersect_q(
                geo.tri_q, geo.tri_anchor, o, d, maxt, n_tris=geo.n_faces)
        if geo.n_analytic:
            # the analytic hit takes the lane where it is nearer (the
            # primitives' own, attached ray, as in the JAX package)
            t_a, a_idx = self._analytic_intersect(ray)
            tri_valid = prim >= 0
            a_wins = (a_idx >= 0) & (~tri_valid | (t_a < torch.where(
                tri_valid, t, float("inf"))))
            t = torch.where(a_wins, t_a, t)
            prim = torch.where(
                a_wins, geo.n_faces + torch.clamp_min(a_idx, 0), prim.to(
                    torch.int64)).to(prim.dtype)
        valid = prim >= 0
        # an analytic prim reads the last face's row, then overrides it
        prim_c = torch.clamp(prim, 0, max(geo.n_faces - 1, 0)).to(torch.int64)
        # keep p finite on miss lanes
        p = ray.o + ray.d * torch.where(valid, t, 1.0)[..., None]
        attr = take_rows(geo.tri_attr, prim_c)
        ng = attr[..., 0:3]
        w = (1.0 - u - v)[..., None]
        u_, v_ = u[..., None], v[..., None]
        ns = fr.normalize(attr[..., 3:6] * w + attr[..., 6:9] * u_
                          + attr[..., 9:12] * v_)
        uv = attr[..., 12:14] * w + attr[..., 14:16] * u_ + attr[..., 16:18] * v_
        shape_idx = None
        if geo.n_analytic:
            ng, ns, uv, attr3 = self._analytic_shading(
                prim, valid, p, ng, ns, uv, attr[..., 18:21])
            a_mat, a_emitter, a_shape = attr3.to(torch.int64).unbind(-1)
            shape_idx = torch.where(valid, a_shape, -1)
        else:
            a_mat = attr[..., 18].to(torch.int64)
            a_emitter = attr[..., 19].to(torch.int64)
        sh_s, sh_t = fr.coordinate_system(ns)
        wi_world = -ray.d
        wi = torch.stack([fr.dot(wi_world, sh_s), fr.dot(wi_world, sh_t),
                          fr.dot(wi_world, ns)], dim=-1)
        return SurfaceInteraction(
            valid=valid, t=torch.where(valid, t, float("inf")), p=p, n=ng,
            sh_s=sh_s, sh_t=sh_t, sh_n=ns, uv=uv, wi=wi, prim_idx=prim,
            mat_idx=torch.where(valid, a_mat, -1),
            emitter_idx=torch.where(valid, a_emitter, -1),
            shape_idx=shape_idx,
        )

    def ray_test(self, ray: Ray) -> torch.Tensor:
        """Shadow-ray occlusion (True = occluded), of the detached ray."""
        geo = self.geo
        route = self.intersect_route()
        o, d, maxt = ray.o.detach(), ray.d.detach(), ray.maxt.detach()
        if route == "clu2":
            occ = isect.occluded_clu2(self.ctab2, o, d, maxt)
        elif route == "packet":
            perm, inv = self._packet_perm(o, d)
            occ = isect.occluded_bvh(self.wbvh, o[perm], d[perm],
                                     maxt[perm])[inv]
        else:
            occ = isect.occluded_q(geo.tri_q, geo.tri_anchor, o, d, maxt,
                                   n_tris=geo.n_faces)
        if geo.n_analytic:
            occ = occ | (self._analytic_intersect(ray)[1] >= 0)
        return occ
