"""Scene: triangle tables, materials, emitters and sensor as tensors, with
ray_intersect building SurfaceInteraction records and ray_test answering
shadow rays. Routing is by face count and the tables the scene holds: up
to 4096 triangles every ray goes to the brute-force q kernels; above that
to the two-level treelet (clu2) kernels over the scene's ClusterTable2 or,
where it has none, to the packet route on rays sorted for coherence: the
closest hit walks the WideBVH built from the scene's PacketBVH, shadow rays
the PacketBVH's skip links (`ops/intersect.py`)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import frame as fr
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
    """Triangle soup: the q table for intersection, the (p0, e1, e2) rows
    (area-light sampling, the classic and MXU brute force) and one packed
    row of shading attributes per face."""

    tri_q: torch.Tensor       # [F_pad, 16] (ops.intersect.pack_tri_q)
    tri_anchor: torch.Tensor  # [3] scene-centre anchor
    # [F_pad, 9]: p0(3) e1(3) e2(3), zero rows padding F to a multiple of 64
    tri_isect: torch.Tensor
    # [F, 24]: ng(3) n0(3) n1(3) n2(3) uv0(2) uv1(2) uv2(2) mat emitter shape
    tri_attr: torch.Tensor

    @property
    def n_faces(self) -> int:
        return self.tri_attr.shape[0]


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

    def ray_intersect(self, ray: Ray) -> SurfaceInteraction:
        """Closest hit -> SurfaceInteraction (wi in the shading frame).
        Every route takes the detached ray, as the JAX package's kernels
        do: t, u and v carry no gradient (the kernels read the ray's
        storage, out of autograd's sight); p, wi and the frames stay
        attached to the ray and the scene's tables."""
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
        valid = prim >= 0
        prim_c = torch.clamp_min(prim, 0).to(torch.int64)
        # keep p finite on miss lanes
        p = ray.o + ray.d * torch.where(valid, t, 1.0)[..., None]
        attr = take_rows(geo.tri_attr, prim_c)
        ng = attr[..., 0:3]
        w = (1.0 - u - v)[..., None]
        u_, v_ = u[..., None], v[..., None]
        ns = fr.normalize(attr[..., 3:6] * w + attr[..., 6:9] * u_
                          + attr[..., 9:12] * v_)
        uv = attr[..., 12:14] * w + attr[..., 14:16] * u_ + attr[..., 16:18] * v_
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
        )

    def ray_test(self, ray: Ray) -> torch.Tensor:
        """Shadow-ray occlusion (True = occluded), of the detached ray."""
        geo = self.geo
        route = self.intersect_route()
        o, d, maxt = ray.o.detach(), ray.d.detach(), ray.maxt.detach()
        if route == "clu2":
            return isect.occluded_clu2(self.ctab2, o, d, maxt)
        if route == "packet":
            perm, inv = self._packet_perm(o, d)
            return isect.occluded_bvh(self.wbvh, o[perm], d[perm],
                                      maxt[perm])[inv]
        return isect.occluded_q(geo.tri_q, geo.tri_anchor, o, d, maxt,
                                n_tris=geo.n_faces)
