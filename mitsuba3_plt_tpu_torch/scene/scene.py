"""Scene: triangle tables, materials, emitters and sensor as tensors, with
ray_intersect building SurfaceInteraction records and ray_test answering
shadow rays. Routing is by face count alone: up to 4096 triangles every
ray goes to the brute-force q kernels, above that to the two-level treelet
(clu2) kernels over the scene's ClusterTable2 (`ops/intersect.py`)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import frame as fr
from ..librender.bsdf import MaterialTable
from ..librender.records import Ray, SurfaceInteraction
from ..librender.sensor import Sensor
from ..ops import intersect as isect
from .bvh import ClusterTable2
from .emitters import EmitterTable

BRUTE_FORCE_MAX_FACES = 4096


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Triangle soup: the q table for intersection and one packed row of
    shading attributes per face."""

    tri_q: torch.Tensor       # [F_pad, 16] (ops.intersect.pack_tri_q)
    tri_anchor: torch.Tensor  # [3] scene-centre anchor
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

    @property
    def device(self) -> torch.device:
        return self.geo.tri_q.device

    def intersect_route(self) -> str:
        """"brute" (q kernels) up to BRUTE_FORCE_MAX_FACES faces, "clu2"
        above; a big mesh without a ClusterTable2 raises."""
        if self.geo.n_faces <= BRUTE_FORCE_MAX_FACES:
            return "brute"
        if self.ctab2 is None:
            raise ValueError(f"{self.geo.n_faces} faces need the clu2 route, "
                             "but the scene has no ClusterTable2")
        return "clu2"

    def ray_intersect(self, ray: Ray) -> SurfaceInteraction:
        """Closest hit -> SurfaceInteraction (wi in the shading frame)."""
        geo = self.geo
        if self.intersect_route() == "clu2":
            t, prim, u, v = isect.intersect_clu2(self.ctab2, ray.o, ray.d,
                                                 ray.maxt)
        else:
            t, prim, u, v = isect.intersect_q(
                geo.tri_q, geo.tri_anchor, ray.o, ray.d, ray.maxt,
                n_tris=geo.n_faces)
        valid = prim >= 0
        prim_c = torch.clamp_min(prim, 0).to(torch.int64)
        # keep p finite on miss lanes
        p = ray.o + ray.d * torch.where(valid, t, 1.0)[..., None]
        attr = geo.tri_attr[prim_c]
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
        """Shadow-ray occlusion (True = occluded)."""
        geo = self.geo
        if self.intersect_route() == "clu2":
            return isect.occluded_clu2(self.ctab2, ray.o, ray.d, ray.maxt)
        return isect.occluded_q(geo.tri_q, geo.tri_anchor, ray.o, ray.d,
                                ray.maxt, n_tris=geo.n_faces)
