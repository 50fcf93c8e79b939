"""Build the port's Scene from flat numpy arrays keyed by the JAX Scene's
pytree paths ("geo.tri_q", "materials.alpha", "emitters.etype",
"sensor.to_world", ...) plus the static fields that are not leaves.

The JAX package's scenes reach the port through this function (tests
flatten a JAX Scene with `jax.tree_util.tree_flatten_with_path`), and so
does the port's own preset, which builds the same dict with numpy alone.
Leaves the port does not read (spectral curves, principled and nested
material parameters, the skip-link BVH, spot-light beams) are ignored;
a scene that needs anything the port does not have is refused. A scene
above 4096 faces needs its `ctab2.*` treelet tables or its `pbvh.*` packet
tables. Analytic spheres, disks and cylinders (`geo.sph_*`, `geo.dsk_*`,
`geo.cyl_*`) come with their own rows; all seven sensor types are ported.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..librender.bsdf import (BSDF_CONDUCTOR, BSDF_DIELECTRIC, BSDF_DIFFUSE,
                              BSDF_ROUGH_CONDUCTOR, BSDF_ROUGH_GRATING, FIELDS,
                              MaterialTable)
from ..librender import sensor as sn
from . import emitters as em
from .bvh import ClusterTable2, PacketBVH
from .scene import BRUTE_FORCE_MAX_FACES, Geometry, Scene

SUPPORTED_BSDFS = (BSDF_DIFFUSE, BSDF_CONDUCTOR, BSDF_ROUGH_CONDUCTOR,
                   BSDF_DIELECTRIC, BSDF_ROUGH_GRATING)
# the triangle soup's vertex rows [F, 3], which the boundary gradients
# (`ad/projective.py`) read and differentiate
VERTEX_FIELDS = ("tri_p0", "tri_p1", "tri_p2")
ANALYTIC_FIELDS = ("sph_center", "sph_radius", "sph_attr", "dsk_center",
                   "dsk_n", "dsk_s", "dsk_radius", "dsk_attr", "cyl_p0",
                   "cyl_axis", "cyl_len", "cyl_radius", "cyl_attr")

# geometry, material and scene features of the JAX package that this slice
# does not port: any leaf under these paths refuses the scene
_REFUSED_PREFIXES = (
    "geo.tri_mxu", "medium.", "ctab.",
    "sdfs", "materials.tex_", "materials.meas",
    "materials.mpol", "materials.vtex_", "emitters.env_", "emitters.proj_",
    "sensor.srf",
)

STATIC_KEYS = ("materials.present_types", "materials.grt_static",
               "materials.mf_static", "emitters.present_types",
               "sensor.resolution", "sensor.stype_static")


def scene_from_arrays(arrays: dict, static: dict, device="cuda") -> Scene:
    """arrays: {pytree path: np.ndarray}; static: the STATIC_KEYS values."""
    dev = resolve_device(device)
    for key in arrays:
        if key.startswith(_REFUSED_PREFIXES):
            raise NotImplementedError(f"scene feature {key!r} is not ported")
    missing = [k for k in STATIC_KEYS if k not in static]
    if missing:
        raise KeyError(f"static fields missing: {missing}")

    present = tuple(int(t) for t in static["materials.present_types"])
    if not set(present) <= set(SUPPORTED_BSDFS):
        raise NotImplementedError(f"BSDF types {present} are not all ported")
    em_present = tuple(int(t) for t in static["emitters.present_types"])
    if not set(em_present) <= set(em.SUPPORTED):
        raise NotImplementedError(f"emitter types {em_present} are not ported")
    if int(static["sensor.stype_static"]) not in sn.SENSOR_TYPES:
        raise NotImplementedError(
            f"sensor type {static['sensor.stype_static']} is not ported")

    def t(key, dtype=torch.float32):
        return torch.as_tensor(np.array(arrays[key]), device=dev).to(dtype)

    attr = np.asarray(arrays["geo.tri_attr"])
    if attr.shape[1] != 24:
        raise NotImplementedError("per-face tangents / vertex colours")
    ctab2 = pbvh = None
    if "ctab2.rows" in arrays:
        ctab2 = ClusterTable2(**{name: t("ctab2." + name) for name in
                                 ("supers", "boxes", "rows", "anchor")})
    if "pbvh.nodes" in arrays:
        pbvh = PacketBVH(nodes=t("pbvh.nodes"), tri=t("pbvh.tri"))
    if (ctab2 is None and pbvh is None
            and attr.shape[0] > BRUTE_FORCE_MAX_FACES):
        raise NotImplementedError(
            f"{attr.shape[0]} faces without ctab2 or pbvh tables: the port "
            "has no other route for big meshes")

    for family in ("sph_", "dsk_", "cyl_"):
        have = [n for n in ANALYTIC_FIELDS
                if n.startswith(family) and "geo." + n in arrays]
        want = [n for n in ANALYTIC_FIELDS if n.startswith(family)]
        if have and have != want:
            raise ValueError(f"analytic rows {sorted(set(want) - set(have))}"
                             " missing")
    geo = Geometry(**{name: t("geo." + name) for name in VERTEX_FIELDS},
                   tri_q=t("geo.tri_q"), tri_anchor=t("geo.tri_anchor"),
                   tri_isect=t("geo.tri_isect"), tri_attr=t("geo.tri_attr"),
                   **{name: t("geo." + name) for name in ANALYTIC_FIELDS
                      if "geo." + name in arrays})
    mats = MaterialTable(
        **{name: t("materials." + name, dtype)
           for name, dtype in FIELDS.items()},
        present_types=present,
        grt_static=tuple(int(x) for x in static["materials.grt_static"]),
        mf_static=int(static["materials.mf_static"]),
    )
    emitters = em.EmitterTable(
        etype=t("emitters.etype", torch.int64),
        radiance=t("emitters.radiance"), position=t("emitters.position"),
        direction=t("emitters.direction"),
        cutoff_cos=t("emitters.cutoff_cos"),
        tri_idx=t("emitters.tri_idx", torch.int64),
        tri_cdf=t("emitters.tri_cdf"), area=t("emitters.area"),
        scene_radius=t("emitters.scene_radius"), present_types=em_present,
    )
    sensor = sn.Sensor(
        **{name: t("sensor." + name) for name in sn.FIELDS
           if name != "stype"},
        stype=t("sensor.stype", torch.int64),
        resolution=tuple(int(x) for x in static["sensor.resolution"]),
        stype_static=int(static["sensor.stype_static"]),
    )
    return Scene(geo=geo, materials=mats, emitters=emitters, sensor=sensor,
                 ctab2=ctab2, pbvh=pbvh)
