"""Build the port's Scene from flat numpy arrays keyed by the JAX Scene's
pytree paths ("geo.tri_q", "materials.alpha", "emitters.etype",
"sensor.to_world", ...) plus the static fields that are not leaves.

The JAX package's scenes reach the port through this function (tests
flatten a JAX Scene with `jax.tree_util.tree_flatten_with_path`), and so
does the port's own preset, which builds the same dict with numpy alone.
Leaves this slice does not read (spectral curves, principled and nested
material parameters, the BVH, area-emitter tables) are ignored; a scene
that needs anything this slice does not port is refused.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..librender.bsdf import (BSDF_DIFFUSE, BSDF_ROUGH_CONDUCTOR,
                              BSDF_ROUGH_GRATING, FIELDS, MaterialTable)
from ..librender.sensor import Sensor
from . import emitters as em
from .scene import BRUTE_FORCE_MAX_FACES, Geometry, Scene

SUPPORTED_BSDFS = (BSDF_DIFFUSE, BSDF_ROUGH_CONDUCTOR, BSDF_ROUGH_GRATING)
SENSOR_PERSPECTIVE = 0

# geometry, material and scene features of the JAX package that this slice
# does not port: any leaf under these paths refuses the scene
_REFUSED_PREFIXES = (
    "geo.sph_", "geo.dsk_", "geo.cyl_", "geo.tri_mxu", "medium.", "pbvh.",
    "ctab.", "ctab2.", "sdfs", "materials.tex_", "materials.meas",
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
    if int(static["sensor.stype_static"]) != SENSOR_PERSPECTIVE:
        raise NotImplementedError("only the perspective sensor is ported")

    def t(key, dtype=torch.float32):
        return torch.as_tensor(np.array(arrays[key]), device=dev).to(dtype)

    attr = np.asarray(arrays["geo.tri_attr"])
    if attr.shape[1] != 24:
        raise NotImplementedError("per-face tangents / vertex colours")
    if attr.shape[0] > BRUTE_FORCE_MAX_FACES:
        raise NotImplementedError(
            f"{attr.shape[0]} faces: only the brute-force route is ported")

    geo = Geometry(tri_q=t("geo.tri_q"), tri_anchor=t("geo.tri_anchor"),
                   tri_attr=t("geo.tri_attr"))
    mats = MaterialTable(
        **{name: t("materials." + name, dtype)
           for name, dtype in FIELDS.items()},
        present_types=present,
        grt_static=tuple(int(x) for x in static["materials.grt_static"]),
        mf_static=int(static["materials.mf_static"]),
    )
    emitters = em.EmitterTable(
        etype=t("emitters.etype", torch.int64),
        radiance=t("emitters.radiance"), direction=t("emitters.direction"),
        scene_radius=t("emitters.scene_radius"), present_types=em_present,
    )
    sensor = Sensor(
        to_world=t("sensor.to_world"), tan_half_x=t("sensor.tan_half_x"),
        aspect=t("sensor.aspect"), ppo=t("sensor.ppo"),
        resolution=tuple(int(x) for x in static["sensor.resolution"]),
    )
    return Scene(geo=geo, materials=mats, emitters=emitters, sensor=sensor)
