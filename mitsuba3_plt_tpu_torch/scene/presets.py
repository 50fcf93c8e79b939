"""Built-in scenes constructed in code (no asset files).

`grating_scene` is a rough diffraction-grating slab on a dark floor lit by
a directional emitter and a faint constant environment: the PLT flagship.
It builds, with numpy alone, the same arrays the JAX package's
`scene/presets.py::grating_scene` produces and hands them to
`bridge.scene_from_arrays`.
"""
from __future__ import annotations

import numpy as np

from ..core import transform as tf
from ..librender.bsdf import (BSDF_DIFFUSE, BSDF_ROUGH_GRATING, BSDFFlags,
                              finalize_grating_meta)
from ..ops.intersect import pack_tri_q
from . import emitters as em
from .bridge import scene_from_arrays

_FLAGS = {
    BSDF_DIFFUSE: BSDFFlags.DiffuseReflection | BSDFFlags.FrontSide,
    BSDF_ROUGH_GRATING: BSDFFlags.GlossyReflection | BSDFFlags.FrontSide,
}


def make_rectangle(to_world):
    """Mitsuba's unit rectangle ([-1, 1]^2 at z = 0, normal +z) transformed
    by to_world [4, 4] float32: (vertices, faces, normals, uvs)."""
    v = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    n = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    v = (v @ to_world[:3, :3].T + to_world[:3, 3]).astype(np.float32)
    n = n @ np.linalg.inv(to_world[:3, :3])  # inverse transpose
    n = (n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True),
                        1e-20)).astype(np.float32)
    return v, f, n, uv


def _geometry(meshes, mat_ids, emitter_ids):
    """Arrays of the q table and the packed per-face attributes."""
    P, N, U, FN, ATT = [[], [], []], [[], [], []], [[], [], []], [], []
    for k, (v, f, n, uv) in enumerate(meshes):
        p = [v[f[:, c]] for c in range(3)]
        fn = np.cross(p[1] - p[0], p[2] - p[0])
        fn = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True),
                             1e-20)
        for c in range(3):
            P[c].append(p[c])
            N[c].append(n[f[:, c]])
            U[c].append(uv[f[:, c]])
        FN.append(fn)
        ATT.append(np.tile([[mat_ids[k], emitter_ids[k], k]], (len(f), 1)))
    cat = lambda xs: np.concatenate(xs, 0).astype(np.float32)  # noqa: E731
    p0, p1, p2 = (cat(x) for x in P)
    tri_q, anchor = pack_tri_q(p0, p1, p2)
    # 21 attribute columns, zero-padded to the JAX package's 24-wide layout
    attr = np.concatenate(
        [cat(FN), *(cat(x) for x in N), *(cat(x) for x in U), cat(ATT),
         np.zeros((len(p0), 3), np.float32)], axis=-1)
    lo = np.minimum.reduce([p0.min(0), p1.min(0), p2.min(0)])
    hi = np.maximum.reduce([p0.max(0), p1.max(0), p2.max(0)])
    radius = float(np.linalg.norm(hi - lo) / 2)
    return {"geo.tri_q": tri_q, "geo.tri_anchor": anchor,
            "geo.tri_attr": attr}, radius


def _materials(bsdfs):
    """Material rows on the JAX package's defaults: (arrays, static)."""
    M = len(bsdfs)
    tab = {
        "mtype": np.array([b[0] for b in bsdfs], np.int32),
        "flags": np.array([_FLAGS[b[0]] for b in bsdfs], np.uint32),
        "twosided": np.zeros(M, bool),
        "base_color": np.full((M, 3), 0.5, np.float32),
        "eta_re": np.zeros((M, 3), np.float32),
        "eta_im": np.ones((M, 3), np.float32),
        "alpha": np.full((M, 2), 0.1, np.float32),
        "mf_type": np.ones(M, np.int32),  # Beckmann, the reference default
        "grt_inv_period": np.ones((M, 2), np.float32),
        "grt_height": np.full(M, 0.1, np.float32),
        "grt_lobes": np.full(M, 3, np.int32),
        "grt_type": np.zeros(M, np.int32),
        "grt_multiplier": np.ones(M, np.float32),
        "grt_coherence": np.ones(M, np.float32),
    }
    for i, (btype, params) in enumerate(bsdfs):
        if btype not in _FLAGS:
            raise NotImplementedError(f"BSDF type {btype} is not ported")
        for key, val in params.items():
            if key not in tab:
                raise NotImplementedError(f"material parameter {key!r}")
            tab[key][i] = val
    grt_static, mf_static = finalize_grating_meta(
        tab["mtype"], tab["mf_type"], tab["grt_lobes"],
        tab["grt_inv_period"], tab["grt_type"])
    static = {
        "materials.present_types": tuple(sorted({b[0] for b in bsdfs})),
        "materials.grt_static": grt_static,
        "materials.mf_static": mf_static,
    }
    return {"materials." + k: v for k, v in tab.items()}, static


def _emitters(emitters, scene_radius):
    E = len(emitters)
    etype = np.zeros(E, np.int32)
    radiance = np.ones((E, 3), np.float32)
    direction = np.tile(np.array([[0, 0, 1]], np.float32), (E, 1))
    for i, e in enumerate(emitters):
        kind = {"constant": em.EMITTER_CONSTANT,
                "directional": em.EMITTER_DIRECTIONAL}.get(e["type"])
        if kind is None:
            raise NotImplementedError(f"emitter type {e['type']!r}")
        etype[i] = kind
        radiance[i] = e["radiance"]
        if "direction" in e:
            d = np.asarray(e["direction"], np.float64)
            direction[i] = d / np.linalg.norm(d)
    arrays = {
        "emitters.etype": etype, "emitters.radiance": radiance,
        "emitters.direction": direction,
        "emitters.scene_radius": np.asarray(scene_radius, np.float32),
    }
    return arrays, {"emitters.present_types": tuple(sorted(set(etype)))}


def _sensor(to_world, fov_x_deg, width, height):
    arrays = {
        "sensor.to_world": np.asarray(to_world, np.float32),
        "sensor.tan_half_x": np.asarray(np.tan(np.deg2rad(fov_x_deg) / 2),
                                        np.float32),
        "sensor.aspect": np.asarray(width / height, np.float32),
        "sensor.ppo": np.zeros(2, np.float32),
    }
    return arrays, {"sensor.resolution": (width, height),
                    "sensor.stype_static": 0}


def grating_scene_arrays(width: int = 256, height: int = 256, *,
                         inv_period=(0.6, 0.0), lobes: int = 7,
                         height_um: float = 0.04, alpha: float = 0.04,
                         radial: bool = False, grt_type: int = 0,
                         coherence: float = 6e5, multiplier: float = 10.0,
                         light_angle_deg: float = -15.0):
    """The (arrays, static) pair of `grating_scene`, numpy only."""
    bsdfs = [
        (BSDF_DIFFUSE, {"base_color": (0.1, 0.1, 0.1)}),
        (BSDF_ROUGH_GRATING, {
            "eta_re": (0.2, 0.92, 1.1), "eta_im": (3.9, 2.45, 2.14),
            "alpha": (alpha, alpha), "grt_inv_period": tuple(inv_period),
            "grt_height": height_um, "grt_lobes": lobes,
            "grt_type": grt_type + (16 if radial else 0),
            "grt_multiplier": multiplier, "grt_coherence": coherence,
        }),
    ]
    floor = make_rectangle(
        (tf.translate([0, -0.501, 0]) @ tf.rotate([1, 0, 0], -90)
         @ tf.scale([4, 4, 1])).astype(np.float32))
    slab = make_rectangle(
        (tf.translate([0, -0.5, 0]) @ tf.rotate([1, 0, 0], -90)).astype(
            np.float32))
    geo, radius = _geometry([floor, slab], [0, 1], [-1, -1])

    th = np.deg2rad(light_angle_deg)
    d = np.array([np.sin(th), -np.cos(th), 0.0])  # light propagation dir
    emitters = [
        {"type": "directional", "direction": tuple(d),
         "radiance": (4.0, 4.0, 4.0)},
        {"type": "constant", "radiance": (0.01, 0.01, 0.01)},
    ]
    # camera on the specular side, in the plane of incidence (x-y)
    spec = np.array([-np.sin(th), np.cos(th), 0.0])
    cam_pos = np.array([0.0, -0.5, 0.0]) + 2.2 * spec + np.array([0, 0, 0.35])
    mats, mat_static = _materials(bsdfs)
    ems, em_static = _emitters(emitters, radius)
    sens, sens_static = _sensor(
        tf.look_at(cam_pos, [0, -0.5, 0], [0, 1, 0]), 45.0, width, height)
    return ({**geo, **mats, **ems, **sens},
            {**mat_static, **em_static, **sens_static})


def grating_scene(width: int = 256, height: int = 256, *, device="cuda",
                  **kwargs):
    """The grating scene (parameters of the reference's gratings.xml:
    sinusoidal, height 0.04 um, inv_period 0.6/um, 7 lobes, alpha 0.04,
    multiplier 10, coherence 6e5) on `device`; keyword arguments as in
    `grating_scene_arrays`."""
    arrays, static = grating_scene_arrays(width, height, **kwargs)
    return scene_from_arrays(arrays, static, device=device)
