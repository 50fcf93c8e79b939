"""Scene loading: the Mitsuba XML subset -> (Scene, meta), and the scene
assembly through which the presets, the XML loader and the dict loader
(`dict_loader.py`) build every scene. The JAX package's
`scene/loader.py` (`load_file`, `assemble_scene`), on the port's subset:

- BSDFs: diffuse, conductor, roughconductor, dielectric, roughgrating and
  twosided, with the `int_ior` / `ext_ior` / `material` presets. A Mitsuba
  BSDF type the port lacks raises NotImplementedError by name, a name in
  no table warns and takes the default diffuse BSDF, and textures raise;
- emitters: area (on meshes and analytic spheres), point, constant and
  directional; spot, envmap, projector, directionalarea and
  directionalspot raise;
- shapes: ply, obj, serialized, rectangle, cube, analytic sphere, disk and
  cylinder (tessellated under a non-uniform scale or with an area light),
  merge, shapegroup / instance; sdfgrid, curves and media raise;
- sensors: perspective, orthographic, thinlens, batch, radiancemeter,
  irradiancemeter and distant, with the film's size and filter and the
  sampler's type and sample count; a sensor's spectral response raises.

Both loaders build sensors and BSDFs through `make_sensor` and
`make_bsdf`, on Mitsuba's dict form (`_plugin_dict` turns an XML element
into it); the XML loader fills absent BSDF parameters from
XML_BSDF_DEFAULTS. A tessellated disk, cylinder or sphere keeps its own
radius, p0 / p1 or centre (`shape_to_world`).

Above BRUTE_FORCE_MAX_FACES faces `assemble_scene` builds the skip-link
BVH and the two-level treelet tables of the clu2 route; at or below, the
scene takes the brute route.
"""
from __future__ import annotations

import os
import warnings
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np

from ..core import transform as tf
from ..core.rng import SAMPLER_TYPES
from ..librender.bsdf import (BSDF_CONDUCTOR, BSDF_DIELECTRIC, BSDF_DIFFUSE,
                              BSDF_ROUGH_CONDUCTOR, BSDF_ROUGH_GRATING)
from ..librender.sensor import Sensor
from . import presets as ps
from . import shape as shp
from .bridge import SUPPORTED_BSDFS, scene_from_arrays
from .bvh import build_bvh, pack_clusters2_arrays
from .scene import BRUTE_FORCE_MAX_FACES

# Mitsuba's named indices of refraction (a subset of its database)
IOR_PRESETS = {
    "vacuum": 1.0, "air": 1.000277, "water": 1.3330, "water ice": 1.31,
    "fused quartz": 1.458, "pyrex": 1.470, "acrylic glass": 1.49,
    "polypropylene": 1.49, "bk7": 1.5046, "sodium chloride": 1.544,
    "amber": 1.55, "pet": 1.5750, "diamond": 2.419,
}

# conductors' (eta, k) at the RGB primaries; "none" is the ideal mirror
CONDUCTOR_PRESETS = {
    "none": ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
    "au": ((0.1431, 0.3749, 1.4424), (3.9831, 2.3857, 1.6032)),
    "ag": ((0.1552, 0.1162, 0.1383), (4.8283, 3.1222, 2.1457)),
    "al": ((1.6581, 0.8821, 0.5211), (9.2238, 6.2691, 4.8370)),
    "cu": ((0.2004, 0.9240, 1.1022), (3.9129, 2.4528, 2.1421)),
}

# Mitsuba BSDF names and the JAX package's type ids of each
BSDF_TYPE_MAP = {
    "diffuse": BSDF_DIFFUSE, "conductor": BSDF_CONDUCTOR,
    "roughconductor": BSDF_ROUGH_CONDUCTOR, "dielectric": BSDF_DIELECTRIC,
    "thindielectric": 5, "roughdielectric": 6, "plastic": 7,
    "roughplastic": 8, "mask": 10, "polarizer": 11, "retarder": 12,
    "roughgrating": BSDF_ROUGH_GRATING, "null": 0, "principled": 19,
    "principledthin": 20, "measured": 14, "hair": 21,
    "measured_polarized": 22,
}
# the BSDF names a scene may use, and those it may not
PORTED_BSDFS = ("diffuse", "conductor", "roughconductor", "dielectric",
                "roughgrating")
UNPORTED_BSDFS = tuple(sorted(
    (set(BSDF_TYPE_MAP) - set(PORTED_BSDFS))
    | {"pplastic", "circular", "blendbsdf", "normalmap", "bumpmap"}))
EMITTERS = ("area", "point", "constant", "directional")
UNPORTED_EMITTERS = ("spot", "envmap", "projector", "directionalarea",
                     "directionalspot")
UNPORTED_SHAPES = ("sdfgrid", "bsplinecurve", "linearcurve")
SENSORS = ("perspective", "orthographic", "thinlens", "batch",
           "radiancemeter", "irradiancemeter", "distant")
A10 = "ROADMAP A10"


class LoadedBSDF:
    """Host-side staging record for one material-table row."""

    def __init__(self, btype, **kw):
        self.btype = btype
        self.twosided = kw.pop("twosided", False)
        self.params = kw


def default_bsdf():
    return LoadedBSDF(BSDF_DIFFUSE, base_color=(0.5, 0.5, 0.5))


def ported_bsdf(name) -> bool:
    """Whether BSDF `name` is one the port renders. A Mitsuba BSDF it lacks
    raises NotImplementedError; a name in no table warns and answers False
    (the caller takes the default diffuse BSDF)."""
    if name in PORTED_BSDFS:
        return True
    if name in UNPORTED_BSDFS:
        raise NotImplementedError(f"BSDF type {name!r} is not ported: {A10}")
    warnings.warn(f"unknown BSDF type {name!r}: using the default diffuse "
                  "BSDF")
    return False


def check_emitter(name):
    """Raise NotImplementedError unless emitter type `name` is ported."""
    if name not in EMITTERS:
        why = f": {A10}" if name in UNPORTED_EMITTERS else ""
        raise NotImplementedError(f"emitter type {name!r} is not ported{why}")


def refuse_shape(name):
    why = f": {A10}" if name in UNPORTED_SHAPES else ""
    raise NotImplementedError(f"shape type {name!r} is not ported{why}")


def ior_value(v) -> float:
    """An index of refraction: a number or a name of IOR_PRESETS."""
    if isinstance(v, str):
        if v in IOR_PRESETS:
            return IOR_PRESETS[v]
        return float(v)  # a number written as a string, or ValueError
    return float(v)


def conductor_preset(material):
    key = str(material).lower()
    if key not in CONDUCTOR_PRESETS:
        raise NotImplementedError(
            f"conductor material {material!r} is not one of "
            f"{sorted(CONDUCTOR_PRESETS)}")
    return CONDUCTOR_PRESETS[key]


def perspective_fov_x(fov, fov_axis, width, height) -> float:
    """Mitsuba's fov along `fov_axis` ("x", "y", "diagonal", "smaller" or
    "larger") as the horizontal fov in degrees."""
    if fov_axis == "smaller":
        fov_axis = "x" if width <= height else "y"
    elif fov_axis == "larger":
        fov_axis = "x" if width >= height else "y"
    if fov_axis == "x":
        return float(fov)
    t = np.tan(np.deg2rad(fov) / 2)
    if fov_axis == "y":
        return float(np.rad2deg(2 * np.arctan(t * width / height)))
    if fov_axis == "diagonal":
        return float(np.rad2deg(2 * np.arctan(
            t * width / np.hypot(width, height))))
    raise ValueError(f"unknown fov_axis {fov_axis!r}")


def emitter_row(e: dict) -> dict:
    """An emitter as `presets._emitters` takes it: its radiance from
    "radiance", "intensity" or "irradiance" (a number is grey), and its
    position, direction, to_world, centre and radius."""
    check = e["type"] if e["type"] != "sphere_area" else "area"
    check_emitter(check)
    rad = e.get("radiance", e.get("intensity", e.get("irradiance",
                                                     (1.0, 1.0, 1.0))))
    if np.isscalar(rad):
        rad = (rad,) * 3
    elif np.asarray(rad).shape != (3,):
        raise NotImplementedError("textured emitter radiance is not ported: "
                                  f"{A10}")
    row = {"type": e["type"], "radiance": tuple(np.asarray(rad, np.float64))}
    for key in ("position", "to_world", "direction", "center", "radius"):
        if key in e:
            row[key] = e[key]
    return row


# ---------------------------------------------------------------------------
# XML parsing helpers
# ---------------------------------------------------------------------------

def _parse_value(s: str, defaults: Dict[str, str]) -> str:
    if s.startswith("$"):
        key = s[1:]
        if key not in defaults:
            raise ValueError(f"undefined scene parameter ${key}")
        return defaults[key]
    return s


def _parse_vec(s: str) -> np.ndarray:
    v = np.array([float(x) for x in s.replace(",", " ").split()], np.float64)
    return np.repeat(v, 3) if v.size == 1 else v


def _parse_transform(elem, defaults) -> np.ndarray:
    """A <transform>'s children composed in order, each later one applied
    to the result (M = C_n @ ... @ C_1), in float32."""
    M = np.eye(4, dtype=np.float32)
    for child in elem:
        tag = child.tag
        if tag == "translate":
            T = tf.translate(_get_xyz_or_value(child, defaults, 0.0))
        elif tag == "scale":
            T = tf.scale(_get_xyz_or_value(child, defaults, 1.0))
        elif tag == "rotate":
            angle = float(_parse_value(child.get("angle", "0"), defaults))
            axis = _get_xyz_or_value(child, defaults, 0.0)
            if np.linalg.norm(axis) == 0:
                axis = np.array([0, 0, 1.0])
            T = tf.rotate(axis, angle)
        elif tag == "matrix":
            vals = [float(x) for x in
                    _parse_value(child.get("value"), defaults).split()]
            if len(vals) == 16:
                T = np.array(vals, np.float32).reshape(4, 4)
            else:
                T = np.eye(4, dtype=np.float32)
                T[:3, :3] = np.array(vals, np.float32).reshape(3, 3)
        elif tag in ("lookat", "look_at"):
            def vec(name, default=None):
                return _parse_vec(_parse_value(child.get(name, default),
                                               defaults))

            T = tf.look_at(vec("origin"), vec("target"), vec("up", "0 1 0"))
        else:
            raise NotImplementedError(f"transform element <{tag}>")
        M = T @ M
    return M


def _get_xyz_or_value(child, defaults, default=0.0):
    if child.get("value") is not None:
        return _parse_vec(_parse_value(child.get("value"), defaults))
    return np.array([float(_parse_value(child.get(a, str(default)),
                                        defaults)) for a in ("x", "y", "z")])


def _props(elem, defaults) -> Dict[str, object]:
    """The typed property children of a plugin element."""
    out = {}
    for child in elem:
        name, tag = child.get("name"), child.tag

        def value():
            return _parse_value(child.get("value"), defaults)

        if tag == "float":
            out[name] = float(value())
        elif tag == "integer":
            out[name] = int(float(value()))
        elif tag == "boolean":
            out[name] = value().lower() == "true"
        elif tag == "string":
            out[name] = value()
        elif tag == "rgb":
            out[name] = tuple(_parse_vec(value()))
        elif tag == "spectrum":
            # a uniform value, or wavelength:value pairs taken as their mean
            sval = _parse_value(child.get("value", "1"), defaults)
            if ":" in sval:
                ys = [float(p.split(":")[1])
                      for p in sval.replace(",", " ").split()]
                out[name] = tuple([float(np.mean(ys))] * 3)
            else:
                out[name] = tuple([float(sval)] * 3)
        elif tag == "transform":
            out[name] = _parse_transform(child, defaults)
        elif tag in ("point", "vector"):
            out[name] = _get_xyz_or_value(child, defaults)
    return out


# ---------------------------------------------------------------------------
# BSDFs and sensors, in the dict loader's form
# ---------------------------------------------------------------------------

_GREY1 = (1.0, 1.0, 1.0)
# The values the XML loader gives a ported BSDF's absent parameters (the
# JAX package's XML parser sets them); the dict loader leaves them at the
# material table's defaults, as the JAX package's dict loader does.
XML_BSDF_DEFAULTS = {
    "diffuse": {"reflectance": (0.5, 0.5, 0.5)},
    "conductor": {"material": "none", "specular_reflectance": _GREY1},
    "roughconductor": {"material": "none", "specular_reflectance": _GREY1,
                       "alpha": 0.1, "distribution": "beckmann"},
    "dielectric": {"int_ior": "bk7", "ext_ior": "air",
                   "specular_reflectance": _GREY1,
                   "specular_transmittance": _GREY1},
    "roughgrating": {"specular_reflectance": _GREY1,
                     "eta": (0.2, 0.92, 1.1), "k": (3.9, 2.45, 2.14),
                     "alpha": 0.1, "inv_period": 0.1, "height": 0.3,
                     "lobes": 5, "lobe_type": "rectangular",
                     "multiplier": 1.0, "coherence": 1e-18},
}
LOBE_TYPES = {"sinusoidal": 0, "rectangular": 1, "linear": 2}


def color(v):
    """An RGB triple of a number, a sequence or an {"type": "rgb" or
    "spectrum", "value": ...} dict; a texture raises."""
    if isinstance(v, dict):
        if v.get("type", "rgb") not in ("rgb", "spectrum"):
            raise NotImplementedError(
                f"texture {v.get('type')!r} is not ported: {A10}")
        v = v.get("value", 0.5)
    if np.isscalar(v):
        return (float(v),) * 3
    return tuple(float(x) for x in v)


def _true(v) -> bool:
    return v is True or str(v).lower() in ("true", "1")


def make_bsdf(d: dict, defaults=None) -> LoadedBSDF:
    """The material row's staging record of a BSDF in dict form (a twosided
    one's inner BSDF is its first nested dict). `defaults` maps a BSDF type
    to the values of its absent parameters (the XML loader passes
    XML_BSDF_DEFAULTS); without it they keep the material table's. A
    texture raises; an unknown lobe_type raises."""
    t, twosided = d.get("type", "diffuse"), False
    while t == "twosided":
        d = next((v for v in d.values() if isinstance(v, dict)
                  and "type" in v), {"type": "diffuse"})
        t, twosided = d.get("type", "diffuse"), True
    if not ported_bsdf(t):
        lb = default_bsdf()
        lb.twosided = twosided
        return lb
    for v in d.values():
        if isinstance(v, dict):
            color(v)  # a texture raises
    d = {**(defaults or {}).get(t, {}), **d}
    kw = {"twosided": twosided}
    if "reflectance" in d:
        kw["base_color"] = color(d["reflectance"])
    if "diffuse_reflectance" in d:
        kw["base_color"] = color(d["diffuse_reflectance"])
    if "specular_reflectance" in d:
        kw.setdefault("base_color", color(d["specular_reflectance"]))
    if "specular_transmittance" in d:
        kw["transmittance"] = color(d["specular_transmittance"])
    if "material" in d:
        kw["eta_re"], kw["eta_im"] = conductor_preset(d["material"])
    if "eta" in d:
        kw["eta_re"] = color(d["eta"])
    if "k" in d:
        kw["eta_im"] = color(d["k"])
    if "int_ior" in d:
        eta = ior_value(d["int_ior"]) / ior_value(d.get("ext_ior", "air"))
        kw["eta_re"] = (eta,) * 3
    if {"alpha", "alpha_u", "alpha_v"} & d.keys():
        a = float(d.get("alpha", 0.1))
        kw["alpha"] = (float(d.get("alpha_u", a)), float(d.get("alpha_v", a)))
    if "distribution" in d:
        kw["mf_type"] = 0 if d["distribution"] == "ggx" else 1
    if {"inv_period", "inv_period_x", "inv_period_y"} & d.keys():
        v = d.get("inv_period", 1.0)
        x, y = (v, 0.0) if np.isscalar(v) else v
        kw["grt_inv_period"] = (float(d.get("inv_period_x", x)),
                                float(d.get("inv_period_y", y)))
    for src, dst in (("height", "grt_height"), ("multiplier",
                                                "grt_multiplier"),
                     ("coherence", "grt_coherence")):
        if src in d:
            kw[dst] = float(d[src])
    if "lobes" in d:
        kw["grt_lobes"] = int(d["lobes"])
    if "lobe_type" in d:
        kind = str(d["lobe_type"]).lower()
        if kind not in LOBE_TYPES:
            raise ValueError(f"unknown lobe_type {d['lobe_type']!r}")
        kw["grt_type"] = LOBE_TYPES[kind] | (16 if _true(d.get("radial"))
                                             else 0)
    return LoadedBSDF(BSDF_TYPE_MAP[t], **kw)


def make_sensor(d: dict):
    """(Sensor on the CPU, filter name, sampler name, spp) of a sensor in
    dict form: its film (an "hdrfilm" with its "rfilter"), its sampler and,
    for a batch sensor, its nested sensors, each a nested dict."""
    t = d.get("type", "perspective")
    if t not in SENSORS:
        raise NotImplementedError(f"sensor type {t!r} is not ported")
    film, smp, subs = {}, None, []
    for key, v in d.items():
        if not isinstance(v, dict):
            continue
        vt = v.get("type")
        if key == "film" or vt == "hdrfilm" or str(vt).endswith("film"):
            if vt != "hdrfilm":
                raise NotImplementedError(
                    f"film type {vt!r} is not ported: {A10}")
            film = v
        elif key == "sampler" or vt in SAMPLER_TYPES:
            if vt not in SAMPLER_TYPES:
                raise NotImplementedError(f"sampler type {vt!r} is not ported")
            smp = v
        elif vt in SENSORS:
            subs.append(v)
    if "srf" in d or "srf" in film:
        raise NotImplementedError(
            f"a sensor's spectral response (srf) is not ported: {A10}")
    fw, fh = int(film.get("width", 256)), int(film.get("height", 256))
    rfilter = film.get("rfilter", {}).get("type", "gaussian")
    sampler, spp = "independent", 16
    if smp is not None:
        sampler, spp = smp["type"], int(smp.get("sample_count", 16))
    tw = np.asarray(d.get("to_world", np.eye(4)), np.float32)
    cpu = {"device": "cpu"}
    if t == "perspective":
        fov = perspective_fov_x(float(d.get("fov", 45.0)),
                                d.get("fov_axis", "x"), fw, fh)
        sensor = Sensor.perspective(
            tw, fov, fw, fh, near=float(d.get("near_clip", 1e-2)),
            far=float(d.get("far_clip", 1e4)),
            ppo=(float(d.get("principal_point_offset_x", 0.0)),
                 float(d.get("principal_point_offset_y", 0.0))), **cpu)
    elif t == "orthographic":
        sensor = Sensor.orthographic(tw, fw, fh, **cpu)
    elif t == "thinlens":
        sensor = Sensor.thinlens(
            tw, float(d.get("fov", 45.0)), fw, fh,
            aperture_radius=float(d.get("aperture_radius", 0.1)),
            focus_distance=float(d.get("focus_distance", 1.0)), **cpu)
    elif t == "batch":
        # orthographic sub-sensors side by side (Mitsuba's batch sensor),
        # each the size of the last one's film
        films = [next((f for f in s.values() if isinstance(f, dict)
                       and f.get("type") == "hdrfilm"), {}) for s in subs]
        sub_w = int(films[-1].get("width", 1)) if films else 1
        sub_h = int(films[-1].get("height", 1)) if films else 1
        sensor = Sensor.batch_orthographic(
            [np.asarray(s.get("to_world", np.eye(4)), np.float32)
             for s in subs], sub_w, sub_h, **cpu)
    elif t == "radiancemeter":
        sensor = Sensor.radiancemeter(tw, **cpu)
    elif t == "irradiancemeter":
        sensor = Sensor.irradiancemeter(tw, **cpu)
    else:  # distant
        sensor = Sensor.distant(d.get("direction", (0.0, 0.0, 1.0)), fw, fh,
                                target=d.get("target", (0.0, 0.0, 0.0)),
                                **cpu)
    return sensor, rfilter, sampler, spp


_PLUGIN_TAGS = ("bsdf", "film", "rfilter", "sampler", "sensor", "texture",
                "emitter", "shape", "integrator")


def _plugin_dict(elem, defaults) -> dict:
    """An XML plugin element in dict form: its type, its properties, and
    each nested plugin under its name, else its tag (the second of a tag
    as tag_1, ...); a <ref> is {"type": "ref", "id": ...}."""
    d = {"type": elem.get("type"), **_props(elem, defaults)}
    for child in elem:
        if child.tag == "ref":
            v = {"type": "ref", "id": child.get("id")}
        elif child.tag in _PLUGIN_TAGS:
            v = _plugin_dict(child, defaults)
        else:
            continue
        key = name = child.get("name") or child.tag
        i = 0
        while key in d:
            i += 1
            key = f"{name}_{i}"
        d[key] = v
    return d


# ---------------------------------------------------------------------------
# main entry point
# ---------------------------------------------------------------------------

def load_file(path: str, parameters: Optional[Dict[str, str]] = None, *,
              device="cuda", **overrides):
    """(Scene on `device`, meta) of a Mitsuba XML scene file. `<default>`
    values, then `parameters`, then `overrides` (e.g. resx=64) fill the
    file's $name references."""
    root = ET.parse(path).getroot()
    defaults: Dict[str, str] = {d.get("name"): d.get("value")
                                for d in root.findall("default")}
    if parameters:
        defaults.update({k: str(v) for k, v in parameters.items()})
    defaults.update({k: str(v) for k, v in overrides.items()})
    return _build_scene_from_xml(root, defaults,
                                 os.path.dirname(os.path.abspath(path)),
                                 device)


_ROOT_TAGS = ("default", "integrator", "bsdf", "sensor", "emitter", "shape")


def _build_scene_from_xml(root, defaults, base_dir, device):
    for child in root:
        if child.tag not in _ROOT_TAGS:
            what = "media" if child.tag == "medium" else f"<{child.tag}>"
            raise NotImplementedError(f"scene element {what} is not ported: "
                                      f"{A10}")
    named_bsdfs: Dict[str, int] = {}
    bsdf_list: List[LoadedBSDF] = []
    meshes, mesh_mat, mesh_emitter = [], [], []
    emitters = []
    spheres, disks, cylinders = [], [], []
    integrator_cfg = {"type": "path", "max_depth": 6}
    sensor, rfilter, sampler, spp = None, "gaussian", "independent", 16

    def add_bsdf(lb: LoadedBSDF) -> int:
        bsdf_list.append(lb)
        return len(bsdf_list) - 1

    def shape_bsdf(sh) -> int:
        """The shape's BSDF row: its inline BSDF, else its reference, else
        a new default diffuse one."""
        if sh.find("medium") is not None:
            raise NotImplementedError(f"media are not ported: {A10}")
        mat_idx = None
        for ref in sh.findall("ref"):
            if ref.get("name") in ("interior", "exterior"):
                raise NotImplementedError(f"media are not ported: {A10}")
        ref = sh.find("ref")
        if ref is not None:
            if ref.get("id") not in named_bsdfs:
                raise ValueError(f"unknown BSDF reference {ref.get('id')!r}")
            mat_idx = named_bsdfs[ref.get("id")]
        inline = sh.find("bsdf")
        if inline is not None:
            mat_idx = add_bsdf(make_bsdf(_plugin_dict(inline, defaults),
                                          XML_BSDF_DEFAULTS))
        return add_bsdf(default_bsdf()) if mat_idx is None else mat_idx

    def shape_emitter(sh):
        """The area light's radiance of a shape, or None."""
        em = sh.find("emitter")
        if em is None:
            return None
        if em.get("type") != "area":
            check_emitter(em.get("type"))
            raise NotImplementedError(
                f"a {em.get('type')!r} emitter on a shape is not ported")
        return _props(em, defaults).get("radiance", (1.0, 1.0, 1.0))

    integ = root.find("integrator")
    if integ is not None:
        integrator_cfg = _integrator_cfg(integ, defaults)
    for b in root.findall("bsdf"):
        idx = add_bsdf(make_bsdf(_plugin_dict(b, defaults),
                                 XML_BSDF_DEFAULTS))
        if b.get("id"):
            named_bsdfs[b.get("id")] = idx
    s = root.find("sensor")
    if s is not None:
        sensor, rfilter, sampler, spp = make_sensor(_plugin_dict(s, defaults))
    for e in root.findall("emitter"):
        check_emitter(e.get("type"))
        emitters.append({"type": e.get("type"), **_props(e, defaults)})

    shape_groups = {}
    for sh in root.findall("shape"):
        stype = sh.get("type")
        p = _props(sh, defaults)
        to_world = p.get("to_world", np.eye(4, dtype=np.float32))
        if p.get("flip_normals", False):
            raise NotImplementedError("flip_normals is not ported")

        if stype == "sphere":
            # the analytic sphere: centre and radius under a uniform scale
            center = np.asarray(p.get("center", (0.0, 0.0, 0.0)), np.float64)
            M = np.asarray(to_world, np.float64)
            center = (M @ np.append(center, 1.0))[:3]
            radius = float(p.get("radius", 1.0)) * float(
                np.cbrt(abs(np.linalg.det(M[:3, :3]))))
            mat_idx = shape_bsdf(sh)
            rad = shape_emitter(sh)
            em_idx = -1
            if rad is not None:
                emitters.append({"type": "sphere_area", "center": center,
                                 "radius": radius, "radiance": rad})
                em_idx = len(emitters) - 1
            spheres.append({"center": center.astype(np.float32),
                            "radius": radius, "mat": mat_idx,
                            "emitter": em_idx,
                            "shape": 10000 + len(spheres)})
            continue

        if stype in ("disk", "cylinder") and sh.find("emitter") is None:
            prim = analytic_prim(stype, p, to_world)
            if prim is not None:
                out = disks if stype == "disk" else cylinders
                out.append({**prim, "mat": shape_bsdf(sh), "emitter": -1,
                            "shape": (20000 if stype == "disk" else 30000)
                            + len(out)})
                continue

        if stype in ("merge", "shapegroup"):
            group = []
            for child in sh.findall("shape"):
                if child.find("emitter") is not None:
                    raise NotImplementedError(
                        f"an area light inside a {stype} is not ported")
                group.append((_load_simple_mesh(child, defaults, base_dir),
                              shape_bsdf(child)))
            if stype == "merge":
                for cm, c_mat in group:
                    meshes.append(cm)
                    mesh_mat.append(c_mat)
                    mesh_emitter.append(-1)
            elif sh.get("id"):
                shape_groups[sh.get("id")] = group
            continue

        if stype == "instance":
            iref = sh.find("ref")
            gid = iref.get("id") if iref is not None else None
            if gid not in shape_groups:
                raise ValueError(f"instance of unknown shapegroup {gid!r}")
            M = np.asarray(to_world, np.float32)
            for cm, c_mat in shape_groups[gid]:
                meshes.append(cm.transformed(M))
                mesh_mat.append(c_mat)
                mesh_emitter.append(-1)
            continue

        mesh = _mesh_of(stype, p, base_dir)
        if p.get("face_normals", False):
            mesh = shp.HostMesh(vertices=mesh.vertices, faces=mesh.faces,
                                uvs=mesh.uvs, face_normals=True,
                                colors=mesh.colors)
        mesh = mesh.transformed(shape_to_world(stype, p, to_world))
        mat_idx = shape_bsdf(sh)
        rad = shape_emitter(sh)
        em_idx = -1
        if rad is not None:
            emitters.append({"type": "area", "radiance": rad})
            em_idx = len(emitters) - 1
        meshes.append(mesh)
        mesh_mat.append(mat_idx)
        mesh_emitter.append(em_idx)

    return assemble_scene(
        meshes, mesh_mat, mesh_emitter, bsdf_list, emitters, sensor,
        integrator_cfg, spp, rfilter=rfilter, spheres=spheres, disks=disks,
        cylinders=cylinders, sampler=sampler, device=device)


def _integrator_cfg(elem, defaults) -> dict:
    """An <integrator>'s config: its type (which may be a $name), its
    properties and a nested integrator's config under "nested"."""
    cfg = {"type": _parse_value(elem.get("type", "path"), defaults),
           **_props(elem, defaults)}
    nested = elem.find("integrator")
    if nested is not None:
        cfg["nested"] = _integrator_cfg(nested, defaults)
    return cfg


def analytic_prim(stype, p, to_world):
    """The analytic disk's or open cylinder's row (Mitsuba's unit disk in
    the xy plane; the cylinder from p0 to p1) under to_world, or None when
    to_world scales x and y apart (the shape is then tessellated)."""
    M = np.asarray(to_world, np.float64)
    R = M[:3, :3]
    sx, sy = np.linalg.norm(R[:, 0]), np.linalg.norm(R[:, 1])
    if not abs(sx - sy) < 1e-5 * max(sx, sy, 1e-9):
        return None
    radius = float(sx * float(p.get("radius", 1.0)))
    if stype == "disk":
        return {"center": M[:3, 3].astype(np.float32),
                "n": (R[:, 2] / max(np.linalg.norm(R[:, 2]), 1e-12)).astype(
                    np.float32),
                "s": (R[:, 0] / max(sx, 1e-12)).astype(np.float32),
                "radius": radius}
    p0 = (M @ np.append(np.asarray(p.get("p0", (0, 0, 0)), np.float64),
                        1.0))[:3]
    p1 = (M @ np.append(np.asarray(p.get("p1", (0, 0, 1)), np.float64),
                        1.0))[:3]
    axis = p1 - p0
    length = float(np.linalg.norm(axis))
    return {"p0": p0.astype(np.float32),
            "axis": (axis / max(length, 1e-12)).astype(np.float32),
            "length": length, "radius": radius}


def shape_to_world(stype, p, to_world) -> np.ndarray:
    """to_world [4, 4] float32 of a tessellated disk, open cylinder or
    sphere, composed (in float64) with the map from the unit shape to the
    shape's own radius, p0 / p1 or centre, as Mitsuba's disk.cpp,
    cylinder.cpp and sphere.cpp compose them; to_world itself where the
    shape has the unit shape's."""
    to_world = np.asarray(to_world, np.float32)
    r = float(p.get("radius", 1.0))
    local = None
    if stype == "disk" and r != 1.0:
        local = np.diag([r, r, 1.0, 1.0])
    elif stype == "sphere" and ("center" in p or r != 1.0):
        local = np.diag([r, r, r, 1.0])
        local[:3, 3] = p.get("center", (0.0, 0.0, 0.0))
    elif stype == "cylinder" and ("p0" in p or "p1" in p or r != 1.0):
        p0 = np.asarray(p.get("p0", (0.0, 0.0, 0.0)), np.float64)
        d = np.asarray(p.get("p1", (0.0, 0.0, 1.0)), np.float64) - p0
        length = float(np.linalg.norm(d))
        n = d / length
        # Frame3f(n): the branchless basis of `core/frame.py`
        sign = 1.0 if n[2] >= 0.0 else -1.0
        a = -1.0 / (sign + n[2])
        b = n[0] * n[1] * a
        s = (1.0 + sign * n[0] * n[0] * a, sign * b, -sign * n[0])
        t = (b, sign + n[1] * n[1] * a, -n[1])
        local = np.eye(4)
        local[:3, 0], local[:3, 1] = np.multiply(s, r), np.multiply(t, r)
        local[:3, 2], local[:3, 3] = n * length, p0
    if local is None:
        return to_world
    return (to_world.astype(np.float64) @ local).astype(np.float32)


def unit_mesh(stype) -> shp.HostMesh:
    """Mitsuba's rectangle or cube, the tessellated unit disk, open
    cylinder or icosphere (subdivision 4), untransformed."""
    eye = np.eye(4, dtype=np.float32)
    if stype == "rectangle":
        return shp.HostMesh(*shp.make_rectangle(eye))
    if stype == "cube":
        v, f, _, _ = shp.make_cube(eye)
        return shp.HostMesh(vertices=v, faces=f, face_normals=True)
    if stype == "disk":
        return shp.make_disk()
    if stype == "cylinder":
        return shp.make_cylinder()
    if stype == "sphere":
        return shp.make_sphere()
    refuse_shape(stype)


def _mesh_of(stype, p, base_dir) -> shp.HostMesh:
    """The untransformed mesh of a mesh-like <shape>."""
    if stype in ("ply", "obj", "serialized"):
        path = os.path.join(base_dir, p["filename"])
        if stype == "ply":
            return shp.load_ply(path)
        if stype == "obj":
            return shp.load_obj(path)
        return shp.load_serialized(path, int(p.get("shape_index", 0)))
    return unit_mesh(stype)


def _load_simple_mesh(sh, defaults, base_dir) -> shp.HostMesh:
    """The mesh of a merge's or shapegroup's member under its own to_world
    (an instance's transform composes later); a sphere member is the
    tessellated icosphere under its centre and radius."""
    stype, p = sh.get("type"), _props(sh, defaults)
    mesh = _mesh_of(stype, p, base_dir)
    if p.get("face_normals", False):
        mesh = shp.HostMesh(vertices=mesh.vertices, faces=mesh.faces,
                            uvs=mesh.uvs, face_normals=True,
                            colors=mesh.colors)
    eye = np.eye(4, dtype=np.float32)
    to_world = shape_to_world(stype, p, p.get("to_world", eye))
    if p.get("to_world") is not None or not np.array_equal(to_world, eye):
        mesh = mesh.transformed(to_world)
    return mesh


# ---------------------------------------------------------------------------
# scene assembly
# ---------------------------------------------------------------------------

def assemble_scene(meshes, mesh_mat, mesh_emitter, bsdf_list, emitters,
                   sensor, integrator_cfg, spp, rfilter="gaussian",
                   spheres=None, disks=None, cylinders=None,
                   sampler="independent", *, device="cuda"):
    """(Scene on `device`, meta) from `meshes` (`shape.HostMesh` in world
    space) with their material and emitter indices, `bsdf_list`
    (`LoadedBSDF`), `emitters` (dicts of type "area", "point", "constant",
    "directional" or "sphere_area"; radiance as "radiance", "intensity" or
    "irradiance"), analytic `spheres` / `disks` / `cylinders` (dicts, as
    `presets._geometry` takes them) and a port `Sensor` (None: a 45-degree
    256 x 256 camera at (0, 0, 4)). meta holds the integrator's config,
    spp, the film's filter name and the sampler name, as the JAX package's
    does. A scene with no mesh gets a degenerate one (the triangle table is
    never empty). Above BRUTE_FORCE_MAX_FACES faces the scene carries the
    ClusterTable2 of a skip-link BVH over all its triangles (the clu2
    route). A BSDF type, BSDF parameter or emitter type the port lacks
    raises NotImplementedError."""
    if sensor is None:
        sensor = Sensor.perspective(
            tf.look_at([0, 0, 4], [0, 0, 0], [0, 1, 0]), 45.0, 256, 256,
            device="cpu")
    if not meshes:
        meshes = [shp.HostMesh(*shp.make_rectangle(
            np.diag([1e-6, 1e-6, 1e-6, 1.0]).astype(np.float32)))]
        mesh_mat, mesh_emitter = [0], [-1]
    bsdfs = []
    for lb in bsdf_list or [default_bsdf()]:
        if lb.btype not in SUPPORTED_BSDFS:
            raise NotImplementedError(f"BSDF type {lb.btype} is not ported")
        bsdfs.append((lb.btype, lb.params, lb.twosided))
    soups = [m.soup() for m in meshes]
    geo, radius = ps._geometry(soups, mesh_mat, mesh_emitter, spheres, disks,
                               cylinders)
    n_faces = sum(len(f) for _, f, _, _ in soups)
    if n_faces > BRUTE_FORCE_MAX_FACES:
        p0, p1, p2 = (np.concatenate([v[f[:, c]] for v, f, _, _ in soups])
                      .astype(np.float32) for c in range(3))
        # the BVH over the soup: vertex k * n_faces + i is corner k of face i
        bvh = build_bvh(np.concatenate([p0, p1, p2]),
                        np.arange(3 * n_faces, dtype=np.int32)
                        .reshape(3, n_faces).T)
        geo.update({"ctab2." + k: x for k, x in
                    pack_clusters2_arrays(bvh, p0, p1, p2).items()})
    mats, mat_static = ps._materials(bsdfs)
    ems, em_static = ps._emitters([emitter_row(e) for e in emitters], radius,
                                  geo)
    sens, sens_static = ps.sensor_arrays(sensor)
    scene = scene_from_arrays({**geo, **mats, **ems, **sens},
                              {**mat_static, **em_static, **sens_static},
                              device=device)
    meta = {"integrator": integrator_cfg, "spp": spp, "rfilter": rfilter,
            "sampler": sampler}
    return scene, meta
