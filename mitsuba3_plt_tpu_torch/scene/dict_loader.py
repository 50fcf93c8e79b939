"""The dict scene loader (Mitsuba's `load_dict` convention): {"type":
"scene", <name>: {"type": ..., props...}, ...}, a BSDF reference being
{"type": "ref", "id": name}. The JAX package's `scene/dict_loader.py` on
the port's subset. BSDFs and sensors are built as the XML loader builds
them (`loader.py::make_bsdf`, `make_sensor`), with the same refusals: a
BSDF, emitter, shape, sensor or texture the port lacks raises by name, a
BSDF name in no table warns and takes the default diffuse BSDF. A BSDF's
absent parameters keep the material table's defaults.

Besides the XML loader's shapes a dict takes "mesh", an in-memory
`shape.HostMesh` (or any record with its fields). A dict's "sphere" is
the tessellated icosphere (subdivision 4) under its centre and radius, as
in the JAX package's dict loader (which ignores a radius without a
centre); the XML loader's is analytic."""
from __future__ import annotations

from typing import Dict

import numpy as np

from .. import integrators
from ..core import transform as tf
from . import shape as shp
from .loader import (A10, BSDF_TYPE_MAP, EMITTERS, SENSORS, UNPORTED_BSDFS,
                     UNPORTED_EMITTERS, UNPORTED_SHAPES, analytic_prim,
                     assemble_scene, check_emitter, color, default_bsdf,
                     make_bsdf, make_sensor, refuse_shape, shape_to_world,
                     unit_mesh)

INTEGRATORS = integrators.PORTED + integrators.UNPORTED
SHAPES = ("rectangle", "cube", "sphere", "disk", "cylinder", "ply", "obj",
          "serialized", "mesh")


def _is_bsdf(t) -> bool:
    return t in BSDF_TYPE_MAP or t in UNPORTED_BSDFS or t == "twosided"


def _to_world(d):
    v = d.get("to_world")
    if v is None:
        return np.eye(4, dtype=np.float32)
    return np.asarray(v, np.float32)


def _host_mesh(m) -> shp.HostMesh:
    """A port HostMesh of an in-memory mesh record."""
    if getattr(m, "tangents", None) is not None:
        raise NotImplementedError(f"per-vertex tangents are not ported: {A10}")

    def arr(name, dtype):
        x = getattr(m, name, None)
        return None if x is None else np.asarray(x, dtype)

    return shp.HostMesh(vertices=arr("vertices", np.float32),
                        faces=arr("faces", np.int32),
                        normals=arr("normals", np.float32),
                        uvs=arr("uvs", np.float32),
                        face_normals=bool(getattr(m, "face_normals", False)),
                        colors=arr("colors", np.float32))


def load_dict(scene_dict: Dict, *, device="cuda"):
    """(Scene on `device`, meta) of a Mitsuba-style scene dict."""
    if scene_dict.get("type") != "scene":
        raise ValueError("the top-level type must be 'scene'")
    named_bsdfs: Dict[str, int] = {}
    bsdf_list = []
    meshes, mesh_mat, mesh_emitter = [], [], []
    emitters, disks, cylinders = [], [], []
    integrator_cfg = {"type": "path"}
    sensor, rfilter, sampler, spp = None, "gaussian", "independent", 16

    def add_bsdf(lb):
        bsdf_list.append(lb)
        return len(bsdf_list) - 1

    items = [(k, v) for k, v in scene_dict.items()
             if isinstance(v, dict) and "type" in v]

    # pass 1: the integrator, the sensor, named BSDFs and emitters
    for name, obj in items:
        t = obj["type"]
        if t in INTEGRATORS:
            integrator_cfg = dict(obj)
        elif _is_bsdf(t):
            named_bsdfs[name] = add_bsdf(make_bsdf(obj))
        elif t in EMITTERS or t in UNPORTED_EMITTERS:
            check_emitter(t)
            if t == "area":
                raise ValueError(f"{name!r}: an area emitter belongs to a "
                                 "shape")
            e = {k: v for k, v in obj.items()
                 if k not in ("radiance", "intensity", "irradiance")}
            if "to_world" in obj:
                e["to_world"] = np.asarray(obj["to_world"], np.float32)
            for key in ("radiance", "intensity", "irradiance"):
                if key in obj:
                    e["radiance"] = color(obj[key])
            emitters.append(e)
        elif t in SENSORS:
            sensor, rfilter, sampler, spp = make_sensor(obj)
        elif t in UNPORTED_SHAPES:
            refuse_shape(t)
        elif t == "medium" or t in ("homogeneous", "heterogeneous"):
            raise NotImplementedError(f"media are not ported: {A10}")
        elif t not in SHAPES:
            raise NotImplementedError(
                f"{name!r}: scene object type {t!r} is not ported")

    def shape_parts(obj):
        """(BSDF row or None, area light radiance or None) of a shape."""
        mat_idx = rad = None
        for v in obj.values():
            if not isinstance(v, dict) or "type" not in v:
                continue
            vt = v["type"]
            if vt == "ref":
                if v.get("id") not in named_bsdfs:
                    raise ValueError(f"unknown BSDF reference {v.get('id')!r}")
                mat_idx = named_bsdfs[v["id"]]
            elif vt in EMITTERS or vt in UNPORTED_EMITTERS:
                check_emitter(vt)
                if vt != "area":
                    raise NotImplementedError(
                        f"a {vt!r} emitter on a shape is not ported")
                rad = color(v.get("radiance", (1, 1, 1)))
            elif vt in ("medium", "homogeneous", "heterogeneous"):
                raise NotImplementedError(f"media are not ported: {A10}")
            else:
                mat_idx = add_bsdf(make_bsdf(v))
        return mat_idx, rad

    # pass 2: shapes
    for name, obj in items:
        t = obj["type"]
        if t not in SHAPES:
            continue
        if obj.get("flip_normals", False):
            raise NotImplementedError("flip_normals is not ported")
        mat_idx, rad = shape_parts(obj)
        if mat_idx is None:
            mat_idx = add_bsdf(default_bsdf())
        tw = _to_world(obj)
        if t in ("disk", "cylinder") and rad is None:
            prim = analytic_prim(t, obj, tw)
            if prim is not None:
                out = disks if t == "disk" else cylinders
                out.append({**prim, "mat": mat_idx, "emitter": -1,
                            "shape": (20000 if t == "disk" else 30000)
                            + len(out)})
                continue
        if t == "mesh":
            mesh = _host_mesh(obj["mesh"])
        elif t == "ply":
            mesh = shp.load_ply(obj["filename"])
        elif t == "obj":
            mesh = shp.load_obj(obj["filename"])
        elif t == "serialized":
            mesh = shp.load_serialized(obj["filename"],
                                       int(obj.get("shape_index", 0)))
        else:
            mesh = unit_mesh(t)
        if t == "sphere" and ("center" in obj or "radius" in obj):
            tw = tw @ tf.translate(np.asarray(obj.get(
                "center", (0.0, 0.0, 0.0)))) @ tf.scale(obj.get("radius", 1.0))
        elif t in ("disk", "cylinder"):
            tw = shape_to_world(t, obj, tw)
        mesh = mesh.transformed(tw.astype(np.float32))
        if obj.get("face_normals", False):
            mesh = shp.HostMesh(vertices=mesh.vertices, faces=mesh.faces,
                                uvs=mesh.uvs, face_normals=True,
                                colors=mesh.colors)
        em_idx = -1
        if rad is not None:
            emitters.append({"type": "area", "radiance": rad})
            em_idx = len(emitters) - 1
        meshes.append(mesh)
        mesh_mat.append(mat_idx)
        mesh_emitter.append(em_idx)

    return assemble_scene(
        meshes, mesh_mat, mesh_emitter, bsdf_list, emitters, sensor,
        integrator_cfg, spp, rfilter=rfilter, disks=disks,
        cylinders=cylinders, sampler=sampler, device=device)

