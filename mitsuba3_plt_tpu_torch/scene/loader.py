"""Scene assembly: host-side meshes, analytic primitives, BSDF records,
emitter dicts and a sensor -> (Scene, meta), the JAX package's
`scene/loader.py::assemble_scene`, through which its presets and its dict
and XML loaders build every scene. The port's assembly takes the port's
BSDF and emitter subset and refuses the rest by name; the parsers come
later (ROADMAP A8)."""
from __future__ import annotations

import numpy as np

from ..core import transform as tf
from ..librender.bsdf import BSDF_DIFFUSE
from ..librender.sensor import Sensor
from . import presets as ps
from . import shape as shp
from .bridge import SUPPORTED_BSDFS, scene_from_arrays


class LoadedBSDF:
    """Host-side staging record for one material-table row."""

    def __init__(self, btype, **kw):
        self.btype = btype
        self.twosided = kw.pop("twosided", False)
        self.params = kw


def default_bsdf():
    return LoadedBSDF(BSDF_DIFFUSE, base_color=(0.5, 0.5, 0.5))


def assemble_scene(meshes, mesh_mat, mesh_emitter, bsdf_list, emitters,
                   sensor, integrator_cfg, spp, rfilter="gaussian",
                   spheres=None, disks=None, cylinders=None,
                   sampler="independent", *, device="cuda"):
    """(Scene on `device`, meta) from `meshes` (`shape.HostMesh` in world
    space) with their material and emitter indices, `bsdf_list`
    (`LoadedBSDF`), `emitters` (dicts of type "area", "point", "constant",
    "directional" or "sphere_area"), analytic `spheres` / `disks` /
    `cylinders` (dicts, as `presets._geometry` takes them) and a port
    `Sensor` (None: a 45-degree 256 x 256 camera at (0, 0, 4)). meta holds
    the integrator's config, spp, the film's filter name and the sampler
    name, as the JAX package's does. A scene with no mesh gets a degenerate
    one (the triangle table is never empty). A BSDF type, BSDF parameter or
    emitter type the port lacks raises NotImplementedError, and so does a
    scene above 4096 faces (the bridge's refusal: its clu2
    tables come with the loaders, ROADMAP A8)."""
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
    geo, radius = ps._geometry([m.soup() for m in meshes], mesh_mat,
                               mesh_emitter, spheres, disks, cylinders)
    mats, mat_static = ps._materials(bsdfs)
    ems, em_static = ps._emitters(emitters, radius, geo)
    sens, sens_static = ps.sensor_arrays(sensor)
    scene = scene_from_arrays({**geo, **mats, **ems, **sens},
                              {**mat_static, **em_static, **sens_static},
                              device=device)
    meta = {"integrator": integrator_cfg, "spp": spp, "rfilter": rfilter,
            "sampler": sampler}
    return scene, meta
