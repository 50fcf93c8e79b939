"""Built-in scenes constructed in code (no asset files).

`grating_scene` is a rough diffraction-grating slab on a dark floor lit by
a directional emitter and a faint constant environment: the PLT flagship.
`mesh_scene` is a diffuse icosphere lit by a point light: the big-mesh
path-tracer scene of the JAX package's bench (`bench.py::bench_mesh_heavy`,
81,920 faces at subdiv 6) and of its mesh20k golden image (subdiv 5).
`cornell_box` is the canonical Cornell box (36 faces, an area light under
the ceiling): the second scene of the JAX bench (`bench.py::bench_cbox`)
and of its cbox_path golden image.
Each builds, with numpy alone, the same arrays the JAX package produces
(`scene/presets.py::grating_scene` and `cornell_box`; `load_dict` of the
mesh scene's dict) and hands them to `bridge.scene_from_arrays`.
"""
from __future__ import annotations

import numpy as np

from ..core import transform as tf
from ..librender.bsdf import (BSDF_DIFFUSE, BSDF_ROUGH_GRATING, BSDFFlags,
                              finalize_grating_meta)
from ..ops.intersect import pack_tri_q
from . import emitters as em
from .bridge import scene_from_arrays
from .bvh import build_bvh, pack_clusters2_arrays, pack_packet_bvh_arrays
from .scene import BRUTE_FORCE_MAX_FACES
from .shape import make_cube, make_rectangle, make_sphere

_FLAGS = {
    BSDF_DIFFUSE: BSDFFlags.DiffuseReflection | BSDFFlags.FrontSide,
    BSDF_ROUGH_GRATING: BSDFFlags.GlossyReflection | BSDFFlags.FrontSide,
}


def _geometry(meshes, mat_ids, emitter_ids):
    """Arrays of the q table, the (p0, e1, e2) rows and the packed per-face
    attributes. A mesh is (vertices, faces, normals, uvs); normals None
    shades it flat (face normals), uvs None gives zero uvs."""
    P, N, U, FN, ATT = [[], [], []], [[], [], []], [[], [], []], [], []
    for k, (v, f, n, uv) in enumerate(meshes):
        p = [v[f[:, c]] for c in range(3)]
        fn = np.cross(p[1] - p[0], p[2] - p[0])
        fn = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True),
                             1e-20)
        for c in range(3):
            P[c].append(p[c])
            N[c].append(fn if n is None else n[f[:, c]])
            U[c].append(np.zeros((len(f), 2), np.float32) if uv is None
                        else uv[f[:, c]])
        FN.append(fn)
        ATT.append(np.tile([[mat_ids[k], emitter_ids[k], k]], (len(f), 1)))
    cat = lambda xs: np.concatenate(xs, 0).astype(np.float32)  # noqa: E731
    p0, p1, p2 = (cat(x) for x in P)
    tri_q, anchor = pack_tri_q(p0, p1, p2)
    isect = np.concatenate([p0, p1 - p0, p2 - p0], axis=-1)
    isect = np.concatenate(
        [isect, np.zeros(((-len(isect)) % 64, 9), np.float32)], axis=0)
    # 21 attribute columns, zero-padded to the JAX package's 24-wide layout
    attr = np.concatenate(
        [cat(FN), *(cat(x) for x in N), *(cat(x) for x in U), cat(ATT),
         np.zeros((len(p0), 3), np.float32)], axis=-1)
    lo = np.minimum.reduce([p0.min(0), p1.min(0), p2.min(0)])
    hi = np.maximum.reduce([p0.max(0), p1.max(0), p2.max(0)])
    radius = float(np.linalg.norm(hi - lo) / 2)
    return {"geo.tri_q": tri_q, "geo.tri_anchor": anchor,
            "geo.tri_isect": isect, "geo.tri_attr": attr}, radius


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


def _emitters(emitters, scene_radius, geo):
    """Emitter rows on the JAX loader's defaults, with the area tables
    built as `scene/loader.py::build_emitter_table` builds them from the
    faces whose emitter column (of `geo`'s `tri_attr`) names the light:
    `tri_idx` padded with -1, `tri_cdf` the area CDF normalised to 1 (1 in
    the padding), `area` the total."""
    E = len(emitters)
    etype = np.zeros(E, np.int32)
    radiance = np.ones((E, 3), np.float32)
    position = np.zeros((E, 3), np.float32)
    direction = np.tile(np.array([[0, 0, 1]], np.float32), (E, 1))
    kinds = {"area": em.EMITTER_AREA, "point": em.EMITTER_POINT,
             "constant": em.EMITTER_CONSTANT,
             "directional": em.EMITTER_DIRECTIONAL}
    for i, e in enumerate(emitters):
        kind = kinds.get(e["type"])
        if kind is None:
            raise NotImplementedError(f"emitter type {e['type']!r}")
        etype[i] = kind
        radiance[i] = e["radiance"]  # a point light's intensity
        if "position" in e:
            position[i] = e["position"]
        if "direction" in e:
            d = np.asarray(e["direction"], np.float64)
            direction[i] = d / np.linalg.norm(d)

    face_emitter = geo["geo.tri_attr"][:, 19]
    rows = geo["geo.tri_isect"]
    tri_lists = {i: np.where(face_emitter == i)[0].astype(np.int32)
                 for i, e in enumerate(emitters) if e["type"] == "area"}
    max_tris = max([1] + [len(x) for x in tri_lists.values()])
    tri_idx = np.full((E, max_tris), -1, np.int32)
    tri_cdf = np.ones((E, max_tris), np.float32)
    area = np.zeros(E, np.float32)
    for i, tris in tri_lists.items():
        if len(tris):
            a = 0.5 * np.linalg.norm(
                np.cross(rows[tris, 3:6], rows[tris, 6:9]), axis=-1)
            area[i] = a.sum()
            tri_idx[i, :len(tris)] = tris
            tri_cdf[i, :len(tris)] = np.cumsum(a) / max(a.sum(), 1e-20)
    arrays = {
        "emitters.etype": etype, "emitters.radiance": radiance,
        "emitters.position": position, "emitters.direction": direction,
        "emitters.tri_idx": tri_idx, "emitters.tri_cdf": tri_cdf,
        "emitters.area": area,
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
    ems, em_static = _emitters(emitters, radius, geo)
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


def mesh_scene_arrays(width: int = 512, height: int = 512, subdiv: int = 6,
                      accel: str = "clu2"):
    """The (arrays, static) pair of `mesh_scene`, numpy only: the unit
    icosphere of `subdiv` (20 * 4**subdiv faces, smooth normals), one
    diffuse material of reflectance 0.7, one point light of intensity 40 at
    (2, 2, 3), and a 45-degree camera at (0, 0, 4) looking at the origin.
    Above BRUTE_FORCE_MAX_FACES faces it carries the tables of `accel`: its
    ClusterTable2 ("clu2") or, in their place, its PacketBVH ("packet")."""
    return _mesh_scene_arrays(width, height, subdiv, accel)[:2]


def _mesh_scene_arrays(width, height, subdiv, accel):
    """`mesh_scene_arrays` and the skip-link BVH its tables were packed
    from (None at or below BRUTE_FORCE_MAX_FACES faces)."""
    if accel not in ("clu2", "packet"):
        raise ValueError(f"accel must be 'clu2' or 'packet', got {accel!r}")
    mesh = make_sphere(subdiv)
    v, f = mesh.vertices, mesh.faces
    # renormalised in float32, as the JAX loader does for every mesh
    n = mesh.normals / np.maximum(
        np.linalg.norm(mesh.normals, axis=-1, keepdims=True), 1e-20)
    uv = np.zeros((len(v), 2), np.float32)
    geo, radius = _geometry([(v, f, n, uv)], [0], [-1])
    bvh = None
    if len(f) > BRUTE_FORCE_MAX_FACES:
        pack, prefix = ((pack_clusters2_arrays, "ctab2.") if accel == "clu2"
                        else (pack_packet_bvh_arrays, "pbvh."))
        bvh = build_bvh(v, f)
        tables = pack(bvh, v[f[:, 0]], v[f[:, 1]], v[f[:, 2]])
        geo.update({prefix + k: x for k, x in tables.items()})
    mats, mat_static = _materials([(BSDF_DIFFUSE,
                                    {"base_color": (0.7, 0.7, 0.7)})])
    ems, em_static = _emitters([{"type": "point",
                                 "position": (2.0, 2.0, 3.0),
                                 "radiance": (40.0, 40.0, 40.0)}], radius,
                               geo)
    sens, sens_static = _sensor(tf.look_at([0, 0, 4], [0, 0, 0], [0, 1, 0]),
                                45.0, width, height)
    return ({**geo, **mats, **ems, **sens},
            {**mat_static, **em_static, **sens_static}, bvh)


def mesh_scene(width: int = 512, height: int = 512, subdiv: int = 6, *,
               accel: str = "clu2", device="cuda"):
    """The mesh scene on `device` (the configuration of the JAX package's
    mesh82k bench at subdiv 6, of its mesh20k golden at subdiv 5), routed
    to the clu2 kernels or, with accel="packet", to the packet-BVH walk."""
    arrays, static, _ = _mesh_scene_arrays(width, height, subdiv, accel)
    return scene_from_arrays(arrays, static, device=device)


def mesh_scene_with_bvh(width: int = 512, height: int = 512,
                        subdiv: int = 6, *, device="cuda"):
    """(`mesh_scene` on the clu2 route, the skip-link BVH of its icosphere
    that its ClusterTable2 was packed from), for a host walk of the same
    tree; the icosphere must have more than BRUTE_FORCE_MAX_FACES faces."""
    arrays, static, bvh = _mesh_scene_arrays(width, height, subdiv, "clu2")
    if bvh is None:
        raise ValueError(f"mesh_scene_with_bvh: subdiv {subdiv} gives "
                         f"{20 * 4 ** subdiv} faces, routed brute force")
    return scene_from_arrays(arrays, static, device=device), bvh


def cornell_box_arrays(width: int = 256, height: int = 256):
    """The (arrays, static) pair of `cornell_box`, numpy only: white walls,
    red left and green right walls, two white diffuse boxes, a 0.46 x 0.38
    area light just below the ceiling, a 39.3077-degree camera at
    (0, 0, 3.9)."""
    white = (0.885809, 0.698859, 0.666422)
    green = (0.105421, 0.37798, 0.076425)
    red = (0.570068, 0.0430135, 0.0443706)
    light_rad = (18.387, 13.9873, 6.75357)
    W, G, R, BOX = 0, 1, 2, 3
    bsdfs = [(BSDF_DIFFUSE, {"base_color": c})
             for c in (white, green, red, white)]
    T, Rt, S = tf.translate, tf.rotate, tf.scale

    def f32(*ms):  # the product in float64, as the JAX preset composes
        out = np.eye(4)
        for mm in ms:
            out = out @ np.asarray(mm, np.float64)
        return out.astype(np.float32)

    meshes = [
        make_rectangle(f32(T([0, -1, 0]), Rt([1, 0, 0], -90))),  # floor
        make_rectangle(f32(T([0, 1, 0]), Rt([1, 0, 0], 90))),    # ceiling
        make_rectangle(f32(T([0, 0, -1]))),                      # back
        make_rectangle(f32(T([1, 0, 0]), Rt([0, 1, 0], -90))),   # green
        make_rectangle(f32(T([-1, 0, 0]), Rt([0, 1, 0], 90))),   # red
        make_cube(f32(T([0.335, -0.7, 0.38]), Rt([0, 1, 0], -17),
                      S([0.25, 0.3, 0.25]))),                    # small box
        make_cube(f32(T([-0.33, -0.4, -0.28]), Rt([0, 1, 0], 18.25),
                      S([0.25, 0.6, 0.25]))),                    # tall box
        make_rectangle(f32(T([0, 0.99, 0.01]), Rt([1, 0, 0], 90),
                           S([0.23, 0.19, 1.0]))),               # light
    ]
    geo, radius = _geometry(meshes, [W, W, W, G, R, BOX, BOX, W],
                            [-1] * 7 + [0])
    mats, mat_static = _materials(bsdfs)
    ems, em_static = _emitters([{"type": "area", "radiance": light_rad}],
                               radius, geo)
    sens, sens_static = _sensor(tf.look_at([0, 0, 3.90], [0, 0, 0],
                                           [0, 1, 0]), 39.3077, width, height)
    return ({**geo, **mats, **ems, **sens},
            {**mat_static, **em_static, **sens_static})


def cornell_box(width: int = 256, height: int = 256, *, device="cuda"):
    """The Cornell box on `device` (the JAX package's `cornell_box` at its
    defaults: the scene of its cbox bench and cbox_path golden). Its
    conductor and dielectric box materials are not ported."""
    arrays, static = cornell_box_arrays(width, height)
    return scene_from_arrays(arrays, static, device=device)
