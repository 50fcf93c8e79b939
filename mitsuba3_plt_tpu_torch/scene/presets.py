"""Built-in scenes constructed in code (no asset files).

`grating_scene` is a rough diffraction-grating slab on a dark floor lit by
a directional emitter and a faint constant environment: the PLT flagship.
`mesh_scene` is a diffuse icosphere lit by a point light: the big-mesh
path-tracer scene of the JAX package's bench (`bench.py::bench_mesh_heavy`,
81,920 faces at subdiv 6) and of its mesh20k golden image (subdiv 5).
`analytic_scene` is the floor and emissive analytic sphere of the JAX
package's `tests/test_sphere.py::sphere_scene` with an analytic disk and
cylinder beside the sphere, built by `loader.assemble_scene`.
`cornell_box` is the canonical Cornell box (36 faces, an area light under
the ceiling): the second scene of the JAX bench (`bench.py::bench_cbox`)
and of its cbox_path golden image, its two boxes diffuse, conductor,
rough conductor, dielectric or a diffraction grating. `furnace_scene` is
the white furnace: an icosphere inside a constant environment.
Each builds, with numpy alone, the same arrays the JAX package produces
(`scene/presets.py::grating_scene`, `cornell_box` and `furnace_scene`;
`load_dict` of the mesh scene's dict) and hands them to
`bridge.scene_from_arrays`.
"""
from __future__ import annotations

import numpy as np

from ..core import transform as tf
from ..librender.bsdf import (BSDF_CONDUCTOR, BSDF_DIELECTRIC, BSDF_DIFFUSE,
                              BSDF_ROUGH_CONDUCTOR, BSDF_ROUGH_GRATING,
                              BSDFFlags, finalize_grating_meta)
from ..librender.sensor import FIELDS, Sensor
from ..ops.intersect import pack_tri_q
from . import emitters as em
from .bridge import scene_from_arrays
from .bvh import build_bvh, pack_clusters2_arrays, pack_packet_bvh_arrays
from .scene import BRUTE_FORCE_MAX_FACES
from .shape import make_cube, make_rectangle, make_sphere

# the JAX loader's flags of each type (`scene/loader.py::FLAG_MAP`): the
# path tracer's NEE runs only on lanes whose flags hold a Smooth lobe
_FLAGS = {
    BSDF_DIFFUSE: BSDFFlags.DiffuseReflection | BSDFFlags.FrontSide,
    BSDF_CONDUCTOR: BSDFFlags.DeltaReflection | BSDFFlags.FrontSide,
    BSDF_ROUGH_CONDUCTOR: BSDFFlags.GlossyReflection | BSDFFlags.FrontSide,
    BSDF_DIELECTRIC: (BSDFFlags.DeltaReflection | BSDFFlags.DeltaTransmission
                      | BSDFFlags.FrontSide | BSDFFlags.BackSide
                      | BSDFFlags.NonSymmetric),
    BSDF_ROUGH_GRATING: BSDFFlags.GlossyReflection | BSDFFlags.FrontSide,
}


def _geometry(meshes, mat_ids, emitter_ids, spheres=None, disks=None,
              cylinders=None):
    """Arrays of the vertex rows, the q table, the (p0, e1, e2) rows and
    the packed per-face attributes, and the radius of the scene's bounding
    box. A mesh is (vertices, faces, normals, uvs); normals None shades it
    flat (face normals), uvs None gives zero uvs. spheres / disks / cylinders are the
    JAX package's analytic-primitive dicts (`build_geometry`: "center",
    "radius"; "center", "n", "s", "radius"; "p0", "axis", "length",
    "radius"; each with "mat", "emitter" and "shape", default 0, -1,
    -1)."""
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
    geo = {"geo.tri_p0": p0, "geo.tri_p1": p1, "geo.tri_p2": p2,
           "geo.tri_q": tri_q, "geo.tri_anchor": anchor,
           "geo.tri_isect": isect, "geo.tri_attr": attr}
    geo.update(_analytic_rows(spheres, disks, cylinders))
    lo = np.minimum.reduce([p0.min(0), p1.min(0), p2.min(0)])
    hi = np.maximum.reduce([p0.max(0), p1.max(0), p2.max(0)])
    # the JAX package's `scene_bounds`, analytic primitives included
    if spheres or disks:
        for c, r in (("geo.sph_center", "geo.sph_radius"),
                     ("geo.dsk_center", "geo.dsk_radius")):
            if c in geo:
                lo = np.minimum(lo, (geo[c] - geo[r][:, None]).min(0))
                hi = np.maximum(hi, (geo[c] + geo[r][:, None]).max(0))
    if cylinders:
        a = geo["geo.cyl_p0"]
        b = a + geo["geo.cyl_axis"] * geo["geo.cyl_len"][:, None]
        r = geo["geo.cyl_radius"][:, None]
        lo = np.minimum(lo, np.minimum(a, b).min(0) - r.max())
        hi = np.maximum(hi, np.maximum(a, b).max(0) + r.max())
    radius = float(np.linalg.norm(hi - lo) / 2)
    return geo, radius


def _analytic_rows(spheres, disks, cylinders):
    """The `geo.sph_*`, `geo.dsk_*` and `geo.cyl_*` arrays of the analytic
    primitive dicts, float32 as the JAX package's `build_geometry`."""
    def vecs(items, key):
        return np.stack([np.asarray(x[key], np.float32) for x in items])

    def scalars(items, key):
        return np.asarray([x[key] for x in items], np.float32)

    def attrs(items):
        return np.asarray([[x.get("mat", 0), x.get("emitter", -1),
                            x.get("shape", -1)] for x in items], np.float32)

    out = {}
    if spheres:
        out.update({"geo.sph_center": vecs(spheres, "center"),
                    "geo.sph_radius": scalars(spheres, "radius"),
                    "geo.sph_attr": attrs(spheres)})
    if disks:
        out.update({"geo.dsk_center": vecs(disks, "center"),
                    "geo.dsk_n": vecs(disks, "n"),
                    "geo.dsk_s": vecs(disks, "s"),
                    "geo.dsk_radius": scalars(disks, "radius"),
                    "geo.dsk_attr": attrs(disks)})
    if cylinders:
        out.update({"geo.cyl_p0": vecs(cylinders, "p0"),
                    "geo.cyl_axis": vecs(cylinders, "axis"),
                    "geo.cyl_len": scalars(cylinders, "length"),
                    "geo.cyl_radius": scalars(cylinders, "radius"),
                    "geo.cyl_attr": attrs(cylinders)})
    return out


def _materials(bsdfs):
    """Material rows on the JAX package's defaults: (arrays, static). A
    BSDF is (type, params) or (type, params, twosided); a twosided one
    also holds the BackSide flag."""
    M = len(bsdfs)
    tab = {
        "mtype": np.array([b[0] for b in bsdfs], np.int32),
        "flags": np.array([_FLAGS[b[0]] for b in bsdfs], np.uint32),
        "twosided": np.zeros(M, bool),
        "base_color": np.full((M, 3), 0.5, np.float32),
        "transmittance": np.ones((M, 3), np.float32),
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
    for i, (btype, params, *twosided) in enumerate(bsdfs):
        if btype not in _FLAGS:
            raise NotImplementedError(f"BSDF type {btype} is not ported")
        if twosided and twosided[0]:
            tab["twosided"][i] = True
            tab["flags"][i] |= BSDFFlags.BackSide
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
    """Emitter rows on the JAX loader's defaults (a to_world gives the
    position and the direction of +z, a direction replaces the latter),
    with the area tables built as `scene/loader.py::build_emitter_table`
    builds them from the faces whose emitter column (of `geo`'s
    `tri_attr`) names the light:
    `tri_idx` padded with -1, `tri_cdf` the area CDF normalised to 1 (1 in
    the padding), `area` the total. A "sphere_area" light (an analytic
    sphere's) keeps its centre in `position`, its radius in `cutoff_cos`
    and 4 pi r^2 in `area`. No emitter at all gives one black constant
    one, as in the JAX loader."""
    if not emitters:
        emitters = [{"type": "constant", "radiance": (0.0, 0.0, 0.0)}]
    E = len(emitters)
    etype = np.zeros(E, np.int32)
    radiance = np.ones((E, 3), np.float32)
    position = np.zeros((E, 3), np.float32)
    direction = np.tile(np.array([[0, 0, 1]], np.float32), (E, 1))
    cutoff = np.full(E, np.cos(np.deg2rad(20.0)), np.float32)
    area = np.zeros(E, np.float32)
    kinds = {"area": em.EMITTER_AREA, "point": em.EMITTER_POINT,
             "constant": em.EMITTER_CONSTANT,
             "directional": em.EMITTER_DIRECTIONAL,
             "sphere_area": em.EMITTER_SPHERE}
    for i, e in enumerate(emitters):
        kind = kinds.get(e["type"])
        if kind is None:
            raise NotImplementedError(f"emitter type {e['type']!r}")
        etype[i] = kind
        radiance[i] = e["radiance"]  # a point light's intensity
        if "position" in e:
            position[i] = e["position"]
        if "to_world" in e:
            M = np.asarray(e["to_world"])
            position[i] = M[:3, 3]
            direction[i] = M[:3, :3] @ np.array([0, 0, 1.0])
        if "direction" in e:
            d = np.asarray(e["direction"], np.float64)
            direction[i] = d / np.linalg.norm(d)
        if kind == em.EMITTER_SPHERE:
            position[i] = np.asarray(e["center"], np.float32)
            cutoff[i] = float(e["radius"])
            area[i] = 4.0 * np.pi * float(e["radius"]) ** 2

    face_emitter = geo["geo.tri_attr"][:, 19]
    rows = geo["geo.tri_isect"]
    tri_lists = {i: np.where(face_emitter == i)[0].astype(np.int32)
                 for i, e in enumerate(emitters) if e["type"] == "area"}
    max_tris = max([1] + [len(x) for x in tri_lists.values()])
    tri_idx = np.full((E, max_tris), -1, np.int32)
    tri_cdf = np.ones((E, max_tris), np.float32)
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
        "emitters.cutoff_cos": cutoff,
        "emitters.tri_idx": tri_idx, "emitters.tri_cdf": tri_cdf,
        "emitters.area": area,
        "emitters.scene_radius": np.asarray(scene_radius, np.float32),
    }
    return arrays, {"emitters.present_types": tuple(
        sorted(int(x) for x in set(etype)))}


def sensor_arrays(sensor: Sensor):
    """The (arrays, static) pair of a port Sensor, on the host."""
    arrays = {"sensor." + name: getattr(sensor, name).cpu().numpy()
              for name in FIELDS}
    arrays["sensor.stype"] = arrays["sensor.stype"].astype(np.int32)
    return arrays, {"sensor.resolution": tuple(sensor.resolution),
                    "sensor.stype_static": sensor.stype_static}


def _sensor(to_world, fov_x_deg, width, height):
    """A perspective camera's (arrays, static), as `Sensor.perspective`
    builds its fields."""
    return sensor_arrays(Sensor.perspective(to_world, fov_x_deg, width,
                                            height, device="cpu"))


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


# the two boxes' material of each `box_material`, the JAX preset's rows
_GOLD_ETA = {"eta_re": (0.2, 0.92, 1.1), "eta_im": (3.9, 2.45, 2.14)}
BOX_MATERIALS = {
    "diffuse": (BSDF_DIFFUSE, {"base_color": (0.885809, 0.698859, 0.666422)}),
    "conductor": (BSDF_CONDUCTOR, _GOLD_ETA),
    "roughconductor": (BSDF_ROUGH_CONDUCTOR, {**_GOLD_ETA,
                                              "alpha": (0.1, 0.1)}),
    "dielectric": (BSDF_DIELECTRIC, {"eta_re": (1.5046,) * 3}),
    "grating": (BSDF_ROUGH_GRATING, {
        **_GOLD_ETA, "alpha": (0.05, 0.05), "grt_inv_period": (0.5, 0.0),
        "grt_height": 0.25, "grt_lobes": 5, "grt_type": 0,
        "grt_multiplier": 1.0, "grt_coherence": 1.0}),
}


def cornell_box_arrays(width: int = 256, height: int = 256, *,
                       light_scale: float = 1.0,
                       box_material: str = "diffuse"):
    """The (arrays, static) pair of `cornell_box`, numpy only: white walls,
    red left and green right walls, two boxes of `box_material` (a key of
    BOX_MATERIALS), a 0.46 x 0.38 area light just below the ceiling whose
    radiance is scaled by light_scale, a 39.3077-degree camera at
    (0, 0, 3.9)."""
    if box_material not in BOX_MATERIALS:
        raise ValueError(f"box_material must be one of "
                         f"{sorted(BOX_MATERIALS)}, got {box_material!r}")
    white = (0.885809, 0.698859, 0.666422)
    green = (0.105421, 0.37798, 0.076425)
    red = (0.570068, 0.0430135, 0.0443706)
    light_rad = tuple(light_scale * c for c in (18.387, 13.9873, 6.75357))
    W, G, R, BOX = 0, 1, 2, 3
    bsdfs = [(BSDF_DIFFUSE, {"base_color": c}) for c in (white, green, red)]
    bsdfs.append(BOX_MATERIALS[box_material])
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


def cornell_box(width: int = 256, height: int = 256, *,
                light_scale: float = 1.0, box_material: str = "diffuse",
                device="cuda"):
    """The Cornell box on `device` (the JAX package's `cornell_box`; at its
    defaults the scene of its cbox bench and cbox_path golden, with
    box_material="dielectric" that of its cbox_stokes golden).
    box_material: "diffuse", "conductor", "roughconductor", "dielectric" or
    "grating" (the PLT showcase); an unknown name raises ValueError."""
    arrays, static = cornell_box_arrays(width, height,
                                        light_scale=light_scale,
                                        box_material=box_material)
    return scene_from_arrays(arrays, static, device=device)


# the sphere's material of each furnace `material` (albedo aside)
FURNACE_MATERIALS = {
    "conductor": (BSDF_CONDUCTOR, {"eta_re": (0.2,) * 3,
                                   "eta_im": (3.9,) * 3}),
    "roughconductor": (BSDF_ROUGH_CONDUCTOR, {
        "eta_re": (0.2,) * 3, "eta_im": (3.9,) * 3, "alpha": (0.3, 0.3)}),
}


def furnace_scene_arrays(width: int = 64, height: int = 64,
                         albedo: float = 0.75, radiance: float = 1.0,
                         material: str = "diffuse"):
    """The (arrays, static) pair of `furnace_scene`, numpy only: the
    1,280-face unit icosphere (smooth normals) of `material` ("diffuse" of
    reflectance albedo, "conductor", "roughconductor") inside a constant
    environment of `radiance`, seen by a 45-degree camera at (0, 0, 4)."""
    if material == "diffuse":
        bsdf = (BSDF_DIFFUSE, {"base_color": (albedo,) * 3})
    elif material in FURNACE_MATERIALS:
        bsdf = FURNACE_MATERIALS[material]
    else:
        raise ValueError(f"material must be 'diffuse', 'conductor' or "
                         f"'roughconductor', got {material!r}")
    mesh = make_sphere(3)
    # the icosphere's normals as they are: the JAX preset hands the mesh to
    # its scene assembly directly, which does not renormalise them
    uv = np.zeros((len(mesh.vertices), 2), np.float32)
    geo, radius = _geometry([(mesh.vertices, mesh.faces, mesh.normals, uv)],
                            [0], [-1])
    mats, mat_static = _materials([bsdf])
    ems, em_static = _emitters([{"type": "constant",
                                 "radiance": (radiance,) * 3}], radius, geo)
    sens, sens_static = _sensor(tf.look_at([0, 0, 4], [0, 0, 0], [0, 1, 0]),
                                45.0, width, height)
    return ({**geo, **mats, **ems, **sens},
            {**mat_static, **em_static, **sens_static})


def furnace_scene(width: int = 64, height: int = 64, albedo: float = 0.75,
                  radiance: float = 1.0, material: str = "diffuse", *,
                  device="cuda"):
    """The white furnace on `device` (the JAX package's `furnace_scene`): a
    convex diffuse sphere of reflectance albedo under a constant
    environment of radiance E shows exactly albedo * E."""
    arrays, static = furnace_scene_arrays(width, height, albedo, radiance,
                                          material)
    return scene_from_arrays(arrays, static, device=device)


def analytic_scene_parts(width: int = 512, height: int = 512):
    """The inputs of `analytic_scene`, numpy and dicts only, for either
    package's `assemble_scene`: the floor's to_world (Mitsuba's rectangle,
    4 x 4 at y = 0), the BSDFs as (type, params) (the default diffuse 0.5
    of the floor and the sphere, the disk's diffuse, the cylinder's rough
    conductor), the sphere light (centre (0, 1, 0), radius 0.4, radiance
    8), the analytic sphere, disk (radius 0.4, facing the camera in the
    plane z = 0 of the sphere's centre, touching the floor at x = -0.95)
    and open cylinder (radius 0.3, height 0.8, standing on the floor at
    x = 0.95), and the thinlens camera (40 degrees at (0, 1, 4), aperture
    radius 0.05, focused at 4). From a point of the disk the sphere light's
    centre lies within rounding of the point's own z, so the light's cone
    frame (`coordinate_system` of a direction whose z is within rounding
    of 0) may take either of its two branches."""
    floor = (tf.translate([0, 0, 0]) @ tf.rotate([1, 0, 0], -90)
             @ tf.scale([4, 4, 1])).astype(np.float32)
    bsdfs = [(BSDF_DIFFUSE, {"base_color": (0.5, 0.5, 0.5)}),
             (BSDF_DIFFUSE, {"base_color": (0.2, 0.4, 0.8)}),
             (BSDF_ROUGH_CONDUCTOR, {**_GOLD_ETA, "alpha": (0.2, 0.2)})]
    centre, radius = np.array([0.0, 1.0, 0.0], np.float32), 0.4
    emitters = [{"type": "sphere_area", "center": centre, "radius": radius,
                 "radiance": (8.0, 8.0, 8.0)}]
    spheres = [{"center": centre, "radius": radius, "mat": 0, "emitter": 0,
                "shape": 10000}]
    disks = [{"center": (-0.95, 0.4, 0.0), "n": (0.0, 0.0, 1.0),
              "s": (1.0, 0.0, 0.0), "radius": 0.4, "mat": 1,
              "shape": 20000}]
    cylinders = [{"p0": (0.95, 0.0, 0.0), "axis": (0.0, 1.0, 0.0),
                  "length": 0.8, "radius": 0.3, "mat": 2, "shape": 30000}]
    camera = {"to_world": tf.look_at([0, 1.0, 4.0], [0, 1.0, 0], [0, 1, 0]),
              "fov": 40.0, "width": width, "height": height,
              "aperture_radius": 0.05, "focus_distance": 4.0}
    return dict(floor=floor, bsdfs=bsdfs, emitters=emitters,
                spheres=spheres, disks=disks, cylinders=cylinders,
                camera=camera)


def analytic_scene(width: int = 512, height: int = 512, *, device="cuda"):
    """(Scene on `device`, meta) of `analytic_scene_parts` through the
    port's `loader.assemble_scene`: one floor mesh of two triangles, one
    analytic sphere light, disk and cylinder, the thinlens camera. meta's
    filter is the box, its sampler "multijitter", its integrator path
    depth 7 / rr 50."""
    from . import loader
    from .shape import HostMesh

    parts = analytic_scene_parts(width, height)
    cam = parts["camera"]
    sensor = Sensor.thinlens(cam["to_world"], cam["fov"], width, height,
                             cam["aperture_radius"], cam["focus_distance"],
                             device="cpu")
    bsdfs = [loader.LoadedBSDF(t, **p) for t, p in parts["bsdfs"]]
    return loader.assemble_scene(
        [HostMesh(*make_rectangle(parts["floor"]))], [0], [-1], bsdfs,
        parts["emitters"], sensor,
        {"type": "path", "max_depth": 7, "rr_depth": 50}, 8, rfilter="box",
        spheres=parts["spheres"], disks=parts["disks"],
        cylinders=parts["cylinders"], sampler="multijitter", device=device)


# The JAX package's silhouette-gradient scenes (tests/test_projective.py)
# as dicts for `load_dict`: an emissive rectangle or cube against black
# (path depth 1: the boundary term is the whole derivative), and a blocker
# over a diffuse floor under a point light ("shadow") or an area light
# ("penumbra"), path depth 2, whose camera sees only the floor. `delta`
# moves the rectangle, the cube or the blocker along x.
BOUNDARY_SCENES = ("rectangle", "cube", "shadow", "penumbra")
# each scene's moving face rows (the floor's two faces come first)
BOUNDARY_ROWS = {"rectangle": slice(None), "cube": slice(None),
                 "shadow": slice(2, 4), "penumbra": slice(2, 4)}


def boundary_scene_dict(name: str, width: int = 48, height: int = 48,
                        delta: float = 0.0) -> dict:
    """The dict of boundary scene `name` (one of BOUNDARY_SCENES)."""
    film = {"type": "hdrfilm", "width": width, "height": height}
    if name in ("rectangle", "cube"):
        return {
            "type": "scene",
            "integrator": {"type": "path", "max_depth": 1},
            "sensor": {"type": "perspective", "fov": 45, "film": film,
                       "to_world": tf.look_at([0, 0, 4], [0, 0, 0],
                                              [0, 1, 0])},
            "obj": {"type": name,
                    "to_world": tf.translate([delta, 0, 0]) @ np.diag(
                        [0.5, 0.5, 0.5, 1.0]).astype(np.float32),
                    "emitter": {"type": "area",
                                "radiance": [5.0, 5.0, 5.0]}},
        }
    if name not in ("shadow", "penumbra"):
        raise ValueError(f"unknown boundary scene {name!r}")
    d = {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 2},
        "sensor": {"type": "perspective", "fov": 25, "film": film,
                   "to_world": tf.look_at([0, 2.5, 0.0], [0, 0, 0.001],
                                          [0, 0, 1])},
        "floor": {"type": "rectangle",
                  "to_world": tf.rotate([1, 0, 0], -90) @ np.diag(
                      [3.0, 3.0, 1.0, 1.0]).astype(np.float32),
                  "bsdf": {"type": "diffuse", "reflectance": 0.8}},
        "blocker": {"type": "rectangle",
                    "to_world": tf.translate([-0.75 + delta, 1.5, 0.0])
                    @ tf.rotate([1, 0, 0], -90)
                    @ np.diag([0.25, 0.25, 1.0, 1.0]).astype(np.float32),
                    "bsdf": {"type": "diffuse", "reflectance": 0.0}},
    }
    if name == "penumbra":
        d["light"] = {
            "type": "rectangle",
            "to_world": tf.translate([-2.0, 3.0, 0.0])
            @ tf.rotate([1, 0, 0], 90)
            @ np.diag([0.3, 0.3, 1.0, 1.0]).astype(np.float32),
            "emitter": {"type": "area", "radiance": [60.0, 60.0, 60.0]}}
    else:
        d["light"] = {"type": "point", "position": [-2.0, 3.0, 0.0],
                      "intensity": [30.0, 30.0, 30.0]}
    return d
