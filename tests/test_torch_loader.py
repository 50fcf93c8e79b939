"""Scene loading in the port against the JAX package (CPU): the XML loader
(`load_file`) and the dict loader (`load_dict`) on the Cornell box, the
grating scene, PLY, OBJ and .serialized meshes, the analytic primitives
with a sphere light, shapegroups, instances and merges, and $name
parameters; each loaded scene's arrays equal, to the bit, those of the
JAX package's load of the same file bridged into the port, the treelet
tables of a loaded scene above 4,096 faces included. Then the package's
render((scene, meta)) of an XML box against JAX's mi.render."""
import numpy as np
import pytest
import torch

import mitsuba3_plt_tpu as mi
from mitsuba3_plt_tpu.core import transform as jtf
from mitsuba3_plt_tpu.scene import shape as jshape
import mitsuba3_plt_tpu_torch as tmi
from mitsuba3_plt_tpu_torch.core import transform as tf
from mitsuba3_plt_tpu_torch.scene import loader as tloader
from mitsuba3_plt_tpu_torch.scene import presets as tpresets
from mitsuba3_plt_tpu_torch.scene import shape as tshape
from mitsuba3_plt_tpu_torch.scene import xml_scenes
from mitsuba3_plt_tpu_torch.scene.bridge import scene_from_arrays
from test_torch_scene import _tensors, jax_scene_arrays
from test_torch_golden_specular import one_torch_thread  # noqa: F401

CT_FIELDS = ("supers", "boxes", "rows", "anchor")


def assert_same_scene(port, jscene):
    """The port's scene equal, tensor for tensor and to the bit, to the
    JAX scene bridged into the port; the treelet tables too where the
    port has them (above 4,096 faces, where it must)."""
    bridged = scene_from_arrays(*jax_scene_arrays(jscene), device="cpu")
    a, b = _tensors(port), _tensors(bridged)
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], torch.Tensor):
            np.testing.assert_array_equal(a[key].numpy(), b[key].numpy(),
                                          err_msg=key)
            assert a[key].dtype == b[key].dtype, key
        else:
            assert a[key] == b[key], key
    assert (port.ctab2 is not None) == (port.geo.n_faces > 4096)
    if port.ctab2 is not None:
        for field in CT_FIELDS:
            np.testing.assert_array_equal(
                getattr(port.ctab2, field).numpy(),
                getattr(bridged.ctab2, field).numpy(), err_msg=field)


def load_both(path, *args, **kw):
    """(port scene, port meta, JAX scene, JAX meta) of one XML file."""
    port, meta = tmi.load_file(str(path), *args, device="cpu", **kw)
    jscene, jmeta = mi.load_file(str(path), *args, **kw)
    return port, meta, jscene, jmeta


def write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return path


# ---------------------------------------------------------------------------
# mesh files, written here
# ---------------------------------------------------------------------------

def write_ply(path, mesh):
    """A binary little-endian PLY: float positions, normals and uvs, and
    uchar-counted int faces."""
    v = np.asarray(mesh.vertices, np.float32)
    n = np.asarray(mesh.normals, np.float32)
    uv = (np.asarray(mesh.uvs, np.float32) if mesh.uvs is not None
          else np.zeros((len(v), 2), np.float32))
    head = ("ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(v)}\n"
            + "".join(f"property float {c}\n"
                      for c in ("x", "y", "z", "nx", "ny", "nz", "u", "v"))
            + f"element face {len(mesh.faces)}\n"
            "property list uchar int vertex_indices\nend_header\n")
    faces = np.zeros(len(mesh.faces), np.dtype([("k", "u1"),
                                                ("i", "<i4", (3,))]))
    faces["k"], faces["i"] = 3, mesh.faces
    with open(path, "wb") as f:
        f.write(head.encode())
        f.write(np.concatenate([v, n, uv], 1).astype("<f4").tobytes())
        f.write(faces.tobytes())


def write_obj(path, mesh):
    """An OBJ with positions, normals and uvs indexed together."""
    uv = (mesh.uvs if mesh.uvs is not None
          else np.zeros((len(mesh.vertices), 2), np.float32))
    lines = [f"v {x!r} {y!r} {z!r}" for x, y, z in mesh.vertices.tolist()]
    lines += [f"vn {x!r} {y!r} {z!r}" for x, y, z in mesh.normals.tolist()]
    lines += [f"vt {u!r} {v!r}" for u, v in uv.tolist()]
    lines += ["f " + " ".join(f"{i + 1}/{i + 1}/{i + 1}" for i in face)
              for face in mesh.faces.tolist()]
    path.write_text("\n".join(lines) + "\n")


def write_ascii_ply_quads(path):
    """An ascii PLY of two quads (fan-split) with 8-bit colours."""
    path.write_text(
        "ply\nformat ascii 1.0\nelement vertex 6\nproperty float x\n"
        "property float y\nproperty float z\nproperty uchar red\n"
        "property uchar green\nproperty uchar blue\nelement face 2\n"
        "property list uchar int vertex_indices\nend_header\n"
        "0 0 0 255 0 0\n1 0 0 0 255 0\n1 1 0 0 0 255\n0 1 0 9 9 9\n"
        "2 0 0 1 2 3\n2 1 0 4 5 6\n4 0 1 2 3\n4 1 4 5 2\n")


MESH_SCENE = """<scene version="3.0.0">
  <sensor type="perspective">
    <float name="fov" value="45"/>
    <transform name="to_world">
      <lookat origin="0, 0, 4" target="0, 0, 0" up="0, 1, 0"/>
    </transform>
    <film type="hdrfilm">
      <integer name="width" value="16"/><integer name="height" value="16"/>
    </film>
  </sensor>
  <emitter type="point">
    <point name="position" x="2" y="2" z="3"/>
    <rgb name="intensity" value="40, 40, 40"/>
  </emitter>
  <shape type="{kind}">
    <string name="filename" value="{file}"/>
    <transform name="to_world"><rotate y="1" angle="30"/>
      <translate x="0.1"/></transform>
    <bsdf type="diffuse"><rgb name="reflectance" value="0.7"/></bsdf>
  </shape>
</scene>
"""


@pytest.mark.parametrize("kind", ["ply", "obj", "serialized"])
def test_mesh_file_scene_equals_jax(tmp_path, kind):
    """The 20,480-face icosphere as a binary PLY, an OBJ and a .serialized
    file in an XML scene: the loaded arrays and the treelet tables of the
    clu2 route equal JAX's."""
    mesh = tshape.make_sphere(5)
    mesh.uvs = (mesh.vertices[:, :2] * 0.5 + 0.5).astype(np.float32)
    name = {"ply": "ball.ply", "obj": "ball.obj",
            "serialized": "ball.serialized"}[kind]
    if kind == "ply":
        write_ply(tmp_path / name, mesh)
    elif kind == "obj":
        write_obj(tmp_path / name, mesh)
    else:
        tshape.save_serialized(str(tmp_path / name), mesh)
    path = write(tmp_path, "scene.xml", MESH_SCENE.format(kind=kind,
                                                         file=name))
    port, meta, jscene, jmeta = load_both(path)
    assert meta == jmeta
    assert port.geo.n_faces == 20480 and port.intersect_route() == "clu2"
    assert_same_scene(port, jscene)


# ---------------------------------------------------------------------------
# XML scenes
# ---------------------------------------------------------------------------

def test_cbox_xml_equals_jax(tmp_path):
    """(a) The Cornell box as XML: equal to JAX's load, and to the
    preset's arrays (its transforms happen to round the same)."""
    path = write(tmp_path, "cbox.xml", xml_scenes.cornell_box_xml(16, 16))
    port, meta, jscene, jmeta = load_both(path)
    assert meta == jmeta == {"integrator": {"type": "path", "max_depth": 7,
                                            "rr_depth": 50}, "spp": 8,
                             "rfilter": "gaussian",
                             "sampler": "independent"}
    assert_same_scene(port, jscene)
    assert port.emitters.tri_idx.tolist() == [[34, 35]]
    preset = tpresets.cornell_box(16, 16, device="cpu")
    a, b = _tensors(port), _tensors(preset)
    for key in a:
        if isinstance(a[key], torch.Tensor):
            assert torch.equal(a[key], b[key]), key


ANALYTIC = """<scene version="3.0.0">
  <integrator type="path"><integer name="max_depth" value="5"/></integrator>
  <sensor type="thinlens">
    <float name="fov" value="40"/>
    <float name="aperture_radius" value="0.05"/>
    <float name="focus_distance" value="4"/>
    <transform name="to_world">
      <lookat origin="0, 1, 4" target="0, 1, 0" up="0, 1, 0"/>
    </transform>
    <sampler type="multijitter"><integer name="sample_count" value="9"/>
    </sampler>
    <film type="hdrfilm"><integer name="width" value="12"/>
      <integer name="height" value="10"/><rfilter type="tent"/></film>
  </sensor>
  <bsdf type="roughconductor" id="gold">
    <string name="material" value="Au"/><float name="alpha" value="0.2"/>
    <string name="distribution" value="ggx"/>
  </bsdf>
  <shape type="rectangle">
    <transform name="to_world"><scale x="4" y="4" z="1"/>
      <rotate x="1" angle="-90"/></transform>
  </shape>
  <shape type="sphere">
    <point name="center" x="0" y="1" z="0"/><float name="radius" value="0.4"/>
    <emitter type="area"><rgb name="radiance" value="8"/></emitter>
  </shape>
  <shape type="disk">
    <transform name="to_world"><scale value="0.4"/>
      <translate x="-0.95" y="0.4"/></transform>
    <bsdf type="diffuse"><rgb name="reflectance" value="0.2, 0.4, 0.8"/>
    </bsdf>
  </shape>
  <shape type="cylinder">
    <float name="radius" value="0.3"/>
    <point name="p0" x="0.95" y="0" z="0"/>
    <point name="p1" x="0.95" y="0.8" z="0"/>
    <ref id="gold"/>
  </shape>
  <shape type="disk">
    <transform name="to_world"><scale x="0.3" y="0.1" z="1"/>
      <translate x="1.5" y="0.01"/></transform>
  </shape>
  <shape type="cylinder">
    <transform name="to_world"><translate z="-1"/></transform>
    <emitter type="area"><rgb name="radiance" value="0.5"/></emitter>
  </shape>
</scene>
"""


def test_analytic_xml_equals_jax(tmp_path):
    """(c) The analytic sphere light, disk and cylinder (and a disk under
    a non-uniform scale, tessellated), the thinlens camera, the
    multijitter sampler and a tent filter. An emissive cylinder, which the
    JAX package drops, is tessellated with its light: the JAX scene is
    compared without it."""
    path = write(tmp_path, "analytic.xml", ANALYTIC)
    port, meta = tmi.load_file(str(path), device="cpu")
    g = port.geo
    assert (g.n_spheres, g.n_disks, g.n_cylinders) == (1, 1, 1)
    assert g.n_faces == 2 + 64 + 128
    assert port.emitters.present_types == (0, 7)  # area, sphere
    assert meta["sampler"] == "multijitter" and meta["rfilter"] == "tent"
    assert meta["spp"] == 9 and port.sensor.stype_static == 2
    # without the emissive cylinder, against JAX
    cut = ANALYTIC[:ANALYTIC.rindex("  <shape type=\"cylinder\">")]
    path = write(tmp_path, "cut.xml", cut + "</scene>\n")
    port, meta, jscene, jmeta = load_both(path)
    assert meta == jmeta
    assert_same_scene(port, jscene)
    assert float(port.emitters.cutoff_cos[0]) == pytest.approx(0.4)


SIZED = """<scene version="3.0.0">
  <shape type="disk"><float name="radius" value="0.2"/>
    <transform name="to_world"><translate y="1"/></transform>
    <emitter type="area"><rgb name="radiance" value="5"/></emitter>
  </shape>
  <shape type="cylinder"><float name="radius" value="0.3"/>
    <point name="p0" x="0.5" y="0" z="0"/><point name="p1" x="0.5" y="0.8" z="0"/>
    <emitter type="area"><rgb name="radiance" value="1"/></emitter>
  </shape>
  <shape type="disk"><float name="radius" value="0.5"/>
    <transform name="to_world"><scale x="2" y="1" z="1"/>
      <translate x="-2"/></transform>
  </shape>
  <shape type="shapegroup" id="ball">
    <shape type="sphere"><float name="radius" value="0.25"/>
      <point name="center" x="0" y="0" z="-2"/></shape>
  </shape>
  <shape type="instance"><ref id="ball"/></shape>
</scene>
"""


def sized_dict():
    return {"type": "scene",
            "light": {"type": "disk", "radius": 0.2,
                      "to_world": tf.translate([0, 1, 0]),
                      "emitter": {"type": "area", "radiance": 5.0}},
            "tube": {"type": "cylinder", "radius": 0.3, "p0": [0.5, 0, 0],
                     "p1": [0.5, 0.8, 0],
                     "emitter": {"type": "area", "radiance": 1.0}},
            "oval": {"type": "disk", "radius": 0.5,
                     "to_world": tf.translate([-2, 0, 0]) @ tf.scale(
                         [2, 1, 1])},
            "ball": {"type": "sphere", "radius": 0.25}}


@pytest.mark.parametrize("loader", ["xml", "dict"])
def test_tessellated_shapes_keep_their_radius_and_ends(tmp_path, loader):
    """A tessellated disk or cylinder (emissive, or under a non-uniform
    scale) and a tessellated sphere keep their own radius, p0 and p1
    (and centre) under to_world, as Mitsuba's disk, cylinder and sphere
    do: the radius-0.2 disk light has the area of its 64-gon and 64
    equal steps in its triangle CDF, the cylinder light runs from p0 to
    p1 at radius 0.3, the oval spans its radius times its scale, and the
    sphere (a shapegroup member in the XML, alone in the dict) has radius
    0.25 about its centre."""
    if loader == "xml":
        port, _ = tmi.load_file(str(write(tmp_path, "sized.xml", SIZED)),
                                device="cpu")
        center = np.array([0.0, 0.0, -2.0])
    else:
        port, _ = tmi.load_dict(sized_dict(), device="cpu")
        center = np.zeros(3)
    rows = port.geo.tri_isect.numpy().astype(np.float64)
    mesh_of = port.geo.tri_attr.numpy()[:, 20]
    corners = np.stack([rows[:, :3], rows[:, :3] + rows[:, 3:6],
                        rows[:, :3] + rows[:, 6:9]], 1)

    def verts(k):
        return corners[:len(mesh_of)][mesh_of == k].reshape(-1, 3)

    area = port.emitters.area.numpy().astype(np.float64)
    cdf = port.emitters.tri_cdf.numpy()
    n = 64
    disk_area = 0.5 * n * np.sin(2 * np.pi / n) * 0.2 ** 2
    tube_area = n * 2 * 0.3 * np.sin(np.pi / n) * 0.8
    np.testing.assert_allclose(area[:2], [disk_area, tube_area], rtol=1e-5)
    np.testing.assert_allclose(cdf[0, :n], np.arange(1, n + 1) / n,
                               atol=1e-6)
    np.testing.assert_allclose(cdf[1, :2 * n],
                               np.arange(1, 2 * n + 1) / (2 * n), atol=1e-6)
    light = verts(0) - [0.0, 1.0, 0.0]
    assert np.abs(light[:, 2]).max() < 1e-6
    np.testing.assert_allclose(np.linalg.norm(light, axis=-1).max(), 0.2,
                               rtol=1e-6)
    tube = verts(1)
    np.testing.assert_allclose(np.hypot(tube[:, 0] - 0.5, tube[:, 2]), 0.3,
                               rtol=1e-5)
    np.testing.assert_allclose([tube[:, 1].min(), tube[:, 1].max()],
                               [0.0, 0.8], atol=1e-6)
    oval = verts(2) - [-2.0, 0.0, 0.0]
    np.testing.assert_allclose(np.abs(oval[:, :2]).max(0), [1.0, 0.5],
                               rtol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(verts(3) - center, axis=-1),
                               0.25, rtol=1e-5)


BOTH_FORMS_XML = """<scene version="3.0.0">
  <sensor type="perspective">
    <float name="fov" value="30"/><string name="fov_axis" value="y"/>
    <float name="near_clip" value="0.5"/><float name="far_clip" value="50"/>
    <float name="principal_point_offset_x" value="0.1"/>
    <transform name="to_world">
      <lookat origin="0, 1, 4" target="0, 0, 0" up="0, 1, 0"/>
    </transform>
    <sampler type="stratified"><integer name="sample_count" value="4"/>
    </sampler>
    <film type="hdrfilm"><integer name="width" value="12"/>
      <integer name="height" value="8"/><rfilter type="box"/></film>
  </sensor>
  <bsdf type="roughgrating" id="g"><float name="height" value="0.2"/>
    <string name="lobe_type" value="LINEAR"/></bsdf>
  <shape type="rectangle"><ref id="g"/></shape>
</scene>
"""


def both_forms_dict(lobe_type="linear"):
    return {"type": "scene",
            "camera": {"type": "perspective", "fov": 30, "fov_axis": "y",
                       "near_clip": 0.5, "far_clip": 50.0,
                       "principal_point_offset_x": 0.1,
                       "to_world": tf.look_at([0, 1, 4], [0, 0, 0],
                                              [0, 1, 0]),
                       "sampler": {"type": "stratified", "sample_count": 4},
                       "film": {"type": "hdrfilm", "width": 12, "height": 8,
                                "rfilter": {"type": "box"}}},
            "g": {"type": "roughgrating", "height": 0.2,
                  "lobe_type": lobe_type},
            "panel": {"type": "rectangle", "bsdf": {"type": "ref",
                                                    "id": "g"}}}


def test_xml_and_dict_share_one_sensor_and_bsdf_builder(tmp_path):
    """Both loaders build sensors and BSDFs through loader.make_sensor and
    make_bsdf: the same perspective camera (fov_axis, clip planes and
    principal point included), sampler and filter in both forms, and the
    same grating but for the parameters the XML loader's defaults fill
    (XML_BSDF_DEFAULTS, where the dict keeps the material table's, as the
    JAX package's two loaders do). An unknown lobe_type raises in both."""
    xml, xmeta = tmi.load_file(str(write(tmp_path, "both.xml",
                                         BOTH_FORMS_XML)), device="cpu")
    dct, dmeta = tmi.load_dict(both_forms_dict(), device="cpu")
    assert xmeta == {**dmeta, "integrator": xmeta["integrator"]}
    assert (xmeta["sampler"], xmeta["rfilter"], xmeta["spp"]) == (
        "stratified", "box", 4)
    a, b = _tensors(xml), _tensors(dct)
    differ = sorted(k for k in a if isinstance(a[k], torch.Tensor)
                    and not torch.equal(a[k], b[k]))
    assert differ == ["materials.base_color", "materials.eta_im",
                      "materials.eta_re", "materials.grt_coherence",
                      "materials.grt_inv_period", "materials.grt_lobes"]
    assert float(xml.sensor.near) == 0.5 and float(xml.sensor.far) == 50.0
    g = both_forms_dict()["g"]
    filled = tloader.make_bsdf(g, tloader.XML_BSDF_DEFAULTS)
    root = tloader.ET.fromstring(BOTH_FORMS_XML)
    parsed = tloader.make_bsdf(tloader._plugin_dict(root.find("bsdf"), {}),
                               tloader.XML_BSDF_DEFAULTS)
    assert (filled.btype, filled.params) == (parsed.btype, parsed.params)
    with pytest.raises(ValueError, match="zigzag"):
        tmi.load_dict(both_forms_dict("zigzag"), device="cpu")
    with pytest.raises(ValueError, match="zigzag"):
        tmi.load_file(str(write(tmp_path, "zigzag.xml", BOTH_FORMS_XML
                                .replace("LINEAR", "zigzag"))), device="cpu")


def test_grating_xml_equals_jax(tmp_path):
    """(d) The grating scene as XML under PLT, against JAX's load: equal;
    against the preset, only the grating's base colour differs (the XML
    default specular_reflectance 1 against the preset's row default)."""
    path = write(tmp_path, "grating.xml", xml_scenes.grating_scene_xml(16,
                                                                       12))
    port, meta, jscene, jmeta = load_both(path)
    assert meta == jmeta and meta["integrator"]["type"] == "plt"
    assert_same_scene(port, jscene)
    a = _tensors(port)
    b = _tensors(tpresets.grating_scene(16, 12, device="cpu"))
    differ = [k for k in a if isinstance(a[k], torch.Tensor)
              and not torch.equal(a[k], b[k])]
    assert differ == ["materials.base_color"]


GROUPS = """<scene version="3.0.0">
  <bsdf type="twosided" id="red"><bsdf type="diffuse">
    <rgb name="reflectance" value="0.8, 0.1, 0.1"/></bsdf></bsdf>
  <bsdf type="conductor" id="mirror"/>
  <shape type="shapegroup" id="pair">
    <shape type="cube">
      <transform name="to_world"><scale value="0.2"/></transform>
      <ref id="red"/>
    </shape>
    <shape type="rectangle">
      <transform name="to_world"><translate y="-0.2"/></transform>
      <bsdf type="dielectric"><string name="int_ior" value="water"/>
      </bsdf>
    </shape>
  </shape>
  <shape type="instance">
    <transform name="to_world"><rotate y="1" angle="20"/>
      <translate x="-0.5"/></transform>
    <ref id="pair"/>
  </shape>
  <shape type="instance">
    <transform name="to_world"><translate x="0.5"/></transform>
    <ref id="pair"/>
  </shape>
  <shape type="merge">
    <shape type="rectangle"><ref id="mirror"/>
      <boolean name="face_normals" value="true"/></shape>
    <shape type="cube">
      <transform name="to_world"><translate z="-3"/></transform>
    </shape>
  </shape>
  <emitter type="constant"><rgb name="radiance" value="0.5"/></emitter>
  <emitter type="directional">
    <vector name="direction" x="0" y="-1" z="-1"/>
    <rgb name="irradiance" value="2"/>
  </emitter>
</scene>
"""


def test_shapegroup_instance_and_merge_equal_jax(tmp_path):
    """(e) A shapegroup (a cube with a referenced twosided BSDF and a
    rectangle with an inline dielectric of a named IOR) instanced twice,
    and a merge; constant and directional lights; no sensor (the default
    camera)."""
    path = write(tmp_path, "groups.xml", GROUPS)
    port, meta, jscene, jmeta = load_both(path)
    assert meta == jmeta
    assert port.geo.n_faces == 2 * (12 + 2) + 2 + 12
    assert_same_scene(port, jscene)
    assert port.materials.twosided.tolist()[0] is True


PARAMS = """<scene version="3.0.0">
  <default name="resx" value="64"/>
  <default name="resy" value="48"/>
  <default name="albedo" value="0.25"/>
  <default name="depth" value="3"/>
  <default name="integrator" value="path"/>
  <integrator type="$integrator">
    <integer name="max_depth" value="$depth"/>
  </integrator>
  <sensor type="perspective">
    <float name="fov" value="30"/><string name="fov_axis" value="y"/>
    <film type="hdrfilm"><integer name="width" value="$resx"/>
      <integer name="height" value="$resy"/></film>
  </sensor>
  <shape type="rectangle">
    <bsdf type="diffuse"><rgb name="reflectance" value="$albedo"/></bsdf>
  </shape>
  <emitter type="point"><point name="position" value="$light"/>
    <spectrum name="intensity" value="400:2, 700:4"/></emitter>
</scene>
"""


@pytest.mark.parametrize("parameters,overrides", [
    ({"light": "0 0 2"}, {}),
    ({"light": "1, 1, 1", "albedo": "0.5"},
     {"resx": 20, "resy": 10, "integrator": "plt"}),
])
def test_defaults_and_parameters_equal_jax(tmp_path, parameters, overrides):
    """(f) <default>s, parameters= and keyword overrides fill $names
    (the integrator's type among them); a fov along y."""
    path = write(tmp_path, "params.xml", PARAMS)
    port, meta, jscene, jmeta = load_both(path, parameters, **overrides)
    assert meta == jmeta
    assert_same_scene(port, jscene)
    want = (overrides.get("resx", 64), overrides.get("resy", 48))
    assert port.sensor.resolution == want
    with pytest.raises(ValueError, match="light"):
        tmi.load_file(str(path), device="cpu")


def mesh20k_dict(mesh, look_at):
    """tests/test_golden.py's mesh20k dict."""
    return {
        "type": "scene",
        "sensor": {"type": "perspective", "fov": 45,
                   "to_world": look_at([0, 0, 4], [0, 0, 0], [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": 32, "height": 32}},
        "light": {"type": "point", "position": [2, 2, 3],
                  "intensity": [40, 40, 40]},
        "ball": {"type": "mesh", "mesh": mesh,
                 "bsdf": {"type": "diffuse", "reflectance": 0.7}},
    }


def test_load_dict_mesh20k_equals_preset_and_jax():
    """(g) load_dict of the mesh20k golden's dict: the arrays equal the
    port's `mesh_scene_arrays(32, 32, 5)` (the preset the card's goldens
    render) and JAX's load_dict of the same dict, treelet tables
    included."""
    port, meta = tmi.load_dict(mesh20k_dict(tshape.make_sphere(5),
                                            tf.look_at), device="cpu")
    jscene, jmeta = mi.load_dict(mesh20k_dict(jshape.make_sphere(5),
                                              jtf.look_at))
    assert meta == jmeta
    assert_same_scene(port, jscene)
    arrays, static = tpresets.mesh_scene_arrays(32, 32, 5)
    preset = scene_from_arrays(arrays, static, device="cpu")
    a, b = _tensors(port), _tensors(preset)
    for key in a:
        if isinstance(a[key], torch.Tensor):
            assert torch.equal(a[key], b[key]), key
    for field in CT_FIELDS:
        assert torch.equal(getattr(port.ctab2, field),
                           getattr(preset.ctab2, field)), field


def test_load_dict_shapes_equal_jax():
    """load_dict's other shapes and lights: a named BSDF by reference, a
    twosided rough conductor, a tessellated sphere of a centre and
    radius, analytic disk and cylinder, an emissive rectangle,
    directional and constant lights."""
    def scene(t):
        return {
            "type": "scene",
            "integrator": {"type": "plt", "max_depth": 5},
            "sensor": {"type": "orthographic",
                       "to_world": t.look_at([0, 3, 3], [0, 0, 0],
                                             [0, 1, 0]),
                       "film": {"type": "hdrfilm", "width": 12,
                                "height": 8}},
            "glass": {"type": "dielectric", "int_ior": 1.33},
            "ball": {"type": "sphere", "center": [0, 0.5, 0],
                     "radius": 0.5, "ref": {"type": "ref", "id": "glass"}},
            "floor": {"type": "rectangle",
                      "to_world": t.scale([3, 3, 1]),
                      "bsdf": {"type": "twosided",
                               "inner": {"type": "roughconductor",
                                         "material": "cu",
                                         "alpha": 0.3}}},
            "disk": {"type": "disk",
                     "to_world": (t.translate([1, 0, 0])
                                  @ t.scale([0.5, 0.5, 1])),
                     "bsdf": {"type": "roughgrating", "inv_period": 0.5,
                              "height": 0.2, "lobes": 3,
                              "lobe_type": "linear"}},
            "tube": {"type": "cylinder", "radius": 0.2},
            "panel": {"type": "rectangle",
                      "to_world": t.translate([0, 2, 0]),
                      "emitter": {"type": "area", "radiance": [3, 2, 1]}},
            "sun": {"type": "directional", "direction": [0, -1, 0.2],
                    "irradiance": 2.0},
            "sky": {"type": "constant", "radiance": {"type": "rgb",
                                                     "value": 0.1}},
        }

    port, meta = tmi.load_dict(scene(tf), device="cpu")
    jscene, jmeta = mi.load_dict(scene(jtf))
    assert meta == jmeta
    assert_same_scene(port, jscene)
    assert port.geo.n_faces == 5120 + 2 + 2 and port.ctab2 is not None


# ---------------------------------------------------------------------------
# the package's render
# ---------------------------------------------------------------------------

def test_render_xml_box_matches_jax(tmp_path):
    """The package's render((scene, meta)) of a 16x16 XML box, 4 spp,
    through the meta's Gaussian filter and path tracer (depth 4, rr 9),
    against JAX's mi.render of the same file, at the filtered image's
    tolerance of tests/test_torch_film.py (rtol 1e-3 / atol 1e-5: every
    lane of this box agrees)."""
    path = write(tmp_path, "box.xml", xml_scenes.cornell_box_xml(
        16, 16, spp=4, max_depth=4, rr_depth=9))
    port, meta, jscene, jmeta = load_both(path)
    got = tmi.render((port, meta), spp=4, seed=3).numpy()
    want = np.asarray(mi.render((jscene, jmeta), spp=4, seed=3))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
    box = tmi.render(port, spp=4, seed=3, rfilter="box").numpy()
    assert np.abs(got - box).max() > 1e-3  # the meta's filter ran
