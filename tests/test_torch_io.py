"""The port's refusals, mesh and image files, CLI and render controls
(CPU): every BSDF, emitter, shape and integrator the port lacks raises by
name (where the JAX package's XML parser takes an unknown BSDF for
diffuse, ROADMAP C2), an unknown BSDF name warns; `make_integrator` builds
JAX's integrators; PLY, OBJ and .serialized meshes and PFM, EXR and PNG
images against the JAX package's readers and writers; the CLI's outputs
against an in-process render; render's timeout and progress."""
import json
import os
import struct
import zlib

import numpy as np
import pytest

from mitsuba3_plt_tpu.integrators import make_integrator as j_make
from mitsuba3_plt_tpu.scene import shape as jshape
from mitsuba3_plt_tpu.utils import exr as jexr
from mitsuba3_plt_tpu.utils import io as jio
import mitsuba3_plt_tpu_torch as tmi
from mitsuba3_plt_tpu_torch import cli
from mitsuba3_plt_tpu_torch.integrators import make_integrator
from mitsuba3_plt_tpu_torch.scene import shape as tshape
from mitsuba3_plt_tpu_torch.scene import xml_scenes
from mitsuba3_plt_tpu_torch.utils import exr as texr
from mitsuba3_plt_tpu_torch.utils import io as tio
from test_torch_golden_specular import one_torch_thread  # noqa: F401
from test_torch_loader import write_ascii_ply_quads, write_obj, write_ply

SILENT_DIFFUSE = ("polarizer", "retarder", "circular", "roughdielectric",
                  "plastic", "roughplastic", "pplastic")
UNPORTED_EMITTERS = ("spot", "envmap", "projector", "directionalarea",
                     "directionalspot")
UNPORTED_INTEGRATORS = ("direct", "direct_projective", "depth", "aov",
                        "moment", "volpath", "volpathmis", "prbvolpath",
                        "ptracer")
# the keys of the JAX package's CLI's _params.json (its cli.py:113-133 and
# the stats of its render)
JAX_PARAMS_KEYS = {"scene", "variant", "integrator", "spp", "resolution",
                   "load_time_s", "render_time_s", "time_per_sample",
                   "passes_done", "n_pass", "compile_s", "total_s",
                   "steady_s_per_pass", "spp_done", "time_per_sample_steady"}


def xml_file(tmp_path, body, name="scene.xml"):
    path = tmp_path / name
    path.write_text(f'<scene version="3.0.0">\n{body}\n</scene>\n')
    return str(path)


def load(path, **kw):
    return tmi.load_file(path, device="cpu", **kw)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("btype", SILENT_DIFFUSE + ("thindielectric",
                                                    "principled", "null",
                                                    "blendbsdf"))
def test_unported_bsdf_raises_by_name(tmp_path, btype):
    shape = f'<shape type="rectangle"><bsdf type="{btype}"/></shape>'
    with pytest.raises(NotImplementedError, match=btype):
        load(xml_file(tmp_path, shape))
    twosided = (f'<bsdf type="twosided" id="a"><bsdf type="{btype}"/>'
                '</bsdf>')
    with pytest.raises(NotImplementedError, match=btype):
        load(xml_file(tmp_path, twosided, "twosided.xml"))
    with pytest.raises(NotImplementedError, match=btype):
        tmi.load_dict({"type": "scene", "r": {"type": "rectangle",
                                              "bsdf": {"type": btype}}},
                      device="cpu")


def test_unknown_bsdf_warns_and_takes_diffuse(tmp_path):
    path = xml_file(tmp_path, '<shape type="rectangle">'
                              '<bsdf type="velvetish"/></shape>')
    with pytest.warns(UserWarning, match="velvetish"):
        scene, _ = load(path)
    assert scene.materials.mtype.tolist() == [1]
    assert scene.materials.base_color.tolist() == [[0.5, 0.5, 0.5]]
    with pytest.warns(UserWarning, match="velvetish"):
        tmi.load_dict({"type": "scene", "r": {
            "type": "rectangle", "bsdf": {"type": "velvetish"}}},
            device="cpu")


def test_textures_raise(tmp_path):
    tex = ('<shape type="rectangle"><bsdf type="diffuse">'
           '<texture type="bitmap" name="reflectance">'
           '<string name="filename" value="a.png"/></texture>'
           '</bsdf></shape>')
    with pytest.raises(NotImplementedError, match="texture"):
        load(xml_file(tmp_path, tex))
    with pytest.raises(NotImplementedError, match="checkerboard"):
        tmi.load_dict({"type": "scene", "r": {"type": "rectangle", "bsdf": {
            "type": "diffuse", "reflectance": {"type": "checkerboard"}}}},
            device="cpu")


@pytest.mark.parametrize("etype", UNPORTED_EMITTERS)
def test_unported_emitter_raises_by_name(tmp_path, etype):
    with pytest.raises(NotImplementedError, match=etype):
        load(xml_file(tmp_path, f'<emitter type="{etype}"/>'))
    with pytest.raises(NotImplementedError, match=etype):
        tmi.load_dict({"type": "scene", "e": {"type": etype}}, device="cpu")


@pytest.mark.parametrize("body,name", [
    ('<shape type="sdfgrid"/>', "sdfgrid"),
    ('<shape type="bsplinecurve"/>', "bsplinecurve"),
    ('<shape type="linearcurve"/>', "linearcurve"),
    ('<shape type="heightfield"/>', "heightfield"),
    ('<medium type="homogeneous" id="m"/>', "media"),
    ('<shape type="rectangle"><ref name="interior" id="m"/></shape>',
     "media"),
    ('<shape type="merge"><shape type="ellipsoid"/></shape>', "ellipsoid"),
    ('<sensor type="perspective"><spectrum name="srf" value="1"/>'
     '</sensor>', "srf"),
    ('<sensor type="perspective"><film type="specfilm"/></sensor>',
     "specfilm"),
])
def test_unported_scene_parts_raise_by_name(tmp_path, body, name):
    with pytest.raises(NotImplementedError, match=name):
        load(xml_file(tmp_path, body))


def test_dict_refusals():
    for obj, name in (({"type": "sdfgrid"}, "sdfgrid"),
                      ({"type": "linearcurve"}, "linearcurve"),
                      ({"type": "homogeneous"}, "media"),
                      ({"type": "teapot"}, "teapot")):
        with pytest.raises(NotImplementedError, match=name):
            tmi.load_dict({"type": "scene", "x": obj}, device="cpu")
    with pytest.raises(ValueError, match="nowhere"):
        tmi.load_dict({"type": "scene", "r": {
            "type": "rectangle", "b": {"type": "ref", "id": "nowhere"}}},
            device="cpu")


@pytest.mark.parametrize("itype", UNPORTED_INTEGRATORS)
def test_unported_integrator_raises_by_name(tmp_path, itype):
    with pytest.raises(NotImplementedError, match=itype):
        make_integrator({"type": itype})
    scene = load(xml_file(tmp_path, f'<integrator type="{itype}"/>'
                          '<shape type="rectangle"/>'))
    with pytest.raises(NotImplementedError, match=itype):
        tmi.render(scene, spp=1)


@pytest.mark.parametrize("cfg", [
    {"type": "path"}, {"type": "mispath", "max_depth": 9, "rr_depth": 2},
    {"type": "plt", "max_depth": 4}, {"type": "plt", "rr_depth": 7},
    {"type": "prb", "max_depth": 3}, {"type": "prb_basic"},
    {"type": "prb_projective", "rr_depth": 1}, {"type": "stokes"},
    {"type": "stokes_fw", "nested": {"type": "path", "max_depth": 5,
                                     "rr_depth": 3}},
    {"type": "path", "max_depth": "$depth"},
])
def test_make_integrator_matches_jax(cfg):
    got, want = make_integrator(cfg), j_make(cfg)
    assert type(got).__name__ == type(want).__name__
    if cfg["type"].startswith("stokes"):
        assert got.forward_basis == want.forward_basis
        assert got.n_out_channels == want.n_out_channels
        got, want = got.inner, want.inner
        assert type(got).__name__ == type(want).__name__
    assert (got.max_depth, got.rr_depth) == (want.max_depth, want.rr_depth)


def test_make_integrator_unknown_warns_and_refuses_unbounded_depth():
    with pytest.warns(UserWarning, match="raytracer"):
        integ = make_integrator({"type": "raytracer", "max_depth": 3})
    assert type(integ).__name__ == "PathIntegrator" and integ.max_depth == 3
    with pytest.raises(ValueError, match="unbounded"):
        make_integrator({"type": "path", "max_depth": -1})


# ---------------------------------------------------------------------------
# image files
# ---------------------------------------------------------------------------

def _image(h=7, w=5, c=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w, c)) * 3).astype(np.float32)


@pytest.mark.parametrize("shape", [(7, 5, 3), (4, 6)])
def test_pfm_bytes_equal_jax(tmp_path, shape):
    img = np.random.default_rng(1).random(shape).astype(np.float32)
    tio.write_pfm(str(tmp_path / "a.pfm"), img)
    jio.write_pfm(str(tmp_path / "b.pfm"), img)
    assert (tmp_path / "a.pfm").read_bytes() == (
        tmp_path / "b.pfm").read_bytes()
    np.testing.assert_array_equal(tio.read_pfm(str(tmp_path / "b.pfm")), img)


@pytest.mark.parametrize("half,channels", [(True, 3), (False, 3),
                                           (True, 1), (False, 4)])
def test_zip_exr_reads_back_in_the_other_package(tmp_path, half, channels):
    img = _image(37, 11, channels)  # three 16-line blocks, one short
    names = None if channels != 3 else ["R", "G", "B"]
    texr.write_exr(str(tmp_path / "t.exr"), img, names, half=half)
    jexr.write_exr(str(tmp_path / "j.exr"), img, names, half=half)
    want = img.astype(np.float16).astype(np.float32) if half else img
    for reader in (texr.read_exr, jexr.read_exr):
        for f in ("t.exr", "j.exr"):
            chans, _ = reader(str(tmp_path / f))
            keys = names or (["Y"] if channels == 1 else list("RGBA"))
            got = np.stack([chans[k] for k in keys], -1)
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tio.read_bitmap(str(tmp_path / "j.exr")),
        jio.read_bitmap(str(tmp_path / "j.exr")))


def test_piz_exr_raises_by_name(tmp_path):
    path = str(tmp_path / "p.exr")
    texr.write_exr(path, _image())
    raw = bytearray(open(path, "rb").read())
    at = raw.index(b"compression\x00compression\x00") + 24 + 4
    raw[at] = texr.PIZ_COMPRESSION
    open(path, "wb").write(bytes(raw))
    with pytest.raises(NotImplementedError, match="PIZ"):
        texr.read_exr(path)


def test_png_decodes_to_jax_tonemap(tmp_path):
    from PIL import Image

    img = _image(9, 13)
    img[0, 0] = (-1.0, 0.001, 100.0)
    path = str(tmp_path / "a.png")
    tio.write_bitmap(path, img, exposure=0.7)
    got = np.asarray(Image.open(path))
    np.testing.assert_array_equal(got, jio.tonemap_srgb(img, 0.7))
    np.testing.assert_array_equal(tio.read_bitmap(path),
                                  jio.read_bitmap(path))
    gray = str(tmp_path / "g.png")
    tio.write_bitmap(gray, img[..., 0])
    np.testing.assert_array_equal(np.asarray(Image.open(gray)),
                                  np.repeat(jio.tonemap_srgb(
                                      img[..., 0])[..., None], 3, -1))


def test_npy_and_unknown_extension(tmp_path):
    img = _image()
    tio.write_bitmap(str(tmp_path / "a.npy"), img)
    np.testing.assert_array_equal(tio.read_bitmap(str(tmp_path / "a.npy")),
                                  img)
    np.testing.assert_array_equal(tio.srgb_to_linear(img[..., 0]),
                                  jio.srgb_to_linear(img[..., 0]))
    with pytest.raises(ValueError, match="unsupported"):
        tio.write_bitmap(str(tmp_path / "a.tga"), img)


@pytest.mark.parametrize("kind", ["ply", "ply_ascii", "obj", "serialized"])
def test_mesh_files_equal_jax_host_mesh(tmp_path, kind):
    """Each reader's HostMesh equals JAX's, field for field, to the bit;
    .serialized round-trips through the port's writer."""
    mesh = tshape.make_sphere(2)
    mesh.uvs = (mesh.vertices[:, 1:] * 0.25).astype(np.float32)
    path = tmp_path / f"m.{kind}"
    if kind == "ply":
        write_ply(path, mesh)
    elif kind == "ply_ascii":
        write_ascii_ply_quads(path)
    elif kind == "obj":
        write_obj(path, mesh)
    else:
        tshape.save_serialized(str(path), mesh)
    reader = "load_ply" if kind.startswith("ply") else "load_" + kind
    got = getattr(tshape, reader)(str(path))
    want = getattr(jshape, reader)(str(path))
    for field in ("vertices", "faces", "normals", "uvs", "colors"):
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None) == (b is None), field
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=field)
            assert a.dtype == b.dtype, field
    assert got.face_normals == want.face_normals
    if kind == "serialized":
        for field in ("vertices", "faces", "normals", "uvs"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(mesh, field))
    if kind == "ply_ascii":
        assert got.faces.tolist() == [[0, 1, 2], [0, 2, 3], [1, 4, 5],
                                      [1, 5, 2]]
        assert got.colors.max() == 1.0


def test_serialized_version_4_and_shape_index(tmp_path):
    """A two-mesh version-4 file (each mesh named, the offset table of
    64-bit offsets): mesh 1 read by shape_index equals the mesh written,
    in both packages."""
    meshes = [tshape.make_sphere(1), tshape.make_sphere(2)]
    raw = struct.pack("<hh", 0x041C, 4)
    offsets = []
    for k, m in enumerate(meshes):
        body = struct.pack("<I", 0x1000 | 0x0001)
        body += f"mesh{k}".encode() + b"\x00"
        body += struct.pack("<QQ", len(m.vertices), len(m.faces))
        body += m.vertices.tobytes() + m.normals.tobytes()
        body += m.faces.astype(np.uint32).tobytes()
        offsets.append(len(raw) if k else 0)  # mesh k's copy of the header
        raw += (struct.pack("<hh", 0x041C, 4) if k else b"") + zlib.compress(
            body)
    raw += b"".join(struct.pack("<Q", o) for o in offsets)
    raw += struct.pack("<I", len(meshes))
    path = tmp_path / "two.serialized"
    path.write_bytes(raw)
    for index, m in enumerate(meshes):
        got = tshape.load_serialized(str(path), index)
        want = jshape.load_serialized(str(path), index)
        np.testing.assert_array_equal(got.vertices, m.vertices)
        np.testing.assert_array_equal(got.faces, want.faces)
        np.testing.assert_array_equal(got.normals, want.normals)
    with pytest.raises(ValueError, match="shape_index"):
        tshape.load_serialized(str(path), 2)


# ---------------------------------------------------------------------------
# the CLI and the render's controls
# ---------------------------------------------------------------------------

def test_cli_writes_the_in_process_render(tmp_path):
    scene = tmp_path / "box.xml"
    scene.write_text(xml_scenes.cornell_box_xml(64, 64, spp=2, max_depth=3,
                                                rr_depth=9))
    out = str(tmp_path / "out" / "box")
    cli.main([str(scene), "-o", out, "--spp", "4", "--resx", "16",
              "--resy", "16", "--device", "cpu", "--quiet", "--seed", "2",
              "-D", "unused=1"])
    img = tmi.render(tmi.load_file(str(scene), device="cpu", resx=16,
                                   resy=16), spp=4, seed=2).numpy()
    np.testing.assert_array_equal(tio.read_pfm(out + ".pfm"), img)
    assert os.path.exists(out + ".png")
    params = json.load(open(out + "_params.json"))
    assert JAX_PARAMS_KEYS <= set(params)
    assert params["resolution"] == [16, 16] and params["spp"] == 4
    assert params["integrator"] == {"type": "path", "max_depth": 3,
                                    "rr_depth": 9}


def test_cli_stokes_writes_the_four_stokes_images(tmp_path):
    scene = tmp_path / "box.xml"
    scene.write_text(xml_scenes.cornell_box_xml(8, 8, spp=1))
    out = str(tmp_path / "s")
    cli.main([str(scene), "-o", out, "--integrator", "stokes",
              "--max-depth", "2", "--device", "cpu", "--quiet"])
    for name in ("S0", "S1", "S2", "S3"):
        assert tio.read_pfm(f"{out}_{name}.pfm").shape == (8, 8, 3)
    params = json.load(open(out + "_params.json"))
    assert params["integrator"]["type"] == "stokes"
    assert params["spp"] == 1


def test_render_timeout_and_progress(tmp_path):
    """timeout=0 stops after the first pass and develops it: the image of
    that pass alone; progress is called after each pass."""
    scene = tmi.load_file(xml_scenes_path(tmp_path), device="cpu")
    calls, stats = [], {}
    img = tmi.render(scene, spp=8, spp_per_pass=2, timeout=0,
                     progress=lambda *a: calls.append(a), stats=stats)
    assert [c[:2] for c in calls] == [(1, 4)]
    assert stats["passes_done"] == 1 and stats["spp_done"] == 2
    first = tmi.render(scene, spp=2, spp_per_pass=2)
    assert np.array_equal(img.numpy(), first.numpy())
    calls, stats = [], {}
    tmi.render(scene, spp=8, spp_per_pass=2,
               progress=lambda *a: calls.append(a), stats=stats)
    assert [c[:2] for c in calls] == [(k, 4) for k in range(1, 5)]
    assert stats["passes_done"] == 4 and stats["spp_done"] == 8
    assert stats["steady_s_per_pass"] > 0


def xml_scenes_path(tmp_path):
    path = tmp_path / "small.xml"
    path.write_text(xml_scenes.cornell_box_xml(8, 8, spp=2, max_depth=2))
    return str(path)


def test_variants():
    assert tmi.variant() == "rgb" and tmi.config() == tmi.RGB
    tmi.set_variant("rgb_polarized")
    try:
        assert tmi.config() == tmi.RGB_POLARIZED
    finally:
        tmi.set_variant("rgb")
    with pytest.raises(NotImplementedError, match="spectral"):
        tmi.set_variant("spectral")
    assert tmi.variant() == "rgb"
