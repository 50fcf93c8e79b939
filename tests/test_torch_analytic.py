"""Analytic spheres, disks and cylinders and the sphere light in the port,
against the JAX package (CPU):

- `assemble_scene`: the port's arrays equal JAX's, leaf for leaf, on the
  scenes of `tests/test_sphere.py` and on the analytic scene of
  `chip_smoke.py`'s main-analytic path;
- `ray_intersect` (t, prim, normals, uv, material, emitter and shape) and
  `ray_test` on seeded rays through the bridged scenes of
  `tests/test_sphere.py` and `tests/test_analytic_prims.py` and the
  analytic scene: rays from outside, rays aimed at each primitive, and
  rays leaving the sphere's surface (no self-hit at JAX's eps of 1e-4);
- the sphere light's sample and pdf, from inside and outside the sphere;
- path radiance per lane (the path tracer and PLT on
  `sphere_scene(analytic=True, emitter=True)`, the path tracer on the
  analytic scene through its thinlens camera and multijitter sampler).
  A differing lane must be one `test_torch_cbox_specular._explain` names:
  a tie, where the JAX package, replaying the port's own ray, hits another
  primitive at the same t (the cylinder's rim and the disk's lowest point
  rest on the floor)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mitsuba3_plt_tpu.config import RGB as JRGB
from mitsuba3_plt_tpu.core.rng import Sampler as JSampler
from mitsuba3_plt_tpu.integrators.common import sample_rays as j_sample_rays
from mitsuba3_plt_tpu.integrators.path import PathIntegrator as JPath
from mitsuba3_plt_tpu.integrators.plt import PLTIntegrator as JPLT
from mitsuba3_plt_tpu.librender.records import Ray as JRay
from mitsuba3_plt_tpu.librender.records import DirectionSample as JDS
from mitsuba3_plt_tpu.librender.sensor import Sensor as JSensor
from mitsuba3_plt_tpu.scene import emitters as jem
from mitsuba3_plt_tpu.scene import loader as jloader
from mitsuba3_plt_tpu.scene import shape as jshape
from mitsuba3_plt_tpu_torch.core.rng import Sampler
from mitsuba3_plt_tpu_torch.integrators.common import sample_rays
from mitsuba3_plt_tpu_torch.integrators.path import PathIntegrator
from mitsuba3_plt_tpu_torch.integrators.plt import PLTIntegrator
from mitsuba3_plt_tpu_torch.librender.records import DirectionSample, Ray
from mitsuba3_plt_tpu_torch.librender.sensor import Sensor
from mitsuba3_plt_tpu_torch.scene import emitters as tem
from mitsuba3_plt_tpu_torch.scene import loader as tloader
from mitsuba3_plt_tpu_torch.scene import presets as tpresets
from mitsuba3_plt_tpu_torch.scene import shape as tshape
from mitsuba3_plt_tpu_torch.scene.bridge import scene_from_arrays
from test_analytic_prims import _scene as jax_prim_scene
from test_sphere import sphere_scene
from test_torch_cbox_specular import _explain, recorded
from test_torch_golden_specular import one_torch_thread  # noqa: F401
from test_torch_scene import _tensors, jax_scene_arrays

MAX_TIES = 1e-3
# within rounding of a sphere light's centre plane: 8 ulps of the scene's
# largest coordinate (4, the camera's z)
FRAME_ROUNDING = 8 * 2.0 ** -21
MAX_FRAME_BRANCH = 2e-2


def jax_analytic_scene(width, height):
    """The JAX package's assembly of `presets.analytic_scene_parts`."""
    parts = tpresets.analytic_scene_parts(width, height)
    cam = parts["camera"]
    sensor = JSensor.thinlens(cam["to_world"], cam["fov"], width, height,
                              cam["aperture_radius"], cam["focus_distance"])
    return jloader.assemble_scene(
        [jshape.make_rectangle().transformed(parts["floor"])], [0], [-1],
        [jloader.LoadedBSDF(t, **p) for t, p in parts["bsdfs"]],
        parts["emitters"], sensor,
        {"type": "path", "max_depth": 7, "rr_depth": 50}, 8, rfilter="box",
        spheres=parts["spheres"], disks=parts["disks"],
        cylinders=parts["cylinders"], sampler="multijitter")


def _bridged(jscene):
    return scene_from_arrays(*jax_scene_arrays(jscene), device="cpu")


def _port_sphere_scene(emitter):
    """`tests/test_sphere.py::sphere_scene(analytic=True, emitter)` through
    the port's own assembly."""
    from mitsuba3_plt_tpu_torch.core import transform as tf

    floor = tshape.HostMesh(*tshape.make_rectangle(
        (tf.translate([0, 0, 0]) @ tf.rotate([1, 0, 0], -90)
         @ tf.scale([4, 4, 1])).astype(np.float32)))
    center, radius = np.array([0.0, 1.0, 0.0], np.float32), 0.4
    emitters = ([{"type": "sphere_area", "center": center, "radius": radius,
                  "radiance": (8.0, 8.0, 8.0)}] if emitter else [])
    spheres = [{"center": center, "radius": radius, "mat": 0,
                "emitter": 0 if emitter else -1, "shape": 10000}]
    sensor = Sensor.perspective(
        tf.look_at([0, 1.0, 4.0], [0, 1.0, 0], [0, 1, 0]), 40.0, 24, 24,
        device="cpu")
    return tloader.assemble_scene(
        [floor], [0], [-1], [tloader.default_bsdf()], emitters, sensor,
        {"type": "path", "max_depth": 3}, 16, rfilter="box",
        spheres=spheres, device="cpu")


def _assert_same_tables(port, jscene):
    a, b = _tensors(port), _tensors(_bridged(jscene))
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], torch.Tensor):
            np.testing.assert_array_equal(a[key].numpy(), b[key].numpy(),
                                          err_msg=key)
            assert a[key].dtype == b[key].dtype, key
        else:
            assert a[key] == b[key], key


@pytest.mark.parametrize("emitter", [False, True])
def test_assemble_scene_equals_jax_sphere_scene(emitter):
    jscene, jmeta = sphere_scene(analytic=True, emitter=emitter)
    port, meta = _port_sphere_scene(emitter)
    _assert_same_tables(port, jscene)
    assert meta == jmeta
    assert port.geo.n_spheres == 1 and port.geo.n_analytic == 1
    if emitter:
        em = port.emitters
        assert em.present_types == (tem.EMITTER_SPHERE,)
        assert float(em.cutoff_cos[0]) == pytest.approx(0.4)
        assert float(em.area[0]) == pytest.approx(4 * np.pi * 0.16)


@pytest.mark.parametrize("thinlens", [True, False])
def test_assemble_scene_equals_jax_analytic_scene(thinlens):
    """Leaf for leaf, through its thinlens camera and with the
    perspective camera of the same pose swapped in on both sides."""
    jscene, jmeta = jax_analytic_scene(16, 12)
    port, meta = tpresets.analytic_scene(16, 12, device="cpu")
    if not thinlens:
        cam = tpresets.analytic_scene_parts(16, 12)["camera"]
        pose = (cam["to_world"], cam["fov"], 16, 12)
        jscene = dataclasses.replace(jscene,
                                     sensor=JSensor.perspective(*pose))
        port = dataclasses.replace(port, sensor=Sensor.perspective(
            *pose, device="cpu"))
    _assert_same_tables(port, jscene)
    assert meta == jmeta
    g = port.geo
    assert (g.n_faces, g.n_spheres, g.n_disks, g.n_cylinders) == (2, 1, 1, 1)


def test_assemble_scene_defaults_and_refusals():
    """No mesh: JAX's degenerate rectangle; no emitter: one black constant
    one; no BSDF: the default diffuse; an unported BSDF type, BSDF
    parameter or emitter type raises."""
    sph = [{"center": (0.0, 0.0, 0.0), "radius": 1.0}]
    jscene, _ = jloader.assemble_scene([], [], [], [], [], None, {}, 4,
                                       spheres=sph)
    port, meta = tloader.assemble_scene([], [], [], [], [], None, {}, 4,
                                        spheres=sph, device="cpu")
    _assert_same_tables(port, jscene)
    assert meta["rfilter"] == "gaussian" and meta["sampler"] == "independent"
    with pytest.raises(NotImplementedError, match="BSDF type"):
        tloader.assemble_scene([], [], [], [tloader.LoadedBSDF(8)], [], None,
                               {}, 4, spheres=sph, device="cpu")
    with pytest.raises(NotImplementedError, match="texture"):
        tloader.assemble_scene(
            [], [], [], [tloader.LoadedBSDF(1, texture="a.png")], [], None,
            {}, 4, spheres=sph, device="cpu")
    with pytest.raises(NotImplementedError, match="spot"):
        tloader.assemble_scene([], [], [], [], [{"type": "spot"}], None, {},
                               4, spheres=sph, device="cpu")
    with pytest.raises(RuntimeError if not torch.cuda.is_available()
                       else NotImplementedError):
        tloader.assemble_scene([], [], [], [tloader.LoadedBSDF(8)], [], None,
                               {}, 4, spheres=sph)


def _rays(rng, n, lo, hi, targets):
    """n rays: a third from random points of the box [lo, hi] in random
    directions, two thirds aimed from there at the target points (jittered
    by 0.05)."""
    o = rng.uniform(lo, hi, (n, 3))
    d = rng.normal(size=(n, 3))
    k = 2 * n // 3
    tgt = targets[rng.integers(0, len(targets), k)] + rng.normal(
        scale=0.05, size=(k, 3))
    d[:k] = tgt - o[:k]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    maxt = np.where(rng.random(n) < 0.2, rng.uniform(0.5, 5.0, n), np.inf)
    return o.astype(np.float32), d.astype(np.float32), maxt.astype(
        np.float32)


def _leaving_sphere(rng, n, c, r):
    """Rays from the sphere's surface, offset along the normal as the
    integrators offset bounce origins, into the outer hemisphere."""
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    o = c + nrm * r * (1 + 1e-5)
    d = rng.normal(size=(n, 3))
    d = np.where((d * nrm).sum(-1, keepdims=True) < 0, -d, d)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (o.astype(np.float32), d.astype(np.float32),
            np.full(n, np.inf, np.float32))


def _scenes():
    out = {"sphere": sphere_scene(analytic=True, emitter=True)[0],
           "analytic": jax_analytic_scene(8, 8)[0]}
    out["disk"] = jax_prim_scene({
        "type": "disk", "bsdf": {"type": "diffuse", "reflectance": 0.8}})
    out["cylinder"] = jax_prim_scene({
        "type": "cylinder", "radius": 0.5, "p0": [0, -1, 0],
        "p1": [0, 1, 0], "bsdf": {"type": "diffuse", "reflectance": 0.8}})
    return out


TARGETS = {
    "sphere": [[0, 1, 0], [0, 1.4, 0], [0.4, 1, 0], [0, 0, 0.5]],
    "analytic": [[0, 1, 0], [-0.95, 0.4, 0.25], [-0.95, 0.0, 0.25],
                 [0.95, 0.4, 0], [0.95, 0.0, 0.3], [0.6, 0.01, 0]],
    "disk": [[0, 0, 0], [0.9, 0, 0], [0, -1, 0]],
    "cylinder": [[0, 0, 0], [0.5, 0, 0], [0, 1, 0.5], [0, -1, 0]],
}


@pytest.mark.parametrize("name", list(TARGETS))
def test_ray_intersect_and_ray_test_match_jax(name):
    jscene = _scenes()[name]
    port = _bridged(jscene)
    g = port.geo
    assert g.n_analytic == (g.n_spheres + g.n_disks + g.n_cylinders) > 0
    rng = np.random.default_rng(len(name))
    sets = [_rays(rng, 4096, [-3, -0.5, -3], [3, 3, 4],
                  np.asarray(TARGETS[name], np.float64))]
    if g.n_spheres:
        c = port.geo.sph_center[0].numpy().astype(np.float64)
        sets.append(_leaving_sphere(rng, 2048, c,
                                    float(port.geo.sph_radius[0])))
    for k, (o, d, maxt) in enumerate(sets):
        jsi = jscene.ray_intersect(JRay(o=jnp.asarray(o), d=jnp.asarray(d),
                                        maxt=jnp.asarray(maxt)))
        tsi = port.ray_intersect(Ray(o=torch.as_tensor(o),
                                     d=torch.as_tensor(d),
                                     maxt=torch.as_tensor(maxt)))
        prim = tsi.prim_idx.numpy()
        jprim = np.asarray(jsi.prim_idx)
        np.testing.assert_array_equal(prim, jprim, err_msg=f"set {k}")
        hit = prim >= 0
        if k == 0:  # the aimed rays meet the primitives
            assert (prim >= g.n_faces).mean() > 0.2
        np.testing.assert_allclose(tsi.t.numpy()[hit],
                                   np.asarray(jsi.t)[hit], rtol=1e-5)
        for f in ("p", "n", "sh_n", "sh_s", "uv", "wi"):
            np.testing.assert_allclose(
                getattr(tsi, f).numpy()[hit], np.asarray(getattr(jsi, f))[
                    hit], rtol=1e-5, atol=2e-5, err_msg=f)
        for f in ("mat_idx", "emitter_idx", "shape_idx", "valid"):
            np.testing.assert_array_equal(
                getattr(tsi, f).numpy(), np.asarray(getattr(jsi, f)),
                err_msg=f)
        if k == 1:  # leaving the sphere: never the sphere again
            assert not (prim == g.n_faces).any()
        jocc = np.asarray(jscene.ray_test(JRay(
            o=jnp.asarray(o), d=jnp.asarray(d), maxt=jnp.asarray(maxt))))
        tocc = port.ray_test(Ray(o=torch.as_tensor(o), d=torch.as_tensor(d),
                                 maxt=torch.as_tensor(maxt))).numpy()
        np.testing.assert_array_equal(tocc, jocc)
        assert tocc.any() and not tocc.all()


def _frame_branch(tscene, lanes, hits):
    """{lane: "frame branch"} for the lanes given whose path meets a
    surface within FRAME_ROUNDING of a sphere light's centre plane z = c_z
    (the port's hit point o + d t): from there the direction to the centre
    has a z within rounding of 0, and the light's cone frame
    (`coordinate_system`, whose branch is the sign of that z) may take
    either branch, in either package: another, equally valid, sample."""
    em = tscene.emitters
    cz = em.position[em.etype == tem.EMITTER_SPHERE][:, 2]
    if not len(lanes) or not len(cz):
        return {}
    idx = torch.as_tensor(lanes)
    near = torch.zeros(len(lanes), dtype=torch.bool)
    for o, d, maxt, prim, t in hits:
        pz = o[idx, 2] + d[idx, 2] * t[idx]
        near |= (prim[idx] >= 0) & (
            (pz[:, None] - cz[None]).abs() <= FRAME_ROUNDING).any(-1)
    return {int(lane): "frame branch"
            for lane, k in zip(lanes, near.tolist()) if k}


def test_sphere_light_sample_and_pdf_match_jax():
    """Reference points outside the sphere (cone sampling) and inside it
    (area sampling), none within 1e-3 of its surface, where the two
    branches meet: the sample's p, d and dist at rtol 1e-5 / atol 2e-5,
    n at 1e-4, pdf at rtol 1e-4 (grazing samples below), and
    pdf_emitter_direction of those
    samples (JAX's and the port's) from the same points."""
    jscene, _ = sphere_scene(analytic=True, emitter=True)
    port = _bridged(jscene)
    rng = np.random.default_rng(7)
    n = 8192
    c, r = np.array([0.0, 1.0, 0.0]), 0.4
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rad = np.where(np.arange(n) % 4 == 0, rng.uniform(0.0, r - 1e-3, n),
                   rng.uniform(r + 1e-3, 6.0, n))
    ref_p = (c + dirs * rad[:, None]).astype(np.float32)
    u1 = rng.random(n).astype(np.float32)
    u2 = rng.random((n, 2)).astype(np.float32)
    jds = jem.sample_emitter_direction(
        jscene.emitters, jscene.geo, jnp.asarray(ref_p), jnp.asarray(u1),
        jnp.asarray(u2), jnp.ones((n,), bool))
    tds = tem.sample_emitter_direction(
        port.emitters, port.geo, torch.as_tensor(ref_p), torch.as_tensor(u1),
        torch.as_tensor(u2), torch.ones((n,), dtype=torch.bool))
    # grazing cone samples: the near hit's distance, dc cos_t - sqrt(r^2 -
    # dc^2 sin_t^2), cancels as the square root's argument nears 0, where
    # a rounding of cos_t moves p and n by up to 1e-3: the samples within
    # 2% of r^2 of that (u1 above ~0.98; in float64 from the port's own
    # direction)
    d64 = tds.d.numpy().astype(np.float64)
    to_c = c - ref_p.astype(np.float64)
    dc = np.linalg.norm(to_c, axis=-1)
    cos_t = (d64 * to_c).sum(-1) / dc
    graze = (rad > r) & (r * r - dc * dc * (1 - cos_t * cos_t) < 0.02 * r * r)
    assert graze.mean() < 0.03
    for f in ("p", "n", "d", "dist", "pdf"):
        got, want = getattr(tds, f).numpy(), np.asarray(getattr(jds, f))
        # n is (p - c) / r: p's 2e-5 over r = 0.4; the cone's pdf,
        # 1 / (2 pi (1 - cos_max)), cancels in 1 - cos_max ~ sin^2 / 2 (a
        # float32 rounding of cos_max is 6e-8 / 2e-3 of it 5 units away)
        np.testing.assert_allclose(got[~graze], want[~graze],
                                   rtol=1e-4 if f == "pdf" else 1e-5,
                                   atol=1e-4 if f == "n" else 2e-5,
                                   err_msg=f)
        np.testing.assert_allclose(got[graze], want[graze], rtol=1e-5,
                                   atol=1e-3, err_msg=f)
    np.testing.assert_array_equal(tds.emitter_idx.numpy(),
                                  np.asarray(jds.emitter_idx))
    inside = rad < r
    assert inside.any() and (~inside).any()
    ds_t = DirectionSample(**{f.name: torch.as_tensor(np.array(
        getattr(jds, f.name))) for f in dataclasses.fields(JDS)})
    ds_t = dataclasses.replace(ds_t, emitter_idx=ds_t.emitter_idx.long())
    want = np.asarray(jem.pdf_emitter_direction(
        jscene.emitters, jscene.geo, jnp.asarray(ref_p), jds))
    got = tem.pdf_emitter_direction(port.emitters, port.geo,
                                    torch.as_tensor(ref_p), ds_t).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    # the density of a sample is the pdf it was drawn with
    np.testing.assert_allclose(got, tds.pdf.numpy(), rtol=1e-4)


def _lanes(jscene, tscene, jinteg, tinteg, W, H, spp, monkeypatch,
           sampler_type="independent"):
    """Per-lane radiance, port against JAX at rtol 1e-3 / atol 1e-5, but
    for the ties `_explain` names, at most MAX_TIES of the lanes."""
    n = W * H * spp
    js = JSampler.create(0, n).fork(0)
    jray, _, _, _ = j_sample_rays(jscene, js, W, H, spp, JRGB,
                                  sampler_type=sampler_type)
    want = np.asarray(jax.jit(
        lambda s, r: jinteg.sample(jscene, s, r, None, JRGB)[0])(js, jray))

    def run():
        ts = Sampler.create(0, n, device="cpu").fork(0)
        tray, _ = sample_rays(tscene, ts, W, H, spp,
                              sampler_type=sampler_type)
        return tinteg.sample(tscene, ts, tray)

    (got, valid), hits, lobes = recorded(run, monkeypatch)
    got = got.numpy()
    close = np.isclose(got, want, rtol=1e-3, atol=1e-5).all(-1)
    bad = np.where(~close)[0]
    why = {**_frame_branch(tscene, bad, hits), **_explain(jscene, bad, hits,
                                                          lobes)}
    print(f"per-lane agreement {close.mean():.6f}; differing {len(bad)}: "
          f"{why}")
    assert set(why) == set(bad.tolist()), sorted(set(bad) - set(why))
    reasons = list(why.values())
    assert set(reasons) <= {"tie", "frame branch"}
    assert reasons.count("tie") <= MAX_TIES * n
    assert reasons.count("frame branch") <= MAX_FRAME_BRANCH * n
    return got, want


@pytest.mark.parametrize("kind,max_depth,rr_depth",
                         [("path", 4, 9), ("path", 5, 2), ("plt", 4, 9)])
def test_sphere_scene_radiance_per_lane_matches_jax(kind, max_depth,
                                                    rr_depth, monkeypatch):
    jscene, _ = sphere_scene(analytic=True, emitter=True)
    tscene = _bridged(jscene)
    J, T = (JPath, PathIntegrator) if kind == "path" else (JPLT,
                                                           PLTIntegrator)
    got, want = _lanes(jscene, tscene, J(max_depth=max_depth,
                                         rr_depth=rr_depth),
                       T(max_depth=max_depth, rr_depth=rr_depth), 24, 24, 4,
                       monkeypatch)
    assert (want > 1.0).any(-1).mean() > 0.03  # the sphere light is seen
    assert ((want > 0) & (want < 1.0)).any(-1).mean() > 0.2  # and lights


def test_analytic_scene_radiance_per_lane_matches_jax(monkeypatch):
    """The analytic scene through the thinlens camera and the multijitter
    sampler, the disk and the rough-conductor cylinder lit by the sphere
    light."""
    W = H = 16
    jscene, _ = jax_analytic_scene(W, H)
    tscene, _ = tpresets.analytic_scene(W, H, device="cpu")
    got, want = _lanes(jscene, tscene, JPath(max_depth=4, rr_depth=9),
                       PathIntegrator(max_depth=4, rr_depth=9), W, H, 4,
                       monkeypatch, sampler_type="multijitter")
    assert (want > 1.0).any(-1).mean() > 0.02


@pytest.mark.parametrize("accel", ["clu2", "packet"])
def test_analytic_hits_merge_on_the_big_mesh_routes(accel):
    """A sphere added to the 20,480-face mesh scene (the clu2 and the packet
    route): each lane keeps the mesh's hit where it is nearer and takes the
    sphere's where the sphere is, as the triangles-only scene and the
    sphere's own hit say; ray_test ORs the sphere in."""
    arrays, static = tpresets.mesh_scene_arrays(8, 8, 5, accel=accel)
    sph = {"geo.sph_center": np.array([[0.0, 0.0, 1.5]], np.float32),
           "geo.sph_radius": np.array([0.4], np.float32),
           "geo.sph_attr": np.array([[0, -1, 7]], np.float32)}
    mesh = scene_from_arrays(arrays, static, device="cpu")
    both = scene_from_arrays({**arrays, **sph}, static, device="cpu")
    assert both.intersect_route() == accel
    rng = np.random.default_rng(3)
    o, d, maxt = _rays(rng, 1024, [-2, -2, 2.5], [2, 2, 4],
                       np.array([[0, 0, 1.5], [0, 0, 1.0], [0.5, 0, 0]]))
    ray = Ray(o=torch.as_tensor(o), d=torch.as_tensor(d),
              maxt=torch.as_tensor(maxt))
    a, b = mesh.ray_intersect(ray), both.ray_intersect(ray)
    t_s, i_s = both._sphere_intersect(ray)
    nf = both.geo.n_faces
    takes = (i_s >= 0) & (t_s < a.t)
    assert takes.any() and (~takes & a.valid).any()
    assert torch.equal(b.prim_idx, torch.where(takes, nf, a.prim_idx))
    assert torch.equal(b.t, torch.where(takes, t_s, a.t))
    assert a.shape_idx is None  # no analytic primitive, no shape column
    a_shape = mesh.geo.tri_attr[torch.clamp_min(a.prim_idx, 0).long(), 20]
    a_shape = torch.where(a.valid, a_shape.long(), -1)
    assert torch.equal(b.shape_idx, torch.where(takes, 7, a_shape))
    assert torch.equal(both.ray_test(ray), mesh.ray_test(ray) | (i_s >= 0))
