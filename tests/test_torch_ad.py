"""The port's gradient path against the JAX package (CPU): `traverse` and
its update, SGD and Adam step by step, LargeSteps both ways, and on
cornell_box(12, 12) with the path tracer (depth 3, no roulette) the image
of `render_differentiable`, the gradients of `render_loss_grad` and the
forward-mode image of `render_forward`, each against the JAX package's on
the same seed. The JAX references are computed once per module."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mitsuba3_plt_tpu.ad import render as jrender
from mitsuba3_plt_tpu.ad import traverse as jtraverse
from mitsuba3_plt_tpu.ad.largesteps import LargeSteps as JLargeSteps
from mitsuba3_plt_tpu.ad.optimizers import SGD as JSGD, Adam as JAdam
from mitsuba3_plt_tpu.config import RGB as JRGB
from mitsuba3_plt_tpu.integrators.path import PathIntegrator as JPath
from mitsuba3_plt_tpu.scene.presets import cornell_box as jcornell_box
from mitsuba3_plt_tpu_torch import ad, ops
from mitsuba3_plt_tpu_torch.integrators.path import PathIntegrator
from mitsuba3_plt_tpu_torch.scene.presets import cornell_box, mesh_scene
from mitsuba3_plt_tpu_torch.scene.shape import make_sphere
from test_torch_golden_specular import one_torch_thread  # noqa: F401

W = H = 12
DEPTH, RR = 3, 8      # rr_depth past max_depth: no roulette
SPP = 8
KEYS = ("materials.base_color", "emitters.radiance")
# the keys both packages' traverse must give (the other scene tables the
# port holds are its own)
SHARED_KEYS = ("materials.base_color", "materials.grt_inv_period",
               "materials.grt_height", "materials.grt_multiplier",
               "materials.grt_coherence", "emitters.radiance",
               "geo.tri_p0", "geo.tri_p1", "geo.tri_p2")
TRI_KEYS = ["geo.tri_p0", "geo.tri_p1", "geo.tri_p2"]


@pytest.fixture(scope="module")
def scenes():
    jscene, _ = jcornell_box(W, H)
    return jscene, cornell_box(W, H, device="cpu")


@pytest.fixture(scope="module")
def jax_refs(scenes):
    """The JAX package's image, loss gradients and forward-mode images."""
    jscene, _ = scenes
    integ = JPath(max_depth=DEPTH, rr_depth=RR)
    img = jrender.render_differentiable(jscene, integ.sample, seed=0,
                                        spp=SPP, cfg=JRGB)
    loss, grads = jrender.render_loss_grad(
        jscene, integ.sample, jnp.mean, list(KEYS), seed=0, spp=SPP,
        cfg=JRGB)
    params = jtraverse(jscene)
    fwd = {}
    for k in KEYS:
        fwd[k] = jrender.render_forward(
            jscene, integ.sample, {k: jnp.ones_like(params[k])}, seed=3,
            spp=SPP, cfg=JRGB)
    return {"img": np.asarray(img), "loss": float(loss),
            "grads": {k: np.asarray(v) for k, v in grads.items()},
            "fwd": {k: tuple(np.asarray(x) for x in v)
                    for k, v in fwd.items()}}


def test_traverse_keys_match_jax(scenes):
    jscene, tscene = scenes
    jp, tp = jtraverse(jscene), ad.traverse(tscene)
    for k in SHARED_KEYS:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    # no static or derived field is a parameter
    assert not any(k.split(".")[-1] in ("present_types", "grt_static",
                                        "mf_static", "env_emitter", "wbvh")
                   for k in tp)
    assert all(isinstance(v, torch.Tensor) for v in tp.values())


def test_traverse_update_round_trip(scenes):
    _, scene = scenes
    params = ad.traverse(scene)
    bc = params["materials.base_color"]
    s2 = params.update({"materials.base_color": bc * 0.5})
    assert torch.equal(s2.materials.base_color, bc * 0.5)
    assert s2.geo is scene.geo and s2.emitters is scene.emitters
    assert s2.materials.alpha is scene.materials.alpha
    assert params.update() is scene
    rad = params["emitters.radiance"]
    s3 = params.update({"emitters.radiance": rad * 2.0})
    assert torch.equal(s3.emitters.radiance, rad * 2.0)
    assert s3.env_emitter == scene.env_emitter
    assert s3.materials is scene.materials


def test_update_keeps_the_wide_bvh():
    """A packet scene's WideBVH is built once: an update of materials or
    emitters keeps the scene's own, and renders the same."""
    scene = mesh_scene(8, 8, subdiv=5, accel="packet", device="cpu")
    params = ad.traverse(scene)
    s2 = params.update({"materials.base_color":
                        params["materials.base_color"] * 1.0})
    assert s2.wbvh is scene.wbvh and s2.pbvh is scene.pbvh
    assert s2.intersect_route() == "packet"
    # new packet tables give a WideBVH of their own
    s3 = params.update({"pbvh.nodes": params["pbvh.nodes"].clone()})
    assert s3.pbvh is not scene.pbvh and s3.wbvh is not scene.wbvh
    assert torch.equal(s3.wbvh.nodes, scene.wbvh.nodes)
    assert s3.wbvh.stack == scene.wbvh.stack


SGD_CASES = {
    "plain": dict(lr=0.1),
    "momentum": dict(lr=0.05, momentum=0.9),
    "lr_per_param": dict(lr=0.1, momentum=0.5, lr_per_param={"b": 0.01}),
}
ADAM_CASES = {
    "plain": dict(lr=0.02),
    "uniform": dict(lr=0.05, uniform=True),
    "lr_per_param": dict(lr=0.02, beta_1=0.8, lr_per_param={"b": 0.3}),
}


def _opt_inputs(seed=0):
    rng = np.random.default_rng(seed)
    params = {"a": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32),
              "c": rng.normal(size=(2,)).astype(np.float32)}
    # five steps of gradients; "c" never gets one
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items() if k != "c"} for _ in range(5)]
    masks = {"a": rng.uniform(size=(4, 3)) < 0.6}
    return params, grads, masks


def _run_both(jopt, topt, masked, tol):
    params, grads, masks = _opt_inputs()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    jm = {k: jnp.asarray(v) for k, v in masks.items()} if masked else None
    tm = {k: torch.as_tensor(v) for k, v in masks.items()} if masked else None
    for g in grads:
        jp, js = jopt.step(jp, {k: jnp.asarray(v) for k, v in g.items()},
                           js, jm)
        tp, ts = topt.step(tp, {k: torch.as_tensor(v) for k, v in g.items()},
                           ts, tm)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=tol, atol=tol)
    np.testing.assert_array_equal(tp["c"].numpy(), params["c"])
    if masked:
        off = ~masks["a"]
        np.testing.assert_array_equal(tp["a"].numpy()[off], params["a"][off])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", list(SGD_CASES))
def test_sgd_matches_jax(case, masked):
    # float32 rounding of the same expressions
    _run_both(JSGD(**SGD_CASES[case]), ad.SGD(**SGD_CASES[case]), masked,
              1e-6)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", list(ADAM_CASES))
def test_adam_matches_jax(case, masked):
    # the step is lr m_hat / (sqrt(v_hat) + eps), a ratio of two running
    # averages that the packages round apart (XLA fuses the update): a
    # few 1e-6 of a parameter after five steps of lr <= 0.3
    _run_both(JAdam(**ADAM_CASES[case]), ad.Adam(**ADAM_CASES[case]),
              masked, 1e-5)


@pytest.mark.parametrize("lambda_", [1.0, 19.0])
def test_largesteps_matches_jax(lambda_):
    mesh = make_sphere(2)
    v, f = mesh.vertices.astype(np.float32), mesh.faces
    jls = JLargeSteps.create(v, f, lambda_)
    tls = ad.LargeSteps.create(torch.as_tensor(v), f, lambda_)
    np.testing.assert_array_equal(tls.edges.numpy(), np.asarray(jls.edges))
    ju = np.asarray(jls.to_differential(v))
    tu = tls.to_differential(torch.as_tensor(v))
    # the same matvec; index_add_ and scatter-add sum in another order
    np.testing.assert_allclose(tu.numpy(), ju, rtol=1e-6, atol=1e-5)
    jv = np.asarray(jls.from_differential(ju))
    tv = tls.from_differential(tu)
    # both solve to tol 1e-6 of |u|; their iterates round apart
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), v, rtol=0, atol=1e-4)


def test_render_differentiable_matches_jax(scenes, jax_refs):
    _, scene = scenes
    integ = PathIntegrator(max_depth=DEPTH, rr_depth=RR)
    img = ad.render_differentiable(scene, integ.sample, seed=0, spp=SPP)
    # the same samples a pixel: float32 rounding of the same sums
    np.testing.assert_allclose(img.numpy(), jax_refs["img"], rtol=1e-5,
                               atol=1e-6)


def test_loss_grads_match_jax(scenes, jax_refs):
    _, scene = scenes
    integ = PathIntegrator(max_depth=DEPTH, rr_depth=RR)
    ops.reset_launch_counts()
    loss, grads = ad.render_loss_grad(scene, integ.sample, torch.mean,
                                      list(KEYS), seed=0, spp=SPP)
    assert not any(ops.launch_counts().values())  # plain on the CPU
    assert abs(float(loss) - jax_refs["loss"]) <= 1e-6 * jax_refs["loss"]
    for k in KEYS:
        want = jax_refs["grads"][k]
        assert np.abs(want).max() > 0
        # float32 rounding of the same chain rule, relative to the largest
        np.testing.assert_allclose(grads[k].numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_render_grad_is_loss_grad(scenes):
    """The adjoint render with the mean's image gradient is the mean's
    loss gradient."""
    _, scene = scenes
    integ = PathIntegrator(max_depth=2, rr_depth=RR)
    _, want = ad.render_loss_grad(scene, integ.sample, torch.mean,
                                  list(KEYS), seed=1, spp=4)
    g_img = torch.full((H, W, 3), 1.0 / (H * W * 3))
    got = ad.render_grad(scene, integ.sample, list(KEYS), g_img, seed=1,
                         spp=4)
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("key", KEYS)
def test_render_forward_matches_jax(scenes, jax_refs, key):
    _, scene = scenes
    integ = PathIntegrator(max_depth=DEPTH, rr_depth=RR)
    params = ad.traverse(scene)
    img, dimg = ad.render_forward(scene, integ.sample,
                                  {key: torch.ones_like(params[key])},
                                  seed=3, spp=SPP)
    jimg, jd = jax_refs["fwd"][key]
    np.testing.assert_allclose(img.numpy(), jimg, rtol=1e-5, atol=1e-6)
    assert np.abs(jd).max() > 1e-3
    np.testing.assert_allclose(dimg.numpy(), jd, rtol=1e-5,
                               atol=1e-6 * np.abs(jd).max())


def test_albedo_grad_matches_finite_difference(scenes):
    """The JAX package's tests/test_ad.py check on the port: the white
    wall's red albedo gradient against a central difference of the same
    estimator (same seed, same samples)."""
    _, scene = scenes
    integ = PathIntegrator(max_depth=DEPTH, rr_depth=RR)
    key = "materials.base_color"
    _, grads = ad.render_loss_grad(scene, integ.sample, torch.mean, [key],
                                   seed=0, spp=16)
    params = ad.traverse(scene)
    bc, eps = params[key], 1e-2

    def run(delta):
        p = bc.clone()
        p[0, 0] += delta
        img = ad.render_differentiable(params.update({key: p}),
                                       integ.sample, seed=0, spp=16)
        return float(img.double().mean())

    fd = (run(eps) - run(-eps)) / (2 * eps)
    g = float(grads[key][0, 0])
    assert abs(fd - g) < 0.05 * max(abs(fd), abs(g), 1e-3), (fd, g)


def test_adam_recovers_a_darker_wall(scenes):
    """Inverse rendering (tests/test_ad.py's smoke): from a target with the
    white wall's albedo halved, 8 Adam steps bring the loss below half the
    first."""
    _, scene = scenes
    integ = PathIntegrator(max_depth=2, rr_depth=RR)
    key = "materials.base_color"
    params = ad.traverse(scene)
    target_albedo = params[key].clone()
    target_albedo[0] *= 0.5
    target = ad.render_differentiable(params.update({key: target_albedo}),
                                      integ.sample, seed=0, spp=16)
    opt = ad.Adam(lr=0.1)
    p = {key: params[key]}
    state = opt.init(p)
    losses = []
    for _ in range(8):
        loss, grads = ad.render_loss_grad(
            params.update(p), integ.sample,
            lambda img: torch.mean((img - target) ** 2), [key], seed=0,
            spp=16)
        losses.append(float(loss))
        p, state = opt.step(p, grads, state)
    assert losses[-1] < 0.5 * losses[0], losses


@pytest.mark.parametrize("rows", [5, 300])
def test_take_rows_gradient_is_the_index_gradient(rows):
    """`take_rows` gives the table's rows, and the table the gradient that
    autograd's index gives it (one-hot product up to ONE_HOT_MAX_ROWS
    rows, index_add_ above; float32 sums in another order); forward mode and no_grad take
    plain indexing."""
    from mitsuba3_plt_tpu_torch.core.math import take_rows

    rng = np.random.default_rng(rows)
    table = torch.as_tensor(rng.normal(size=(rows, 3)).astype(np.float32))
    idx = torch.as_tensor(rng.integers(0, rows, (4000,)))
    g = torch.as_tensor(rng.normal(size=(4000, 3)).astype(np.float32))
    t1 = table.clone().requires_grad_(True)
    out = take_rows(t1, idx)
    assert out.grad_fn is not None and torch.equal(out, table[idx])
    out.backward(g)
    t2 = table.clone().requires_grad_(True)
    t2[idx].backward(g)
    np.testing.assert_allclose(t1.grad.numpy(), t2.grad.numpy(), rtol=1e-5,
                               atol=1e-5)
    with torch.no_grad():
        assert take_rows(t1, idx).grad_fn is None
    import torch.autograd.forward_ad as fwAD
    with fwAD.dual_level(), torch.no_grad():
        d = fwAD.make_dual(table, torch.ones_like(table))
        assert torch.equal(fwAD.unpack_dual(take_rows(d, idx)).tangent,
                           torch.ones((4000, 3)))


def test_take_rows_ab_ways_agree():
    """tools/take_rows_ab.py on the CPU at a tiny size: both ways of the
    table gradient give the same gradients (float32 sums in another
    order) in every cell and on the sweep's tables either side of
    ONE_HOT_MAX_ROWS."""
    from mitsuba3_plt_tpu_torch.core.math import ONE_HOT_MAX_ROWS
    from mitsuba3_plt_tpu_torch.tools import take_rows_ab as tr

    rows = tr.run(tr.cells(8, 6, 8, 8, depth=3, rr=9, spp=2, mesh_subdiv=2,
                           device="cpu"), evals=1)
    assert [r["cell"] for r in rows] == ["grad-grating", "grad-cbox-path",
                                         "grad-cbox-prb", "grad-mesh-attr"]
    for r in rows:
        assert r["grad_rel_diff"] < 1e-5 and r["calls"], r
        assert all(c["rel_diff"] < 1e-5 for c in r["calls"]), r
    # the mesh's shading rows lie above ONE_HOT_MAX_ROWS
    assert max(c["rows"] for c in rows[3]["calls"]) > ONE_HOT_MAX_ROWS
    sizes = (2, ONE_HOT_MAX_ROWS, ONE_HOT_MAX_ROWS + 1)
    out = tr.sweep(sizes, 3000, device="cpu")
    assert [(r["rows"], r["columns"]) for r in out] == [
        (n, c) for c in (1, 3) for n in sizes]
    assert all(r["rel_diff"] < 1e-5 for r in out), out


def test_geometry_boundary_raises(scenes):
    """Named for what it held before the boundary terms were ported (a
    NotImplementedError): `geometry_boundary=True` now returns the vertex
    rows' gradients with the boundary terms added (their interior term is
    zero, as in the JAX package: the render reads the tables, which are
    not rebuilt from the rows), and leaves the other keys' as they
    were."""
    _, scene = scenes
    integ = PathIntegrator(max_depth=2, rr_depth=RR)
    keys = list(KEYS) + TRI_KEYS
    _, plain = ad.render_loss_grad(scene, integ.sample, torch.mean, keys,
                                   spp=1)
    _, both = ad.render_loss_grad(scene, integ.sample, torch.mean, keys,
                                  spp=1, geometry_boundary=True,
                                  boundary_samples=1024)
    for k in KEYS:
        assert torch.equal(both[k], plain[k]), k
    for k in TRI_KEYS:
        assert plain[k].shape == (scene.geo.n_faces, 3)
        assert not plain[k].any() and torch.isfinite(both[k]).all(), k
    assert any(both[k].abs().max() > 0 for k in TRI_KEYS)
