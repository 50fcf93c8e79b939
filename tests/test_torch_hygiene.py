"""Package rules of the PyTorch/CUDA port: it imports neither JAX nor the
JAX package, and its entry points do not fall back to the CPU."""
import ast
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "mitsuba3_plt_tpu_torch")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module or "")
    return mods


def test_port_imports_no_jax_and_no_jax_package():
    files = _port_files()
    assert len(files) > 20
    # the scene loaders, the package's render, the CLI and the image files
    for name in ("scene/loader.py", "scene/dict_loader.py",
                 "scene/xml_scenes.py", "scene/shape.py",
                 "integrators/__init__.py", "__init__.py", "cli.py",
                 "utils/io.py", "utils/exr.py", "ad/projective.py",
                 "ad/render.py", "core/device.py"):
        assert os.path.join(PORT, name) in files, name
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            root = mod.split(".")[0]
            if root in ("jax", "jaxlib", "mitsuba3_plt_tpu"):
                bad.append((os.path.relpath(path, REPO), mod))
    assert not bad, bad


def test_kernel_sources_and_data_are_in_the_package():
    csrc = os.path.join(PORT, "ops", "csrc")
    files = sorted(os.listdir(csrc))
    from mitsuba3_plt_tpu_torch.ops import build

    # every .cu file is built, and the headers are the launch's grid and
    # the q row test
    assert sorted(build.SOURCES) == [f for f in files if f.endswith(".cu")]
    assert [f for f in files if not f.endswith(".cu")] == ["launch.cuh",
                                                          "q_row.cuh"]
    assert {"plt_intersect_bvh", "plt_occluded_bvh", "plt_intersect_classic",
            "plt_occluded_classic", "plt_intersect_mxu", "plt_intersect_clu",
            "plt_occluded_clu", "plt_intersect_q_variant",
            "plt_occluded_q_variant", "plt_intersect_q_macc",
            "plt_fma_roof"} <= set(build.SIGNATURES)
    assert os.path.exists(os.path.join(PORT, "core", "data_cie1931.npz"))


def test_q_row_test_is_shared_by_b1_and_the_sweep():
    """intersect_q.cu (B1, B2) and intersect_sweep.cu (B11a, B11b, B11c)
    run the one row test of q_row.cuh and its launch (the table's stage,
    and the grid of launch.cuh, which intersect_mxu.cu's B9 takes too),
    which none of them defines itself."""
    csrc = os.path.join(PORT, "ops", "csrc")
    header = open(os.path.join(csrc, "q_row.cuh")).read()
    for name in ("q_terms(", "void stage(", '#include "launch.cuh"'):
        assert name in header, name
    assert "int grid_for(" in open(os.path.join(csrc, "launch.cuh")).read()
    mxu = open(os.path.join(csrc, "intersect_mxu.cu")).read()
    assert '#include "launch.cuh"' in mxu and "int grid_for(" not in mxu
    for name in ("intersect_q.cu", "intersect_sweep.cu"):
        src = open(os.path.join(csrc, name)).read()
        assert '#include "q_row.cuh"' in src, name
        assert "QTerms q_terms(" not in src, name
        assert "bool q_inside(" not in src, name
        assert "void stage(" not in src, name
        assert "int grid_for(" not in src, name


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from mitsuba3_plt_tpu_torch import resolve_device
    from mitsuba3_plt_tpu_torch.core.rng import Sampler
    from mitsuba3_plt_tpu_torch.scene.bridge import scene_from_arrays
    from mitsuba3_plt_tpu_torch.scene.presets import (
        grating_scene, grating_scene_arrays,
    )

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        grating_scene(8, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        scene_from_arrays(*grating_scene_arrays(8, 8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Sampler.create(0, 16)
    with pytest.raises(RuntimeError):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    assert grating_scene(8, 8, device="cpu").device == torch.device("cpu")


def test_boundary_gradients_run_on_their_scenes_device():
    """The boundary estimators take no device: they run where the scene
    lies (a card's by default), here on the CPU a scene was asked for."""
    from mitsuba3_plt_tpu_torch import ad
    from mitsuba3_plt_tpu_torch.ad import projective
    from mitsuba3_plt_tpu_torch.integrators.path import PathIntegrator
    from mitsuba3_plt_tpu_torch.scene.presets import cornell_box

    scene = cornell_box(8, 8, device="cpu")
    g_img = torch.ones((8, 8, 3))
    integ = PathIntegrator(2, 8)
    outs = [projective.primary_boundary_grad(scene, integ.sample, g_img,
                                             n_samples=256),
            projective.nee_boundary_grad(scene, integ.sample, g_img,
                                         n_samples=256),
            projective.area_nee_boundary_grad_guided(scene, g_img,
                                                     n_samples=512)]
    for out in outs:
        assert sorted(out) == ["geo.tri_p0", "geo.tri_p1", "geo.tri_p2"]
        assert all(v.device == torch.device("cpu") for v in out.values())
    assert "geo.tri_p0" in ad.traverse(scene)


def test_loaders_and_the_cli_need_a_card_unless_asked_for_the_cpu(
        tmp_path):
    """load_file, load_dict, the scene assembly above 4,096 faces (the
    clu2 tables) and the CLI by default raise without a card; the package's
    render follows its scene's device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    import numpy as np

    import mitsuba3_plt_tpu_torch as tmi
    from mitsuba3_plt_tpu_torch import cli
    from mitsuba3_plt_tpu_torch.scene import loader, shape, xml_scenes

    path = tmp_path / "box.xml"
    path.write_text(xml_scenes.cornell_box_xml(8, 8, spp=1, max_depth=2))
    sphere = {"type": "scene", "ball": {"type": "mesh",
                                        "mesh": shape.make_sphere(5)}}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmi.load_file(str(path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmi.load_dict(sphere)
    big = shape.make_sphere(5)
    args = ([big], [0], [-1], [], [], None, {}, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loader.assemble_scene(*args)
    scene, _ = loader.assemble_scene(*args, device="cpu")
    assert scene.intersect_route() == "clu2"
    assert scene.ctab2.rows.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([str(path), "-o", str(tmp_path / "out"), "--quiet"])
    img = tmi.render(tmi.load_file(str(path), device="cpu"), spp=1)
    assert img.device == torch.device("cpu")
    assert np.isfinite(img.numpy()).all()


def test_intersect_wrappers_check_arguments():
    from mitsuba3_plt_tpu_torch.ops import intersect as isect

    tri_q = torch.zeros((64, 16))
    anchor = torch.zeros(3)
    o, d, mt = torch.zeros((5, 3)), torch.ones((5, 3)), torch.ones(5)
    with pytest.raises(TypeError):
        isect.intersect_q(tri_q, anchor, o.double(), d, mt)
    with pytest.raises(ValueError):
        isect.occluded_q(tri_q, anchor, o, d[:4], mt)
    with pytest.raises(ValueError):
        isect.intersect_q(tri_q[:, :15], anchor, o, d, mt)
    with pytest.raises(ValueError):
        isect.intersect_q(tri_q, anchor, o, d, mt, n_tris=65)
    t, prim, u, v = isect.intersect_q(tri_q, anchor, o, d, mt)
    assert (prim == -1).all() and torch.isinf(t).all()


def test_launch_counters_stay_zero_on_the_cpu():
    from mitsuba3_plt_tpu_torch import ops
    from mitsuba3_plt_tpu_torch.integrators.common import render
    from mitsuba3_plt_tpu_torch.integrators.plt import PLTIntegrator
    from mitsuba3_plt_tpu_torch.scene.presets import grating_scene

    from mitsuba3_plt_tpu_torch import ad

    ops.reset_launch_counts()
    scene = grating_scene(4, 4, device="cpu")
    render(scene, PLTIntegrator(max_depth=2), spp=1)
    # and a gradient: the lobe sum's backward is the plain version's too
    ad.render_loss_grad(scene, PLTIntegrator(max_depth=2).sample,
                        torch.mean, ["materials.grt_height"], spp=1)
    assert ops.launch_counts() == {"intersect_q": 0, "occluded_q": 0,
                                   "intersect_clu2": 0, "occluded_clu2": 0,
                                   "intersect_bvh": 0, "occluded_bvh": 0,
                                   "intersect_classic": 0,
                                   "occluded_classic": 0, "intersect_mxu": 0,
                                   "intersect_clu": 0, "occluded_clu": 0,
                                   "intersect_q_variant": 0,
                                   "occluded_q_variant": 0,
                                   "intersect_q_macc": 0, "fma_roof": 0,
                                   "grating_sample": 0, "grating_lobe_sum": 0,
                                   "grating_lobe_sum_bwd": 0,
                                   "grating_lobe_sum_record": 0}


def test_tool_entry_points_need_a_card_unless_asked_for_the_cpu():
    """The cluster tables and the tools' rays follow the device they are
    given; without one the tables need a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from mitsuba3_plt_tpu_torch.scene.presets import cornell_box
    from mitsuba3_plt_tpu_torch.tools import bench_isect as bi
    from mitsuba3_plt_tpu_torch.tools import isect_mask_sort as ms
    from mitsuba3_plt_tpu_torch.tools import isect_unroll_sweep as us
    from mitsuba3_plt_tpu_torch.tools import kernel_mfu as km
    from mitsuba3_plt_tpu_torch.scene.bvh import pack_clusters

    scene = cornell_box(8, 8, device="cpu")
    bvh, p0, p1, p2 = bi.soup_bvh(scene)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pack_clusters(bvh, p0, p1, p2)
    assert pack_clusters(bvh, p0, p1, p2, device="cpu").rows.device.type \
        == "cpu"
    assert all(t.device.type == "cpu" for t in ms.tables(scene)["ctab128"]
               .__dict__.values())
    assert us.sweep_rays(scene, 16)[0].device.type == "cpu"
    assert ms.ray_sets(scene, 1)["shadow2"][2].device.type == "cpu"
    assert all(t.device.type == "cpu" for t in km.pixel_rays(scene))
    assert all(t.device.type == "cpu"
               for t in km.lobe_inputs(4, "cpu").values())
