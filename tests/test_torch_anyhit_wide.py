"""The any-hit walk over the WideBVH (`occluded_bvh_plain`, B7b's plain
version, CPU) against the skip-link walk over the PacketBVH that it
replaced (`_bvh_walk`, any_hit True), on every lane: the flag is a function
of the leaves a ray enters, and both walks enter the same ones (a child's
box lies inside its parent's and slab rounding is monotone in the box
planes), so the two agree to the bit. maxt at and about the edges that
decide a flag: one ulp short of the closest hit, at it, one ulp past it,
infinite, zero, and equal to the near distance of a leaf box the ray
enters. Then the packet scene's shadow rays of its camera hits, through
`Scene.ray_test`, and the walk's counts."""
import numpy as np
import pytest
import torch

from mitsuba3_plt_tpu_torch.core import math as m
from mitsuba3_plt_tpu_torch.librender.records import Ray
from mitsuba3_plt_tpu_torch.ops import intersect as tisect
from mitsuba3_plt_tpu_torch.scene import presets as tpresets
from mitsuba3_plt_tpu_torch.scene.bvh import (
    build_bvh, pack_packet_bvh, pack_wide_bvh,
)
from test_torch_mesh import _mesh_of, _soup
from test_torch_packet import _rays, _sphere4, _t

N_RAYS = 2048
MAXT_CASES = ("short", "at", "past", "inf", "zero", "leaf-near")


@pytest.fixture(scope="module")
def tables():
    """{name: (port PacketBVH, its WideBVH)}: the 5,120-face sphere and the
    three spheres over a plane."""
    out = {}
    for name in ("sphere4", "spheres"):
        p = _sphere4() if name == "sphere4" else _soup(name)
        tpb = pack_packet_bvh(build_bvh(*_mesh_of(p)), *p, device="cpu")
        out[name] = (tpb, pack_wide_bvh(tpb))
    return out


def _leaf_near(tpb, o, d):
    """The near distance of the first PacketBVH leaf box each ray enters
    (near <= far, far > 0), with the walks' slab arithmetic, and whether
    it enters one."""
    nodes = tpb.nodes[tpb.nodes[:, 7] > 0]
    inv = 1.0 / tisect._signed_eps(d)
    t0 = (nodes[None, :, 0:3] - o[:, None, :]) * inv[:, None, :]
    t1 = (nodes[None, :, 3:6] - o[:, None, :]) * inv[:, None, :]
    near = torch.minimum(t0, t1).amax(-1)
    far = torch.maximum(t0, t1).amin(-1)
    enter = (near <= far) & (far > 0.0) & (near > 0.0)
    k = enter.to(torch.int8).argmax(-1)
    return near.gather(1, k[:, None])[:, 0], enter.any(-1)


def _maxt(case, tpb, twb, o, d):
    """maxt [N] of one case; lanes whose closest hit or leaf the case
    needs and that have none get maxt 1."""
    inf = torch.full((o.shape[0],), float("inf"))
    t0 = tisect.intersect_bvh_plain(twb, o, d, inf)[0]
    hit = torch.isfinite(t0)
    if case == "inf":
        return inf
    if case == "zero":
        return torch.zeros_like(inf)
    if case == "leaf-near":
        near, entered = _leaf_near(tpb, o, d)
        return torch.where(entered, near, 1.0)
    edge = {"short": torch.nextafter(t0, torch.zeros_like(t0)), "at": t0,
            "past": torch.nextafter(t0, inf)}[case]
    return torch.where(hit, edge, 1.0)


@pytest.mark.parametrize("case", MAXT_CASES)
@pytest.mark.parametrize("name", ["sphere4", "spheres"])
def test_anyhit_wide_walk_matches_skip_link_walk(tables, name, case):
    tpb, twb = tables[name]
    o, d = _rays(N_RAYS, seed=21)
    if name == "spheres":
        o[:, 0] *= 2.0  # spread the origins over the three spheres
    o, d = _t(o, d)
    mt = _maxt(case, tpb, twb, o, d)
    counts, closest = {}, {}
    got = tisect.occluded_bvh_plain(twb, o, d, mt, counts=counts)
    want = tisect._bvh_walk(tpb, o, d, mt, True, None)[4]
    assert got.dtype == torch.bool
    assert torch.equal(got, want)
    t0 = tisect.intersect_bvh_plain(twb, o, d, mt, counts=closest)[0]
    share = got.float().mean().item()
    # an occluded ray has a closest hit before maxt. Not the converse: the
    # any hit's gate is near < maxt, the closest hit's near <= maxt, and a
    # flat box's slab near can round past the t of a triangle in it (the
    # ground plane of "spheres" at maxt one ulp past the hit)
    assert not (got & ~torch.isfinite(t0)).any()
    if case in ("zero", "short", "at"):
        assert share == 0.0
    else:
        assert 0.1 < share < 0.95
    assert counts["stack_peak"] <= twb.stack
    assert counts["steps"] == int(counts["ray_pops"].max())
    assert counts["triangle_tests"] == int(
        counts["ray_triangle_tests"].sum())
    # leaving at the first hit: never more triangle tests than the walk to
    # the closest hit, and fewer where any ray is occluded
    assert counts["triangle_tests"] <= closest["triangle_tests"]
    if share > 0:
        assert counts["triangle_tests"] < closest["triangle_tests"]


def test_anyhit_wide_walk_leaves_at_the_first_hit(tables):
    """An occluded ray has tested rows and never more rows than the leaves
    it popped hold; a lane whose maxt ends before every box pops the root
    once, slab-tests its children and tests no row."""
    tpb, twb = tables["sphere4"]
    o, d = _t(*_rays(N_RAYS, seed=5))
    inf = torch.full((N_RAYS,), float("inf"))
    counts = {}
    occ = tisect.occluded_bvh_plain(twb, o, d, inf, counts=counts)
    tests, pops = counts["ray_triangle_tests"], counts["ray_pops"]
    assert 0.2 < occ.float().mean() < 0.9
    assert (tests[occ] >= 1).all()
    assert (tests <= tisect.PACKET_LEAF * pops).all()
    tiny = torch.full((N_RAYS,), 1e-3)  # the sphere is >= 2 from |o| = 3
    counts = {}
    assert not tisect.occluded_bvh_plain(twb, o, d, tiny,
                                         counts=counts).any()
    root = int((twb.nodes[0, 7::8] >= 0).sum())
    assert counts["slab_tests"] == N_RAYS * root
    assert counts["triangle_tests"] == counts["stack_peak"] == 0
    assert counts["steps"] == 1 and (counts["ray_pops"] == 1).all()


@pytest.fixture(scope="module")
def packet_scene():
    return tpresets.mesh_scene(24, 24, 5, accel="packet", device="cpu")


def _shadow_rays(scene):
    """The shadow rays of the scene's camera hits to its point light, as the
    path integrator's NEE sends them (origin pushed off along the face
    normal, maxt short of the light), dead rays (o = 1e8, maxt 0) where the
    camera ray missed."""
    from mitsuba3_plt_tpu_torch.core.rng import Sampler
    from mitsuba3_plt_tpu_torch.integrators.common import sample_rays

    W, H = scene.sensor.resolution
    cam, _ = sample_rays(scene, Sampler.create(0, W * H * 4, device="cpu"),
                         W, H, 4)
    si = scene.ray_intersect(cam)
    org = si.p + si.n * m.RayEpsilon
    to_l = scene.emitters.position[0] - org
    dist = to_l.norm(dim=-1)
    live = si.valid[:, None]
    o = torch.where(live, org, torch.full_like(org, 1e8))
    d = torch.where(live, to_l / dist[:, None],
                    torch.tensor([0.0, 0.0, 1.0]))
    mt = torch.where(si.valid, dist * (1.0 - m.ShadowEpsilon), 0.0)
    return o, d, mt, si.valid


def test_anyhit_wide_walk_on_the_packet_scene(packet_scene):
    """The 20,480-face packet scene's camera-hit shadow rays: the WideBVH
    walk equals the skip-link walk on every lane, the route (sorted,
    launched, unsorted) returns the same flags, and the walk stays within
    the table's stack."""
    scene = packet_scene
    o, d, mt, live = _shadow_rays(scene)
    counts = {}
    got = tisect.occluded_bvh_plain(scene.wbvh, o, d, mt, counts=counts)
    want = tisect._bvh_walk(scene.pbvh, o, d, mt, True, None)[4]
    assert torch.equal(got, want)
    assert 0.2 < live.float().mean() < 0.6  # the sphere fills ~31%
    # the visible points that face away from the light (~18%)
    assert 0.1 < got[live].float().mean() < 0.5
    assert not got[~live].any()
    assert torch.equal(scene.ray_test(Ray(o=o, d=d, maxt=mt)), got)
    assert 0 < counts["stack_peak"] <= scene.wbvh.stack
    # a dead lane (o = 1e8) pops the root once and tests no triangle
    assert (counts["ray_pops"][~live] == 1).all()
    assert (counts["ray_triangle_tests"][~live] == 0).all()
    # the same rays with maxt past the light, and infinite
    for far in (mt * 4.0, torch.full_like(mt, float("inf"))):
        assert torch.equal(
            tisect.occluded_bvh_plain(scene.wbvh, o, d, far),
            tisect._bvh_walk(scene.pbvh, o, d, far, True, None)[4])
