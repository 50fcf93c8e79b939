"""Visibility (silhouette) gradients for geometry parameters: the JAX
package's `ad/projective.py`.

Autograd through the render gives the interior term of a geometry
derivative (shading, foreshortening, normals). It misses the boundary
term, the radiance jump swept by a moving silhouette:

    dI/dtheta = interior (autograd)  +  sum over view silhouettes of
                w(px) (L_minus - L_plus) (n_hat . d px(theta)/d theta) dl

sampled uniformly by 3D edge length. The jump is probed with two camera
rays offset +-delta pixels across the projected edge (`integrator_sample`
on 2n lanes, so the path's own intersection kernels), and each sample's
screen velocity is pulled back to the soup's vertex rows by autograd of
the projection: the samples are independent, so one backward of their sum
gives every sample its own gradient. Each call reads the edge table (built
on the host once a geometry) and the emitter list on the host first;
everything after runs at fixed shapes with no host synchronisation.

- `primary_boundary_grad`: camera-visibility silhouettes.
- `nee_boundary_grad`: shadow silhouettes of occluders under point-like
  emitters, through the analytic line-plane extension from the light past
  the edge to the receiver.
- `area_nee_boundary_grad`: area-light penumbrae by (edge point, emitter
  point) pairs with the closed-form direct term as the jump, lit and
  shadow side told apart by two shadow rays;
  `area_nee_boundary_grad_guided` adds a pilot pass whose per-edge mass
  guides the second pass's edge choice.

Scope: perspective sensors. Cotangents of a shared vertex land on the
sampled edge's own face rows: right for any parameterisation that moves
coincident soup rows together (translations, LargeSteps vertex fields).
Each function returns {"geo.tri_p0", "geo.tri_p1", "geo.tri_p2": [F, 3]}
cotangents of d(loss)/d(vertex rows) for loss = sum(grad_image * image).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict

import numpy as np
import torch

from ..config import RGB, RenderConfig
from ..core.device import fp32_matmul
from ..core.rng import Sampler
from ..librender import bsdfs
from ..librender.records import Ray
from ..librender.sensor import SENSOR_PERSPECTIVE
from ..scene.emitters import EMITTER_AREA, EMITTER_POINT

# the JAX package's spot and projector ids, point-like as the point light;
# the port has neither emitter yet, so only the point light reaches the
# shadow estimator
EMITTER_SPOT = 5
EMITTER_PROJECTOR = 9
POINT_LIKE = (EMITTER_POINT, EMITTER_SPOT, EMITTER_PROJECTOR)

KEYS = ("geo.tri_p0", "geo.tri_p1", "geo.tri_p2")


# ---------------------------------------------------------------------------
# host-side edge extraction
# ---------------------------------------------------------------------------

_EDGE_CACHE: Dict[bytes, Any] = {}


def build_edges(geo) -> dict:
    """Unique-edge table of the triangle soup (host, numpy).

    Soup rows duplicate shared vertices, so edges are matched by their
    endpoints' coordinates quantized at 1e5. Edges come in the order of
    their first occurrence over (face, corner), degenerate ones skipped;
    the first occurrence gives the endpoints, the second the other face.
    Returns int32 arrays [E]: a_face, a_corner, b_face, b_corner (corner k
    of face f is tri_p{k}[f]) and f1, f2 (the adjacent faces; f2 = -1 for
    an open edge). The same arrays as the JAX package's loop, vectorised.
    """
    p = np.stack([np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor)
                             else x) for x in (geo.tri_p0, geo.tri_p1,
                                               geo.tri_p2)], axis=1)
    F = p.shape[0]
    key = np.round(p.astype(np.float64) * 1e5).astype(np.int64)  # [F, 3, 3]
    ka = key.reshape(F * 3, 3)                     # record f * 3 + c
    kb = key[:, [1, 2, 0]].reshape(F * 3, 3)       # corner (c + 1) % 3
    # lexicographic order of the two endpoint keys
    diff = ka != kb
    first = np.argmax(diff, axis=1)
    rows = np.arange(F * 3)
    a_less = ka[rows, first] < kb[rows, first]
    keep = diff.any(axis=1)                        # degenerate edges skipped
    lo = np.where(a_less[:, None], ka, kb)
    hi = np.where(a_less[:, None], kb, ka)
    rec = rows[keep]
    edge_key = np.concatenate([lo, hi], axis=1)[keep]
    if rec.size == 0:
        empty = np.zeros((0,), np.int32)
        return {k: empty for k in ("a_face", "a_corner", "b_face",
                                   "b_corner", "f1", "f2")}
    _, first_pos, inverse = np.unique(edge_key, axis=0, return_index=True,
                                      return_inverse=True)
    inverse = inverse.reshape(-1)
    # the second record of each edge: records sorted by (edge, position)
    order = np.lexsort((np.arange(rec.size), inverse))
    g = inverse[order]
    starts = np.flatnonzero(np.r_[True, g[1:] != g[:-1]])
    counts = np.diff(np.r_[starts, g.size])
    second = np.full(first_pos.shape, -1, np.int64)
    has2 = counts > 1
    second[g[starts[has2]]] = rec[order[starts[has2] + 1]]
    # edges in order of first occurrence
    by_first = np.argsort(first_pos, kind="stable")
    r1 = rec[first_pos[by_first]]
    r2 = second[by_first]
    face, corner = r1 // 3, r1 % 3
    return dict(
        a_face=face.astype(np.int32),
        a_corner=corner.astype(np.int32),
        b_face=face.astype(np.int32),
        b_corner=((corner + 1) % 3).astype(np.int32),
        f1=face.astype(np.int32),
        f2=np.where(r2 >= 0, r2 // 3, -1).astype(np.int32),
    )


def _edges_for(scene) -> dict:
    """build_edges of the scene's geometry, from a single-entry cache keyed
    by the content of tri_p0 (an object's id recycles after collection)."""
    key = hashlib.sha1(
        scene.geo.tri_p0.detach().cpu().numpy().tobytes()).digest()
    if key not in _EDGE_CACHE:
        _EDGE_CACHE.clear()
        _EDGE_CACHE[key] = build_edges(scene.geo)
    return _EDGE_CACHE[key]


def _edge_tensors(scene):
    """The edge table on the scene's device, and (pa, pb) [E, 3]: each
    edge's endpoints, detached from the vertex rows."""
    ed = {k: torch.as_tensor(v, dtype=torch.int64, device=scene.device)
          for k, v in _edges_for(scene).items()}
    tri_p = torch.stack([scene.geo.tri_p0, scene.geo.tri_p1,
                         scene.geo.tri_p2]).detach()       # [3, F, 3]
    pa = tri_p[ed["a_corner"], ed["a_face"]]
    pb = tri_p[ed["b_corner"], ed["b_face"]]
    return ed, pa, pb


def _scatter(scene, ed, e_idx, cot_a, cot_b):
    """The cotangents of the sampled edges' endpoints summed into the soup
    rows: {key: [F, 3]}; flat slot = face * 3 + corner."""
    F = scene.geo.n_faces
    slots = torch.cat([ed["a_face"][e_idx] * 3 + ed["a_corner"][e_idx],
                       ed["b_face"][e_idx] * 3 + ed["b_corner"][e_idx]])
    acc = torch.zeros((3 * F, 3), dtype=torch.float32,
                      device=scene.device).index_add_(
        0, slots, torch.cat([cot_a, cot_b]))
    return {k: acc[c::3] for c, k in enumerate(KEYS)}


def _zeros(scene):
    F = scene.geo.n_faces
    return {k: torch.zeros((F, 3), dtype=torch.float32, device=scene.device)
            for k in KEYS}


def _check_sensor(scene):
    if scene.sensor.stype_static != SENSOR_PERSPECTIVE:
        raise NotImplementedError(
            "the boundary gradients take a perspective sensor, got sensor "
            f"type {scene.sensor.stype_static}")


# ---------------------------------------------------------------------------
# camera projection (perspective)
# ---------------------------------------------------------------------------

def _project_px(sensor, x):
    """World point [.., 3] -> (continuous pixel coordinates [.., 2], depth
    [..]): the inverse of the perspective `Sensor.sample_ray`, u = (1 -
    x_c / (z_c tx)) / 2 - ppo_x, scaled by the resolution. The camera
    frame's product is written out (no matrix product, so no TF32)."""
    R = sensor.to_world[:3, :3]
    t = sensor.to_world[:3, 3]
    v = x - t
    xc = v[..., 0:1] * R[0] + v[..., 1:2] * R[1] + v[..., 2:3] * R[2]
    z = xc[..., 2]
    tx = sensor.tan_half_x
    ty = sensor.tan_half_x / sensor.aspect
    zc = torch.clamp_min(z, 1e-6)
    u = (1.0 - xc[..., 0] / (zc * tx)) * 0.5 - sensor.ppo[0]
    vv = (1.0 - xc[..., 1] / (zc * ty)) * 0.5 - sensor.ppo[1]
    w, h = sensor.resolution
    return torch.stack([u * w, vv * h], dim=-1), z


def _on_screen(sensor, px, z):
    w, h = sensor.resolution
    return ((z > 1e-4) & (px[:, 0] > 0.5) & (px[:, 0] < w - 0.5)
            & (px[:, 1] > 0.5) & (px[:, 1] < h - 0.5))


def _normal_2d(e2d):
    """(unit normal of the screen segment e2d [N, 2], its length)."""
    e2d_len = torch.linalg.norm(e2d, dim=-1)
    n2d = torch.stack([-e2d[:, 1], e2d[:, 0]], dim=-1) / torch.clamp_min(
        e2d_len, 1e-9)[:, None]
    return n2d, e2d_len


def _silhouette(scene, ed, e_idx, view):
    """Whether the sampled edge is a silhouette seen along `view` [N, 3]:
    an open edge, or one whose two faces face opposite ways."""
    fn = scene.geo.tri_attr[:, 0:3]
    s1 = torch.sum(fn[ed["f1"][e_idx]] * view, dim=-1)
    f2e = ed["f2"][e_idx]
    s2 = torch.sum(fn[torch.clamp_min(f2e, 0)] * view, dim=-1)
    return torch.where(f2e >= 0, s1 * s2 < 0.0, True)


def _sample_edges(weights, key, n_samples, device):
    """(sampler, e_idx, u, cum): edges drawn by searchsorted over the
    weights' cumulative sum (dimension 0), u uniform on the edge
    (dimension 1)."""
    cum = torch.cumsum(weights, dim=0)
    sampler = Sampler.create(int(key), n_samples, device=device)
    r_e = sampler.next_1d(0)
    u = sampler.next_1d(1)
    e_idx = torch.clamp(torch.searchsorted(cum, r_e * cum[-1]), 0,
                        weights.shape[0] - 1)
    return sampler, e_idx, u, cum


def _pixel_weight(sensor, grad_image, px):
    w, h = sensor.resolution
    ix = torch.clamp(px[:, 0].to(torch.int32), 0, w - 1).to(torch.int64)
    iy = torch.clamp(px[:, 1].to(torch.int32), 0, h - 1).to(torch.int64)
    return grad_image[iy, ix]


def _probe(scene, integrator_sample, px, n2d, key, delta_px, cfg):
    """(L_plus, L_minus) [N, C]: the integrator's radiance through the
    pixel positions px +- delta_px n2d, on 2N lanes of the sampler
    (key + 1); invalid lanes count as 0."""
    w, h = scene.sensor.resolution
    res = torch.tensor([w, h], dtype=torch.float32, device=px.device)
    n = px.shape[0]
    uv2 = torch.cat([(px + delta_px * n2d) / res,
                     (px - delta_px * n2d) / res])
    o2, d2 = scene.sensor.sample_ray(uv2)
    sam2 = Sampler.create(int(key) + 1, 2 * n, device=px.device)
    values, valid = integrator_sample(scene, sam2, Ray.create(o2, d2), cfg)
    values = torch.where(valid[:, None], values, 0.0)
    return values[:n], values[n:]


def _per_sample_grads(fn, *args):
    """Each sample's gradient of fn's [N] output with respect to the first
    two arguments [N, 3]: one backward of the sum (the samples are
    independent)."""
    with torch.enable_grad():
        a = args[0].detach().requires_grad_(True)
        b = args[1].detach().requires_grad_(True)
        s = fn(a, b, *args[2:])
        return torch.autograd.grad(s.sum(), (a, b))


def _ray_test(scene, o, d, maxt):
    return scene.ray_test(Ray(o=o.expand(d.shape).contiguous(), d=d,
                              maxt=maxt))


# ---------------------------------------------------------------------------
# boundary gradient estimator
# ---------------------------------------------------------------------------

@torch.no_grad()
@fp32_matmul()
def primary_boundary_grad(scene, integrator_sample, grad_image, key=0,
                          n_samples: int = 1 << 14, cfg: RenderConfig = RGB,
                          delta_px: float = 0.35):
    """Boundary-term cotangents {tri_p0, tri_p1, tri_p2: [F, 3]} of the
    camera silhouettes, for loss = sum(grad_image * image); grad_image
    [H, W, C] is the loss's adjoint at the developed image."""
    _check_sensor(scene)
    sensor = scene.sensor
    ed, pa_all, pb_all = _edge_tensors(scene)
    elen = torch.linalg.norm(pb_all - pa_all, dim=-1)
    _, e_idx, u, cum = _sample_edges(elen, key, n_samples, scene.device)
    total_len = cum[-1]
    pa, pb = pa_all[e_idx], pb_all[e_idx]
    x = pa + (pb - pa) * u[:, None]

    # silhouette with respect to the camera origin
    cam_o = sensor.to_world[:3, 3]
    view = x - cam_o
    sil = _silhouette(scene, ed, e_idx, view)

    # projection, on-screen test and the edge's screen normal
    px, z = _project_px(sensor, x)
    n2d, _ = _normal_2d(_project_px(sensor, pb)[0]
                        - _project_px(sensor, pa)[0])

    # the edge point visible from the camera
    dist = torch.linalg.norm(view, dim=-1)
    vdir = view / torch.clamp_min(dist, 1e-9)[:, None]
    occ = _ray_test(scene, cam_o, vdir, dist * (1.0 - 1e-3))
    active = sil & _on_screen(sensor, px, z) & ~occ

    # radiance on both sides; moving the edge along +n2d grows L_minus's
    # region
    L_plus, L_minus = _probe(scene, integrator_sample, px, n2d, key,
                             delta_px, cfg)
    w_px = _pixel_weight(sensor, grad_image, px)
    jump = torch.sum(w_px * (L_minus - L_plus), dim=-1)

    # the edge point's screen velocity pulled back to the endpoints, and
    # |d px / d u|, the du -> screen arclength factor
    def s_of(a3, b3, uu, nn):
        p2d, _ = _project_px(sensor, a3 + (b3 - a3) * uu[:, None])
        return torch.sum(p2d * nn, dim=-1)

    g_a, g_b = _per_sample_grads(s_of, pa, pb, u, n2d)
    with torch.enable_grad():
        uu = u.detach().requires_grad_(True)
        p2d, _ = _project_px(sensor, pa + (pb - pa) * uu[:, None])
        dpx_du = torch.stack([
            torch.autograd.grad(p2d[:, k].sum(), uu, retain_graph=k == 0)[0]
            for k in range(2)], dim=-1)
    arc = torch.linalg.norm(dpx_du, dim=-1)

    # the sample's pdf per unit u on its edge: elen_e / total_len
    inv_pdf = total_len / torch.clamp_min(elen[e_idx], 1e-12)
    coef = torch.where(active, jump * arc * inv_pdf, 0.0) / n_samples
    return _scatter(scene, ed, e_idx, g_a * coef[:, None],
                    g_b * coef[:, None])


# ---------------------------------------------------------------------------
# NEE / shadow-ray boundary (occluder silhouettes as seen from the light)
# ---------------------------------------------------------------------------

@torch.no_grad()
@fp32_matmul()
def nee_boundary_grad(scene, integrator_sample, grad_image, key=0,
                      n_samples: int = 1 << 14, cfg: RenderConfig = RGB,
                      delta_px: float = 0.6):
    """Shadow-silhouette cotangents {tri_p0, tri_p1, tri_p2: [F, 3]} of
    point-like emitters: the emitter-occluder visibility term.

    As `primary_boundary_grad`, applied to the shadow curve: an edge point
    x, sampled by length, is kept where it is a silhouette seen from the
    light position e and visible from it; the ray e -> x is extended to
    its receiver hit y, where the shadow boundary lies; two camera rays
    +-delta px across the projected curve probe the jump; the shadow
    point's screen velocity pulls back through the analytic extension
    y(x) = e + (x - e) ((q0 - e).n) / ((x - e).n), the receiver's plane
    held fixed (the receiver's own motion is the primary term).

    Sums over every point-like emitter, each with its own samples (key +
    2 i); zero where the scene has none."""
    em = scene.emitters
    out = _zeros(scene)
    if not set(em.present_types) & set(POINT_LIKE):
        return out
    _check_sensor(scene)
    etype = em.etype.cpu().numpy()
    positions = em.position[torch.as_tensor(
        np.flatnonzero(np.isin(etype, POINT_LIKE)), device=scene.device)]
    for i in range(positions.shape[0]):
        g = _nee_boundary_grad_one(scene, integrator_sample, grad_image,
                                   positions[i], int(key) + 2 * i, n_samples,
                                   cfg, delta_px)
        out = {k: out[k] + g[k] for k in out}
    return out


def _shadow_point(a3, b3, uu, e3, q0, nr):
    """The receiver-plane point y of the light ray e3 -> x, x = a3 + (b3 -
    a3) uu, on the plane through q0 with normal nr (rows [N, 3])."""
    w = a3 + (b3 - a3) * uu[:, None] - e3
    denom = torch.sum(w * nr, dim=-1)
    s = torch.sum((q0 - e3) * nr, dim=-1) / torch.where(
        torch.abs(denom) > 1e-9, denom, 1e-9)
    return e3 + w * s[:, None]


def _shadow_curve(sensor, pa, pb, u, e3, q0, nr):
    """(n2d, arc): the screen normal of the projected shadow curve and |d
    px / d u|, from the projections of y(u -+ 1e-3)."""
    eps_u = 1e-3
    p_l, _ = _project_px(sensor, _shadow_point(pa, pb, u - eps_u, e3, q0, nr))
    p_r, _ = _project_px(sensor, _shadow_point(pa, pb, u + eps_u, e3, q0, nr))
    n2d, e2d_len = _normal_2d(p_r - p_l)
    return n2d, e2d_len, e2d_len / (2 * eps_u)


def _shadow_grads(sensor, pa, pb, u, n2d, e3, q0, nr):
    """Each sample's gradient of n2d . px(y(x)) with respect to the edge's
    endpoints, through the analytic extension."""
    def s_of(a3, b3, uu, nn):
        p2d, _ = _project_px(sensor, _shadow_point(a3, b3, uu, e3, q0, nr))
        return torch.sum(p2d * nn, dim=-1)

    return _per_sample_grads(s_of, pa, pb, u, n2d)


def _receiver(scene, x, ldir):
    """The receiver hit past x along ldir: (y, its normal, hit)."""
    si = scene.ray_intersect(Ray.create(x + ldir * 1e-4, ldir))
    return si, si.p, si.n, si.valid


def _camera_visible(scene, y):
    sensor = scene.sensor
    cam_o = sensor.to_world[:3, 3]
    cview = y - cam_o
    cdist = torch.linalg.norm(cview, dim=-1)
    cdir = cview / torch.clamp_min(cdist, 1e-9)[:, None]
    occ_c = _ray_test(scene, cam_o, cdir, cdist * (1.0 - 1e-3))
    return cdir, ~occ_c


def _nee_boundary_grad_one(scene, integrator_sample, grad_image, e_pos, key,
                           n_samples, cfg, delta_px):
    """Shadow-silhouette cotangents for one point-like emitter at e_pos."""
    sensor = scene.sensor
    ed, pa_all, pb_all = _edge_tensors(scene)
    elen = torch.linalg.norm(pb_all - pa_all, dim=-1)
    _, e_idx, u, cum = _sample_edges(elen, key, n_samples, scene.device)
    total_len = cum[-1]
    pa, pb = pa_all[e_idx], pb_all[e_idx]
    x = pa + (pb - pa) * u[:, None]

    # silhouette with respect to the light, x visible from it
    lview = x - e_pos
    sil = _silhouette(scene, ed, e_idx, lview)
    ldist = torch.linalg.norm(lview, dim=-1)
    ldir = lview / torch.clamp_min(ldist, 1e-9)[:, None]
    occ_l = _ray_test(scene, e_pos, ldir, ldist * (1.0 - 1e-3))

    # extend past x to the receiver; the shadow point on screen and seen
    _, y, recv_n, hit_recv = _receiver(scene, x, ldir)
    px, z = _project_px(sensor, y)
    _, cam_vis = _camera_visible(scene, y)
    active = (sil & ~occ_l & hit_recv & _on_screen(sensor, px, z)
              & cam_vis)

    e3 = e_pos.expand(x.shape)
    n2d, e2d_len, arc = _shadow_curve(sensor, pa, pb, u, e3, y, recv_n)
    active = active & (e2d_len > 1e-6)

    # radiance probes across the projected shadow curve
    L_plus, L_minus = _probe(scene, integrator_sample, px, n2d, key,
                             delta_px, cfg)
    w_px = _pixel_weight(sensor, grad_image, px)
    jump = torch.sum(w_px * (L_minus - L_plus), dim=-1)

    g_a, g_b = _shadow_grads(sensor, pa, pb, u, n2d, e3, y, recv_n)
    inv_pdf = total_len / torch.clamp_min(elen[e_idx], 1e-12)
    coef = torch.where(active, jump * arc * inv_pdf, 0.0) / n_samples
    return _scatter(scene, ed, e_idx, g_a * coef[:, None],
                    g_b * coef[:, None])


# ---------------------------------------------------------------------------
# area-light penumbra boundary
# ---------------------------------------------------------------------------

@torch.no_grad()
@fp32_matmul()
def area_nee_boundary_grad(scene, grad_image, key=0,
                           n_samples: int = 1 << 14, cfg: RenderConfig = RGB,
                           delta_px: float = 0.8, edge_weights=None,
                           return_edge_mass: bool = False):
    """Penumbra (area-light shadow boundary) cotangents {tri_p0, tri_p1,
    tri_p2: [F, 3]} by (edge point, emitter point) pairs.

    For a fixed emitter point e the moving occluder edge sweeps a sharp
    visibility step whose jump is the closed-form direct term f(y; w_cam,
    w_e) Le cos(theta_e) / r^2 (no probe renders: the penumbra is smooth on
    screen). Two shadow rays from the receiver plane at +-delta px tell the
    lit side from the shadowed one; velocities pull back through the
    analytic extension as in `nee_boundary_grad`.

    Samples every area emitter (chosen by area). Edges of emitter faces
    are excluded (their silhouette is another term). `edge_weights` [E]
    replaces the length-uniform edge choice (the guided estimator);
    `return_edge_mass` also returns each edge's summed |contribution|."""
    em, geo = scene.emitters, scene.geo
    if EMITTER_AREA not in em.present_types:
        return (_zeros(scene), None) if return_edge_mass else _zeros(scene)
    etype = em.etype.cpu().numpy()
    area_all = em.area.cpu().numpy()
    area_em = [int(i) for i in np.flatnonzero(etype == EMITTER_AREA)
               if float(area_all[i]) > 0]
    if not area_em:
        return (_zeros(scene), None) if return_edge_mass else _zeros(scene)
    _check_sensor(scene)
    sensor, dev = scene.sensor, scene.device
    ed, pa_all, pb_all = _edge_tensors(scene)

    # edges of an emitter's faces are the light's own silhouette
    tri_emitter = geo.tri_attr[:, 19]
    on_emitter = ((tri_emitter[ed["f1"]] >= 0)
                  | (tri_emitter[torch.clamp_min(ed["f2"], 0)] >= 0))
    elen = torch.where(on_emitter, 0.0,
                       torch.linalg.norm(pb_all - pa_all, dim=-1))
    samp_w = elen if edge_weights is None else torch.where(
        elen > 0, torch.clamp_min(edge_weights, 0.0), 0.0)
    sampler, e_idx, u, cum = _sample_edges(samp_w, key, n_samples, dev)
    total_len = cum[-1]
    pa, pb = pa_all[e_idx], pb_all[e_idx]
    x = pa + (pb - pa) * u[:, None]

    # the emitter point: an area emitter by area, a triangle by its cdf,
    # a uniform barycentric point
    areas = np.asarray([float(area_all[i]) for i in area_em])
    cdf_sel = torch.as_tensor(np.cumsum(areas / areas.sum()),
                              dtype=torch.float32, device=dev)
    which = torch.clamp(torch.searchsorted(cdf_sel, sampler.next_1d(2)), 0,
                        len(area_em) - 1)
    ei = torch.as_tensor(area_em, dtype=torch.int64, device=dev)[which]
    tri_cdf = em.tri_cdf[ei]                                  # [N, T]
    ti = torch.clamp(torch.sum(tri_cdf < sampler.next_1d(3)[:, None],
                               dim=-1), 0, tri_cdf.shape[-1] - 1)
    f_e = torch.clamp_min(em.tri_idx[ei, ti], 0)
    b1, b2 = sampler.next_1d(4), sampler.next_1d(5)
    fold = b1 + b2 > 1.0
    b1 = torch.where(fold, 1.0 - b1, b1)
    b2 = torch.where(fold, 1.0 - b2, b2)
    p0 = geo.tri_p0.detach()[f_e]
    e_pt = (p0 + b1[:, None] * (geo.tri_p1.detach()[f_e] - p0)
            + b2[:, None] * (geo.tri_p2.detach()[f_e] - p0))
    n_e = geo.tri_attr[f_e, 0:3]
    # the joint (emitter, point) density: (area_i / sum) (1 / area_i)
    inv_pdf_e = float(np.float32(areas.sum()))
    Le = em.radiance[ei]

    # silhouette with respect to the emitter point, x visible from it
    lview = x - e_pt
    sil = _silhouette(scene, ed, e_idx, lview)
    ldist = torch.linalg.norm(lview, dim=-1)
    ldir = lview / torch.clamp_min(ldist, 1e-9)[:, None]
    cos_e = torch.sum(n_e * ldir, dim=-1)
    occ_l = _ray_test(scene, e_pt + ldir * 1e-4, ldir,
                      ldist * (1.0 - 2e-3))

    # extend past x to the receiver
    si, y, recv_n, hit_recv = _receiver(scene, x, ldir)
    px, z = _project_px(sensor, y)
    cdir, cam_vis = _camera_visible(scene, y)
    active = (sil & ~occ_l & hit_recv & _on_screen(sensor, px, z) & cam_vis
              & (cos_e > 1e-4) & (total_len > 0))

    n2d, e2d_len, arc = _shadow_curve(sensor, pa, pb, u, e_pt, y, recv_n)
    active = active & (e2d_len > 1e-6)

    # the closed-form jump at y for emitter point e: wi toward the camera,
    # wo toward the light (the BSDF's eval includes the cosine at y)
    si_eval = dataclasses.replace(si, wi=si.to_local(-cdir))
    f_val = bsdfs.eval_(scene.materials, torch.clamp_min(si.mat_idx, 0),
                        si_eval, si.to_local(-ldir), cfg.n_channels)
    r_ye = torch.linalg.norm(y - e_pt, dim=-1)
    delta_rgb = f_val * Le * (cos_e / torch.clamp_min(r_ye * r_ye, 1e-9)
                              )[:, None]

    # lit / shadow side by two receiver-plane shadow rays
    w, h = sensor.resolution
    res = torch.tensor([w, h], dtype=torch.float32, device=dev)

    def plane_point(px2):
        o2, d2 = sensor.sample_ray(px2 / res)
        denom = torch.sum(d2 * recv_n, dim=-1)
        t = torch.sum((y - o2) * recv_n, dim=-1) / torch.where(
            torch.abs(denom) > 1e-6, denom, 1e-6)
        return o2 + d2 * t[:, None]

    def lit_from(yq):
        dv = e_pt - yq
        dl = torch.linalg.norm(dv, dim=-1)
        dn = dv / torch.clamp_min(dl, 1e-9)[:, None]
        off = torch.where(torch.sum(dn * recv_n, dim=-1) >= 0, 1e-4,
                          -1e-4)[:, None] * recv_n
        occ = _ray_test(scene, yq + off, dn, dl * (1.0 - 2e-3))
        return (~occ).to(torch.float32)

    # +1: the +n2d side is lit; growth of the lit region adds +delta
    v_jump = (lit_from(plane_point(px + delta_px * n2d))
              - lit_from(plane_point(px - delta_px * n2d)))
    w_px = _pixel_weight(sensor, grad_image, px)
    jump = torch.sum(w_px * delta_rgb, dim=-1) * (-v_jump)

    g_a, g_b = _shadow_grads(sensor, pa, pb, u, n2d, e_pt, y, recv_n)
    # the edge density per unit u: samp_w_e / total
    inv_pdf = total_len / torch.clamp_min(samp_w[e_idx], 1e-12)
    coef = torch.where(active, jump * arc * inv_pdf * inv_pdf_e,
                       0.0) / n_samples
    out = _scatter(scene, ed, e_idx, g_a * coef[:, None],
                   g_b * coef[:, None])
    if return_edge_mass:
        mass = torch.zeros((elen.shape[0],), dtype=torch.float32,
                           device=dev).index_add_(0, e_idx, torch.abs(coef))
        return out, mass
    return out


def area_nee_boundary_grad_guided(scene, grad_image, key=0,
                                  n_samples: int = 1 << 14,
                                  cfg: RenderConfig = RGB,
                                  delta_px: float = 0.8,
                                  pilot_frac: float = 0.25):
    """The penumbra estimator with guided edge sampling, at fixed shapes:
    a pilot pass (pilot_frac of the budget, length-uniform, key) that
    also sums each edge's contribution mass, then a pass (key + 7919) that
    draws edges 75% by the pilot mass and 25% by length (a floor that
    keeps unvisited edges). Both passes are unbiased; the result is their
    average weighted by sample count."""
    n1 = max(int(n_samples * pilot_frac), 256)
    n2 = max(n_samples - n1, 256)
    g1, mass = area_nee_boundary_grad(
        scene, grad_image, key=key, n_samples=n1, cfg=cfg,
        delta_px=delta_px, return_edge_mass=True)
    if mass is None:
        return g1
    with torch.no_grad():
        _, pa, pb = _edge_tensors(scene)
        elen = torch.linalg.norm(pb - pa, dim=-1)
        weights = (0.75 * mass / torch.clamp_min(torch.sum(mass), 1e-20)
                   + 0.25 * elen / torch.clamp_min(torch.sum(elen), 1e-20))
    g2 = area_nee_boundary_grad(
        scene, grad_image, key=int(key) + 7919, n_samples=n2, cfg=cfg,
        delta_px=delta_px, edge_weights=weights)
    w1 = n1 / (n1 + n2)
    return {k: w1 * g1[k] + (1.0 - w1) * g2[k] for k in g1}
