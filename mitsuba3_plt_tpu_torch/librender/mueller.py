"""Mueller and Stokes calculus for the polarized render mode.

Layout: one dense tensor with the 4 x 4 block first. A Mueller matrix
is [4, 4, ...] and a Stokes vector [4, ...]; a spectrally valued one is
[4, 4, N, C] (row, column, lane, channel) and [4, N, C], and a per-lane
rotator [4, 4, N, 1] broadcasts over the channels. The lanes and
channels stay the contiguous inner axes, so every step is a coalesced
elementwise kernel: a matrix is built by stacking its 16 entries on a
new first axis, a product is one broadcast multiply and one sum over k
(an outer reduction), a lane select broadcasts its mask [N, 1] over the
block. The block last ([N, C, 4, 4]) cost uncoalesced stores on the H100
for every matrix built (16 entries interleaved), and cuBLAS's batched
4 x 4 product, which splits millions of products into batches of 65,535,
was slower still. The JAX package keeps 16 separate planes with
structural zeros instead (its `MuellerP`), a workaround for XLA's
concatenates; the dense products here also multiply the zeros, which
changes no finite value. `to_lanes` gives the [..., 4, 4] view.

Frame conventions are the JAX package's (`librender/mueller.py`), those
of the reference's `mueller.h`: `stokes_basis(forward)` is the first
vector of `coordinate_system(forward)`, rotations follow Collett's
"Polarized Light", and the specular reflection and transmission use
Verdet's sign of a_p.
"""
from __future__ import annotations

import torch

from ..core import math as m
from ..core.frame import coordinate_system, cross, dot, normalize
from . import fresnel as fr


def _mm(rows):
    """[4, 4, ...] from 16 entries (row-major), broadcast together."""
    flat = torch.broadcast_tensors(*rows)
    return torch.stack(flat).reshape(4, 4, *flat[0].shape)


def to_lanes(M):
    """[4, 4, ...] -> [..., 4, 4] (a view)."""
    return M.movedim((0, 1), (-2, -1))


def identity(batch_shape=(), device=None):
    eye = torch.eye(4, dtype=torch.float32, device=device)
    return eye.reshape(4, 4, *(1,) * len(batch_shape)).expand(
        4, 4, *batch_shape)


def depolarizer(value):
    """[4, 4, ...] with value at (0, 0) and zeros elsewhere."""
    out = torch.zeros((4, 4, *value.shape), dtype=value.dtype,
                      device=value.device)
    out[0, 0] = value
    return out


def rotator(theta):
    """Counter-clockwise rotation of the Stokes reference frame by theta."""
    s, c = torch.sin(2.0 * theta), torch.cos(2.0 * theta)
    o, z = torch.ones_like(s), torch.zeros_like(s)
    return _mm([o, z, z, z,
                z, c, s, z,
                z, -s, c, z,
                z, z, z, o])


def transpose(M):
    return M.transpose(0, 1)


def matmul(A, B):
    """A [i, k, ...] @ B [k, j, ...], the batch axes broadcast."""
    return (A[:, :, None] * B[None]).sum(1)


def apply(M, s):
    """M [4, 4, ...] times the Stokes vector s [4, ...]."""
    return (M * s[None]).sum(1)


def apply_unpolarized(M, value):
    """M times the unpolarized Stokes vector (value, 0, 0, 0): M's first
    column scaled, [4, ...]."""
    return M[:, 0] * value


def where(mask, A, B):
    """Per lane: A where mask [N], else B; A and B [..., N, C]."""
    return torch.where(mask[:, None], A, B)


def _reflection_mueller(a_s, a_p):
    sin_delta, cos_delta = fr.sincos_arg_diff(a_p, a_s)
    r_s = fr.c_abs2(a_s)
    r_p = fr.c_abs2(a_p)
    a = 0.5 * (r_s + r_p)
    b = 0.5 * (r_s - r_p)
    c = m.safe_sqrt(r_s * r_p)
    zero_c = c == 0.0
    sin_delta = torch.where(zero_c, 0.0, sin_delta)
    cos_delta = torch.where(zero_c, 0.0, cos_delta)
    z = torch.zeros_like(a)
    return _mm([a, b, z, z,
                b, a, z, z,
                z, z, c * cos_delta, -c * sin_delta,
                z, z, c * sin_delta, c * cos_delta])


def specular_reflection_dielectric(cos_theta_i, eta):
    a_s, a_p, _, _, _ = fr.fresnel_polarized_dielectric(cos_theta_i, eta)
    return _reflection_mueller(a_s, a_p)


def specular_reflection_conductor(cos_theta_i, eta_re, eta_im):
    a_s, a_p, _, _, _ = fr.fresnel_polarized_conductor(cos_theta_i, eta_re,
                                                       eta_im)
    return _reflection_mueller(a_s, a_p)


def specular_transmission(cos_theta_i, eta):
    """Transmission through a dielectric boundary; a grazing lane (|cos_i|
    <= 1e-8) transmits nothing."""
    a_s, a_p, cos_theta_t, eta_it, eta_ti = fr.fresnel_polarized_dielectric(
        cos_theta_i, eta)
    ok = torch.abs(cos_theta_i) > 1e-8
    factor = -eta_it * torch.where(
        ok, cos_theta_t / torch.where(ok, cos_theta_i, 1.0), 0.0)
    a_s_r = 1.0 + a_s[0]
    a_p_r = (1.0 + a_p[0]) * eta_ti
    t_s = a_s_r * a_s_r
    t_p = a_p_r * a_p_r
    a = 0.5 * factor * (t_s + t_p)
    b = 0.5 * factor * (t_s - t_p)
    c = factor * m.safe_sqrt(t_s * t_p)
    z = torch.zeros_like(a)
    return _mm([a, b, z, z,
                b, a, z, z,
                z, z, c, z,
                z, z, z, c])


# --- Stokes reference frames -------------------------------------------------

def stokes_basis(forward):
    """The implicit Stokes basis of a propagation direction [..., 3]."""
    return coordinate_system(forward)[0]


def rotate_stokes_basis(forward, basis_current, basis_target):
    """Rotator [4, 4, ...] taking Stokes vectors from basis_current to
    basis_target about forward; theta is negative where forward points
    against current x target."""
    theta = m.unit_angle(normalize(basis_current), normalize(basis_target))
    flip = dot(forward, cross(basis_current, basis_target)) < 0
    return rotator(torch.where(flip, -theta, theta))
