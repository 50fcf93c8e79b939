"""4x4 affine transforms, built on the host in numpy (Mitsuba's
Transform4f composition order: translate/rotate/scale/look_at)."""
from __future__ import annotations

import numpy as np


def translate(v):
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = v
    return t


def scale(v):
    v = np.broadcast_to(np.asarray(v, np.float32), (3,))
    t = np.eye(4, dtype=np.float32)
    t[0, 0], t[1, 1], t[2, 2] = v
    return t


def rotate(axis, angle_deg):
    """Rotation of angle_deg degrees around `axis` (normalized here)."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    s = np.sin(np.deg2rad(angle_deg))
    c = np.cos(np.deg2rad(angle_deg))
    x, y, z = a
    K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    R = np.eye(3) + s * K + (1 - c) * (K @ K)
    t = np.eye(4, dtype=np.float32)
    t[:3, :3] = R.astype(np.float32)
    return t


def look_at(origin, target, up):
    """Camera space +z toward target, +x left, +y up (Mitsuba)."""
    origin = np.asarray(origin, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    d = target - origin
    d = d / np.linalg.norm(d)
    left = np.cross(up / np.linalg.norm(up), d)
    left = left / np.linalg.norm(left)
    new_up = np.cross(d, left)
    t = np.eye(4, dtype=np.float32)
    t[:3, 0] = left
    t[:3, 1] = new_up
    t[:3, 2] = d
    t[:3, 3] = origin
    return t.astype(np.float32)
