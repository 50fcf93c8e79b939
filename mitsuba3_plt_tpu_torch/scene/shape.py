"""Host-side triangle meshes (numpy only): the mesh record, the unit
icosphere of the mesh scenes, and Mitsuba's unit rectangle and cube. Same
vertices, faces and normals as the JAX package's `scene/shape.py`
(`HostMesh`, `make_sphere`, `make_rectangle`, `make_cube`)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class HostMesh:
    vertices: np.ndarray                  # [V, 3] f32
    faces: np.ndarray                     # [F, 3] i32
    normals: Optional[np.ndarray] = None  # [V, 3] f32 vertex normals


def _transformed(v, n, to_world):
    """Vertices and (where given) normals under to_world [4, 4] float32,
    as the JAX package's `HostMesh.transformed` computes them."""
    v = (v @ to_world[:3, :3].T + to_world[:3, 3]).astype(np.float32)
    if n is not None:
        n = n @ np.linalg.inv(to_world[:3, :3])  # inverse transpose
        n = (n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True),
                            1e-20)).astype(np.float32)
    return v, n


def make_rectangle(to_world):
    """Mitsuba's unit rectangle ([-1, 1]^2 at z = 0, normal +z) transformed
    by to_world [4, 4] float32: (vertices, faces, normals, uvs)."""
    v = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    n = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    v, n = _transformed(v, n, to_world)
    return v, f, n, uv


def make_cube(to_world):
    """Mitsuba's cube ([-1, 1]^3, four vertices and two faces per side)
    transformed by to_world [4, 4] float32: (vertices, faces, None, None):
    flat shading (face normals) and zero uvs."""
    corners = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                        [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]],
                       np.float32)
    quads = [(0, 3, 2, 1), (4, 5, 6, 7), (0, 1, 5, 4),
             (2, 3, 7, 6), (1, 2, 6, 5), (0, 4, 7, 3)]
    v = corners[np.asarray(quads).reshape(-1)]
    b = 4 * np.arange(6, dtype=np.int32)[:, None]
    f = np.concatenate([b + [0, 1, 2], b + [0, 2, 3]], axis=1).reshape(-1, 3)
    v, _ = _transformed(v, None, to_world)
    return v, f.astype(np.int32), None, None


def make_sphere(subdiv: int = 4) -> HostMesh:
    """Unit icosphere, each subdivision splitting every face in four with
    edge midpoints pushed onto the sphere; smooth normals equal the
    vertices. 20 * 4**subdiv faces."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    f = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    for _ in range(subdiv):
        edge_mid = {}
        verts = list(map(tuple, v))

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                mid = (np.asarray(verts[a]) + np.asarray(verts[b])) / 2
                mid = mid / np.linalg.norm(mid)
                verts.append(tuple(mid))
                edge_mid[key] = len(verts) - 1
            return edge_mid[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.asarray(verts)
        f = np.asarray(nf, np.int64)

    v = v.astype(np.float32)
    return HostMesh(vertices=v, faces=f.astype(np.int32), normals=v.copy())
