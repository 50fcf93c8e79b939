"""Host-side triangle meshes (numpy only): the mesh record and the unit
icosphere of the mesh scenes. Same vertices, faces and normals as the JAX
package's `scene/shape.py::HostMesh` and `make_sphere`."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class HostMesh:
    vertices: np.ndarray                  # [V, 3] f32
    faces: np.ndarray                     # [F, 3] i32
    normals: Optional[np.ndarray] = None  # [V, 3] f32 vertex normals


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
