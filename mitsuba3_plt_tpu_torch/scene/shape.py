"""Host-side triangle meshes (numpy only): the mesh record, the unit
icosphere of the mesh scenes, Mitsuba's unit rectangle and cube, and the
tessellated unit disk and open cylinder. Same vertices, faces, normals and
uvs as the JAX package's `scene/shape.py` (`HostMesh`, `make_sphere`,
`make_rectangle`, `make_cube`, `make_disk`, `make_cylinder`)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class HostMesh:
    vertices: np.ndarray                  # [V, 3] f32
    faces: np.ndarray                     # [F, 3] i32
    normals: Optional[np.ndarray] = None  # [V, 3] f32 vertex normals
    uvs: Optional[np.ndarray] = None      # [V, 2] f32
    face_normals: bool = False            # shade flat (face normals)

    def transformed(self, to_world) -> "HostMesh":
        """The mesh under to_world [4, 4] float32 (normals by the inverse
        transpose, renormalised)."""
        v, n = _transformed(self.vertices, self.normals, to_world)
        return dataclasses.replace(self, vertices=v, normals=n)

    def soup(self):
        """(vertices, faces, normals or None for flat shading, uvs or None
        for zero uvs): the mesh as `presets._geometry` takes it."""
        return (self.vertices, self.faces,
                None if self.face_normals else self.normals, self.uvs)


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


def make_disk(segments: int = 64) -> HostMesh:
    """The unit disk at z = 0 (normal +z): a centre vertex and a fan of
    `segments` triangles."""
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    rim = np.stack([np.cos(ang), np.sin(ang), np.zeros_like(ang)], -1)
    v = np.concatenate([[[0.0, 0.0, 0.0]], rim]).astype(np.float32)
    f = np.array([[0, 1 + i, 1 + ((i + 1) % segments)]
                  for i in range(segments)], np.int32)
    n = np.tile(np.array([[0, 0, 1]], np.float32), (len(v), 1))
    return HostMesh(vertices=v, faces=f, normals=n)


def make_cylinder(n_seg: int = 64) -> HostMesh:
    """The open cylinder of radius 1 along +z from z = 0 to 1: two rings of
    n_seg vertices, radial normals, uv (angle / 2 pi, z)."""
    ang = np.arange(n_seg) / n_seg * 2.0 * np.pi
    ring = np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    v0 = np.concatenate([ring, np.zeros((n_seg, 1))], axis=-1)
    v1 = np.concatenate([ring, np.ones((n_seg, 1))], axis=-1)
    verts = np.concatenate([v0, v1], axis=0).astype(np.float32)
    faces = []
    for i in range(n_seg):
        j = (i + 1) % n_seg
        faces.append([i, j, n_seg + i])
        faces.append([j, n_seg + j, n_seg + i])
    nrm = np.concatenate([ring, np.zeros((n_seg, 1))], axis=-1)
    normals = np.concatenate([nrm, nrm], axis=0).astype(np.float32)
    uv = np.stack([np.concatenate([ang, ang]) / (2.0 * np.pi),
                   np.concatenate([np.zeros(n_seg), np.ones(n_seg)])],
                  axis=-1).astype(np.float32)
    return HostMesh(vertices=verts, faces=np.asarray(faces, np.int32),
                    normals=normals, uvs=uv)
