"""Host-side triangle meshes (numpy only): the mesh record, the unit
icosphere of the mesh scenes, Mitsuba's unit rectangle and cube, the
tessellated unit disk and open cylinder, and the PLY, OBJ and Mitsuba
.serialized readers (and a .serialized writer). Same vertices, faces,
normals and uvs as the JAX package's `scene/shape.py` (`HostMesh`,
`make_sphere`, `make_rectangle`, `make_cube`, `make_disk`, `make_cylinder`,
`load_ply`, `load_obj`, `load_serialized`, `save_serialized`). Curve files
are not ported (ROADMAP A10): the loaders refuse curve shapes by name."""
from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Optional

import numpy as np


@dataclasses.dataclass
class HostMesh:
    vertices: np.ndarray                  # [V, 3] f32
    faces: np.ndarray                     # [F, 3] i32
    normals: Optional[np.ndarray] = None  # [V, 3] f32 vertex normals
    uvs: Optional[np.ndarray] = None      # [V, 2] f32
    face_normals: bool = False            # shade flat (face normals)
    colors: Optional[np.ndarray] = None   # [V, 3] f32 vertex colours (read,
    # kept through transforms, not rendered: the mesh_attribute texture
    # that reads them is not ported)

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


# ---------------------------------------------------------------------------
# mesh files
# ---------------------------------------------------------------------------

_PLY_TYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def load_ply(path: str) -> HostMesh:
    """A PLY mesh (ascii or binary_little_endian; polygons fan-split into
    triangles): positions, and normals, uvs ((u, v), (s, t) or
    (texture_u, texture_v)) and colours where the file has them."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header\n")
    if end < 0:
        raise ValueError(f"{path}: no PLY end_header")
    header = data[:end].decode("ascii", "replace").splitlines()
    body = data[end + len(b"end_header\n"):]

    fmt = None
    elements = []  # (name, count, [(type, name) | ("list", cnt_t, idx_t, name)])
    for line in header:
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1][2].append(("list", tok[2], tok[3], tok[4]))
            else:
                elements[-1][2].append((tok[1], tok[2]))

    verts = normals = uvs = colors = None
    faces = []
    if fmt == "ascii":
        lines = body.decode("ascii", "replace").split("\n")
        li = 0
        for name, count, props in elements:
            if name == "vertex":
                rows = np.array([lines[li + i].split() for i in range(count)],
                                dtype=np.float64)
                verts, normals, uvs, colors = _vertex_data(
                    rows, [p[1] for p in props])
            elif name == "face":
                for i in range(count):
                    tok = lines[li + i].split()
                    k = int(tok[0])
                    idx = list(map(int, tok[1:1 + k]))
                    faces += [(idx[0], idx[j], idx[j + 1])
                              for j in range(1, k - 1)]
            li += count
    elif fmt == "binary_little_endian":
        off = 0
        for name, count, props in elements:
            if name == "vertex":
                dt = np.dtype([(p[1], "<" + _PLY_TYPES[p[0]][0])
                               for p in props])
                arr = np.frombuffer(body, dtype=dt, count=count, offset=off)
                off += count * dt.itemsize
                cols = [p[1] for p in props]
                rows = np.stack([arr[c].astype(np.float64) for c in cols],
                                axis=-1)
                verts, normals, uvs, colors = _vertex_data(rows, cols)
            elif name == "face":
                faces, off = _ply_binary_faces(body, off, count, props[0])
            else:  # fixed-size elements
                off += count * struct.calcsize(
                    "<" + "".join(_PLY_TYPES[p[0]][0] for p in props))
    else:
        raise ValueError(f"{path}: unsupported PLY format {fmt}")

    def f32(x):
        return None if x is None else np.asarray(x, np.float32)

    return HostMesh(vertices=f32(verts),
                    faces=np.asarray(faces, np.int32).reshape(-1, 3),
                    normals=f32(normals), uvs=f32(uvs), colors=f32(colors))


def _ply_binary_faces(body, off, count, prop):
    """The face list of a binary PLY from byte `off`: (faces, new offset).
    All-triangle lists are read in one go."""
    cnt_fmt, cnt_sz = _PLY_TYPES[prop[1]]
    idx_fmt, idx_sz = _PLY_TYPES[prop[2]]
    stride = cnt_sz + 3 * idx_sz
    if off + count * stride <= len(body):
        dt = np.dtype([("k", "<" + cnt_fmt), ("idx", "<" + idx_fmt, (3,))])
        probe = np.frombuffer(body, dtype=dt, count=count, offset=off)
        if (probe["k"] == 3).all():
            return (probe["idx"].astype(np.int32).reshape(-1, 3),
                    off + count * stride)
    faces = []
    for _ in range(count):
        (k,) = struct.unpack_from("<" + cnt_fmt, body, off)
        off += cnt_sz
        idx = struct.unpack_from("<" + idx_fmt * k, body, off)
        off += idx_sz * k
        faces += [(idx[0], idx[j], idx[j + 1]) for j in range(1, k - 1)]
    return faces, off


def _vertex_data(rows, cols):
    """(positions, normals, uvs, colours) of a PLY vertex table; colours
    above 1 are 8-bit and scaled to [0, 1]."""
    def col(name):
        return rows[:, cols.index(name)]

    verts = np.stack([col("x"), col("y"), col("z")], -1)
    normals = uvs = colors = None
    if "nx" in cols:
        normals = np.stack([col("nx"), col("ny"), col("nz")], -1)
    for uname, vname in (("u", "v"), ("s", "t"), ("texture_u", "texture_v")):
        if uname in cols:
            uvs = np.stack([col(uname), col(vname)], -1)
            break
    if "red" in cols:
        colors = np.stack([col("red"), col("green"), col("blue")], -1)
        if colors.max() > 1.0:
            colors = colors / 255.0
    return verts, normals, uvs, colors


def load_obj(path: str) -> HostMesh:
    """A Wavefront OBJ mesh (polygons fan-split). Normals and uvs indexed
    apart from the positions are gathered per corner: a vertex's normal is
    the normalised sum of its corners', its uv the last corner's."""
    verts, norms, uvs = [], [], []
    fv, fn, ft = [], [], []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "v":
                verts.append(tuple(map(float, tok[1:4])))
            elif tok[0] == "vn":
                norms.append(tuple(map(float, tok[1:4])))
            elif tok[0] == "vt":
                uvs.append(tuple(map(float, tok[1:3])))
            elif tok[0] == "f":
                idx = []
                for t in tok[1:]:
                    parts = t.split("/")
                    vi = int(parts[0])
                    ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
                    ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
                    idx.append((vi, ti, ni))
                for j in range(1, len(idx) - 1):
                    for vi, ti, ni in (idx[0], idx[j], idx[j + 1]):
                        fv.append(vi - 1 if vi > 0 else len(verts) + vi)
                        ft.append(ti - 1 if ti > 0 else -1)
                        fn.append(ni - 1 if ni > 0 else -1)
    v = np.asarray(verts, np.float32)
    faces = np.asarray(fv, np.int32).reshape(-1, 3)
    mesh_normals = mesh_uvs = None
    if norms and all(n >= 0 for n in fn):
        corner = np.asarray(norms, np.float32)[np.asarray(fn).reshape(-1, 3)]
        acc = np.zeros_like(v)
        np.add.at(acc, faces.ravel(), corner.reshape(-1, 3))
        ln = np.linalg.norm(acc, axis=-1, keepdims=True)
        mesh_normals = acc / np.maximum(ln, 1e-20)
    if uvs and all(t >= 0 for t in ft):
        corner = np.asarray(uvs, np.float32)[np.asarray(ft).reshape(-1, 3)]
        mesh_uvs = np.zeros((len(v), 2), np.float32)
        mesh_uvs[faces.ravel()] = corner.reshape(-1, 2)
    return HostMesh(vertices=v, faces=faces, normals=mesh_normals,
                    uvs=mesh_uvs)


# .serialized flags (Mitsuba's src/shapes/serialized.cpp)
_SER_NORMALS, _SER_TEXCOORDS, _SER_COLORS = 0x0001, 0x0002, 0x0008
_SER_FACE_NORMALS, _SER_SINGLE, _SER_DOUBLE = 0x0010, 0x1000, 0x2000
_SER_MAGIC = 0x041C


def load_serialized(path: str, shape_index: int = 0) -> HostMesh:
    """Mesh `shape_index` of a Mitsuba .serialized file (versions 3 and 4:
    a 0x041C header, zlib-compressed mesh streams, a trailing offset
    table), single or double precision, with its normals and uvs (colours
    are skipped)."""
    with open(path, "rb") as f:
        raw = f.read()
    fmt, version = struct.unpack_from("<hh", raw, 0)
    if fmt != _SER_MAGIC:
        raise ValueError(f"{path}: not a .serialized mesh (format {fmt:#x})")
    if version not in (3, 4):
        raise ValueError(f"{path}: unsupported .serialized version {version}")
    start = 4
    if shape_index != 0:
        (count,) = struct.unpack_from("<I", raw, len(raw) - 4)
        if shape_index >= count:
            raise ValueError(
                f"shape_index {shape_index} out of range 0..{count - 1}")
        if version == 4:
            (offset,) = struct.unpack_from(
                "<Q", raw, len(raw) - 8 * (count - shape_index) - 4)
        else:
            (offset,) = struct.unpack_from(
                "<I", raw, len(raw) - 4 * (count - shape_index + 1))
        start = offset + 4  # past the mesh's own copy of the header
    data = zlib.decompress(raw[start:])
    (flags,) = struct.unpack_from("<I", data, 0)
    pos = 4
    if version == 4:  # the mesh's name, null-terminated
        pos = data.index(b"\x00", pos) + 1
    v_count, f_count = struct.unpack_from("<QQ", data, pos)
    pos += 16
    ftype = np.float64 if flags & _SER_DOUBLE else np.float32

    def read_f(n):
        nonlocal pos
        arr = np.frombuffer(data, ftype, n, pos)
        pos += n * arr.itemsize
        return arr.astype(np.float32)

    verts = read_f(v_count * 3).reshape(-1, 3)
    normals = (read_f(v_count * 3).reshape(-1, 3)
               if flags & _SER_NORMALS else None)
    uvs = (read_f(v_count * 2).reshape(-1, 2)
           if flags & _SER_TEXCOORDS else None)
    if flags & _SER_COLORS:
        read_f(v_count * 3)
    faces = np.frombuffer(data, np.uint32, f_count * 3, pos).astype(
        np.int32).reshape(-1, 3)
    return HostMesh(vertices=verts, faces=faces, normals=normals, uvs=uvs,
                    face_normals=bool(flags & _SER_FACE_NORMALS))


def save_serialized(path: str, mesh: HostMesh):
    """Write `mesh` as a one-mesh version-3 .serialized file, single
    precision, with its normals and uvs."""
    flags = _SER_SINGLE
    if mesh.normals is not None:
        flags |= _SER_NORMALS
    if mesh.uvs is not None:
        flags |= _SER_TEXCOORDS
    if mesh.face_normals:
        flags |= _SER_FACE_NORMALS
    body = struct.pack("<I", flags)
    body += struct.pack("<QQ", len(mesh.vertices), len(mesh.faces))
    body += np.asarray(mesh.vertices, np.float32).tobytes()
    if mesh.normals is not None:
        body += np.asarray(mesh.normals, np.float32).tobytes()
    if mesh.uvs is not None:
        body += np.asarray(mesh.uvs, np.float32).tobytes()
    body += np.asarray(mesh.faces, np.uint32).tobytes()
    out = struct.pack("<hh", _SER_MAGIC, 3) + zlib.compress(body)
    out += struct.pack("<I", 0)  # offset of mesh 0
    out += struct.pack("<I", 1)  # mesh count
    with open(path, "wb") as f:
        f.write(out)
