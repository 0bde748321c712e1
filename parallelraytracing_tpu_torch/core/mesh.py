"""Triangle meshes: the PLY reader, vertex normals and midpoint subdivision.

The counterpart of ``parallelraytracing_tpu.core.mesh`` (host, numpy).
``load_ply`` reads ascii and binary_little_endian PLY with the pure-Python
reader only: the JAX package's native C++ parser (``native/``) is not in
this port (ROADMAP Queue 1 item 2), and nothing here tries to load it.
The arrays are the JAX package's, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from parallelraytracing_tpu_torch import native

_PLY_TYPES = {
    "char": ("i1", 1), "int8": ("i1", 1),
    "uchar": ("u1", 1), "uint8": ("u1", 1),
    "short": ("i2", 2), "int16": ("i2", 2),
    "ushort": ("u2", 2), "uint16": ("u2", 2),
    "int": ("i4", 4), "int32": ("i4", 4),
    "uint": ("u4", 4), "uint32": ("u4", 4),
    "float": ("f4", 4), "float32": ("f4", 4),
    "double": ("f8", 8), "float64": ("f8", 8),
}


@dataclasses.dataclass
class Mesh:
    vertices: np.ndarray                    # (V,3) f32
    indices: np.ndarray                     # (F*3,) u32
    normals: Optional[np.ndarray] = None    # (V,3) f32
    texcoords: Optional[np.ndarray] = None  # (V,2) f32

    @property
    def num_vertices(self) -> int:
        return len(self.vertices)

    @property
    def num_triangles(self) -> int:
        return len(self.indices) // 3

    def compute_vertex_normals(self) -> None:
        """Area-weighted vertex normals for meshes without them."""
        v = self.vertices.astype(np.float64)
        idx = self.indices.reshape(-1, 3)
        fn = np.cross(v[idx[:, 1]] - v[idx[:, 0]], v[idx[:, 2]] - v[idx[:, 0]])
        n = np.zeros_like(v)
        for k in range(3):
            np.add.at(n, idx[:, k], fn)
        lens = np.linalg.norm(n, axis=1, keepdims=True)
        self.normals = (n / np.maximum(lens, 1e-30)).astype(np.float32)


def subdivide(mesh: Mesh, levels: int = 1) -> Mesh:
    """Midpoint 1->4 triangle subdivision (no smoothing): each edge gains
    one deduplicated midpoint vertex; normals and texcoords are the plain
    average of the edge's ends (the shading path normalises the
    interpolated normal anyway)."""
    v = mesh.vertices.astype(np.float64)
    n = (mesh.normals.astype(np.float64)
         if mesh.normals is not None else None)
    t = (mesh.texcoords.astype(np.float64)
         if mesh.texcoords is not None else None)
    idx = mesh.indices.reshape(-1, 3).astype(np.int64)
    for _ in range(levels):
        nv = len(v)
        e = np.concatenate([idx[:, [0, 1]], idx[:, [1, 2]], idx[:, [2, 0]]])
        uniq, inv = np.unique(np.sort(e, axis=1), axis=0, return_inverse=True)
        mid = nv + inv.reshape(3, -1)       # (3, F): m01, m12, m20
        v = np.concatenate([v, (v[uniq[:, 0]] + v[uniq[:, 1]]) * 0.5])
        if n is not None:
            n = np.concatenate([n, (n[uniq[:, 0]] + n[uniq[:, 1]]) * 0.5])
        if t is not None:
            t = np.concatenate([t, (t[uniq[:, 0]] + t[uniq[:, 1]]) * 0.5])
        a, b, c = idx[:, 0], idx[:, 1], idx[:, 2]
        m01, m12, m20 = mid[0], mid[1], mid[2]
        idx = np.concatenate([
            np.stack([a, m01, m20], 1), np.stack([m01, b, m12], 1),
            np.stack([m20, m12, c], 1), np.stack([m01, m12, m20], 1)])
    return Mesh(vertices=v.astype(np.float32),
                indices=idx.reshape(-1).astype(np.uint32),
                normals=None if n is None else n.astype(np.float32),
                texcoords=None if t is None else t.astype(np.float32))


_PHI = (1.0 + 5.0 ** 0.5) / 2.0
#: the regular icosahedron: 12 closed-form vertices (0, +-1, +-phi) and
#: cyclic permutations, 20 faces wound counter-clockwise seen from outside
ICO_V = ((-1, _PHI, 0), (1, _PHI, 0), (-1, -_PHI, 0), (1, -_PHI, 0),
         (0, -1, _PHI), (0, 1, _PHI), (0, -1, -_PHI), (0, 1, -_PHI),
         (_PHI, 0, -1), (_PHI, 0, 1), (-_PHI, 0, -1), (-_PHI, 0, 1))
ICO_F = ((0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
         (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
         (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
         (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1))


def icosphere(level: int) -> Mesh:
    """The icosahedron, vertices on the unit sphere, subdivided `level`
    times (20 x 4 ** level triangles), with area-weighted vertex normals:
    the mesh a PLY of its positions and faces loads as (``load_ply``
    computes the same normals)."""
    v = np.asarray(ICO_V, np.float64)
    v = v / np.linalg.norm(v, axis=1, keepdims=True)
    mesh = subdivide(Mesh(v.astype(np.float32),
                          np.asarray(ICO_F, np.uint32).reshape(-1)), level)
    mesh.compute_vertex_normals()
    return mesh


def write_ply(path: str, mesh: Mesh) -> int:
    """Write `mesh`'s positions and faces as a binary little-endian PLY
    (``load_ply`` computes the smooth vertex normals again).  Returns the
    triangle count."""
    faces = np.zeros(mesh.num_triangles, [("n", "u1"), ("i", "<i4", (3,))])
    faces["n"] = 3
    faces["i"] = mesh.indices.reshape(-1, 3)
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {mesh.num_vertices}\n"
              "property float x\nproperty float y\nproperty float z\n"
              f"element face {mesh.num_triangles}\n"
              "property list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(mesh.vertices.astype("<f4").tobytes())
        f.write(faces.tobytes())
    return mesh.num_triangles


def _parse_header(data: bytes, path: str):
    end = data.find(b"end_header")
    if end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    nl = data.find(b"\n", end)
    fmt = None
    elements: List[Tuple[str, int, List]] = []  # (name, count, props)
    for line in data[:nl].decode("ascii", errors="replace").splitlines():
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
                elements[-1][2].append(("scalar", tok[1], tok[2]))
    if fmt not in ("ascii", "binary_little_endian"):
        raise ValueError(f"{path}: unsupported PLY format {fmt}")
    return fmt, elements, data[nl + 1:]


def _parse_ascii(body: bytes, elements) -> Dict[str, Dict[str, np.ndarray]]:
    text = body.decode("ascii").split()
    pos = 0
    parsed = {}
    for name, count, props in elements:
        cols: Dict[str, List] = {p[-1] if p[0] == "scalar" else p[3]: []
                                 for p in props}
        for _ in range(count):
            for p in props:
                if p[0] == "scalar":
                    cols[p[2]].append(float(text[pos]))
                    pos += 1
                else:
                    k = int(text[pos])
                    pos += 1
                    cols[p[3]].append([float(text[pos + i]) for i in range(k)])
                    pos += k
        parsed[name] = {k: np.asarray(v) for k, v in cols.items()}
    return parsed


def _read_list(body: bytes, pos: int, cnt_t: str, val_t: str):
    cdt, csz = _PLY_TYPES[cnt_t]
    vdt, vsz = _PLY_TYPES[val_t]
    k = int(np.frombuffer(body, "<" + cdt, 1, pos)[0])
    pos += csz
    return np.frombuffer(body, "<" + vdt, k, pos), pos + k * vsz


def _parse_binary(body: bytes, elements) -> Dict[str, Dict[str, np.ndarray]]:
    pos = 0
    parsed = {}
    for name, count, props in elements:
        if all(p[0] == "scalar" for p in props):
            # fixed stride: one structured decode
            dtypes = [(p[2], "<" + _PLY_TYPES[p[1]][0]) for p in props]
            arr = np.frombuffer(body, dtype=np.dtype(dtypes), count=count,
                                offset=pos)
            pos += arr.dtype.itemsize * count
            parsed[name] = {p[2]: arr[p[2]] for p in props}
        elif len(props) == 1:
            # one list property (faces): vectorised when every row has the
            # arity of the first
            _, cnt_t, val_t, pname = props[0]
            cdt, csz = _PLY_TYPES[cnt_t]
            vdt, vsz = _PLY_TYPES[val_t]
            first_n = int(np.frombuffer(body, "<" + cdt, 1, pos)[0])
            row = csz + first_n * vsz
            blob = np.frombuffer(body, np.uint8, count * row, pos)
            counts = (blob.reshape(count, row)[:, :csz].copy()
                      .view("<" + cdt).ravel())
            if np.all(counts == first_n):
                vals = (blob.reshape(count, row)[:, csz:].copy()
                        .view("<" + vdt).reshape(count, first_n))
                parsed[name] = {pname: vals}
                pos += count * row
            else:
                rows = []
                for _ in range(count):
                    vals, pos = _read_list(body, pos, cnt_t, val_t)
                    rows.append(vals)
                parsed[name] = {pname: rows}
        else:
            # mixed scalar + list element: per-row decode
            cols: Dict[str, List] = {p[-1]: [] for p in props}
            for _ in range(count):
                for p in props:
                    if p[0] == "scalar":
                        dt, sz = _PLY_TYPES[p[1]]
                        cols[p[2]].append(np.frombuffer(body, "<" + dt, 1, pos)[0])
                        pos += sz
                    else:
                        vals, pos = _read_list(body, pos, p[1], p[2])
                        cols[p[3]].append(vals)
            parsed[name] = {k: np.asarray(v) for k, v in cols.items()}
    return parsed


def load_ply(path: str, prefer_native: bool = True) -> Mesh:
    """Load a PLY mesh (ascii or binary_little_endian): positions, optional
    per-vertex normals (computed when absent) and texcoords, and triangle
    indices (polygons fan-triangulated).  Read by the native C++ reader
    when it builds (native.py), else by the Python reader below, the
    reference semantics."""
    if prefer_native and native.available():
        v, n, uv, idx = native.load_ply(path)
        mesh = Mesh(vertices=v, indices=idx, normals=n, texcoords=uv)
        if mesh.normals is None and mesh.num_triangles:
            mesh.compute_vertex_normals()
        return mesh
    return _load_ply_python(path)


def _load_ply_python(path: str) -> Mesh:
    with open(path, "rb") as f:
        data = f.read()
    fmt, elements, body = _parse_header(data, path)
    parsed = (_parse_ascii if fmt == "ascii" else _parse_binary)(body, elements)

    vtx = parsed.get("vertex")
    if vtx is None or "x" not in vtx:
        raise ValueError(f"{path}: no vertex element")
    vertices = np.stack([vtx["x"], vtx["y"], vtx["z"]], axis=1).astype(np.float32)
    normals = None
    if all(k in vtx for k in ("nx", "ny", "nz")):
        normals = np.stack([vtx["nx"], vtx["ny"], vtx["nz"]],
                           axis=1).astype(np.float32)
    texcoords = None
    for ku, kv in (("u", "v"), ("s", "t")):
        if ku in vtx and kv in vtx:
            texcoords = np.stack([vtx[ku], vtx[kv]], axis=1).astype(np.float32)
            break

    face = parsed.get("face", {})
    idx_raw = face.get("vertex_indices", face.get("vertex_index"))
    if idx_raw is None:
        indices = np.zeros((0,), np.uint32)
    else:
        idx = np.asarray(idx_raw)
        if idx.ndim == 2 and idx.shape[1] == 3:
            indices = idx.astype(np.uint32).ravel()
        else:  # fan-triangulate polygons
            tris = []
            for poly in idx_raw:
                poly = np.asarray(poly, dtype=np.uint32)
                for i in range(1, len(poly) - 1):
                    tris.extend([poly[0], poly[i], poly[i + 1]])
            indices = np.asarray(tris, dtype=np.uint32)

    mesh = Mesh(vertices=vertices, indices=indices, normals=normals,
                texcoords=texcoords)
    if mesh.normals is None and mesh.num_triangles:
        mesh.compute_vertex_normals()
    return mesh
