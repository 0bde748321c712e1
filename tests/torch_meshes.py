"""Meshes for the port's tests, built with numpy (no PLY files ship with
the repo, and nothing here imports JAX, so the GPU tests can use it on a
machine without it).

Three sizes, one for each walk of the triangle kind: a tetrahedron (4
triangles: a tiny kind, a plain loop), an octahedron (8 triangles, 2
clusters of TRI_CLUSTER: the linear scan) and the icosahedron from its 12
closed-form vertices at level 2 (320 triangles: the threaded SAH tree).
All have their vertices on the unit sphere and outward winding."""

import numpy as np

from parallelraytracing_tpu_torch.core import mesh as tmesh

PHI = (1.0 + 5.0 ** 0.5) / 2.0
ICO_V = ((-1, PHI, 0), (1, PHI, 0), (-1, -PHI, 0), (1, -PHI, 0),
         (0, -1, PHI), (0, 1, PHI), (0, -1, -PHI), (0, 1, -PHI),
         (PHI, 0, -1), (PHI, 0, 1), (-PHI, 0, -1), (-PHI, 0, 1))
ICO_F = ((0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
         (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
         (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
         (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1))
OCTA_V = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1))
OCTA_F = ((0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4),
          (2, 0, 5), (1, 2, 5), (3, 1, 5), (0, 3, 5))
TETRA_V = ((1, 1, 1), (1, -1, -1), (-1, 1, -1), (-1, -1, 1))
TETRA_F = ((0, 1, 2), (0, 3, 1), (0, 2, 3), (1, 3, 2))
#: the three triangle kinds: tiny (plain loop), linear scan, SAH tree
MESHES = {"tetra": (TETRA_V, TETRA_F, 0), "octa": (OCTA_V, OCTA_F, 0),
          "ico2": (ICO_V, ICO_F, 2)}


def make_mesh(name: str) -> tmesh.Mesh:
    """The named mesh, vertices on the unit sphere, outward winding."""
    verts, faces, level = MESHES[name]
    v = np.asarray(verts, np.float64)
    v = v / np.linalg.norm(v, axis=1, keepdims=True)
    f = np.asarray(faces, np.int64)
    cross = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    assert ((cross * v[f].mean(1)).sum(1) > 0).all()  # outward
    return tmesh.subdivide(tmesh.Mesh(v.astype(np.float32),
                                      f.reshape(-1).astype(np.uint32)), level)


def write_ply(path, mesh, fmt: str = "binary", normals: bool = False) -> str:
    """Write `mesh` as a PLY (numpy only): positions, optional normals,
    faces as uchar-counted int lists."""
    props = ["x", "y", "z"] + (["nx", "ny", "nz"] if normals else [])
    cols = [mesh.vertices] + ([mesh.normals] if normals else [])
    vert = np.concatenate(cols, axis=1).astype(np.float32)
    header = ("ply\nformat " + ("ascii" if fmt == "ascii"
                                else "binary_little_endian") + " 1.0\n"
              f"element vertex {len(vert)}\n"
              + "".join(f"property float {p}\n" for p in props)
              + f"element face {mesh.num_triangles}\n"
              "property list uchar int vertex_indices\nend_header\n")
    idx = mesh.indices.reshape(-1, 3)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if fmt == "ascii":
            for row in vert:
                f.write((" ".join(repr(float(x)) for x in row) + "\n").encode())
            for tri in idx:
                f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n".encode())
        else:
            faces = np.zeros(len(idx), [("n", "u1"), ("i", "<i4", (3,))])
            faces["n"] = 3
            faces["i"] = idx
            f.write(vert.astype("<f4").tobytes())
            f.write(faces.tobytes())
    return str(path)


def mesh_ply(tmp_path, name: str) -> str:
    return write_ply(tmp_path / f"{name}.ply", make_mesh(name))
