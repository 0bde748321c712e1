"""Meshes and instanced scenes for the port's tests, built with numpy (no
PLY files ship with the repo, and nothing here imports JAX, so the GPU
tests can use it on a machine without it).

Three sizes, one for each walk of the triangle kind: a tetrahedron (4
triangles: a tiny kind, a plain loop), an octahedron (8 triangles, 2
clusters of TRI_CLUSTER: the linear scan) and the icosahedron from its 12
closed-form vertices at level 2 (320 triangles: the threaded SAH tree).
All have their vertices on the unit sphere and outward winding.  The
textured scenes give a mesh equirectangular texture coordinates
(``with_equirect_uv``) and take their images from the port's
``texture_demo`` recipes (``plaid_image``, ``globe_image``)."""

import numpy as np
import torch

from parallelraytracing_tpu_torch.core import mesh as tmesh
from parallelraytracing_tpu_torch.core.mesh import ICO_F, ICO_V  # noqa: F401

# One PyTorch thread a test process.  The suite runs in several worker
# processes (pytest-xdist), each of which would start an OpenMP thread a
# core; on a machine of a few cores the workers' threads then spin in
# each other's way, and a plain-version test that takes 0.2 s alone took
# 87 s among six workers.  Every worker imports this module when it
# collects the port's tests.
torch.set_num_threads(1)

OCTA_V = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1))
OCTA_F = ((0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4),
          (2, 0, 5), (1, 2, 5), (3, 1, 5), (0, 3, 5))
TETRA_V = ((1, 1, 1), (1, -1, -1), (-1, 1, -1), (-1, -1, 1))
TETRA_F = ((0, 1, 2), (0, 3, 1), (0, 2, 3), (1, 3, 2))
#: the three triangle kinds: tiny (plain loop), linear scan, SAH tree
#: (the icosahedron at level 1, 80 triangles, is a tree too)
MESHES = {"tetra": (TETRA_V, TETRA_F, 0), "octa": (OCTA_V, OCTA_F, 0),
          "ico1": (ICO_V, ICO_F, 1), "ico2": (ICO_V, ICO_F, 2)}


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


def tlas_scene(scene_cls, mesh, instanced: bool = True):
    """The layout of tests/test_tlas.py around `mesh`, built with either
    package's Scene class: three red instances turned 30 degrees apart
    and one metal instance at twice the size, over a 30x30 ground quad,
    under an emissive sphere.  ``instanced=False`` bakes the same
    transforms with add_mesh."""
    s = scene_cls(preset=None)
    red = s.add_lambertian((0.9, 0.2, 0.2))
    metal = s.add_metal((0.9, 0.9, 0.9), 0.05)
    tr_red = [((1, 1, 1), (0, 30 * i, 0), (i * 3.0 - 3.0, 1, 0))
              for i in range(3)]
    tr_metal = [((2, 2, 2), (0, 0, 45), (0, 2, -4))]
    _place(s, mesh, red, tr_red, instanced)
    _place(s, mesh, metal, tr_metal, instanced)
    s.add_quad(30, 30, s.add_lambertian((0.5, 0.5, 0.5)), None)
    s.add_sphere(1.0, s.add_emissive((10, 10, 10)),
                 ((1, 1, 1), (0, 0, 0), (4, 8, 4)))
    return s


def two_mesh_scene(scene_cls, small, big, instanced: bool = True):
    """Two unique meshes, each instanced twice (a glass and a diffuse
    copy of `small`, two diffuse copies of `big`), over a ground quad with
    a quad light and a sphere light, one flat sphere beside them."""
    s = scene_cls(preset=None)
    glass = s.add_dielectric(1.5)
    red = s.add_lambertian((0.8, 0.15, 0.1))
    body = s.add_lambertian((0.7, 0.6, 0.45))
    _place(s, small, glass, [((1.5,) * 3, (0, 30, 0), (2.5, 1.5, 1.0))],
           instanced)
    _place(s, big, body, [((2, 2, 2), (0, 160, 0), (-1.5, 2, -1)),
                          ((1, 1, 1), (0, 40, 0), (-4, 1, 2))], instanced)
    _place(s, small, red, [((1,) * 3, (30, 0, 0), (1, 1, 3.5))], instanced)
    s.add_sphere(0.8, s.add_metal((0.9, 0.9, 0.9), 0.1),
                 ((1, 1, 1), (0, 0, 0), (4, 0.8, -2)))
    s.add_quad(30, 30, s.add_lambertian((0.5, 0.5, 0.52)), None)
    s.add_quad(4, 4, s.add_emissive((6, 6, 6)),
               ((1, 1, 1), (180, 0, 0), (0, 9, 0)))
    s.add_sphere(1.5, s.add_emissive((9, 9, 8)),
                 ((1, 1, 1), (0, 0, 0), (6, 9, 6)))
    return s


def _place(scene, mesh, mat, transforms, instanced):
    if instanced:
        scene.add_mesh_instances(mesh, mat, transforms)
    else:
        for t in transforms:
            scene.add_mesh(mesh, mat, t)


def with_equirect_uv(mesh: tmesh.Mesh) -> tmesh.Mesh:
    """`mesh` (vertices on the unit sphere) with per-vertex texture
    coordinates u = 0.5 + atan2(z, x) / 2 pi, v = 0.5 + asin(y) / pi."""
    v = mesh.vertices.astype(np.float64)
    v = v / np.linalg.norm(v, axis=1, keepdims=True)
    uv = np.stack([0.5 + np.arctan2(v[:, 2], v[:, 0]) / (2.0 * np.pi),
                   0.5 + np.arcsin(np.clip(v[:, 1], -1.0, 1.0)) / np.pi], 1)
    return tmesh.Mesh(mesh.vertices, mesh.indices, mesh.normals,
                      uv.astype(np.float32))


def stream_scene(scene_cls, mesh, image=None):
    """tests/test_stream.py's scene around `mesh`: a red mesh scaled 2,
    turned 20 degrees and lifted 2, over a 30x30 ground quad, under an
    emissive sphere.  With `image` the mesh is in that image texture at
    its equirectangular texture coordinates (the 33-row triangle table)."""
    s = scene_cls(preset=None)
    if image is None:
        body = s.add_lambertian((0.8, 0.2, 0.1))
    else:
        body = s.add_textured_lambertian(s.add_texture(image))
        mesh = with_equirect_uv(mesh)
    s.add_mesh(mesh, body, ((2.0,) * 3, (0, 20, 0), (0, 2, 0)))
    s.add_quad(30, 30, s.add_lambertian((0.5, 0.5, 0.55)), None)
    s.add_sphere(2.0, s.add_emissive((9, 9, 8)),
                 ((1, 1, 1), (0, 0, 0), (6, 10, 6)))
    return s


def image_scene(scene_cls, image):
    """bench.py's textured fidelity scene (a 6x6 image quad tilted 60
    degrees over a 40x40 ground quad, sky-lit) with the 16x16 image of
    bench's recipe replaced by `image`, plus an image-textured triangle
    with explicit texture coordinates and a small emissive sphere (so NEE
    reads the textured albedo)."""
    s = scene_cls(preset=None)
    tm = s.add_textured_lambertian(s.add_texture(image))
    s.add_quad(6, 6, tm, ((1, 1, 1), (60, 0, 0), (0, 4, -4)))
    s.add_quad(40, 40, s.add_lambertian((0.5, 0.5, 0.52)), None)
    s.add_triangle((-5.0, 0.5, 1.0), (-1.0, 0.5, 2.0), (-3.0, 4.5, 0.0),
                   material=tm, uv0=(0.0, 0.0), uv1=(1.5, 0.0),
                   uv2=(0.7, 1.25))
    s.add_sphere(0.6, s.add_emissive((8, 8, 7)),
                 ((1, 1, 1), (0, 0, 0), (3, 5, 2)))
    return s


def bench_image() -> np.ndarray:
    """bench.py's 16x16 test image of its textured fidelity scene."""
    yy, xx = np.mgrid[0:16, 0:16]
    return np.stack([(xx % 8) / 7.0, (yy % 8) / 7.0,
                     ((xx + yy) % 16) / 15.0], axis=-1)


def textured_sphere_scene(scene_cls, image):
    """A globe: an image-textured sphere turned 25 degrees, a checker
    floor, a plain sphere inside the view, under an emissive sphere."""
    s = scene_cls(preset=None)
    s.add_quad(30, 30, s.add_checker((0.8, 0.8, 0.8), (0.1, 0.2, 0.3),
                                     scale=0.7), None)
    s.add_sphere(1.6, s.add_textured_lambertian(s.add_texture(image)),
                 ((1, 1, 1), (0, 25, 0), (0.0, 1.6, 0.0)))
    s.add_sphere(0.8, s.add_metal((0.9, 0.8, 0.7), 0.1),
                 ((1, 1, 1), (0, 0, 0), (2.6, 0.8, 1.0)))
    s.add_sphere(1.0, s.add_emissive((7, 7, 6)),
                 ((1, 1, 1), (0, 0, 0), (-3, 6, 3)))
    return s


def checker_scene(scene_cls):
    """A checker floor and a checker sphere (two checker materials) with a
    glass and a diffuse sphere, under an emissive sphere and the constant
    sky."""
    s = scene_cls(preset=None)
    s.add_quad(40, 40, s.add_checker((0.85, 0.85, 0.85), (0.12, 0.15, 0.2),
                                     scale=0.8), None)
    s.add_sphere(1.2, s.add_checker((0.9, 0.3, 0.2), (0.2, 0.3, 0.9),
                                    scale=2.5),
                 ((1, 1, 1), (0, 0, 0), (-1.5, 1.2, 0.0)))
    s.add_sphere(1.0, s.add_dielectric(1.5), ((1, 1, 1), (0, 0, 0),
                                               (1.5, 1.0, 1.0)))
    s.add_sphere(0.7, s.add_lambertian((0.3, 0.7, 0.3)),
                 ((1, 1, 1), (0, 0, 0), (0.5, 0.7, -2.0)))
    s.add_sphere(1.5, s.add_emissive((6, 6, 6)), ((1, 1, 1), (0, 0, 0),
                                                  (0, 9, 0)))
    return s


def textured_instance_scene(scene_cls, small, big, image,
                            instanced: bool = True):
    """two_mesh_scene's layout with the big mesh's two copies in an image
    texture (both meshes carry equirectangular texture coordinates)."""
    s = scene_cls(preset=None)
    glass = s.add_dielectric(1.5)
    red = s.add_lambertian((0.8, 0.15, 0.1))
    body = s.add_textured_lambertian(s.add_texture(image))
    small, big = with_equirect_uv(small), with_equirect_uv(big)
    _place(s, small, glass, [((1.5,) * 3, (0, 30, 0), (2.5, 1.5, 1.0))],
           instanced)
    _place(s, big, body, [((2, 2, 2), (0, 160, 0), (-1.5, 2, -1)),
                          ((1, 1, 1), (0, 40, 0), (-4, 1, 2))], instanced)
    _place(s, small, red, [((1,) * 3, (30, 0, 0), (1, 1, 3.5))], instanced)
    s.add_quad(30, 30, s.add_lambertian((0.5, 0.5, 0.52)), None)
    s.add_sphere(1.5, s.add_emissive((9, 9, 8)),
                 ((1, 1, 1), (0, 0, 0), (6, 9, 6)))
    return s
