"""Scene descriptions: a configuration's frozen scene, expanded to plain
data that both sides take.

A configuration file (``configs/<name>.json``) describes its scene as
materials, objects and optional generators:

- a material is ``{"type": "lambertian" | "metal" | "dielectric" |
  "emissive", ...}`` with ``albedo``, ``roughness``, ``ior`` or
  ``emission``;
- an object is a sphere (``radius``), a quad (``width``, ``height``) or a
  mesh (``{"icosphere": level}``), each with a material id and a
  transform ``[scale(3), euler degrees(3), translation(3)]`` or null;
- the generator ``random_balls`` lays out the upstream RANDOM_BALLS
  presets (src/scene.cpp:62-170): balls drawn by an mt19937 stream with
  libstdc++'s float mapping, then the emissive spheres.

``expand`` turns a description into lists of materials and objects (the
meshes as numpy arrays); ``build_program_scene`` hands them to the
renderer's ``Scene`` API, and ``reference.RefScene`` bakes them itself.
The camera of frame k of an orbit is ``orbit_camera``: the eye and the
view direction turned about the world's Y axis through the origin, as
the viewer's orbit turns them.  Nothing here imports the renderer except
``build_program_scene``, which is the harness's call into it.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

MATERIAL_TYPES = ("lambertian", "metal", "dielectric", "emissive")


class MT19937:
    """A 32-bit Mersenne Twister, the stream of std::mt19937."""

    N, M = 624, 397

    def __init__(self, seed: int):
        self.mt = [0] * self.N
        self.mt[0] = seed & 0xFFFFFFFF
        for i in range(1, self.N):
            prev = self.mt[i - 1]
            self.mt[i] = (1812433253 * (prev ^ (prev >> 30)) + i) & 0xFFFFFFFF
        self.index = self.N

    def _twist(self) -> None:
        mt = self.mt
        for i in range(self.N):
            y = (mt[i] & 0x80000000) | (mt[(i + 1) % self.N] & 0x7FFFFFFF)
            mt[i] = mt[(i + self.M) % self.N] ^ (y >> 1)
            if y & 1:
                mt[i] ^= 0x9908B0DF
        self.index = 0

    def next_u32(self) -> int:
        if self.index >= self.N:
            self._twist()
        y = self.mt[self.index]
        self.index += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & 0xFFFFFFFF

    def uniform(self, lo: float = 0.0, hi: float = 1.0) -> float:
        """uniform_real_distribution<float> as libstdc++ draws it: one
        32-bit word, its top 24 bits."""
        u = (self.next_u32() >> 8) * (1.0 / float(1 << 24))
        return lo + (hi - lo) * u


def random_balls(gen: dict) -> Tuple[list, list]:
    """(materials, objects) of the RANDOM_BALLS layout: for each ball its
    radius, x, z, material choice and the material's draws, in the
    preset's draw order; then the emissive spheres at height 8."""
    rng = MT19937(int(gen["mt19937_seed"]))
    area = float(gen["area"])
    r_lo, r_hi = gen["radius"]
    mats, objs = [], []
    for _ in range(int(gen["balls"])):
        radius = rng.uniform(r_lo, r_hi)
        pos = [rng.uniform(-area, area), radius, rng.uniform(-area, area)]
        m = rng.uniform()
        if m < 0.65:
            mats.append({"type": "lambertian",
                         "albedo": [rng.uniform(), rng.uniform(),
                                    rng.uniform()]})
        elif m < 0.9:
            g = 0.7 + 0.3 * rng.uniform()
            mats.append({"type": "metal", "albedo": [g, g, g],
                         "roughness": 0.05 * rng.uniform()})
        else:
            mats.append({"type": "dielectric", "ior": 1.3 + 0.4 * rng.uniform()})
        objs.append({"kind": "sphere", "radius": radius,
                     "material": len(mats) - 1,
                     "transform": [[1, 1, 1], [0, 0, 0], pos]})
    for _ in range(int(gen["lights"])):
        pos = [rng.uniform(-area, area), float(gen["light_height"]),
               rng.uniform(-area, area)]
        e = 10.0 + 10.0 * rng.uniform()
        mats.append({"type": "emissive", "emission": [e, e, e]})
        objs.append({"kind": "sphere", "radius": float(gen["light_radius"]),
                     "material": len(mats) - 1,
                     "transform": [[1, 1, 1], [0, 0, 0], pos]})
    return mats, objs


# --------------------------------------------------------------------------
# meshes
# --------------------------------------------------------------------------

_PHI = (1.0 + 5.0 ** 0.5) / 2.0
_ICO_V = ((-1, _PHI, 0), (1, _PHI, 0), (-1, -_PHI, 0), (1, -_PHI, 0),
          (0, -1, _PHI), (0, 1, _PHI), (0, -1, -_PHI), (0, 1, -_PHI),
          (_PHI, 0, -1), (_PHI, 0, 1), (-_PHI, 0, -1), (-_PHI, 0, 1))
_ICO_F = ((0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
          (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
          (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
          (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1))


def icosphere(level: int):
    """(vertices (V, 3) float32, indices (3F,) uint32, normals (V, 3)
    float32): the unit icosahedron split 1 -> 4 `level` times at
    deduplicated edge midpoints (no smoothing), with area-weighted vertex
    normals, as a PLY of its positions and faces loads."""
    v = np.asarray(_ICO_V, np.float64)
    v = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    v = v.astype(np.float64)
    idx = np.asarray(_ICO_F, np.int64)
    for _ in range(level):
        nv = len(v)
        e = np.concatenate([idx[:, [0, 1]], idx[:, [1, 2]], idx[:, [2, 0]]])
        uniq, inv = np.unique(np.sort(e, axis=1), axis=0, return_inverse=True)
        mid = nv + inv.reshape(3, -1)
        v = np.concatenate([v, (v[uniq[:, 0]] + v[uniq[:, 1]]) * 0.5])
        a, b, c = idx[:, 0], idx[:, 1], idx[:, 2]
        m01, m12, m20 = mid[0], mid[1], mid[2]
        idx = np.concatenate([
            np.stack([a, m01, m20], 1), np.stack([m01, b, m12], 1),
            np.stack([m20, m12, c], 1), np.stack([m01, m12, m20], 1)])
    verts = v.astype(np.float32)
    v64 = verts.astype(np.float64)
    fn = np.cross(v64[idx[:, 1]] - v64[idx[:, 0]], v64[idx[:, 2]] - v64[idx[:, 0]])
    n = np.zeros_like(v64)
    for k in range(3):
        np.add.at(n, idx[:, k], fn)
    lens = np.linalg.norm(n, axis=1, keepdims=True)
    normals = (n / np.maximum(lens, 1e-30)).astype(np.float32)
    return verts, idx.reshape(-1).astype(np.uint32), normals


def _mesh_arrays(spec: dict):
    if set(spec) != {"icosphere"}:
        raise ValueError(f"mesh {spec}: the harness makes {{'icosphere': "
                         f"level}} meshes")
    return icosphere(int(spec["icosphere"]))


def expand(desc: dict) -> Tuple[List[dict], List[dict]]:
    """(materials, objects) of a scene description, generators expanded
    after the listed ones (their material ids offset), each mesh object's
    ``mesh`` replaced by its (vertices, indices, normals) arrays."""
    mats = [dict(m) for m in desc.get("materials", [])]
    objs = [dict(o) for o in desc.get("objects", [])]
    for gen in desc.get("generators", []):
        if gen.get("kind") != "random_balls":
            raise ValueError(f"unknown scene generator {gen.get('kind')!r}")
        gm, go = random_balls(gen)
        base = len(mats)
        mats += gm
        objs += [{**o, "material": o["material"] + base} for o in go]
    for m in mats:
        if m["type"] not in MATERIAL_TYPES:
            raise ValueError(f"material type {m['type']!r}")
    for o in objs:
        if o["kind"] == "mesh":
            o["mesh"] = _mesh_arrays(o["mesh"])
        elif o["kind"] not in ("sphere", "quad"):
            raise ValueError(f"object kind {o['kind']!r}")
    return mats, objs


def transform_spec(t):
    """A JSON transform as the Scene API takes it: None, or (scale,
    euler degrees, translation) tuples."""
    return None if t is None else tuple(tuple(float(x) for x in v) for v in t)


# --------------------------------------------------------------------------
# cameras
# --------------------------------------------------------------------------

def _rot_y(angle_rad: float) -> np.ndarray:
    """The Rodrigues rotation about +Y (the viewer's orbit about the
    world's up axis)."""
    c, s = math.cos(angle_rad), math.sin(angle_rad)
    a = np.array([0.0, 1.0, 0.0])
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return c * np.eye(3) + s * k + (1 - c) * np.outer(a, a)


def orbit_camera(camera: dict, frame: int, step_deg: float):
    """(eye, view) float64 of orbit frame `frame`: the description's eye
    and view vector (look_at - eye, not normalised: the camera normalises
    it) turned by frame x step_deg about +Y through the origin; frame 0
    (or a step of 0) is the camera at rest."""
    eye = np.asarray(camera["eye"], np.float64)
    view = np.asarray(camera["look_at"], np.float64) - eye
    if frame == 0 or step_deg == 0.0:
        return eye, view
    r = _rot_y(math.radians(step_deg * frame))
    return r @ eye, r @ view


# --------------------------------------------------------------------------
# the renderer's side
# --------------------------------------------------------------------------

def build_program_scene(desc: dict, mats, objs):
    """The renderer's ``Scene`` for an expanded description, through its
    builder API (materials first, in id order; then the objects)."""
    from parallelraytracing_tpu_torch.core.mesh import Mesh
    from parallelraytracing_tpu_torch.core.scene import Scene
    scene = Scene(preset=None)
    scene.set_sky(bottom=tuple(desc["sky"]))
    for m in mats:
        kind = m["type"]
        if kind == "lambertian":
            scene.add_lambertian(tuple(m["albedo"]))
        elif kind == "metal":
            scene.add_metal(tuple(m["albedo"]), float(m["roughness"]))
        elif kind == "dielectric":
            scene.add_dielectric(float(m["ior"]))
        else:
            scene.add_emissive(tuple(m["emission"]))
    for o in objs:
        tf = transform_spec(o["transform"])
        if o["kind"] == "sphere":
            scene.add_sphere(float(o["radius"]), o["material"], tf)
        elif o["kind"] == "quad":
            scene.add_quad(float(o["width"]), float(o["height"]),
                           o["material"], tf)
        else:
            v, idx, n = o["mesh"]
            scene.add_mesh(Mesh(v, idx, n), o["material"], tf)
    return scene


def program_camera(eye, view, width: int, height: int):
    """The renderer's ``Camera`` at `eye` looking along `view` for a
    width x height film."""
    from parallelraytracing_tpu_torch.core.camera import Camera
    return Camera(eye, view, float(width), float(height), 100.0)
