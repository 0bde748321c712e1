"""Scene model: builder API, preset scenes, and the flat device representation.

The counterpart of ``parallelraytracing_tpu.core.scene``.  A scene compiles
once into flat struct-of-array tensors indexed by integer ids (``SceneData``,
on the device the caller names).  Primitives are baked to world space like
the reference's OptiX backend (spheres to center + scaled radius, quads to
center + half-extent edge vectors + unit normal, triangles to world-space
vertices and normals), and materials flatten into one table {type, albedo,
roughness, ior, emission}.

The seven reference presets are replicated, including the mt19937(1337)
layout of the RANDOM_BALLS variants, so ``build()`` gives the same arrays
as the JAX package; ``add_mesh`` and ``ply_showcase_scene`` give its mesh
scenes.  Sky models, textures and instances are not in this port yet and
raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from parallelraytracing_tpu_torch.config import DEFAULT_SKY
from parallelraytracing_tpu_torch.core import geometry as geo
from parallelraytracing_tpu_torch.core.host_rng import UniformSceneRng

# Material type codes (order matches the reference MatType enum).
MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_EMISSIVE = 3

_SCENE_EXTENSIONS = "ROADMAP Queue 1 item 11 (scene extensions)"


class ScenePreset(enum.Enum):
    """The reference's preset enum (src/core/scene.h:6-20) plus the JAX
    package's two extension demos, which need features this port does
    not have yet (building them raises)."""

    DEFAULT = "default"
    LIGHT_TEST = "light_test"
    MATERIAL_TEST = "material_test"
    CORNELL = "cornell"
    RANDOM_BALLS_SMALL = "random_balls_small"
    RANDOM_BALLS_MEDIUM = "random_balls_medium"
    RANDOM_BALLS_LARGE = "random_balls_large"
    TEXTURE_DEMO = "texture_demo"
    SKY_DEMO = "sky_demo"


@dataclasses.dataclass(frozen=True)
class SceneData:
    """Flat scene on one device.  Empty categories are padded with one
    inert element and masked via ``*_valid``; float fields are float32,
    ids int32, flags bool — the JAX package's dtypes."""

    sph_center: torch.Tensor  # (Ns,3)
    sph_radius: torch.Tensor  # (Ns,)
    sph_mat: torch.Tensor     # (Ns,) i32
    sph_valid: torch.Tensor   # (Ns,) bool

    quad_center: torch.Tensor  # (Nq,3)
    quad_u: torch.Tensor       # (Nq,3) half width edge
    quad_v: torch.Tensor       # (Nq,3) half height edge
    quad_normal: torch.Tensor  # (Nq,3) unit
    quad_mat: torch.Tensor     # (Nq,)
    quad_valid: torch.Tensor   # (Nq,)

    tri_v0: torch.Tensor  # (Nt,3)
    tri_v1: torch.Tensor
    tri_v2: torch.Tensor
    tri_n0: torch.Tensor
    tri_n1: torch.Tensor
    tri_n2: torch.Tensor
    tri_mat: torch.Tensor    # (Nt,)
    tri_valid: torch.Tensor  # (Nt,)

    mat_type: torch.Tensor    # (Nm,) i32
    mat_albedo: torch.Tensor  # (Nm,3)
    mat_rough: torch.Tensor   # (Nm,)
    mat_ior: torch.Tensor     # (Nm,)
    mat_emit: torch.Tensor    # (Nm,3)

    sky: torch.Tensor  # (3,)

    def numpy(self) -> dict:
        """Every field as a host numpy array, keyed by field name."""
        return {f.name: getattr(self, f.name).cpu().numpy()
                for f in dataclasses.fields(self)}


TransformSpec = Union[np.ndarray, Tuple, None]


def _resolve_transform(transform: TransformSpec) -> np.ndarray:
    if transform is None:
        return np.eye(4)
    if isinstance(transform, np.ndarray):
        return transform
    scale, euler_deg, translation = transform
    return geo.make_transform(scale, euler_deg, translation)


class Scene:
    """Mutable scene builder; ``build(device)`` compiles to SceneData."""

    def __init__(self, preset: Optional[ScenePreset] = ScenePreset.RANDOM_BALLS_LARGE):
        self._mat_type: List[int] = []
        self._mat_albedo: List[np.ndarray] = []
        self._mat_rough: List[float] = []
        self._mat_ior: List[float] = []
        self._mat_emit: List[np.ndarray] = []

        self._sph: List[Tuple[np.ndarray, float, int]] = []
        self._quad: List[Tuple] = []
        self._tri: List[Tuple] = []

        # Set per preset but never consumed by the reference backends
        # (they hardcode the sky); use_sky_intensity=True honors it.
        self.sky_light_intensity = 1.0
        self.use_sky_intensity = False
        self.sky_color = np.array(DEFAULT_SKY, dtype=np.float64)

        if preset is not None:
            _PRESET_BUILDERS[preset](self)

    # ------------------------------------------------ not in this port yet
    def set_sky(self, *args, **kw) -> None:
        raise NotImplementedError(
            f"Scene.set_sky (gradient + sun sky): {_SCENE_EXTENSIONS}")

    def add_checker(self, *args, **kw) -> int:
        raise NotImplementedError(
            f"Scene.add_checker (procedural texture): {_SCENE_EXTENSIONS}")

    def add_texture(self, *args, **kw) -> int:
        raise NotImplementedError(
            f"Scene.add_texture (image texture): {_SCENE_EXTENSIONS}")

    def add_textured_lambertian(self, *args, **kw) -> int:
        raise NotImplementedError(
            f"Scene.add_textured_lambertian: {_SCENE_EXTENSIONS}")

    def add_mesh_instances(self, *args, **kw) -> None:
        raise NotImplementedError(
            "Scene.add_mesh_instances: ROADMAP Queue 1 item 10 (instancing)")

    # ------------------------------------------------------------ materials
    def _add_material(self, mtype: int, albedo=(0, 0, 0), rough=0.0,
                      ior=1.0, emit=(0, 0, 0)) -> int:
        self._mat_type.append(mtype)
        self._mat_albedo.append(np.asarray(albedo, dtype=np.float64))
        self._mat_rough.append(float(rough))
        self._mat_ior.append(float(ior))
        self._mat_emit.append(np.asarray(emit, dtype=np.float64))
        return len(self._mat_type) - 1

    def add_lambertian(self, albedo) -> int:
        return self._add_material(MAT_LAMBERTIAN, albedo=albedo)

    def add_metal(self, albedo, roughness: float) -> int:
        return self._add_material(MAT_METAL, albedo=albedo, rough=roughness)

    def add_dielectric(self, refraction_index: float) -> int:
        return self._add_material(MAT_DIELECTRIC, ior=refraction_index)

    def add_emissive(self, emission) -> int:
        return self._add_material(MAT_EMISSIVE, emit=emission)

    # ----------------------------------------------------------- primitives
    def add_sphere(self, radius: float, material: int,
                   transform: TransformSpec = None) -> None:
        """Reference 'Circle' shape (shape.h:17-29) baked to world space."""
        m = _resolve_transform(transform)
        scale = geo.uniform_scale_of(m)
        center = geo.transform_point(m, (0.0, 0.0, 0.0))
        self._sph.append((center, float(radius) * scale, material))

    def add_quad(self, width: float, height: float, material: int,
                 transform: TransformSpec = None) -> None:
        """Local y=0 plane, x in [-w/2,w/2], z in [-h/2,h/2], normal +Y
        (shape.h:31-47)."""
        m = _resolve_transform(transform)
        inv = np.linalg.inv(m)
        center = geo.transform_point(m, (0.0, 0.0, 0.0))
        u = geo.transform_point(m, (width / 2.0, 0.0, 0.0)) - center
        v = geo.transform_point(m, (0.0, 0.0, height / 2.0)) - center
        n = geo.transform_normal(inv, (0.0, 1.0, 0.0))
        self._quad.append((center, u, v, n, material))

    def add_triangle(self, v0, v1, v2, n0=None, n1=None, n2=None,
                     material: int = 0, transform: TransformSpec = None) -> None:
        m = _resolve_transform(transform)
        inv = np.linalg.inv(m)
        w0 = geo.transform_point(m, v0)
        w1 = geo.transform_point(m, v1)
        w2 = geo.transform_point(m, v2)
        if n0 is None:
            gn = np.cross(w1 - w0, w2 - w0)
            nrm = np.linalg.norm(gn)
            gn = gn / nrm if nrm > 0 else np.array([0.0, 1.0, 0.0])
            wn0 = wn1 = wn2 = gn
        else:
            wn0 = geo.transform_normal(inv, n0)
            wn1 = geo.transform_normal(inv, n1)
            wn2 = geo.transform_normal(inv, n2)
        self._tri.append((w0, w1, w2, wn0, wn1, wn2, material))

    def add_mesh(self, mesh, material: int,
                 transform: TransformSpec = None) -> None:
        """Add every triangle of a Mesh (core/mesh.py), baked to world
        space; vertex normals go through the inverse transpose and are
        renormalised, and a mesh without them gets flat face normals."""
        m = _resolve_transform(transform)
        inv = np.linalg.inv(m)
        verts = np.asarray(mesh.vertices, dtype=np.float64)
        idx = np.asarray(mesh.indices, dtype=np.int64).reshape(-1, 3)
        w = verts @ m[:3, :3].T + m[:3, 3]
        if mesh.normals is not None and len(mesh.normals) == len(verts):
            nrm = np.asarray(mesh.normals, dtype=np.float64) @ inv[:3, :3]
            lens = np.linalg.norm(nrm, axis=1, keepdims=True)
            nrm = nrm / np.maximum(lens, 1e-30)
        else:
            nrm = None
        for (a, b, c) in idx:
            if nrm is not None:
                self._tri.append((w[a], w[b], w[c], nrm[a], nrm[b], nrm[c],
                                  material))
            else:
                gn = np.cross(w[b] - w[a], w[c] - w[a])
                ln = np.linalg.norm(gn)
                gn = gn / ln if ln > 0 else np.array([0.0, 1.0, 0.0])
                self._tri.append((w[a], w[b], w[c], gn, gn, gn, material))

    @property
    def num_primitives(self) -> int:
        return len(self._sph) + len(self._quad) + len(self._tri)

    # ---------------------------------------------------------------- build
    def build(self, device) -> SceneData:
        """Compile to SceneData on `device`.  float64 host values round to
        float32 in numpy, as the JAX package's build does."""
        def f32(x):
            a = np.asarray(x, dtype=np.float64).astype(np.float32)
            return torch.from_numpy(a).to(device)

        def i32(x):
            return torch.from_numpy(np.asarray(x, np.int32)).to(device)

        def flag(x):
            return torch.from_numpy(np.asarray(x, bool)).to(device)

        sph = self._sph or [(np.array([0.0, 0.0, 0.0]), 0.0, 0)]
        quad = self._quad or [(np.zeros(3), np.array([1.0, 0, 0]),
                               np.array([0, 0, 1.0]), np.array([0, 1.0, 0]), 0)]
        tri = self._tri or [(np.zeros(3), np.zeros(3), np.zeros(3),
                             np.array([0, 1.0, 0]), np.array([0, 1.0, 0]),
                             np.array([0, 1.0, 0]), 0)]
        if not self._mat_type:
            self._add_material(MAT_LAMBERTIAN, albedo=(0.5, 0.5, 0.5))

        sky_scale = (self.sky_light_intensity
                     if self.use_sky_intensity else 1.0)
        return SceneData(
            sph_center=f32([s[0] for s in sph]),
            sph_radius=f32([s[1] for s in sph]),
            sph_mat=i32([s[2] for s in sph]),
            sph_valid=flag([True] * len(self._sph) or [False]),
            quad_center=f32([q[0] for q in quad]),
            quad_u=f32([q[1] for q in quad]),
            quad_v=f32([q[2] for q in quad]),
            quad_normal=f32([q[3] for q in quad]),
            quad_mat=i32([q[4] for q in quad]),
            quad_valid=flag([True] * len(self._quad) or [False]),
            tri_v0=f32([t[0] for t in tri]),
            tri_v1=f32([t[1] for t in tri]),
            tri_v2=f32([t[2] for t in tri]),
            tri_n0=f32([t[3] for t in tri]),
            tri_n1=f32([t[4] for t in tri]),
            tri_n2=f32([t[5] for t in tri]),
            tri_mat=i32([t[6] for t in tri]),
            tri_valid=flag([True] * len(self._tri) or [False]),
            mat_type=i32(self._mat_type),
            mat_albedo=f32(self._mat_albedo),
            mat_rough=f32(self._mat_rough),
            mat_ior=f32(self._mat_ior),
            mat_emit=f32(self._mat_emit),
            sky=f32(self.sky_color * sky_scale),
        )


# ----------------------------------------------------------------------------
# Presets — the reference's scene.cpp:62-350, as in the JAX package.
# ----------------------------------------------------------------------------

def _t(scale, euler, trans):
    return geo.make_transform(scale, euler, trans)


def _init_random_balls(scene: Scene, ball_count: int) -> None:
    """scene.cpp:62-170 (ground quad + N random balls + 8 emissive)."""
    scene.sky_light_intensity = 1.0
    ground = scene.add_lambertian((0.5, 0.5, 0.5))
    scene.add_quad(200.0, 200.0, ground, None)

    rng = UniformSceneRng(1337)  # scene.cpp:86

    for _ in range(ball_count):
        # Draw order matters: radius, then pos.x, pos.z.
        radius = rng.uniform(0.2, 1.0)
        pos = (rng.uniform(-40.0, 40.0), radius, rng.uniform(-40.0, 40.0))
        m = rng.uniform()
        if m < 0.65:
            mat = scene.add_lambertian((rng.uniform(), rng.uniform(), rng.uniform()))
        elif m < 0.9:
            g = 0.7 + 0.3 * rng.uniform()
            mat = scene.add_metal((g, g, g), 0.05 * rng.uniform())
        else:
            mat = scene.add_dielectric(1.3 + 0.4 * rng.uniform())
        scene.add_sphere(radius, mat, _t((1, 1, 1), (0, 0, 0), pos))

    for _ in range(8):
        pos = (rng.uniform(-40.0, 40.0), 8.0, rng.uniform(-40.0, 40.0))
        e = 10.0 + 10.0 * rng.uniform()
        mat = scene.add_emissive((e, e, e))
        scene.add_sphere(1.5, mat, _t((1, 1, 1), (0, 0, 0), pos))


def _init_default(scene: Scene) -> None:
    """scene.cpp:188-278."""
    em = scene.add_emissive((10, 5, 5))
    scene.add_sphere(1.0, em, _t((2, 2, 2), (0, 0, 0), (5, 6, 0)))

    qe = scene.add_emissive((3, 4, 2))
    scene.add_quad(8, 8, qe, _t((1, 1, 1), (50, 0, 0), (-4, 7, 7)))
    qe2 = scene.add_emissive((3, 2, 1))
    scene.add_quad(8, 8, qe2, _t((1, 1, 1), (50, 0, 0), (4, 7, 7)))

    green = scene.add_lambertian((0.2, 1.0, 0.2))
    scene.add_sphere(1.0, green, _t((1, 1, 1), (0, 0, 0), (4, 1, 0)))
    red = scene.add_lambertian((1.0, 0.2, 0.2))
    scene.add_sphere(1.0, red, _t((1, 1, 1), (0, 0, 0), (-4, 1, 0)))
    # Intentional-looking sub-unity IoR in the reference (scene.cpp:246).
    diel = scene.add_dielectric(0.9)
    scene.add_sphere(1.0, diel, _t((1, 1, 1), (0, 0, 0), (0, 1, 4)))
    metal = scene.add_metal((1.0, 0.7, 0.8), 0.01)
    scene.add_sphere(1.0, metal, _t((1, 1, 1), (0, 0, 0), (0, 1, -4)))
    ground = scene.add_lambertian((0.7, 0.7, 0.4))
    scene.add_quad(20, 20, ground, None)


def _init_light_test(scene: Scene) -> None:
    """scene.cpp:280-305 (emissive-only lighting; sky intensity 0)."""
    scene.sky_light_intensity = 0.0
    ground = scene.add_lambertian((0.6, 0.6, 0.6))
    scene.add_quad(30, 30, ground, None)
    for i in range(-5, 6):
        mat = scene.add_emissive((4, 4, 4))
        scene.add_sphere(0.5, mat, _t((1, 1, 1), (0, 0, 0), (i * 2.0, 6, 0)))


def _init_material_test(scene: Scene) -> None:
    """scene.cpp:307-330 (one sphere per BSDF over a ground quad)."""
    ground = scene.add_lambertian((0.8, 0.8, 0.8))
    scene.add_quad(25, 25, ground, None)
    scene.add_sphere(1.0, scene.add_lambertian((1, 0, 0)),
                     _t((1, 1, 1), (0, 0, 0), (-4, 1, 0)))
    scene.add_sphere(1.0, scene.add_metal((0.9, 0.9, 0.9), 0.0),
                     _t((1, 1, 1), (0, 0, 0), (0, 1, 0)))
    scene.add_sphere(1.0, scene.add_dielectric(1.5),
                     _t((1, 1, 1), (0, 0, 0), (4, 1, 0)))


def _init_cornell(scene: Scene) -> None:
    """scene.cpp:332-350."""
    scene.sky_light_intensity = 0.0
    red = scene.add_lambertian((0.75, 0.1, 0.1))
    green = scene.add_lambertian((0.1, 0.75, 0.1))
    white = scene.add_lambertian((0.8, 0.8, 0.8))
    scene.add_quad(10, 10, white, None)
    scene.add_quad(10, 10, red, _t((1, 1, 1), (90, 0, 0), (-5, 5, 0)))
    scene.add_quad(10, 10, green, _t((1, 1, 1), (90, 0, 0), (5, 5, 0)))
    light = scene.add_emissive((15, 15, 15))
    scene.add_quad(10, 10, light, _t((1, 1, 1), (90, 0, 0), (0, 9, 0)))


def _needs_extensions(scene: Scene) -> None:
    raise NotImplementedError(
        f"the texture_demo and sky_demo presets: {_SCENE_EXTENSIONS}")


def ply_showcase_scene(path: str):
    """The PLY showcase of the JAX package (``core/scene.py``
    ``ply_showcase_scene``): the mesh scaled 8x and turned to face the
    camera, on a gray 100x100 ground quad under an emissive sphere.

    Returns (scene, eye, look_at)."""
    from parallelraytracing_tpu_torch.core.mesh import load_ply
    mesh = load_ply(path)
    scene = Scene(preset=None)
    mat = scene.add_lambertian((0.75, 0.65, 0.5))
    scene.add_mesh(mesh, mat, ((8, 8, 8), (0, 180, 0), (0, 8, 0)))
    ground = scene.add_lambertian((0.5, 0.5, 0.5))
    scene.add_quad(100, 100, ground, None)
    light = scene.add_emissive((12, 12, 12))
    scene.add_sphere(3.0, light, ((1, 1, 1), (0, 0, 0), (12, 25, 12)))
    return scene, (0.0, 14.0, 28.0), (0.0, 7.0, 0.0)


_PRESET_BUILDERS = {
    ScenePreset.DEFAULT: _init_default,
    ScenePreset.LIGHT_TEST: _init_light_test,
    ScenePreset.MATERIAL_TEST: _init_material_test,
    ScenePreset.CORNELL: _init_cornell,
    ScenePreset.RANDOM_BALLS_SMALL: lambda s: _init_random_balls(s, 100),
    ScenePreset.RANDOM_BALLS_MEDIUM: lambda s: _init_random_balls(s, 400),
    ScenePreset.RANDOM_BALLS_LARGE: lambda s: _init_random_balls(s, 800),
    ScenePreset.TEXTURE_DEMO: _needs_extensions,
    ScenePreset.SKY_DEMO: _needs_extensions,
}
