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
scenes, and ``add_mesh_instances`` its instanced ones (kept as records,
world-baked only by ``build(bake_instances=True)``).  The scene
extensions are the JAX package's too: ``set_sky`` (gradient and sun
sky), ``add_checker`` (procedural checker albedo), ``add_texture`` /
``add_textured_lambertian`` (image textures, sampled at the hit's UV),
mesh texture coordinates, and the ``texture_demo`` and ``sky_demo``
presets.  Their ``SceneData`` fields are present only when used, as in
the JAX package.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from parallelraytracing_tpu_torch.config import DEFAULT_SKY
from parallelraytracing_tpu_torch.core import geometry as geo
from parallelraytracing_tpu_torch.core.host_rng import UniformSceneRng
from parallelraytracing_tpu_torch.ops.textures import TEX_CHECKER, TEX_IMAGE_BASE

# Material type codes (order matches the reference MatType enum).
MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_EMISSIVE = 3

# Primitive kinds of a hit (-1 on a miss); the global ordinal of a
# primitive is its index plus the counts of the kinds before it.
KIND_SPHERE = 0
KIND_QUAD = 1
KIND_TRIANGLE = 2


class ScenePreset(enum.Enum):
    """The reference's preset enum (src/core/scene.h:6-20) plus the JAX
    package's two extension demos: ``texture_demo`` (checker floor, image
    textures on a quad and a sphere) and ``sky_demo`` (gradient and sun
    sky over specular spheres)."""

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

    sky: torch.Tensor  # (3,) constant sky, or the gradient's bottom

    # Scene extensions, None when unused (the JAX package's optional
    # fields): sky_top the gradient's top color; sun (9,) = [dir(3),
    # color(3), power, 0, 0]; mat_tex per material 0 none, 1 checker,
    # >= 2 image (id + 2), with mat_tex_param [cell scale, odd rgb];
    # tex_atlas (T, TH, TW, 3) zero-padded images of true size tex_size
    # (T, 2) (h, w); tri_uv0..2 (Nt, 2) texture coordinates (image
    # scenes).
    sky_top: Optional[torch.Tensor] = None
    sun: Optional[torch.Tensor] = None
    mat_tex: Optional[torch.Tensor] = None
    mat_tex_param: Optional[torch.Tensor] = None
    tex_atlas: Optional[torch.Tensor] = None
    tex_size: Optional[torch.Tensor] = None
    tri_uv0: Optional[torch.Tensor] = None
    tri_uv1: Optional[torch.Tensor] = None
    tri_uv2: Optional[torch.Tensor] = None

    def numpy(self) -> dict:
        """Every field as a host numpy array (None where unused), keyed by
        field name."""
        return {f.name: (None if getattr(self, f.name) is None
                         else getattr(self, f.name).cpu().numpy())
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
        self._mat_tex: List[int] = []
        self._mat_tex_param: List[np.ndarray] = []
        self._textures: List[np.ndarray] = []  # (H, W, 3) images

        self._sph: List[Tuple[np.ndarray, float, int]] = []
        self._quad: List[Tuple] = []
        self._tri: List[Tuple] = []

        # Instanced meshes: unique meshes and (mesh index, material, 4x4
        # transform) records, not baked, so geometry memory stays
        # proportional to unique meshes (ops/pack.pack_instance_tables).
        self._inst_meshes: List = []
        self._instances: List[Tuple[int, int, np.ndarray]] = []

        # Set per preset but never consumed by the reference backends
        # (they hardcode the sky); use_sky_intensity=True honors it.
        self.sky_light_intensity = 1.0
        self.use_sky_intensity = False
        self.sky_color = np.array(DEFAULT_SKY, dtype=np.float64)
        # set_sky: None keeps the constant sky
        self.sky_top: Optional[np.ndarray] = None
        self.sun_spec: Optional[Tuple[np.ndarray, np.ndarray, int]] = None

        if preset is not None:
            _PRESET_BUILDERS[preset](self)

    # ----------------------------------------------------------------- sky
    def set_sky(self, bottom=None, top=None, sun_direction=None,
                sun_color=None, sun_power: int = 32) -> None:
        """The sky model (the reference hardcodes one constant sky):

        - bottom: the horizon color (replaces sky_color; alone, the sky
          stays constant);
        - top: the zenith color, enabling the gradient
          lerp(bottom, top, 0.5 * (d_hat.y + 1));
        - sun_direction / sun_color / sun_power: a sun disc
          color * max(d_hat . dir, 0) ** power added on top; the power is
          a positive integer (the kernels raise to it by squaring)."""
        if bottom is not None:
            self.sky_color = np.asarray(bottom, dtype=np.float64)
        self.sky_top = (None if top is None
                        else np.asarray(top, dtype=np.float64))
        if sun_direction is None:
            self.sun_spec = None
            return
        d = np.asarray(sun_direction, dtype=np.float64)
        n = np.linalg.norm(d)
        if n < 1e-12:
            raise ValueError("set_sky: sun_direction must be non-zero")
        c = np.asarray(sun_color if sun_color is not None else (1.0, 1.0, 1.0),
                       dtype=np.float64)
        p = int(sun_power)
        if p < 1:
            raise ValueError("set_sky: sun_power must be a positive integer")
        self.sun_spec = (d / n, c, p)

    # ------------------------------------------------------------ materials
    def _add_material(self, mtype: int, albedo=(0, 0, 0), rough=0.0,
                      ior=1.0, emit=(0, 0, 0), tex=0,
                      tex_param=(0.0, 0.0, 0.0, 0.0)) -> int:
        self._mat_type.append(mtype)
        self._mat_albedo.append(np.asarray(albedo, dtype=np.float64))
        self._mat_rough.append(float(rough))
        self._mat_ior.append(float(ior))
        self._mat_emit.append(np.asarray(emit, dtype=np.float64))
        self._mat_tex.append(int(tex))
        self._mat_tex_param.append(np.asarray(tex_param, dtype=np.float64))
        return len(self._mat_type) - 1

    def add_checker(self, even, odd, scale: float = 1.0) -> int:
        """A Lambertian with a 3D checker albedo: cells of world-space size
        1/scale alternate between `even` and `odd` (position-based, no
        texture coordinates needed)."""
        odd = np.asarray(odd, dtype=np.float64)
        return self._add_material(
            MAT_LAMBERTIAN, albedo=even, tex=TEX_CHECKER,
            tex_param=(float(scale), odd[0], odd[1], odd[2]))

    def add_texture(self, image) -> int:
        """Register an (H, W, 3) float image; returns its texture id for
        add_textured_lambertian."""
        img = np.asarray(image, dtype=np.float64)
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"add_texture: want an (H, W, 3) image, got "
                             f"{img.shape}")
        self._textures.append(img)
        return len(self._textures) - 1

    def add_textured_lambertian(self, texture_id: int) -> int:
        """A Lambertian whose albedo is the image texture `texture_id`,
        sampled bilinearly with repeat wrap at the hit's UV (quad
        half-extent coordinates, a triangle's interpolated texture
        coordinates, a sphere's equirectangular map)."""
        if not 0 <= texture_id < len(self._textures):
            raise ValueError(f"add_textured_lambertian: no texture "
                             f"{texture_id}")
        return self._add_material(MAT_LAMBERTIAN, albedo=(1.0, 1.0, 1.0),
                                  tex=TEX_IMAGE_BASE + texture_id)

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
                     material: int = 0, transform: TransformSpec = None,
                     uv0=None, uv1=None, uv2=None) -> None:
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
        self._tri.append((w0, w1, w2, wn0, wn1, wn2, material, uv0, uv1, uv2))

    def add_mesh(self, mesh, material: int,
                 transform: TransformSpec = None) -> None:
        """Add every triangle of a Mesh (core/mesh.py), baked to world
        space; vertex normals go through the inverse transpose and are
        renormalised, and a mesh without them gets flat face normals.  The
        mesh's per-vertex texture coordinates, when it has them, go with
        each triangle."""
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
        uv = (np.asarray(mesh.texcoords, dtype=np.float64)
              if mesh.texcoords is not None
              and len(mesh.texcoords) == len(verts) else None)
        for (a, b, c) in idx:
            uvs = (uv[a], uv[b], uv[c]) if uv is not None else (None,) * 3
            if nrm is not None:
                self._tri.append((w[a], w[b], w[c], nrm[a], nrm[b], nrm[c],
                                  material, *uvs))
            else:
                gn = np.cross(w[b] - w[a], w[c] - w[a])
                ln = np.linalg.norm(gn)
                gn = gn / ln if ln > 0 else np.array([0.0, 1.0, 0.0])
                self._tri.append((w[a], w[b], w[c], gn, gn, gn, material,
                                  *uvs))

    def add_mesh_instances(self, mesh, material: int,
                           transforms: Sequence[TransformSpec]) -> None:
        """Instance a mesh under several transforms (the role of the
        reference's OptiX instance acceleration structure).  Stored as
        {mesh, material, transform} records, not baked: the engines trace
        them through the kernels' instance block, and only
        ``build(bake_instances=True)`` world-bakes a copy.  A mesh is
        kept once, by identity, however often it is instanced."""
        for i, m in enumerate(self._inst_meshes):
            if m is mesh:
                mesh_i = i
                break
        else:
            self._inst_meshes.append(mesh)
            mesh_i = len(self._inst_meshes) - 1
        for t in transforms:
            self._instances.append((mesh_i, material, _resolve_transform(t)))

    @property
    def instances(self):
        """The (mesh index, material id, 4x4 transform) records."""
        return list(self._instances)

    @property
    def num_primitives(self) -> int:
        inst_tris = sum(len(np.asarray(self._inst_meshes[mi].indices)) // 3
                        for mi, _, _ in self._instances)
        return len(self._sph) + len(self._quad) + len(self._tri) + inst_tris

    def build_two_level(self, device):
        """Compile for the two-level walk: (the base SceneData without the
        instanced meshes, their TwoLevelBVH or None when the scene has no
        instances), both on `device`."""
        base = self.build(device, bake_instances=False)
        if not self._instances:
            return base, None
        from parallelraytracing_tpu_torch.accel.tlas import build_two_level
        return base, build_two_level(self._inst_meshes, self._instances,
                                     device)

    def _baked_instance_tris(self) -> List[Tuple]:
        """The instances world-baked into triangle records, as add_mesh
        bakes a mesh."""
        saved, self._tri = self._tri, []
        try:
            for mesh_i, mat, m4 in self._instances:
                self.add_mesh(self._inst_meshes[mesh_i], mat, m4)
            return self._tri
        finally:
            self._tri = saved

    # ---------------------------------------------------------------- build
    def build(self, device, bake_instances: bool = True) -> SceneData:
        """Compile to SceneData on `device`.  float64 host values round to
        float32 in numpy, as the JAX package's build does.  The instances
        are world-baked after the other triangles unless
        `bake_instances` is False (the engines' base scene).  The
        extension fields are filled only when the scene uses them: the
        texture fields when a material is textured, the atlas and the
        triangles' texture coordinates when one is an image."""
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
        tris = self._tri + (self._baked_instance_tris()
                            if bake_instances and self._instances else [])
        tri = tris or [(np.zeros(3), np.zeros(3), np.zeros(3),
                        np.array([0, 1.0, 0]), np.array([0, 1.0, 0]),
                        np.array([0, 1.0, 0]), 0, None, None, None)]
        if not self._mat_type:
            self._add_material(MAT_LAMBERTIAN, albedo=(0.5, 0.5, 0.5))

        ext = {}
        if any(self._mat_tex):
            ext["mat_tex"] = i32(self._mat_tex)
            ext["mat_tex_param"] = f32(self._mat_tex_param)
        if any(t >= TEX_IMAGE_BASE for t in self._mat_tex):
            th = max(t.shape[0] for t in self._textures)
            tw = max(t.shape[1] for t in self._textures)
            atlas = np.zeros((len(self._textures), th, tw, 3))
            size = np.zeros((len(self._textures), 2), np.int64)
            for i, img in enumerate(self._textures):
                atlas[i, :img.shape[0], :img.shape[1]] = img
                size[i] = img.shape[:2]
            ext["tex_atlas"] = f32(atlas)
            ext["tex_size"] = i32(size)
            for k in range(3):
                ext[f"tri_uv{k}"] = f32([
                    np.zeros(2) if t[7 + k] is None
                    else np.asarray(t[7 + k], np.float64) for t in tri])

        sky_scale = (self.sky_light_intensity
                     if self.use_sky_intensity else 1.0)
        if self.sky_top is not None:
            ext["sky_top"] = f32(self.sky_top * sky_scale)
        if self.sun_spec is not None:
            sd, sc, power = self.sun_spec
            ext["sun"] = f32(np.concatenate([sd, sc * sky_scale,
                                             [float(power), 0.0, 0.0]]))
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
            tri_valid=flag([True] * len(tris) or [False]),
            mat_type=i32(self._mat_type),
            mat_albedo=f32(self._mat_albedo),
            mat_rough=f32(self._mat_rough),
            mat_ior=f32(self._mat_ior),
            mat_emit=f32(self._mat_emit),
            sky=f32(self.sky_color * sky_scale),
            **ext,
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


def _init_texture_demo(scene: Scene) -> None:
    """The JAX package's extension demo: a checkered ground plane, a row
    of Lambertian / metal / dielectric spheres at staggered depths, an
    emissive sphere, a 32x32 procedural plaid image on a back-wall quad
    and a 96x48 latitude-band globe image on a sphere."""
    floor = scene.add_checker((0.85, 0.85, 0.85), (0.12, 0.15, 0.2),
                              scale=0.8)
    scene.add_quad(60, 60, floor, None)
    mirror = scene.add_metal((0.9, 0.9, 0.95), 0.02)
    glass = scene.add_dielectric(1.5)
    for i, z in enumerate((-6.0, -2.0, 2.0, 6.0)):
        tint = scene.add_lambertian((0.8, 0.25 + 0.15 * i, 0.2))
        scene.add_sphere(1.0, tint, ((1, 1, 1), (0, 0, 0), (-2.5, 1.0, z)))
        scene.add_sphere(1.0, mirror if i % 2 else glass,
                         ((1, 1, 1), (0, 0, 0), (2.5, 1.0, z)))
    light = scene.add_emissive((6, 6, 6))
    scene.add_sphere(2.0, light, ((1, 1, 1), (0, 0, 0), (0.0, 12.0, 0.0)))
    scene.add_quad(6, 4, scene.add_textured_lambertian(
        scene.add_texture(plaid_image())),
        ((1, 1, 1), (90, 0, 0), (0.0, 4.0, -9.0)))
    scene.add_sphere(1.4, scene.add_textured_lambertian(
        scene.add_texture(globe_image())),
        ((1, 1, 1), (0, 25, 0), (0.0, 1.4, -4.0)))


def plaid_image() -> np.ndarray:
    """texture_demo's 32x32 procedural plaid, (32, 32, 3) float64."""
    yy, xx = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    return np.stack([
        0.15 + 0.8 * ((xx // 8 + yy // 8) % 2),
        0.2 + 0.6 * np.abs(np.sin(xx * 0.4)),
        0.25 + 0.7 * (yy / 31.0)], axis=2)


def globe_image() -> np.ndarray:
    """texture_demo's 96x48 latitude-band globe, (48, 96, 3) float64."""
    gy, gx = np.meshgrid(np.arange(48), np.arange(96), indexing="ij")
    return np.stack([
        0.2 + 0.6 * (np.sin(gy * np.pi / 12.0) > 0),
        0.3 + 0.5 * ((gx // 12) % 2),
        0.7 - 0.5 * np.abs(gy / 47.0 - 0.5) * 2.0], axis=2)


def _init_sky_demo(scene: Scene) -> None:
    """The JAX package's extension demo: the gradient sky with a sun disc
    of power 256 over a mirror, a glass and a brushed-metal sphere and a
    row of six diffuse ones on a gray floor."""
    scene.set_sky(bottom=(1.0, 1.0, 1.0), top=(0.35, 0.55, 0.95),
                  sun_direction=(0.45, 0.65, 0.35),
                  sun_color=(14.0, 12.0, 9.0), sun_power=256)
    ground = scene.add_lambertian((0.55, 0.55, 0.55))
    scene.add_quad(80, 80, ground, None)
    mirror = scene.add_metal((0.95, 0.95, 0.95), 0.02)
    brushed = scene.add_metal((0.8, 0.65, 0.4), 0.25)
    glass = scene.add_dielectric(1.5)
    scene.add_sphere(2.0, mirror, ((1, 1, 1), (0, 0, 0), (-4.5, 2.0, 0)))
    scene.add_sphere(2.0, glass, ((1, 1, 1), (0, 0, 0), (0.0, 2.0, 1.5)))
    scene.add_sphere(2.0, brushed, ((1, 1, 1), (0, 0, 0), (4.5, 2.0, 0)))
    for i in range(6):
        tint = scene.add_lambertian((0.25 + 0.1 * i, 0.4, 0.7 - 0.08 * i))
        scene.add_sphere(0.7, tint, ((1, 1, 1), (0, 0, 0),
                                     (-5.0 + 2.0 * i, 0.7, 4.5)))


def ply_showcase_scene(path: str):
    """The PLY showcase of the JAX package (``core/scene.py``
    ``ply_showcase_scene``): the mesh scaled 8x and turned to face the
    camera, on a gray 100x100 ground quad under an emissive sphere.

    Returns (scene, eye, look_at)."""
    from parallelraytracing_tpu_torch.core.mesh import load_ply
    return showcase_scene(load_ply(path))


def showcase_scene(mesh):
    """``ply_showcase_scene`` around a loaded `mesh`; (scene, eye,
    look_at)."""
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
    ScenePreset.TEXTURE_DEMO: _init_texture_demo,
    ScenePreset.SKY_DEMO: _init_sky_demo,
}
