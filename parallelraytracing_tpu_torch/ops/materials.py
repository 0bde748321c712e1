"""The four BSDFs of the megakernel engine, evaluated masked over the
material table (the counterpart of ``parallelraytracing_tpu.ops.materials``;
the kernels' shading lives in csrc/bounce.cuh).

The semantics are the reference's (material.h): a Lambertian scatters to
normal + a random unit vector (the normal itself when that sum is near
zero); a metal reflects, adds roughness times a unit vector and dies below
the surface; a dielectric chooses reflection or Snell refraction by
Schlick's Fresnel against a uniform; an emissive material emits and ends
the path.  Its random unit vectors are normalized standard normals from
the threefry streams (``ops/rng.normal``), as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch

from parallelraytracing_tpu_torch.core.scene import (MAT_DIELECTRIC,
                                                     MAT_EMISSIVE,
                                                     MAT_LAMBERTIAN,
                                                     MAT_METAL)
from parallelraytracing_tpu_torch.ops import ieee, rng
from parallelraytracing_tpu_torch.ops.intersect import HitRecord


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _normalize(v, eps=1e-30):
    return v / torch.clamp_min(ieee.sqrt(_dot(v, v)), eps)[..., None]


def reflect(d, n):
    """Mirror reflection: d - 2 dot(d, n) n."""
    return d - 2.0 * _dot(d, n)[..., None] * n


def refract(d, n, eta):
    """Snell refraction of unit d about unit n with ratio eta (reference
    math.h:45-50)."""
    cos_theta = torch.clamp_max(_dot(-d, n), 1.0)
    r_perp = eta[..., None] * (d + cos_theta[..., None] * n)
    r_par = -ieee.sqrt(torch.abs(1.0 - _dot(r_perp, r_perp)))[..., None] * n
    return r_perp + r_par


def schlick(cosine, ref_idx):
    """Schlick's Fresnel approximation (material.h:105-109)."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * torch.pow(1.0 - cosine, 5.0)


def unit_vectors(normals: torch.Tensor) -> torch.Tensor:
    """(n, 3) standard normals scaled to unit length: uniform directions."""
    return _normalize(normals)


def random_unit_vectors(key, n: int, device=None) -> torch.Tensor:
    """(n, 3) uniform directions from ``normal(key, (n, 3))``."""
    return unit_vectors(rng.normal(key, (n, 3), device))


def surface_albedo(scene, hit: HitRecord) -> torch.Tensor:
    """(R, 3) albedo at each hit: the material's color, textured where
    the material carries a texture (the one source of the BSDF's and the
    NEE term's albedo)."""
    albedo = scene.mat_albedo[hit.mat]
    if scene.mat_tex is not None:
        from parallelraytracing_tpu_torch.ops.textures import textured_albedo
        albedo = textured_albedo(scene, hit, albedo)
    return albedo


def emitted(scene, mat: torch.Tensor) -> torch.Tensor:
    """(R, 3) emission of each material: its color if emissive, else 0."""
    is_emit = scene.mat_type[mat] == MAT_EMISSIVE
    return torch.where(is_emit[:, None], scene.mat_emit[mat], 0.0)


def scatter(scene, d: torch.Tensor, hit: HitRecord, unit_vec: torch.Tensor,
            uniform: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """Every BSDF evaluated, the hit material's selected: (out_dir (R, 3)
    unit, attenuation (R, 3), alive (R,) bool) for incoming unit
    directions `d`, random unit vectors `unit_vec` and uniforms `uniform`
    in [0, 1).  Scattered rays start at hit.pos (t_min guards the
    surface)."""
    n = hit.normal
    mat = hit.mat
    mtype = scene.mat_type[mat]
    albedo = surface_albedo(scene, hit)
    rough = scene.mat_rough[mat]
    ior = scene.mat_ior[mat]

    lam_dir = n + unit_vec
    degen = torch.all(torch.abs(lam_dir) < 1e-8, dim=-1)
    lam_dir = _normalize(torch.where(degen[:, None], n, lam_dir))

    met_dir = _normalize(_normalize(reflect(d, n)) + rough[:, None] * unit_vec)
    met_alive = _dot(met_dir, n) > 0.0

    ri = torch.where(hit.front, 1.0 / ior, ior)
    cos_theta = torch.clamp_max(_dot(-d, n), 1.0)
    sin_theta = ieee.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    cannot_refract = ri * sin_theta > 1.0
    reflect_choice = cannot_refract | (schlick(cos_theta, ri) > uniform)
    die_dir = _normalize(torch.where(reflect_choice[:, None], reflect(d, n),
                                     refract(d, n, ri)))

    is_lam = mtype == MAT_LAMBERTIAN
    is_met = mtype == MAT_METAL
    is_die = mtype == MAT_DIELECTRIC
    is_emit = mtype == MAT_EMISSIVE
    out_dir = torch.where(is_lam[:, None], lam_dir,
                          torch.where(is_met[:, None], met_dir,
                                      torch.where(is_die[:, None], die_dir, n)))
    attenuation = torch.where(is_die[:, None], 1.0,
                              torch.where(is_emit[:, None], 0.0, albedo))
    alive = torch.where(is_met, met_alive, ~is_emit)
    return out_dir, attenuation, alive
