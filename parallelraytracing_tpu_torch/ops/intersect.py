"""Brute-force closest hit of rays against every primitive (the
counterpart of ``parallelraytracing_tpu.ops.intersect``).

The megakernel engine's intersector and the denoiser's guide pass.  Rays
are tested against primitive chunks of ``chunk`` (``cfg.intersect_chunk``)
at once, (R, chunk) transients, with a running closest-hit fold across
chunks and kinds.  The geometry is the reference's: a sphere's quadratic
with front-face logic (both roots >= t_min: front, near root; else the far
root, back face), a quad's plane hit with its half-extent test, a
triangle's Moller-Trumbore in scalar triple products, and interpolated
vertex normals flipped toward the ray.  Ties at equal t go to the lowest
global ordinal (spheres, then quads, then triangles), as in the kernels'
fold (csrc/bounce.cuh).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from parallelraytracing_tpu_torch.core.scene import (KIND_QUAD, KIND_SPHERE,
                                                     KIND_TRIANGLE)
from parallelraytracing_tpu_torch.ops import ieee
from parallelraytracing_tpu_torch.ops.rng import fma

_BIG = 3.0e38


def _cols(a: torch.Tensor):
    """The columns of (N, 3) a as (N, 1) float32 and float64 tensors (the
    rays' side of ``_rk``)."""
    return ([a[:, i:i + 1] for i in range(3)],
            [a[:, i:i + 1].double() for i in range(3)])


def _rows(b: torch.Tensor):
    """The columns of (K, 3) b as (1, K) float32 and float64 rows (the
    primitives' side of ``_rk``, cut once per scene)."""
    return ([b[None, :, i].contiguous() for i in range(3)],
            [b[None, :, i].double().contiguous() for i in range(3)])


def _rk(a, b) -> torch.Tensor:
    """(R, 3) x (K, 3) -> (R, K), the JAX package's ``_rk_dot``: three
    broadcast products summed in its order (a TPU workaround there,
    against the MXU's bf16 matmul), with the multiply-adds fused as XLA's
    CPU backend fuses them: fma(a2, b2, fma(a0, b0, a1 b1)).  The sphere
    test's discriminant cancels, so a rounding of its own would move a
    grazing hit's t by up to 1e-4 relative.  `a` and `b` come from
    ``_cols`` and ``_rows``; each fused step is exact in float64 and
    rounded once to float32."""
    (af, ad), (bf, bd) = a, b
    inner = (ad[0] * bd[0] + af[1] * bf[1]).float()
    return (ad[2] * bd[2] + inner).float()


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rows' dot products, as XLA's CPU backend reduces them: the first
    product, then fused multiply-adds of the others."""
    return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1],
                                         a[..., 0] * b[..., 0]))


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean length of the rows of (R, 3) v."""
    return ieee.sqrt(dot3(v, v))


@dataclasses.dataclass(frozen=True)
class HitRecord:
    """The closest hit of each ray and the winning primitive's identity."""

    t: torch.Tensor       # (R,) world distance (inf on a miss)
    hit: torch.Tensor     # (R,) bool
    pos: torch.Tensor     # (R, 3)
    normal: torch.Tensor  # (R, 3) unit, flipped toward the ray's side
    front: torch.Tensor   # (R,) bool
    mat: torch.Tensor     # (R,) int32 material id (0 on a miss)
    kind: torch.Tensor    # (R,) int32 KIND_* (-1 on a miss)
    idx: torch.Tensor     # (R,) int32 index within its kind
    #: surface UV, filled only on image-textured scenes
    uv: Optional[torch.Tensor] = None


def _pad_chunks(arrs, valid, chunk):
    """Pad each array's leading dim to a multiple of the chunk (`chunk`,
    or the count when smaller) and reshape to (n_chunks, k, ...).
    Returns (padded arrays, padded valid)."""
    n = valid.shape[0]
    k = min(chunk, max(n, 1))
    n_pad = (-n) % k
    out = []
    for a in arrs:
        pad = torch.zeros((n_pad,) + tuple(a.shape[1:]), dtype=a.dtype,
                          device=a.device)
        out.append(torch.cat([a, pad]).reshape((n + n_pad) // k, k,
                                               *a.shape[1:]))
    v = torch.cat([valid, torch.zeros(n_pad, dtype=torch.bool,
                                      device=valid.device)])
    return out, v.reshape((n + n_pad) // k, k)


def _fold_best(carry, t, hit, front, idx_base, kind, ord_base):
    """Fold a chunk's (R, K) results into the running closest hit: the
    chunk's lowest t (its first index on a tie) replaces the carry when
    strictly nearer, or equally near with a lower global ordinal."""
    best_t, best_kind, best_idx, best_front, best_ord = carry
    t = torch.where(hit, t, _BIG)
    chunk_arg = torch.argmin(t, dim=1)
    chunk_min = t.gather(1, chunk_arg[:, None])[:, 0]
    chunk_arg = chunk_arg.to(torch.int32)
    if front is None:
        chunk_front = torch.ones_like(best_front)
    else:
        chunk_front = front.gather(1, chunk_arg.long()[:, None])[:, 0]
    chunk_ord = ord_base + idx_base + chunk_arg
    better = (chunk_min < best_t) | ((chunk_min == best_t) & (chunk_min < _BIG)
                                     & (chunk_ord < best_ord))
    return (torch.where(better, chunk_min, best_t),
            torch.where(better, kind, best_kind),
            torch.where(better, idx_base + chunk_arg, best_idx),
            torch.where(better, chunk_front, best_front),
            torch.where(better, chunk_ord, best_ord))


def _sphere_chunk(o, d, do, oo, center, cc, valid, t_min, t_max):
    """A chunk's sphere tests: (R, K) t, hit and front; o, d and center
    pre-split (``_cols``, ``_rows``), cc = |center|^2 - radius^2."""
    dc = _rk(d, center)
    ocn = _rk(o, center)
    b2 = do[:, None] - dc
    c_term = oo[:, None] - 2.0 * ocn + cc[None, :]
    disc = fma(b2, b2, -c_term)
    sq = ieee.sqrt(torch.clamp_min(disc, 0.0))
    t_near = -b2 - sq
    t_far = -b2 + sq
    front = t_near >= t_min
    t = torch.where(front, t_near, t_far)
    hit = (disc >= 0.0) & (t >= t_min) & (t <= t_max) & valid[None, :]
    return t, hit, front


def _quad_chunk(o, d, n, cn, us, cu, vs, cv, valid, t_min, t_max):
    """A chunk's quad tests; n the unit normals, cn = center.n, us =
    u / |u|^2, cu = center.us, likewise vs and cv (o, d, n, us, vs
    pre-split)."""
    dn = _rk(d, n)
    on = _rk(o, n)
    denom_ok = torch.abs(dn) >= 1e-8
    inv_dn = torch.where(denom_ok, 1.0 / torch.where(denom_ok, dn, 1.0), 0.0)
    t = (cn[None, :] - on) * inv_dn
    a = _rk(o, us) + t * _rk(d, us) - cu[None, :]
    b = _rk(o, vs) + t * _rk(d, vs) - cv[None, :]
    hit = (denom_ok & (t > t_min) & (t <= t_max) & (a * a < 1.0)
           & (b * b < 1.0) & valid[None, :])
    front = (on - cn[None, :]) > 0.0
    return t, hit, front


def _tri_chunk(o, d, w, ng, p0ng, e1, e2, e2xp0, p0xe1, valid, t_min, t_max):
    """A chunk's Moller-Trumbore tests in triple products; w = o x d,
    ng = e1 x e2, p0ng = v0.ng, e2xp0 = e2 x v0, p0xe1 = v0 x e1 (all
    but p0ng pre-split)."""
    div = -_rk(d, ng)
    div_ok = div != 0.0
    inv = torch.where(div_ok, 1.0 / torch.where(div_ok, div, 1.0), 0.0)
    t = (_rk(o, ng) - p0ng[None, :]) * inv
    b1 = (_rk(w, e2) - _rk(d, e2xp0)) * inv
    b2 = (-_rk(w, e1) - _rk(d, p0xe1)) * inv
    hit = (div_ok & (t >= t_min) & (t <= t_max) & (b1 >= 0.0) & (b2 >= 0.0)
           & (b1 + b2 <= 1.0) & valid[None, :])
    return t, hit, None


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row cross products, each component fused as XLA's CPU backend
    fuses jnp.cross's: fma(a1, b2, -(a2 b1))."""
    return torch.stack([fma(a[:, 1], b[:, 2], -(a[:, 2] * b[:, 1])),
                        fma(a[:, 2], b[:, 0], -(a[:, 0] * b[:, 2])),
                        fma(a[:, 0], b[:, 1], -(a[:, 1] * b[:, 0]))], dim=1)


@dataclasses.dataclass(frozen=True)
class PreparedScene:
    """A scene's primitives cut into chunks once, each chunk holding the
    terms of its kind's test (for a caller that intersects one scene many
    times).  A kind with no valid primitive has no chunk: the JAX fold
    over its inert placeholder never changes the carry."""

    scene: object
    sph: tuple   # per chunk (first index, center rows, |c|^2 - r^2, valid)
    quad: tuple  # per chunk (first index, n, cn, us, cu, vs, cv, valid)
    tri: tuple   # per chunk (first index, ng, p0ng, e1, e2, e2xp0, p0xe1, valid)
    n_sph: int
    n_quad: int


def _chunked(arrs, valid, chunk):
    """(first index, arrays..., valid) of each chunk of `chunk`
    primitives, or () when no primitive is valid."""
    if not bool(valid.any()):
        return ()
    cks, v_ck = _pad_chunks(arrs, valid, chunk)
    k = v_ck.shape[1]
    return tuple((i * k, *(a[i] for a in cks), v_ck[i])
                 for i in range(v_ck.shape[0]))


def prepare_scene(scene, chunk: int = 256) -> PreparedScene:
    """Cut `scene` (a SceneData) into the chunks of ``intersect_scene``."""
    sph = tuple((i, _rows(c), fma(-r, r, dot3(c, c)), v)
                for i, c, r, v in _chunked([scene.sph_center, scene.sph_radius],
                                           scene.sph_valid, chunk))
    qn, qc = scene.quad_normal, scene.quad_center
    qu, qv = scene.quad_u, scene.quad_v
    us = qu / torch.clamp_min(dot3(qu, qu), 1e-30)[:, None]
    vs = qv / torch.clamp_min(dot3(qv, qv), 1e-30)[:, None]
    quad = tuple((i, _rows(n), cn, _rows(u), cu, _rows(v_), cv, v)
                 for i, n, cn, u, cu, v_, cv, v in _chunked(
                     [qn, dot3(qc, qn), us, dot3(qc, us), vs, dot3(qc, vs)],
                     scene.quad_valid, chunk))
    v0 = scene.tri_v0
    e1 = scene.tri_v1 - v0
    e2 = scene.tri_v2 - v0
    ng = cross3(e1, e2)
    tri = tuple((i, _rows(g), p0ng, _rows(a), _rows(b), _rows(x), _rows(y), v)
                for i, g, p0ng, a, b, x, y, v in _chunked(
                    [ng, dot3(v0, ng), e1, e2, cross3(e2, v0), cross3(v0, e1)],
                    scene.tri_valid, chunk))
    return PreparedScene(scene, sph, quad, tri, scene.sph_center.shape[0],
                         scene.quad_normal.shape[0])


def intersect_scene(scene, o: torch.Tensor, d: torch.Tensor, t_min: float,
                    t_max: float, chunk: int = 256,
                    prepared: Optional[PreparedScene] = None) -> HitRecord:
    """Closest hit of the rays (o, d), each (R, 3), against every
    primitive of `scene` (a SceneData), in chunks of `chunk`;
    `prepared`, ``prepare_scene(scene, chunk)``, saves the cut."""
    p = prepared if prepared is not None else prepare_scene(scene, chunk)
    r = o.shape[0]
    dev = o.device
    do = dot3(d, o)
    oo = dot3(o, o)
    oc, dc = _cols(o), _cols(d)
    carry = (torch.full((r,), _BIG, device=dev),
             torch.full((r,), -1, dtype=torch.int32, device=dev),
             torch.zeros(r, dtype=torch.int32, device=dev),
             torch.zeros(r, dtype=torch.bool, device=dev),
             torch.full((r,), 2**30, dtype=torch.int32, device=dev))
    for base, center, cc, valid in p.sph:
        t, hit, front = _sphere_chunk(oc, dc, do, oo, center, cc, valid, t_min,
                                      t_max)
        carry = _fold_best(carry, t, hit, front, base, KIND_SPHERE, 0)
    for base, *terms, valid in p.quad:
        t, hit, front = _quad_chunk(oc, dc, *terms, valid, t_min, t_max)
        carry = _fold_best(carry, t, hit, front, base, KIND_QUAD, p.n_sph)
    if p.tri:
        wc = _cols(cross3(o, d))
        for base, *terms, valid in p.tri:
            t, hit, front = _tri_chunk(oc, dc, wc, *terms, valid, t_min, t_max)
            carry = _fold_best(carry, t, hit, front, base, KIND_TRIANGLE,
                               p.n_sph + p.n_quad)
    best_t, best_kind, best_idx, best_front, _ = carry
    return resolve_hit(scene, o, d, best_t, best_kind, best_idx, best_front,
                       t_min, kinds=(bool(p.sph), bool(p.quad), bool(p.tri)))


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(_norm(v), 1e-30)[:, None]


def resolve_hit(scene, o, d, t, kind, idx, front, t_min: float,
                kinds=(True, True, True)) -> HitRecord:
    """Position, normal, material (and UV on image-textured scenes) of
    each ray's winning primitive, from per-ray gathers.  `kinds` says
    which of spheres, quads and triangles can win (a kind without a valid
    primitive never does; its attributes are not computed)."""
    hit = kind >= 0
    pos = o + torch.where(hit, t, 0.0)[:, None] * d
    zeros3 = torch.zeros_like(pos)
    zeros1 = torch.zeros_like(kind)
    image = scene.tex_atlas is not None
    normal, mat, uv = zeros3, zeros1, zeros3[:, :2]

    if kinds[2]:  # the triangle's barycentrics, recomputed for the winner
        t_idx = torch.clamp(idx, 0, scene.tri_v0.shape[0] - 1).long()
        v0 = scene.tri_v0[t_idx]
        e1 = scene.tri_v1[t_idx] - v0
        e2 = scene.tri_v2[t_idx] - v0
        s = o - v0
        s1 = cross3(d, e2)
        s2 = cross3(s, e1)
        div = dot3(s1, e1)
        div = torch.where(div == 0.0, 1.0, div)
        b1 = dot3(s1, s) / div
        b2 = dot3(s2, d) / div
        b0 = 1.0 - b1 - b2
        tn = (b0[:, None] * scene.tri_n0[t_idx]
              + b1[:, None] * scene.tri_n1[t_idx]
              + b2[:, None] * scene.tri_n2[t_idx])
        tri_back = dot3(tn, d) > 0.0
        normal = _unit(torch.where(tri_back[:, None], -tn, tn))
        mat = scene.tri_mat[t_idx]
        front = torch.where(kind == KIND_TRIANGLE, ~tri_back, front)
        if image:  # the barycentric blend of the vertex texcoords
            uv = (b0[:, None] * scene.tri_uv0[t_idx]
                  + b1[:, None] * scene.tri_uv1[t_idx]
                  + b2[:, None] * scene.tri_uv2[t_idx])

    if kinds[1]:
        q_idx = torch.clamp(idx, 0, scene.quad_normal.shape[0] - 1).long()
        q_n = scene.quad_normal[q_idx]
        is_q = (kind == KIND_QUAD)[:, None]
        normal = torch.where(is_q, torch.where(front[:, None], q_n, -q_n),
                             normal)
        mat = torch.where(is_q[:, 0], scene.quad_mat[q_idx], mat)
        if image:  # the half-extent coordinates in [-1, 1] mapped to [0, 1]
            qu = scene.quad_u[q_idx]
            qv = scene.quad_v[q_idx]
            rel = pos - scene.quad_center[q_idx]
            q_u = 0.5 + 0.5 * (dot3(rel, qu)
                               / torch.clamp_min(dot3(qu, qu), 1e-30))
            q_v = 0.5 + 0.5 * (dot3(rel, qv)
                               / torch.clamp_min(dot3(qv, qv), 1e-30))
            uv = torch.where(is_q, torch.stack([q_u, q_v], dim=1), uv)

    if kinds[0]:
        s_idx = torch.clamp(idx, 0, scene.sph_center.shape[0] - 1).long()
        out_n = _unit(pos - scene.sph_center[s_idx])
        is_s = (kind == KIND_SPHERE)[:, None]
        normal = torch.where(is_s, torch.where(front[:, None], out_n, -out_n),
                             normal)
        mat = torch.where(is_s[:, 0], scene.sph_mat[s_idx], mat)
        if image:  # the equirectangular map of the outward unit normal
            s_u = 0.5 + ieee.atan2(out_n[:, 2], out_n[:, 0]) / (2.0 * math.pi)
            s_v = 0.5 - ieee.asin(torch.clamp(out_n[:, 1], -1.0, 1.0)) / math.pi
            uv = torch.where(is_s, torch.stack([s_u, s_v], dim=1), uv)

    return HitRecord(
        t=torch.where(hit, t, float("inf")),
        hit=hit,
        pos=pos,
        normal=torch.where(hit[:, None], normal, 0.0),
        front=front & hit,
        mat=torch.where(hit, mat, 0).to(torch.int32),
        kind=kind,
        idx=idx,
        uv=uv if image else None,
    )
