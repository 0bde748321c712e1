"""Next-event estimation: the scene's samplable lights, and the
megakernel engine's light sampling.

The counterpart of ``extract_lights`` and ``sample_light`` in
``parallelraytracing_tpu/ops/nee.py``.  A light is an emissive
primitive: the reference has no light objects, only emissive materials,
so the lights are found in the compiled scene.  The kernels sample one light per Lambertian vertex from the table
that ``ops/pack.pack_lights_table`` builds from these records, trace a
shadow ray, and add the direct term; emission is then skipped at the
next vertex when a diffuse bounce reached it (the alive == 2 mark of the
path state), so nothing is counted twice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from parallelraytracing_tpu_torch.core.scene import (KIND_QUAD, KIND_SPHERE,
                                                     MAT_EMISSIVE)
from parallelraytracing_tpu_torch.ops import ieee
from parallelraytracing_tpu_torch.ops.intersect import cross3, dot3


@dataclasses.dataclass(frozen=True)
class Lights:
    """Flat records of the samplable emissive primitives, float32 except
    the ids."""

    kind: np.ndarray    # (Nl,) int32 KIND_*
    idx: np.ndarray     # (Nl,) int32 index within its kind
    center: np.ndarray  # (Nl, 3)
    radius: np.ndarray  # (Nl,) spheres only
    u: np.ndarray       # (Nl, 3) quads only: half-extent edges
    v: np.ndarray       # (Nl, 3)
    normal: np.ndarray  # (Nl, 3) quads only: unit normal
    emit: np.ndarray    # (Nl, 3)

    @property
    def count(self) -> int:
        return int(self.kind.shape[0])

    def to(self, device) -> "Lights":
        """The same records as tensors on `device` (``sample_light``'s
        form), moved once per scene."""
        return Lights(**{f.name: torch.as_tensor(getattr(self, f.name),
                                                 device=device)
                         for f in dataclasses.fields(self)})


def extract_lights(scene: dict) -> Optional[Lights]:
    """The emissive spheres and then the emissive quads of a scene's arrays
    (``SceneData.numpy()`` or the JAX package's SceneData fields as numpy),
    each in index order, as the JAX package enumerates them.  None when
    the scene has no light."""
    mt = np.asarray(scene["mat_type"])
    emit = np.asarray(scene["mat_emit"], np.float32)
    sm = np.asarray(scene["sph_mat"])
    qm = np.asarray(scene["quad_mat"])
    s_ids = np.nonzero(np.asarray(scene["sph_valid"])
                       & (mt[sm] == MAT_EMISSIVE))[0]
    q_ids = np.nonzero(np.asarray(scene["quad_valid"])
                       & (mt[qm] == MAT_EMISSIVE))[0]
    if len(s_ids) + len(q_ids) == 0:
        return None

    def rows(key, ids, width=3):
        return np.asarray(scene[key], np.float32)[ids].reshape(len(ids), width)

    zeros = np.zeros((len(s_ids), 3), np.float32)
    return Lights(
        kind=np.concatenate([np.full(len(s_ids), KIND_SPHERE),
                             np.full(len(q_ids), KIND_QUAD)]).astype(np.int32),
        idx=np.concatenate([s_ids, q_ids]).astype(np.int32),
        center=np.concatenate([rows("sph_center", s_ids),
                               rows("quad_center", q_ids)]),
        radius=np.concatenate([rows("sph_radius", s_ids, 1)[:, 0],
                               np.zeros(len(q_ids), np.float32)]),
        u=np.concatenate([zeros, rows("quad_u", q_ids)]),
        v=np.concatenate([zeros, rows("quad_v", q_ids)]),
        normal=np.concatenate([zeros, rows("quad_normal", q_ids)]),
        emit=np.concatenate([emit[sm[s_ids]], emit[qm[q_ids]]]))


_TWO_PI = 2.0 * math.pi


def sample_light(lights: Lights, p: torch.Tensor, u3: torch.Tensor
                 ) -> Tuple[torch.Tensor, ...]:
    """One light sample per shading point, for the megakernel engine.

    lights: ``Lights.to(device)``; p (R, 3) surface points; u3 (R, 3)
    uniforms (the light's pick, then two for the point on it).  Returns
    (wi (R, 3) unit, pdf (R,) per steradian including the uniform 1/Nl
    pick, valid (R,), kind (R,), idx (R,), emit (R, 3)).  A sphere light
    is sampled uniformly in its cone of directions (pdf 1 / (2 pi (1 -
    cos theta_max)), invalid from inside it); a quad light uniformly in
    area, its pdf converted to solid angle."""
    nl = lights.count
    li = torch.clamp((u3[:, 0] * nl).to(torch.int32), 0, nl - 1).long()
    kind = lights.kind[li]
    c = lights.center[li]
    r = lights.radius[li]
    lu = lights.u[li]
    lv = lights.v[li]
    ln = lights.normal[li]
    emit = lights.emit[li]
    u1 = u3[:, 1]
    u2 = u3[:, 2]

    # sphere: cone sampling toward the sphere
    to_c = c - p
    dc2 = dot3(to_c, to_c)
    dc = ieee.sqrt(torch.clamp_min(dc2, 1e-20))
    axis = to_c / dc[:, None]
    sin2_max = torch.clamp(r * r / torch.clamp_min(dc2, 1e-20), 0.0, 1.0)
    cos_max = ieee.sqrt(torch.clamp_min(1.0 - sin2_max, 0.0))
    cos_t = 1.0 - u1 * (1.0 - cos_max)
    sin_t = ieee.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = _TWO_PI * u2
    # an orthonormal frame around the axis
    h = torch.zeros_like(axis)
    away = torch.abs(axis[:, 0]) > 0.9
    h[:, 0] = torch.where(away, 0.0, 1.0)
    h[:, 1] = torch.where(away, 1.0, 0.0)
    t1 = cross3(axis, h)
    t1 = t1 / torch.clamp_min(ieee.sqrt(dot3(t1, t1)), 1e-20)[:, None]
    t2 = cross3(axis, t1)
    wi_s = (axis * cos_t[:, None]
            + (t1 * ieee.cos(phi)[:, None]
               + t2 * ieee.sin(phi)[:, None])
            * sin_t[:, None])
    pdf_s = 1.0 / torch.clamp_min(_TWO_PI * (1.0 - cos_max), 1e-12)
    s_valid = dc2 > r * r

    # quad: area sampling, the pdf in solid angle
    q = c + (2.0 * u1 - 1.0)[:, None] * lu + (2.0 * u2 - 1.0)[:, None] * lv
    dq = q - p
    dist2 = dot3(dq, dq)
    dist = ieee.sqrt(torch.clamp_min(dist2, 1e-20))
    wi_q = dq / dist[:, None]
    cl = cross3(lu, lv)
    area = 4.0 * ieee.sqrt(dot3(cl, cl))
    cos_l = torch.abs(dot3(wi_q, ln))
    pdf_q = dist2 / torch.clamp_min(cos_l * area, 1e-12)
    q_valid = (cos_l > 1e-6) & (dist2 > 1e-12)

    is_sph = kind == KIND_SPHERE
    wi = torch.where(is_sph[:, None], wi_s, wi_q)
    pdf = torch.where(is_sph, pdf_s, pdf_q) / nl
    valid = torch.where(is_sph, s_valid, q_valid)
    return wi, pdf, valid, kind, lights.idx[li], emit
