"""Next-event estimation: the scene's samplable lights (host, numpy).

The counterpart of ``extract_lights`` in ``parallelraytracing_tpu/ops/
nee.py``.  A light is an emissive primitive: the reference has no light
objects, only emissive materials, so the lights are found in the compiled
scene.  The kernels sample one light per Lambertian vertex from the table
that ``ops/pack.pack_lights_table`` builds from these records, trace a
shadow ray, and add the direct term; emission is then skipped at the
next vertex when a diffuse bounce reached it (the alive == 2 mark of the
path state), so nothing is counted twice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from parallelraytracing_tpu_torch.core.scene import MAT_EMISSIVE

#: light kinds, the JAX package's KIND_SPHERE and KIND_QUAD
KIND_SPHERE = 0
KIND_QUAD = 1


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
