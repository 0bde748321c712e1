"""State carried across from the JAX package.

The port's counterpart of weights: a scene's flat arrays and its packed
trace tables.  Both come in as numpy arrays (``np.asarray`` of the JAX
package's arrays), so this module imports nothing of JAX, and the tests
can run the JAX package's own tables through the port's trace — which
holds the kernel to the reference independently of the port's packer.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from parallelraytracing_tpu_torch.core.scene import SceneData
from parallelraytracing_tpu_torch.engines.tables import SceneTables

#: SceneData fields of the JAX package with no counterpart here yet (sky
#: models and textures, ROADMAP Queue 1 item 11)
_EXTENSIONS = ("sky_top", "sun", "mat_tex", "mat_tex_param", "tex_atlas",
               "tex_size", "tri_uv0", "tri_uv1", "tri_uv2")


def scene_data_from_numpy(arrays: dict, device) -> SceneData:
    """SceneData on `device` from the JAX package's SceneData fields as
    numpy, keyed by field name (e.g. ``{f: np.asarray(getattr(sd, f))}``).
    Extension fields must be absent or None."""
    used = [k for k in _EXTENSIONS if arrays.get(k) is not None]
    if used:
        raise NotImplementedError(
            f"SceneData fields {used}: ROADMAP Queue 1 item 11 (not ported yet)")
    return SceneData(**{
        f.name: torch.from_numpy(np.array(arrays[f.name])).to(device)
        for f in dataclasses.fields(SceneData)})


def tables_from_numpy(sph, quad, tri, sph_cl, quad_cl, tri_cl, mats, sky,
                      device) -> SceneTables:
    """SceneTables on `device` from packed host tables (either package's
    ``pack_scene_tables``) and the sky 3-tuple."""
    def dev(a):
        return torch.from_numpy(
            np.array(a, dtype=np.float32, order="C")).to(device)

    tri = np.asarray(tri, np.float32)
    return SceneTables(
        sph=dev(sph), quad=dev(quad), tri=dev(tri), sph_cl=dev(sph_cl),
        quad_cl=dev(quad_cl), tri_cl=dev(tri_cl), mats=dev(mats),
        sky=tuple(float(s) for s in np.asarray(sky, np.float32)),
        tri_live=bool(np.any(tri[0:3] != 0.0)))
