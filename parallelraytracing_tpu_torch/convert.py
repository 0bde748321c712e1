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
from parallelraytracing_tpu_torch.engines.tables import InstanceTables, SceneTables
from parallelraytracing_tpu_torch.ops.pack import (LIGHT_ROWS, check_instance_layout,
                                                   instance_ranges)

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
                      device, bb=((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
                      lights=None, nee: bool = False,
                      inst=None) -> SceneTables:
    """SceneTables on `device` from packed host tables (either package's
    ``pack_scene_tables``), the sky 3-tuple and the scene box ``bb`` =
    ((lo), (1 / extent)) of the sort key (the JAX engine tables' ``bb``;
    it only orders the wavefront queue, never changes an image).
    `lights` is either package's ``pack_lights_table`` (default: the
    (28, 1) zero table of a scene without lights) and `nee` whether the
    trace samples it: pass True only for a table of real lights (the JAX
    engine tables' ``nee``).  `inst` is either package's
    ``pack_instance_tables`` output (itri, iacc, ibox, inst), or None for
    a scene without instances; take the JAX package's unsplit (25, Nt)
    itri from ``pack_instance_tables``, not the engine tables' ``inst[0]``,
    which may be only the 16-row hot half of a hot/cold split."""
    def dev(a):
        return torch.from_numpy(
            np.array(a, dtype=np.float32, order="C")).to(device)

    tri = np.asarray(tri, np.float32)
    if lights is None:
        if nee:
            raise ValueError("nee needs the light table")
        lights = np.zeros((LIGHT_ROWS, 1), np.float32)
    if inst is not None:
        itri, iacc, ibox, irec = (np.asarray(a, np.float32) for a in inst)
        check_instance_layout(itri.shape[0], iacc.shape[0])
        inst = InstanceTables(itri=dev(itri), iacc=dev(iacc), ibox=dev(ibox),
                              inst=dev(irec),
                              ranges=instance_ranges(iacc, irec))
    return SceneTables(
        sph=dev(sph), quad=dev(quad), tri=dev(tri), sph_cl=dev(sph_cl),
        quad_cl=dev(quad_cl), tri_cl=dev(tri_cl), mats=dev(mats),
        sky=tuple(float(s) for s in np.asarray(sky, np.float32)),
        tri_live=bool(np.any(tri[0:3] != 0.0)), lights=dev(lights),
        nee=bool(nee), bb=tuple(tuple(float(x) for x in v) for v in bb),
        inst=inst)
