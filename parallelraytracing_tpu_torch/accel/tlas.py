"""Two-level instancing: the mesh-local arrays the instance packer reads.

The counterpart of ``parallelraytracing_tpu/accel/tlas.py``.  Each unique
mesh keeps one copy of its triangles in mesh-local space; instances are
{mesh, material, transform} records (``Scene.add_mesh_instances``), and
the kernels transform a ray into the mesh's space on entry without
renormalising its direction, so local t equals world t
(``ops/pack.pack_instance_tables``, ``csrc/bounce.cuh``).

Only ``_mesh_local_arrays`` is ported here: the packer needs it.  The jnp
mirror (``build_two_level``, ``tlas_intersect``,
``resolve_instanced_hit``) serves the JAX package's ``tlas_ref`` engine
and waits for the torch-eager engines (ROADMAP Queue 1 item 14).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _mesh_local_arrays(mesh) -> Tuple[np.ndarray, ...]:
    """(v0, v1, v2, n0, n1, n2) float64 (F, 3) arrays of a Mesh in its own
    space: vertex normals renormalised, or flat face normals when the mesh
    has none."""
    verts = np.asarray(mesh.vertices, np.float64)
    idx = np.asarray(mesh.indices, np.int64).reshape(-1, 3)
    v0, v1, v2 = verts[idx[:, 0]], verts[idx[:, 1]], verts[idx[:, 2]]
    if mesh.normals is not None and len(mesh.normals) == len(verts):
        nrm = np.asarray(mesh.normals, np.float64)
        lens = np.linalg.norm(nrm, axis=1, keepdims=True)
        nrm = nrm / np.maximum(lens, 1e-30)
        n0, n1, n2 = nrm[idx[:, 0]], nrm[idx[:, 1]], nrm[idx[:, 2]]
    else:
        gn = np.cross(v1 - v0, v2 - v0)
        ln = np.linalg.norm(gn, axis=1, keepdims=True)
        gn = np.where(ln > 0, gn / np.maximum(ln, 1e-30),
                      np.array([0.0, 1.0, 0.0]))
        n0 = n1 = n2 = gn
    return v0, v1, v2, n0, n1, n2
