"""Per-frame BVH refit for animated scenes (the counterpart of
``parallelraytracing_tpu.accel.refit``).

The reference builds its acceleration structure once and never refits.
Here a refit is a level sweep on the device:

- the threaded preorder layout encodes children implicitly: an internal
  node s has its left child at s + 1 and its right child at
  node_miss[s + 1] (the left subtree's escape link lands on its sibling);
- a host plan groups the internal nodes by depth once, at build;
- each frame, the leaf boxes are recomputed from the (moved) primitive
  arrays and the unions sweep bottom-up, deepest level first: one
  indexed assignment per level.

The topology is kept as long as the primitives' identity is (same counts
and kinds); only positions and sizes may change.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from parallelraytracing_tpu_torch.accel.lbvh import BVHData
from parallelraytracing_tpu_torch.core.scene import KIND_QUAD, KIND_SPHERE


@dataclasses.dataclass(frozen=True)
class RefitPlan:
    """Per-level (node, left, right) index triples of the internal nodes,
    deepest level first, and the quad padding of the build."""

    levels: Tuple[Tuple[np.ndarray, np.ndarray, np.ndarray], ...]
    quad_pad: float = 1e-2


def build_refit_plan(bvh: BVHData) -> RefitPlan:
    kind = bvh.node_kind.cpu().numpy()
    miss = bvh.node_miss.cpu().numpy()
    m = len(kind)
    if m == 1:
        return RefitPlan(levels=())
    depth = np.zeros(m, np.int32)
    for s in range(m):  # preorder: a parent's depth is set before its children
        if kind[s] < 0:
            depth[s + 1] = depth[s] + 1
            depth[miss[s + 1]] = depth[s] + 1
    internals = np.nonzero(kind < 0)[0]
    lefts = internals + 1
    rights = miss[internals + 1]
    levels: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    top = int(depth[internals].max()) if len(internals) else 0
    for d in range(top, -1, -1):
        sel = depth[internals] == d
        if sel.any():
            levels.append((internals[sel].astype(np.int32),
                           lefts[sel].astype(np.int32),
                           rights[sel].astype(np.int32)))
    return RefitPlan(levels=tuple(levels))


def leaf_aabbs(scene, kind: torch.Tensor, idx: torch.Tensor,
               quad_pad: float = 1e-2):
    """(M, 3) min and max boxes of the leaves from the current primitive
    arrays (an internal node gets a placeholder, overwritten by the
    sweep)."""
    si = torch.clamp(idx, 0, scene.sph_center.shape[0] - 1)
    sc = scene.sph_center[si]
    sr = scene.sph_radius[si][:, None]

    qi = torch.clamp(idx, 0, scene.quad_center.shape[0] - 1)
    qc = scene.quad_center[qi]
    ext = scene.quad_u[qi].abs() + scene.quad_v[qi].abs() + quad_pad

    ti = torch.clamp(idx, 0, scene.tri_v0.shape[0] - 1)
    v0, v1, v2 = scene.tri_v0[ti], scene.tri_v1[ti], scene.tri_v2[ti]

    k = kind[:, None]
    mn = torch.where(k == KIND_SPHERE, sc - sr,
                     torch.where(k == KIND_QUAD, qc - ext,
                                 torch.minimum(torch.minimum(v0, v1), v2)))
    mx = torch.where(k == KIND_SPHERE, sc + sr,
                     torch.where(k == KIND_QUAD, qc + ext,
                                 torch.maximum(torch.maximum(v0, v1), v2)))
    return mn, mx


def refit_bvh(bvh: BVHData, scene, plan: RefitPlan) -> BVHData:
    """Every node box recomputed from the scene's current primitives: the
    leaves from ``leaf_aabbs``, then one indexed assignment per level,
    deepest first."""
    mn, mx = leaf_aabbs(scene, bvh.node_kind, bvh.node_idx, plan.quad_pad)
    is_leaf = (bvh.node_kind >= 0)[:, None]
    node_min = torch.where(is_leaf, mn, bvh.node_min)
    node_max = torch.where(is_leaf, mx, bvh.node_max)
    if plan.levels:  # every level's triples in one copy to the device
        trip = torch.from_numpy(np.concatenate(
            [np.stack(level) for level in plan.levels], 1).astype(np.int64))
        trip = trip.to(node_min.device)
        start = 0
        for nodes, _, _ in plan.levels:
            n, lc, rc = trip[:, start:start + len(nodes)]
            start += len(nodes)
            node_min[n] = torch.minimum(node_min[lc], node_min[rc])
            node_max[n] = torch.maximum(node_max[lc], node_max[rc])
    return dataclasses.replace(bvh, node_min=node_min, node_max=node_max)
