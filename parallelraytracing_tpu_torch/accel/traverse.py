"""Stackless BVH traversal (the counterpart of
``parallelraytracing_tpu.accel.traverse``).

Each ray walks the threaded preorder layout of accel/lbvh.py: a box hit
continues to node + 1, a miss jumps the escape link.  A leaf runs the
sphere, quad or Moller-Trumbore test inline, with the brute-force path's
front-face rules, and folds into the ray's closest hit by strict `<` with
the lowest global ordinal on a tie.  Slab tests are clipped by the ray's
best t so far.  The float contract is the JAX walk's: the 1e-20 clamps of
1/d, the slab test `tn <= min(best_t, t_max)`, the inline tests with the
multiply-adds fused as XLA's CPU backend fuses them (``dot3``, ``cross3``,
``fma``), and ``resolve_hit`` at the end.

On a device the walk is a loop over the live rays that never makes a ray
take a step it would not take in the JAX loop, so each ray's arithmetic,
and so the film, is the JAX walk's.  It runs in rounds: in a round every
live ray takes up to ``SUBSTEPS`` box-test steps and parks at the first
leaf whose box it hits; then one host read of four counts partitions the
rays (a prefix sum, stable) into those parked at a sphere, a quad or a
triangle leaf, those still walking, and those done, so each leaf test
runs on its own rays only, a kind the scene lacks runs nothing, and the
finished rays leave the set.  ``walk_counts`` counts the rounds and the
steps.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from parallelraytracing_tpu_torch.accel.lbvh import BVHData
from parallelraytracing_tpu_torch.core.scene import (KIND_QUAD, KIND_SPHERE,
                                                     KIND_TRIANGLE)
from parallelraytracing_tpu_torch.ops import ieee
from parallelraytracing_tpu_torch.ops.intersect import (HitRecord, cross3,
                                                        dot3, resolve_hit)
from parallelraytracing_tpu_torch.ops.rng import fma

_BIG = 3.0e38
#: box-test steps a walking ray takes in a round (between two host reads;
#: on an H100 the headline's bvh frame took 4.1 / 3.4 / 2.6 / 3.3 s at
#: 2 / 4 / 8 / 16, host-bound: benchmarks/walk_rounds.py)
SUBSTEPS = 8
#: walks run, their rounds (one host read each) and box-test steps
walk_counts = {"walks": 0, "rounds": 0, "steps": 0}
#: the float columns of a walking ray: origin, 1/d, direction, clip t
_O, _INV, _D, _CLIP = slice(0, 3), slice(3, 6), slice(6, 9), 9


def safe_inv(d: torch.Tensor) -> torch.Tensor:
    """1 / d with |d| clamped to at least 1e-20, keeping its sign."""
    return 1.0 / torch.where(d.abs() < 1e-20,
                             torch.where(d < 0, -1e-20, 1e-20), d)


def walk_table(node_min: torch.Tensor, node_max: torch.Tensor,
               hit_next: torch.Tensor, miss_next: torch.Tensor
               ) -> torch.Tensor:
    """(M, 8) int32 rows of a box-test step: the box's six floats (as
    bits), then the node a hit and a miss lead to (a code <= -2 parks the
    ray at a leaf, -1 ends its walk), so a step is one gather."""
    box = torch.cat([node_min, node_max], 1).float().contiguous()
    return torch.cat([box.view(torch.int32), hit_next[:, None].int(),
                      miss_next[:, None].int()], 1).contiguous()


def park_code(node: torch.Tensor) -> torch.Tensor:
    """The code of a ray parked at `node` (and back: it is an involution)."""
    return -node - 2


def box_steps(tab: torch.Tensor, node: torch.Tensor, ray: torch.Tensor,
              t_min: float, steps: int) -> torch.Tensor:
    """`steps` box-test steps of the walking rays (node >= 0) of `ray`
    ((A, 10): origin, 1/d, direction, clip t); parked and finished rays
    keep their node.  Returns the new nodes."""
    o, inv, clip = ray[:, None, _O], ray[:, None, _INV], ray[:, _CLIP]
    for _ in range(steps):
        rec = torch.index_select(tab, 0, node.clamp_min(0))
        # the slab's two planes of each axis at once: (A, 2, 3)
        t01 = (rec[:, :6].view(torch.float32).view(-1, 2, 3) - o) * inv
        tn = t01.amin(1).amax(1)
        tf = t01.amax(1).amin(1)
        hit = (tn <= tf) & (tf >= t_min) & (tn <= clip)
        node = torch.where(node >= 0, torch.where(hit, rec[:, 6], rec[:, 7]),
                           node)
    walk_counts["steps"] += steps
    return node


def partition(code: torch.Tensor, n_codes: int):
    """Stable partition of the rays by `code` in [0, n_codes), a code of
    n_codes dropping the ray: one prefix sum over the codes' indicators
    laid end to end, and one host read of the counts.  Returns (perm
    (kept,) int64 ray positions grouped by code, counts per code)."""
    a = code.shape[0]
    cats = torch.arange(n_codes, device=code.device, dtype=code.dtype)
    onehot = code[None, :] == cats[:, None]
    csum = onehot.view(-1).cumsum(0)
    ends = csum[a - 1::a].tolist()
    counts = [ends[0]] + [ends[i] - ends[i - 1] for i in range(1, n_codes)]
    kept = ends[-1]
    dest = (csum.view(n_codes, a) * onehot).sum(0) - 1
    perm = torch.empty(kept + 1, dtype=torch.int64, device=code.device)
    perm.index_copy_(0, torch.where(dest >= 0, dest, kept),
                     torch.arange(a, device=code.device))
    walk_counts["rounds"] += 1
    return perm[:kept], counts


@dataclasses.dataclass(frozen=True)
class BVHWalk:
    """A BVH's tables for the walk: the box-test rows, each node's
    (primitive index, ordinal, escape link) and the primitive kinds its
    leaves hold."""

    bvh: BVHData
    tab: torch.Tensor   # (M, 8) int32, walk_table
    leaf: torch.Tensor  # (M, 3) int32: idx, ord, miss
    kinds: Tuple[bool, bool, bool]


def bvh_walk(bvh: BVHData) -> BVHWalk:
    """The walk tables of `bvh` (one host read: the kinds it holds)."""
    m = bvh.num_nodes
    node = torch.arange(m, dtype=torch.int32, device=bvh.node_kind.device)
    hit_next = torch.where(bvh.node_kind >= 0, park_code(node), node + 1)
    kinds = set(bvh.node_kind.unique().tolist())
    return BVHWalk(bvh, walk_table(bvh.node_min, bvh.node_max, hit_next,
                                   bvh.node_miss),
                   torch.stack([bvh.node_idx, bvh.node_ord, bvh.node_miss], 1),
                   tuple(k in kinds for k in (KIND_SPHERE, KIND_QUAD,
                                              KIND_TRIANGLE)))


def _sphere_test(scene, pidx, o, d, t_min, t_max):
    sc = scene.sph_center[pidx]
    sr = scene.sph_radius[pidx]
    oc = o - sc
    b2 = dot3(d, oc)
    # XLA's CPU fusion: |oc|^2 summed unfused, r^2 fused into the subtraction
    c = fma(-sr, sr, (oc[:, 0] * oc[:, 0] + oc[:, 1] * oc[:, 1])
            + oc[:, 2] * oc[:, 2])
    disc = fma(b2, b2, -c)
    sq = ieee.sqrt(torch.clamp_min(disc, 0.0))
    near, far = -b2 - sq, -b2 + sq
    front = near >= t_min
    t = torch.where(front, near, far)
    return t, (disc >= 0.0) & (t >= t_min) & (t <= t_max), front


def _quad_test(scene, pidx, o, d, t_min, t_max):
    qn = scene.quad_normal[pidx]
    qc = scene.quad_center[pidx]
    qu = scene.quad_u[pidx]
    qv = scene.quad_v[pidx]
    dn = dot3(d, qn)
    ok_dn = dn.abs() >= 1e-8
    t = torch.where(ok_dn, dot3(qc - o, qn) / torch.where(ok_dn, dn, 1.0), 0.0)
    qp = fma(t[:, None], d, o) - qc
    qa = dot3(qp, qu) / torch.clamp_min(dot3(qu, qu), 1e-30)
    qb = dot3(qp, qv) / torch.clamp_min(dot3(qv, qv), 1e-30)
    ok = (ok_dn & (t > t_min) & (t <= t_max) & (qa * qa < 1.0)
          & (qb * qb < 1.0))
    return t, ok, dot3(o - qc, qn) > 0.0


def triangle_test(v0, v1, v2, o, d, t_min, t_max):
    """Moller-Trumbore of each ray against its triangle: (t, ok, b1, b2)."""
    e1 = v1 - v0
    e2 = v2 - v0
    sv = o - v0
    s1 = cross3(d, e2)
    s2 = cross3(sv, e1)
    div = dot3(s1, e1)
    ok_div = div != 0.0
    inv = torch.where(ok_div, 1.0 / torch.where(ok_div, div, 1.0), 0.0)
    t = dot3(s2, e2) * inv
    b1 = dot3(s1, sv) * inv
    b2 = dot3(s2, d) * inv
    ok = (ok_div & (t >= t_min) & (t <= t_max) & (b1 >= 0.0) & (b2 >= 0.0)
          & (b1 + b2 <= 1.0))
    return t, ok, b1, b2


def _tri_test(scene, pidx, o, d, t_min, t_max):
    t, ok, _, _ = triangle_test(scene.tri_v0[pidx], scene.tri_v1[pidx],
                                scene.tri_v2[pidx], o, d, t_min, t_max)
    return t, ok, torch.ones_like(ok)


_TESTS = ((KIND_SPHERE, _sphere_test), (KIND_QUAD, _quad_test),
          (KIND_TRIANGLE, _tri_test))


def bvh_intersect_scene(scene, bvh, o: torch.Tensor, d: torch.Tensor,
                        t_min: float, t_max: float) -> HitRecord:
    """Closest hit of the rays (o, d), each (R, 3) with d unit, through
    the threaded BVH (a BVHData, or its ``bvh_walk`` tables)."""
    walk = bvh if isinstance(bvh, BVHWalk) else bvh_walk(bvh)
    r, dev = o.shape[0], o.device
    best_t = torch.full((r,), _BIG, device=dev)
    # kind, idx, ordinal, front of each ray's best hit
    best_i = torch.tensor([-1, 0, 2**30, 0], dtype=torch.int32,
                          device=dev).repeat(r, 1)
    walk_counts["walks"] += 1
    if r and any(walk.kinds):
        node = torch.zeros(r, dtype=torch.int32, device=dev)
        act = torch.arange(r, device=dev)
        ray = torch.cat([o, safe_inv(d), d,
                         torch.full((r, 1), min(_BIG, t_max), device=dev)], 1)
        while True:
            node = box_steps(walk.tab, node, ray, t_min, SUBSTEPS)
            parked = node <= -2
            leaf_kind = walk.bvh.node_kind[park_code(node).clamp_min(0)]
            code = torch.where(parked, leaf_kind,
                               torch.where(node >= 0, 3, 4))
            perm, counts = partition(code, 4)
            if perm.numel() == 0:
                break
            node, act, ray = node[perm], act[perm], ray[perm]
            start = 0
            for (kind, test), n in zip(_TESTS, counts[:3]):
                if n:
                    node[start:start + n] = _leaf_fold(
                        scene, walk, kind, test, slice(start, start + n),
                        node, act, ray, best_t, best_i, t_min, t_max)
                start += n
    hit_kind = best_i[:, 0]
    return resolve_hit(scene, o, d,
                       torch.where(hit_kind >= 0, best_t, _BIG), hit_kind,
                       best_i[:, 1], best_i[:, 3].bool(), t_min,
                       kinds=walk.kinds)


def _leaf_fold(scene, walk, kind, test, sl, node, act, ray, best_t, best_i,
               t_min, t_max) -> torch.Tensor:
    """The leaf test of the rays of `sl` (all parked at a leaf of `kind`)
    folded into their best hits; updates their clip t and returns their
    next nodes (the leaves' escape links)."""
    lanes = act[sl]
    leaf = torch.index_select(walk.leaf, 0, park_code(node[sl]))
    pidx, pord = leaf[:, 0], leaf[:, 1]
    t, ok, front = test(scene, pidx, ray[sl, _O], ray[sl, _D], t_min, t_max)
    bt = best_t[lanes]
    bi = best_i[lanes]
    upd = ok & ((t < bt) | ((t == bt) & (pord < bi[:, 2])))
    new_t = torch.where(upd, t, bt)
    best_t[lanes] = new_t
    mine = torch.stack([torch.full_like(pidx, kind), pidx, pord,
                        front.int()], 1)
    best_i[lanes] = torch.where(upd[:, None], mine, bi)
    ray[sl, _CLIP] = new_t.clamp_max(t_max)
    return leaf[:, 2]
