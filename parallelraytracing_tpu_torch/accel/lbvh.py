"""LBVH construction: Morton codes, a Karras binary radix tree, and its
threaded (stackless) preorder layout (the counterpart of
``parallelraytracing_tpu.accel.lbvh``).

One linear BVH over every primitive of a scene (spheres, quads and
triangles in one tree), flattened in depth-first order with escape links
so that a walk needs no stack:

    node = 0
    while node != -1:
        if the box is hit:  node = node + 1 (preorder child) [or test the leaf]
        else:               node = miss_link[node]  (escape the subtree)

The build is host numpy at scene-compile time, as in the JAX package;
``BVHData.to`` moves the arrays to a device once.  Quad leaf boxes are
padded by 0.01, like the reference's quad acceleration structure.  The
JAX package also has a native C++ builder (``native/src/lbvh.cpp``,
topology bit-identical to this one); the port builds with this Python
builder only.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from parallelraytracing_tpu_torch import native
from parallelraytracing_tpu_torch.core import geometry as geo
from parallelraytracing_tpu_torch.core.scene import (KIND_QUAD, KIND_SPHERE,
                                                     KIND_TRIANGLE)


@dataclasses.dataclass(frozen=True)
class BVHData:
    """Threaded BVH in preorder.  M = 2N - 1 nodes (N primitives); a hit
    continues to node + 1, a miss jumps to node_miss (-1 ends the walk)."""

    node_min: torch.Tensor   # (M, 3) float32
    node_max: torch.Tensor   # (M, 3) float32
    node_kind: torch.Tensor  # (M,) int32: KIND_* for leaves, -1 internal
    node_idx: torch.Tensor   # (M,) int32: index into the kind's arrays
    node_miss: torch.Tensor  # (M,) int32: escape link, -1 ends the walk
    node_ord: torch.Tensor   # (M,) int32: global primitive ordinal

    @property
    def num_nodes(self) -> int:
        return int(self.node_miss.shape[0])

    def to(self, device) -> "BVHData":
        return BVHData(**{f.name: getattr(self, f.name).to(device)
                          for f in dataclasses.fields(self)})


# ----------------------------------------------------------------- morton

def _expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of v over 30 bits (x -> x<<2 interleave)."""
    v = v.astype(np.uint64)
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(points01: np.ndarray) -> np.ndarray:
    """(N, 3) in [0, 1] -> (N,) uint64 30-bit Morton codes."""
    q = np.clip(points01 * 1024.0, 0.0, 1023.0).astype(np.uint64)
    return (_expand_bits(q[:, 0]) << 2) | (_expand_bits(q[:, 1]) << 1) \
        | _expand_bits(q[:, 2])


def _clz64(x: np.ndarray) -> np.ndarray:
    """Leading zeros of uint64 values (vectorized, exact)."""
    x = x.astype(np.uint64)
    hi = (x >> np.uint64(32)).astype(np.uint32)
    lo = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    def clz32(v):
        v = v.astype(np.int64)
        bl = np.zeros_like(v)
        nz = v > 0
        bl[nz] = np.floor(np.log2(v[nz])).astype(np.int64) + 1
        return 32 - bl

    return np.where(hi > 0, clz32(hi), 32 + clz32(lo)).astype(np.int64)


# ------------------------------------------------------------ karras tree

def _karras_tree(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Binary radix tree over sorted unique 64-bit keys.  Returns (left,
    right), the children of the N - 1 internal nodes; a child c encodes an
    internal node as c and a leaf as ~c."""
    n = len(keys)
    if n == 1:
        return np.zeros((0,), np.int64), np.zeros((0,), np.int64)
    i = np.arange(n - 1, dtype=np.int64)

    def delta(a, b):
        """Common-prefix length of keys[a] and keys[b]; -1 out of range."""
        ok = (b >= 0) & (b < n)
        bb = np.clip(b, 0, n - 1)
        return np.where(ok, _clz64(keys[a] ^ keys[bb]), -1)

    d = np.sign(delta(i, i + 1) - delta(i, i - 1)).astype(np.int64)
    d = np.where(d == 0, 1, d)
    delta_min = delta(i, i - d)

    # exponential search for the range's other end
    lmax = np.full(n - 1, 2, np.int64)
    while True:
        probe = delta(i, i + lmax * d) > delta_min
        if not probe.any():
            break
        lmax = np.where(probe, lmax * 2, lmax)
        if (lmax > 4 * n).all():
            break

    # binary search of its exact length l
    l = np.zeros(n - 1, np.int64)
    t = lmax // 2
    while (t > 0).any():
        ok = (t > 0) & (delta(i, i + (l + t) * d) > delta_min)
        l = np.where(ok, l + t, l)
        t //= 2
    j = i + l * d

    # binary search of the split (the highest differing bit in the range):
    # steps of ceil(l/2), ceil(l/4), ...
    delta_node = delta(i, j)
    s = np.zeros(n - 1, np.int64)
    div = np.ones(n - 1, np.int64)
    while True:
        div *= 2
        t = (l + div - 1) // div
        ok = (t >= 1) & (delta(i, i + (s + t) * d) > delta_node)
        s = np.where(ok, s + t, s)
        if (t <= 1).all():
            break
    gamma = i + s * d + np.minimum(d, 0)

    lo = np.minimum(i, j)
    hi = np.maximum(i, j)
    left = np.where(lo == gamma, ~gamma, gamma)  # a leaf when its range is 1
    right = np.where(hi == gamma + 1, ~(gamma + 1), gamma + 1)
    return left, right


# ---------------------------------------------------------------- threading

def _subtree_sizes(left: np.ndarray, right: np.ndarray, n_leaves: int):
    """Node count of each internal node's subtree (iterative postorder)."""
    size = np.full(n_leaves - 1, -1, np.int64)
    stack = [(0, False)]
    while stack:
        node, processed = stack.pop()
        lc, rc = left[node], right[node]
        lsz = 1 if lc < 0 else size[lc]
        rsz = 1 if rc < 0 else size[rc]
        if processed or (lsz > 0 and rsz > 0):
            size[node] = 1 + lsz + rsz
        else:
            stack.append((node, True))
            if lc >= 0 and size[lc] < 0:
                stack.append((lc, False))
            if rc >= 0 and size[rc] < 0:
                stack.append((rc, False))
    return size


def thread_tree(left: np.ndarray, right: np.ndarray, n_leaves: int):
    """Preorder slots and escape links from explicit subtree sizes.
    Returns (is_leaf (M,), payload (M,), miss (M,)): payload is the
    sorted-leaf index of a leaf and the internal node's id otherwise."""
    if n_leaves == 1:
        return (np.array([True]), np.array([0], np.int64),
                np.array([-1], np.int64))
    size = _subtree_sizes(left, right, n_leaves)
    m = 2 * n_leaves - 1
    is_leaf = np.zeros(m, bool)
    payload = np.zeros(m, np.int64)
    miss = np.full(m, -1, np.int64)
    stack = [(0, False, -1)]
    out = 0
    while stack:
        code, leaf, escape = stack.pop()
        idx = out
        out += 1
        is_leaf[idx] = leaf
        payload[idx] = code
        miss[idx] = escape
        if not leaf:
            lc, rc = left[code], right[code]
            l_leaf, r_leaf = lc < 0, rc < 0
            l_code = ~lc if l_leaf else lc
            r_code = ~rc if r_leaf else rc
            right_slot = idx + 1 + (1 if l_leaf else size[l_code])
            stack.append((r_code, bool(r_leaf), escape))
            stack.append((l_code, bool(l_leaf), right_slot))
    assert out == m
    return is_leaf, payload, miss


# ------------------------------------------------------------------- build

def scene_primitive_aabbs(scene):
    """World boxes and (kind, index) of every valid primitive, spheres,
    then quads, then triangles; `scene` a SceneData or its ``numpy()``."""
    s = scene if isinstance(scene, dict) else scene.numpy()
    mins, maxs, kinds, idxs = [], [], [], []

    def add(kind, valid, box):
        mn, mx = box
        mins.append(mn)
        maxs.append(mx)
        kinds.append(np.full(len(mn), kind))
        idxs.append(np.nonzero(valid)[0])

    def f64(key, valid):
        return np.asarray(s[key], np.float64)[valid]

    sv = np.asarray(s["sph_valid"])
    if sv.any():
        add(KIND_SPHERE, sv, geo.sphere_aabb(f64("sph_center", sv),
                                             f64("sph_radius", sv)))
    qv = np.asarray(s["quad_valid"])
    if qv.any():
        add(KIND_QUAD, qv, geo.quad_aabb(f64("quad_center", qv),
                                         f64("quad_u", qv), f64("quad_v", qv)))
    tv = np.asarray(s["tri_valid"])
    if tv.any():
        add(KIND_TRIANGLE, tv, geo.triangle_aabb(
            f64("tri_v0", tv), f64("tri_v1", tv), f64("tri_v2", tv)))
    if not mins:
        return (np.zeros((0, 3)), np.zeros((0, 3)),
                np.zeros(0, np.int64), np.zeros(0, np.int64))
    return (np.concatenate(mins), np.concatenate(maxs),
            np.concatenate(kinds), np.concatenate(idxs))


def _sorted_tree(mn: np.ndarray, mx: np.ndarray):
    """Morton order of the boxes' centroids and the threaded tree over it:
    (order, is_leaf, payload, miss), payload of a leaf its sorted index.
    The primitive's rank in the low bits makes the Karras keys unique."""
    n = len(mn)
    centroid = (mn + mx) * 0.5
    lo = centroid.min(axis=0)
    extent = np.maximum(centroid.max(axis=0) - lo, 1e-12)
    codes = morton3d((centroid - lo) / extent)
    order = np.argsort(codes, kind="stable")
    keys = (codes[order].astype(np.uint64) << np.uint64(31)) \
        | np.arange(n, dtype=np.uint64)
    left, right = _karras_tree(keys)
    return (order,) + thread_tree(left, right, n)


def _union_boxes(node_min, node_max, is_leaf) -> None:
    """Fill the internal boxes in place from the leaves': a reverse
    preorder sweep with a stack, each internal node the union of the two
    subtrees that follow it."""
    stack = []
    for s in range(len(is_leaf) - 1, -1, -1):
        if is_leaf[s]:
            stack.append((node_min[s].copy(), node_max[s].copy()))
        else:
            mn1, mx1 = stack.pop()
            mn2, mx2 = stack.pop()
            node_min[s] = np.minimum(mn1, mn2)
            node_max[s] = np.maximum(mx1, mx2)
            stack.append((node_min[s], node_max[s]))
    assert len(stack) == 1


def build_threaded(mn: np.ndarray, mx: np.ndarray,
                   prefer_native: bool = True):
    """Threaded LBVH over N boxes (host numpy): (node_min (M, 3), node_max,
    is_leaf (M,), payload (M,), miss (M,)), M = 2N - 1; a leaf's payload is
    its ORIGINAL box index.  The core shared by the scene BVH and the
    two-level builder.  Built by the native C++ builder when it builds
    (native.py; the same arrays), else by the Python builder below, the
    reference."""
    n = len(mn)
    assert n >= 1
    if n == 1:
        return (mn.copy(), mx.copy(), np.array([True]),
                np.array([0], np.int64), np.array([-1], np.int64))
    if prefer_native and native.available():
        node_min, node_max, is_leaf, payload, miss, order = native.build_lbvh(
            mn.astype(np.float64), mx.astype(np.float64))
        payload = payload.astype(np.int64)
        payload[is_leaf] = order[payload[is_leaf]]
        return node_min, node_max, is_leaf, payload, miss.astype(np.int64)
    order, is_leaf, payload, miss = _sorted_tree(mn, mx)
    m = 2 * n - 1
    node_min = np.zeros((m, 3))
    node_max = np.zeros((m, 3))
    leaf_slots = np.nonzero(is_leaf)[0]
    src = order[payload[leaf_slots]]
    payload = payload.copy()
    payload[leaf_slots] = src
    node_min[leaf_slots] = mn[src]
    node_max[leaf_slots] = mx[src]
    _union_boxes(node_min, node_max, is_leaf)
    return node_min, node_max, is_leaf, payload, miss


def _global_ordinals(scene, kind: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Kind offset + index within the kind (spheres, quads, triangles): the
    tie-break of the brute-force fold and the kernels' ord columns, so a
    coplanar equal-t tie resolves to the same primitive on every path."""
    s = scene if isinstance(scene, dict) else scene.numpy()
    n_sph = int(np.asarray(s["sph_valid"]).shape[0])
    n_quad = int(np.asarray(s["quad_valid"]).shape[0])
    off = np.where(kind == KIND_SPHERE, 0,
                   np.where(kind == KIND_QUAD, n_sph, n_sph + n_quad))
    return off + idx


def _bvh_tensors(node_min, node_max, kind, idx, miss, ords) -> BVHData:
    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float64).astype(np.float32))

    def i32(a):
        return torch.from_numpy(np.asarray(a, np.int64).astype(np.int32))
    return BVHData(node_min=f32(node_min), node_max=f32(node_max),
                   node_kind=i32(kind), node_idx=i32(idx),
                   node_miss=i32(miss), node_ord=i32(ords))


def build_bvh(scene, device=None, prefer_native: bool = True) -> BVHData:
    """The threaded LBVH of a compiled scene (a SceneData), on `device`
    (the host when None), through ``build_threaded``: the native C++
    builder when it builds (the same arrays, faster on big meshes), else
    the Python builder, the reference semantics."""
    s = scene.numpy()
    mn, mx, kind, idx = scene_primitive_aabbs(s)
    if len(kind) == 0:
        bvh = _bvh_tensors(np.zeros((1, 3)), np.full((1, 3), -1.0),
                           [-1], [0], [-1], [0])
    else:
        node_min, node_max, is_leaf, payload, miss = build_threaded(
            mn, mx, prefer_native)
        m = len(miss)
        node_kind = np.full(m, -1, np.int64)
        node_idx = np.zeros(m, np.int64)
        node_ord = np.zeros(m, np.int64)
        leaf_slots = np.nonzero(is_leaf)[0]
        src = payload[leaf_slots]
        node_kind[leaf_slots] = kind[src]
        node_idx[leaf_slots] = idx[src]
        node_ord[leaf_slots] = _global_ordinals(s, kind[src], idx[src])
        bvh = _bvh_tensors(node_min, node_max, node_kind, node_idx, miss,
                           node_ord)
    return bvh if device is None else bvh.to(device)
