"""Two-level instancing: a top-level tree over instances, one bottom-level
tree per unique mesh (the counterpart of
``parallelraytracing_tpu/accel/tlas.py``).

Each unique mesh keeps one copy of its triangles in mesh-local space and
one threaded LBVH over them; instances are {mesh, material, transform}
records (``Scene.add_mesh_instances``), and a small threaded tree over
the instances' world boxes routes the rays.  A ray entering an instance
leaf is moved into the mesh's space by the inverse transform without
renormalising its direction, so local t equals world t and hits compose
across instances and the flat primitives without rescaling.  The kernels
read the same local arrays through ``ops/pack.pack_instance_tables``
(``_mesh_local_arrays``); ``build_two_level``, ``tlas_intersect`` and
``resolve_instanced_hit`` serve the `tlas_ref` engine.

``tlas_intersect`` walks both levels as one threaded walk over the
concatenated nodes (accel/traverse.py's rounds): a ray carries its
current ray (world in the top tree, local in a mesh's tree); entering an
instance leaf, testing a triangle leaf and leaving a mesh's tree (its
escape link -1) park the ray until the round's end, where each runs on
its own rays.  A ray's sequence of tests is the JAX walk's.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from parallelraytracing_tpu_torch.accel import traverse
from parallelraytracing_tpu_torch.accel.lbvh import build_threaded
from parallelraytracing_tpu_torch.accel.traverse import (
    _CLIP, _D, _INV, _O, box_steps, park_code, partition, safe_inv,
    triangle_test, walk_table)
from parallelraytracing_tpu_torch.ops.ieee import sqrt
from parallelraytracing_tpu_torch.ops.intersect import dot3
from parallelraytracing_tpu_torch.ops.rng import fma

_BIG = 3.0e38


@dataclasses.dataclass(frozen=True)
class TwoLevelBVH:
    """The top tree, the instances, the concatenated mesh trees and the
    local triangle soup, as tensors."""

    # top tree (threaded preorder over instances; t_inst -1 internal)
    t_min: torch.Tensor   # (Mt, 3) float32
    t_max: torch.Tensor   # (Mt, 3)
    t_miss: torch.Tensor  # (Mt,) int32
    t_inst: torch.Tensor  # (Mt,) int32

    # instances
    inst_root: torch.Tensor  # (Ni,) int32 node index of the mesh tree's root
    inst_inv: torch.Tensor   # (Ni, 3, 4) float32 world -> local affine
    inst_nrm: torch.Tensor   # (Ni, 3, 3) float32 local normal -> world
    inst_mat: torch.Tensor   # (Ni,) int32 material id

    # concatenated mesh trees (threaded; escape links global, -1 leaves
    # the mesh's tree; b_tri -1 internal)
    b_min: torch.Tensor   # (Mb, 3)
    b_max: torch.Tensor   # (Mb, 3)
    b_miss: torch.Tensor  # (Mb,) int32
    b_tri: torch.Tensor   # (Mb,) int32 index into the local triangles

    # local triangle soup, concatenated across the unique meshes
    v0: torch.Tensor  # (Nt, 3)
    v1: torch.Tensor
    v2: torch.Tensor
    n0: torch.Tensor
    n1: torch.Tensor
    n2: torch.Tensor

    @property
    def num_instances(self) -> int:
        return int(self.inst_mat.shape[0])

    @property
    def num_unique_triangles(self) -> int:
        return int(self.v0.shape[0])

    def to(self, device) -> "TwoLevelBVH":
        return TwoLevelBVH(**{f.name: getattr(self, f.name).to(device)
                              for f in dataclasses.fields(self)})


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


def build_two_level(meshes: Sequence, instances: Sequence[Tuple[int, int,
                                                                np.ndarray]],
                    device=None) -> TwoLevelBVH:
    """The two levels of unique `meshes` and their `instances` ((mesh
    index, material id, 4x4 world transform) records), on `device` (the
    host when None)."""
    assert len(instances) >= 1, "the top tree needs at least one instance"
    tri_arrays: List[List[np.ndarray]] = [[] for _ in range(6)]
    b_min, b_max, b_miss, b_tri = [], [], [], []
    mesh_root, mesh_box = [], []
    node_off = tri_off = 0
    for mesh in meshes:
        arrays = _mesh_local_arrays(mesh)
        for a, arr in zip(tri_arrays, arrays):
            a.append(arr)
        v0, v1, v2 = arrays[:3]
        nmn, nmx, is_leaf, payload, miss = build_threaded(
            np.minimum(np.minimum(v0, v1), v2), np.maximum(np.maximum(v0, v1), v2))
        b_min.append(nmn)
        b_max.append(nmx)
        b_miss.append(np.where(miss >= 0, miss + node_off, -1))
        b_tri.append(np.where(is_leaf, payload + tri_off, -1))
        mesh_root.append(node_off)
        mesh_box.append((nmn[0], nmx[0]))  # the preorder root is node 0
        node_off += len(miss)
        tri_off += len(v0)

    inst_root, inst_inv, inst_nrm, inst_mat, w_mn, w_mx = [], [], [], [], [], []
    for mesh_i, mat_id, m4 in instances:
        m4 = np.asarray(m4, np.float64)
        inv = np.linalg.inv(m4)
        inst_root.append(mesh_root[mesh_i])
        inst_inv.append(inv[:3, :4])
        inst_nrm.append(inv[:3, :3].T)  # the linear part's inverse transpose
        inst_mat.append(mat_id)
        lo, hi = mesh_box[mesh_i]
        corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                            for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
        wc = corners @ m4[:3, :3].T + m4[:3, 3]
        w_mn.append(wc.min(0))
        w_mx.append(wc.max(0))
    tmn, tmx, t_leaf, t_payload, t_miss = build_threaded(np.asarray(w_mn),
                                                         np.asarray(w_mx))

    def f32(a):
        a = np.concatenate(a) if isinstance(a, list) else np.asarray(a)
        return torch.from_numpy(np.asarray(a, np.float64).astype(np.float32))

    def i32(a):
        a = np.concatenate(a) if isinstance(a, list) else np.asarray(a)
        return torch.from_numpy(np.asarray(a, np.int64).astype(np.int32))

    tl = TwoLevelBVH(
        t_min=f32(tmn), t_max=f32(tmx), t_miss=i32(t_miss),
        t_inst=i32(np.where(t_leaf, t_payload, -1)),
        inst_root=i32(np.asarray(inst_root)), inst_inv=f32(np.asarray(inst_inv)),
        inst_nrm=f32(np.asarray(inst_nrm)), inst_mat=i32(np.asarray(inst_mat)),
        b_min=f32(b_min), b_max=f32(b_max), b_miss=i32(b_miss), b_tri=i32(b_tri),
        v0=f32(tri_arrays[0]), v1=f32(tri_arrays[1]), v2=f32(tri_arrays[2]),
        n0=f32(tri_arrays[3]), n1=f32(tri_arrays[4]), n2=f32(tri_arrays[5]))
    return tl if device is None else tl.to(device)


def _mat_vec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(R, 3, 3) x (R, 3) -> (R, 3), each row's sum in XLA's CPU order
    for ``einsum("rij,rj->ri")``: the products fused into one chain,
    fma(m2, v2, fma(m1, v1, m0 v0))."""
    return fma(m[:, :, 2], v[:, None, 2],
               fma(m[:, :, 1], v[:, None, 1], m[:, :, 0] * v[:, None, 0]))


@dataclasses.dataclass(frozen=True)
class TLASWalk:
    """Both levels as one threaded walk: nodes [0, Mt) the top tree's,
    [Mt, Mt + Mb) the mesh trees'; EXIT parks a ray leaving a mesh tree."""

    tl: TwoLevelBVH
    tab: torch.Tensor  # (Mt + Mb, 8) int32, traverse.walk_table
    mt: int
    exit: int


def tlas_walk(tl: TwoLevelBVH) -> TLASWalk:
    mt, mb = int(tl.t_miss.shape[0]), int(tl.b_miss.shape[0])
    dev = tl.t_miss.device
    t_node = torch.arange(mt, dtype=torch.int32, device=dev)
    b_node = torch.arange(mt, mt + mb, dtype=torch.int32, device=dev)
    exit_code = park_code(torch.tensor(mt + mb, dtype=torch.int32))
    b_next = torch.where(tl.b_miss >= 0, tl.b_miss + mt, exit_code.to(dev))
    hit_next = torch.cat([
        torch.where(tl.t_inst >= 0, park_code(t_node), t_node + 1),
        torch.where(tl.b_tri >= 0, park_code(b_node), b_node + 1)])
    tab = walk_table(torch.cat([tl.t_min, tl.b_min]),
                     torch.cat([tl.t_max, tl.b_max]), hit_next,
                     torch.cat([tl.t_miss, b_next]))
    return TLASWalk(tl, tab, mt, mt + mb)


#: parked-ray codes of a round: entering an instance, a triangle leaf,
#: leaving a mesh tree; then walking, done
_ENTER, _TRI, _EXIT, _WALK = 0, 1, 2, 3


def tlas_intersect(tl, o: torch.Tensor, d: torch.Tensor, t_min: float,
                   t_max: float):
    """Closest instanced-triangle hit of the world rays (o, d), each (R,
    3), d unit; `tl` a TwoLevelBVH or its ``tlas_walk``.  Returns (t,
    inst, tri, b1, b2): world distance (BIG on a miss), the winning
    instance and local triangle, and its barycentrics."""
    walk = tl if isinstance(tl, TLASWalk) else tlas_walk(tl)
    tl = walk.tl
    r, dev = o.shape[0], o.device
    inv = safe_inv(d)
    best_f = torch.zeros((r, 3), device=dev)  # t, b1, b2
    best_f[:, 0] = _BIG
    best_i = torch.zeros((r, 2), dtype=torch.int32, device=dev)  # inst, tri
    node = torch.zeros(r, dtype=torch.int32, device=dev)
    act = torch.arange(r, device=dev)
    lane = torch.zeros((r, 2), dtype=torch.int32, device=dev)  # esc, inst
    ray = torch.cat([o, inv, d, torch.full((r, 1), min(_BIG, t_max),
                                           device=dev)], 1)
    while r:
        node = box_steps(walk.tab, node, ray, t_min, traverse.SUBSTEPS)
        leaf = park_code(node)
        code = torch.where(node >= 0, _WALK, 4)
        code = torch.where(leaf >= 0, torch.where(leaf < walk.mt, _ENTER, _TRI),
                           code)
        code = torch.where(leaf == walk.exit, _EXIT, code)
        perm, counts = partition(code, 4)
        if perm.numel() == 0:
            break
        node, act, lane, ray = node[perm], act[perm], lane[perm], ray[perm]
        a = counts[_ENTER]
        b = a + counts[_TRI]
        c = b + counts[_EXIT]
        if a:  # enter the instance: the local ray, its mesh tree's root
            sl = slice(0, a)
            tn = park_code(node[sl])
            inst = tl.t_inst[tn]
            inv4 = tl.inst_inv[inst]
            lanes = act[sl]
            lo = _mat_vec(inv4[:, :, :3], o[lanes]) + inv4[:, :, 3]
            ld = _mat_vec(inv4[:, :, :3], d[lanes])
            ray[sl, _O], ray[sl, _INV], ray[sl, _D] = lo, safe_inv(ld), ld
            lane[sl] = torch.stack([tl.t_miss[tn], inst], 1)
            node[sl] = tl.inst_root[inst] + walk.mt
        if b > a:  # the triangle leaf, then its escape link
            sl = slice(a, b)
            bn = park_code(node[sl]) - walk.mt
            tri = tl.b_tri[bn]
            tt, ok, b1, b2 = triangle_test(tl.v0[tri], tl.v1[tri], tl.v2[tri],
                                           ray[sl, _O], ray[sl, _D], t_min,
                                           t_max)
            lanes = act[sl]
            bf = best_f[lanes]
            upd = ok & (tt < bf[:, 0])
            best_f[lanes] = torch.where(upd[:, None],
                                        torch.stack([tt, b1, b2], 1), bf)
            best_i[lanes] = torch.where(
                upd[:, None], torch.stack([lane[sl, 1], tri], 1),
                best_i[lanes])
            ray[sl, _CLIP] = best_f[lanes, 0].clamp_max(t_max)
            node[sl] = walk.tab[bn + walk.mt, 7]
        if c > b:  # leave the mesh tree: the world ray, the top tree's escape
            sl = slice(b, c)
            lanes = act[sl]
            ray[sl, _O], ray[sl, _INV], ray[sl, _D] = o[lanes], inv[lanes], d[lanes]
            node[sl] = lane[sl, 0]
    return (best_f[:, 0], best_i[:, 0], best_i[:, 1], best_f[:, 1],
            best_f[:, 2])


def resolve_instanced_hit(tl: TwoLevelBVH, o, d, t, inst, tri, b1, b2):
    """World position, normal, front flag and material of each ray's
    winning instanced triangle (a lane with t = BIG gets values its caller
    masks)."""
    ii = torch.clamp(inst, 0, tl.num_instances - 1)
    ti = torch.clamp(tri, 0, tl.num_unique_triangles - 1)
    b0 = 1.0 - b1 - b2
    nl = (b0[:, None] * tl.n0[ti] + b1[:, None] * tl.n1[ti]
          + b2[:, None] * tl.n2[ti])
    nw = _mat_vec(tl.inst_nrm[ii], nl)
    back = dot3(nw, d) > 0.0
    nw = torch.where(back[:, None], -nw, nw)
    nw = nw / torch.clamp_min(sqrt(dot3(nw, nw)), 1e-30)[:, None]
    pos = o + t[:, None] * d
    return pos, nw, ~back, tl.inst_mat[ii]
