"""Scene-table packing for the trace kernel (host, numpy).

The counterpart of ``pack_scene_tables`` in
``parallelraytracing_tpu/ops/pallas_trace.py``, on its default path: one
(C, N) float32 table per primitive kind, each column one primitive, plus a
per-kind acceleration table and the compressed material table.  The
tables are EQUAL to the JAX package's (``pack_scene_tables(..., eye=None)``),
so either package's tables can feed either trace.

    sph  (6, Ns):  cx cy cz r2 mid ord
    quad (14, Nq): n(3) cn us(3) cu vs(3) cv mid ord
    tri  (27, Nt): ng(3) p0ng e1(3) e2(3) e2xp0(3) p0xe1(3) mid ord
                   n0(3) n1(3) n2(3); a scene with image textures
                   (``tri_uv0`` in its arrays) adds rows 27-32, the
                   texture coordinates u0 v0 u1 v1 u2 v2 (33 rows)
    mats (5, Nm):  mtype c(3) extra — c is the emission of an emissive
                   material and the albedo otherwise; extra is roughness
                   (metal), IoR (dielectric) or 1.

Invalid and padding primitives are never-hit geometry (sphere r2 = -1,
quad zero normal with cu = cv = 2, triangle zero geometric normal), so
the hit tests read no valid flag.  ``ord`` is the global primitive
ordinal (spheres, then quads, then triangles): the tie-break of the
closest-hit fold.

Acceleration tables, chosen per kind by cluster count:
- more than TREE_THRESHOLD clusters: a binned-SAH BVH over the
  primitives, emitted as a threaded preorder table (8, M): rows 0-5 the
  box (min xyz, max xyz), row 6 the escape link (-1 ends the walk), row 7
  a leaf's run packed as lo*64 + span (-1 for an internal node).  The
  primitive columns are permuted into leaf order.
- otherwise: a linear table (6, n_cl + 1) of the union box of each run of
  CLUSTER primitives, plus the kind's root box as the last column.

Instanced meshes get four more tables (``pack_instance_tables``): the
unique meshes' local triangles, their concatenated threaded trees, the
instances' world boxes and the instance records.  Image textures are
packed as rows of 128 texels (``pack_kernel_textures``).

The JAX package's other layouts (Karras tree, ordered tree, straggler-tail
views, SBVH, tile-SAH, streamed big-mesh blocks, eye-ordered linear
scans) are left out: none is on its default path, and the eye ordering
changes no result, since the closest-hit fold does not depend on order.
"""

from __future__ import annotations

import sys

import numpy as np

from parallelraytracing_tpu_torch.core import geometry as geo
from parallelraytracing_tpu_torch.core.scene import MAT_DIELECTRIC, MAT_EMISSIVE, MAT_METAL
from parallelraytracing_tpu_torch.ops.textures import TEX_IMAGE_BASE

#: primitives per leaf / linear cluster, sphere and quad kinds
CLUSTER = 24
#: primitives per leaf / linear cluster, triangle kind
TRI_CLUSTER = 4
#: more clusters than this switch a kind from the linear scan to the tree
TREE_THRESHOLD = 4
#: splice internal nodes whose surface area is >= this x their parent's
COLLAPSE_TAU = 0.6
#: triangle count above which the JAX package streams the mesh from HBM
STREAM_THRESHOLD = 24576
#: SAH bins per axis
_NB = 16


def _expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of v over 30 bits (x -> x<<2 interleave)."""
    v = v.astype(np.uint64)
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(points01: np.ndarray) -> np.ndarray:
    """(N,3) in [0,1] -> (N,) uint64 30-bit Morton codes."""
    q = np.clip(points01 * 1024.0, 0.0, 1023.0).astype(np.uint64)
    return (_expand_bits(q[:, 0]) << 2) | (_expand_bits(q[:, 1]) << 1) \
        | _expand_bits(q[:, 2])


def _cluster_bounds(mn: np.ndarray, mx: np.ndarray, csize: int) -> np.ndarray:
    """(N,3)x2 AABBs -> (6, ceil(N/csize)) cluster-union bounds."""
    n = len(mn)
    n_cl = max(1, -(-n // csize))
    out = np.zeros((6, n_cl), np.float32)
    for c in range(n_cl):
        lo, hi = c * csize, min((c + 1) * csize, n)
        if lo >= n:
            out[:3, c] = 1.0
            out[3:, c] = -1.0  # empty (inverted) box: never hit
        else:
            out[:3, c] = mn[lo:hi].min(0)
            out[3:, c] = mx[lo:hi].max(0)
    return out


def _area(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])


def _sah_threaded_tree(mn: np.ndarray, mx: np.ndarray, csize: int,
                       collapse_tau: float = COLLAPSE_TAU):
    """Binned-SAH BVH over primitive AABBs -> (perm, (8, M) threaded table).

    Top-down build with 16 bins per axis; leaves hold <= csize primitives
    and their boxes are the exact union of those primitives.  Invalid
    primitives (inverted boxes) go last in `perm`, outside every leaf run.
    Internal nodes whose area is >= collapse_tau x their parent's are
    spliced out of the emitted table (their children hang off the
    parent); the escape-link encoding takes any arity, and the leaf runs
    are unchanged."""
    n = len(mn)
    valid = (mn <= mx).all(1)
    ids_v = np.nonzero(valid)[0]
    ids_i = np.nonzero(~valid)[0]
    if len(ids_v) == 0:
        out = np.zeros((8, 1), np.float32)
        out[:3, 0] = 1.0
        out[3:6, 0] = -1.0
        out[6, 0] = -1.0
        out[7, 0] = 0.0  # empty leaf: lo = 0, span = 0
        return np.arange(n), out

    perm_out = []
    # node records: [mn(3), mx(3), kind, a, b]; kind 0 internal (a, b =
    # child record ids), kind 1 leaf (a, b = perm range lo, hi)
    recs = []
    sys.setrecursionlimit(max(10000, sys.getrecursionlimit()))

    def build(ids, rmn, rmx, depth=0):
        bmn = rmn.min(0)
        bmx = rmx.max(0)
        rcen = (rmn + rmx) * 0.5
        if len(ids) <= csize:
            lo = len(perm_out)
            perm_out.extend(ids.tolist())
            recs.append([bmn, bmx, 1, lo, len(perm_out)])
            return len(recs) - 1
        cmin = rcen.min(0)
        ext = rcen.max(0) - cmin
        best = None  # (cost, axis, bins, split)
        # Beyond depth 60 force median splits so recursion stays bounded.
        if depth > 60:
            order = np.argsort(rcen[:, int(np.argmax(ext))], kind="stable")
            half = len(ids) // 2
            ol, orr = order[:half], order[half:]
            rec = [bmn, bmx, 0, -1, -1]
            recs.append(rec)
            me = len(recs) - 1
            rec[3] = build(ids[ol], rmn[ol], rmx[ol], depth + 1)
            rec[4] = build(ids[orr], rmn[orr], rmx[orr], depth + 1)
            return me
        for ax in range(3):
            if ext[ax] <= 1e-12:
                continue
            b = np.minimum(((rcen[:, ax] - cmin[ax]) / ext[ax]
                            * _NB).astype(np.int64), _NB - 1)
            counts = np.bincount(b, minlength=_NB)
            bin_mn = np.full((_NB, 3), np.inf)
            bin_mx = np.full((_NB, 3), -np.inf)
            for k in range(_NB):
                sel = b == k
                if counts[k]:
                    bin_mn[k] = rmn[sel].min(0)
                    bin_mx[k] = rmx[sel].max(0)
            pre_a = np.zeros(_NB)
            suf_a = np.zeros(_NB)
            cmn = np.full(3, np.inf)
            cmx = np.full(3, -np.inf)
            for k in range(_NB):
                cmn = np.minimum(cmn, bin_mn[k])
                cmx = np.maximum(cmx, bin_mx[k])
                pre_a[k] = _area(cmn, cmx) if np.isfinite(cmn).all() else 0.0
            cmn = np.full(3, np.inf)
            cmx = np.full(3, -np.inf)
            for k in range(_NB - 1, -1, -1):
                cmn = np.minimum(cmn, bin_mn[k])
                cmx = np.maximum(cmx, bin_mx[k])
                suf_a[k] = _area(cmn, cmx) if np.isfinite(cmn).all() else 0.0
            pre_n = np.cumsum(counts)
            for k in range(_NB - 1):
                nl = pre_n[k]
                nr = len(ids) - nl
                if nl == 0 or nr == 0:
                    continue
                cost = pre_a[k] * nl + suf_a[k + 1] * nr
                if best is None or cost < best[0]:
                    best = (cost, ax, b, k)
        if best is None:
            half = len(ids) // 2
            sel = np.zeros(len(ids), bool)
            sel[:half] = True
        else:
            _, ax, b, k = best
            sel = b <= k
        rec = [bmn, bmx, 0, -1, -1]
        recs.append(rec)
        me = len(recs) - 1
        rec[3] = build(ids[sel], rmn[sel], rmx[sel], depth + 1)
        rec[4] = build(ids[~sel], rmn[~sel], rmx[~sel], depth + 1)
        return me

    root = build(ids_v, mn[ids_v].astype(np.float64),
                 mx[ids_v].astype(np.float64))
    perm = np.concatenate([np.asarray(perm_out, np.int64),
                           ids_i]).astype(np.int64)
    assert len(perm) == n and len(set(perm.tolist())) == n

    # Per-record (contiguous) perm ranges: children have higher record
    # ids than their parent, so one reverse sweep.
    m = len(recs)
    rlo = np.zeros(m, np.int64)
    rhi = np.zeros(m, np.int64)
    for ri in range(m - 1, -1, -1):
        _, _, kind, a, b = recs[ri]
        if kind == 1:
            rlo[ri], rhi[ri] = a, b
        else:
            rlo[ri] = min(rlo[a], rlo[b])
            rhi[ri] = max(rhi[a], rhi[b])

    rarea = np.array([_area(np.asarray(r[0]), np.asarray(r[1]))
                      for r in recs])
    kids_memo = {}

    def is_leaf_rec(ri):
        return recs[ri][2] == 1

    def kids_of(ri):
        """Spliced child list of an internal record."""
        ks = kids_memo.get(ri)
        if ks is None:
            ks = []
            for c in (recs[ri][3], recs[ri][4]):
                if (not is_leaf_rec(c) and collapse_tau > 0.0
                        and rarea[c] >= collapse_tau * rarea[ri]):
                    ks.extend(kids_of(c))
                else:
                    ks.append(c)
            kids_memo[ri] = ks
        return ks

    # Threaded preorder with escape links: child i escapes to its next
    # sibling's slot, the last child to the parent's escape.
    size = np.ones(m, np.int64)
    for ri in range(m - 1, -1, -1):
        if not is_leaf_rec(ri):
            size[ri] = 1 + sum(size[c] for c in kids_of(ri))
    out = np.zeros((8, size[root]), np.float32)
    slot = 0
    stack = [(root, -1)]
    while stack:
        ri, esc = stack.pop()
        bmn, bmx, kind, a, b = recs[ri]
        out[:3, slot] = bmn
        out[3:6, slot] = bmx
        out[6, slot] = esc
        if is_leaf_rec(ri):
            lo, span = rlo[ri], rhi[ri] - rlo[ri]
            assert 0 <= span < 64
            if lo * 64 + span >= (1 << 24):
                raise ValueError(
                    f"threaded-tree leaf encoding overflows the f32 integer "
                    f"range at {lo + span} primitives (lo*64+span must stay "
                    f"< 2^24, i.e. < {1 << 18} primitives per table)")
            out[7, slot] = lo * 64 + span
        else:
            out[7, slot] = -1.0
            ks = kids_of(ri)
            nxt = slot + 1
            escs = []
            for c in ks:
                nxt += size[c]
                escs.append(nxt)  # next sibling's slot
            escs[-1] = esc        # last child exits like the parent
            for c, e in zip(reversed(ks), reversed(escs)):
                stack.append((c, e))
        slot += 1
    assert slot == size[root]
    return perm, out


def _append_root(cl, mn2, mx2):
    """Append the kind's union box as the last column of a linear table
    (the root pretest); invalid primitives are left out of the union."""
    valid = (mn2 <= mx2).all(1)
    root = np.zeros((6, 1), np.float32)
    if valid.any():
        root[:3, 0] = mn2[valid].min(0)
        root[3:, 0] = mx2[valid].max(0)
    else:
        root[:3, 0] = 1.0
        root[3:, 0] = -1.0
    return np.concatenate([cl, root], axis=1)


def _accelerate(tab, mn2, mx2, csize):
    """(tab permuted into leaf order, acceleration table) for one kind."""
    cl = _cluster_bounds(mn2, mx2, csize)
    if cl.shape[1] > TREE_THRESHOLD:
        perm, tree = _sah_threaded_tree(mn2, mx2, csize)
        return np.ascontiguousarray(tab[:, perm]), tree
    return tab, _append_root(cl, mn2, mx2)


def _morton_order(mn, mx):
    cen = (mn + mx) * 0.5
    lo = cen.min(0)
    ext = np.maximum(cen.max(0) - lo, 1e-12)
    return np.argsort(morton3d((cen - lo) / ext), kind="stable")


def scene_bbox(scene: dict, ibox=None):
    """The scene's bounding box as ((lo xyz), (1 / extent xyz)): the frame
    in which wavefront_fused quantises ray origins for its sort key.  The
    union of the world boxes of every valid primitive (the role of
    ``accel/lbvh.scene_primitive_aabbs`` in the JAX package's
    ``engines/tables.py``) and of the instance world boxes ``ibox``
    ((6, Ni), ``pack_instance_tables``) when given; the unit box when the
    scene is empty."""
    mins, maxs = [], []
    if ibox is not None:
        mins.append(np.asarray(ibox)[:3].T)
        maxs.append(np.asarray(ibox)[3:].T)
    sv = np.asarray(scene["sph_valid"])
    if sv.any():
        mn, mx = geo.sphere_aabb(
            np.asarray(scene["sph_center"], np.float64)[sv],
            np.asarray(scene["sph_radius"], np.float64)[sv])
        mins.append(mn)
        maxs.append(mx)
    qv = np.asarray(scene["quad_valid"])
    if qv.any():
        mn, mx = geo.quad_aabb(*(np.asarray(scene[k], np.float64)[qv]
                                 for k in ("quad_center", "quad_u", "quad_v")))
        mins.append(mn)
        maxs.append(mx)
    tv = np.asarray(scene["tri_valid"])
    if tv.any():
        mn, mx = geo.triangle_aabb(*(np.asarray(scene[k], np.float64)[tv]
                                     for k in ("tri_v0", "tri_v1", "tri_v2")))
        mins.append(mn)
        maxs.append(mx)
    if mins:
        lo = np.concatenate(mins).min(0)
        ext = np.maximum(np.concatenate(maxs).max(0) - lo, 1e-9)
    else:
        lo = np.zeros(3)
        ext = np.ones(3)
    return (tuple(float(x) for x in lo), tuple(float(1.0 / x) for x in ext))


def pack_scene_tables(scene: dict):
    """Pack a scene's arrays (``SceneData.numpy()`` or the JAX package's
    SceneData fields as numpy, keyed by field name) into
    (sph, quad, tri, sph_cl, quad_cl, tri_cl, mats) float32 tables."""
    mt = np.asarray(scene["mat_type"], np.float32)
    alb = np.asarray(scene["mat_albedo"], np.float32)
    emit = np.asarray(scene["mat_emit"], np.float32)
    rough = np.asarray(scene["mat_rough"], np.float32)
    ior = np.asarray(scene["mat_ior"], np.float32)
    mc = np.where((mt == MAT_EMISSIVE)[:, None], emit, alb)
    extra = np.where(mt == MAT_METAL, rough,
                     np.where(mt == MAT_DIELECTRIC, ior, 1.0))
    mats = np.stack([mt, mc[:, 0], mc[:, 1], mc[:, 2], extra],
                    axis=0).astype(np.float32)

    def mat_cols(ids):
        return np.asarray(ids, np.float32)[None]

    n_sph_full = int(np.asarray(scene["sph_valid"]).shape[0])
    n_quad_full = int(np.asarray(scene["quad_valid"]).shape[0])

    # --- spheres
    c = np.asarray(scene["sph_center"], np.float32)
    r = np.asarray(scene["sph_radius"], np.float32)
    sv = np.asarray(scene["sph_valid"])
    s_mn, s_mx = geo.sphere_aabb(c.astype(np.float64), r.astype(np.float64))
    s_ord = _morton_order(s_mn, s_mx)
    c, r, sv = c[s_ord], r[s_ord], sv[s_ord]
    # r2 = -1 makes the discriminant provably negative: never hit.
    r2 = np.where(sv, r * r, -1.0).astype(np.float32)
    sph = np.concatenate([
        c.T, r2[None],
        mat_cols(np.asarray(scene["sph_mat"])[s_ord]),
        s_ord.astype(np.float32)[None]], axis=0)
    s_mn2 = np.where(sv[:, None], s_mn[s_ord], np.float64(1.0))
    s_mx2 = np.where(sv[:, None], s_mx[s_ord], np.float64(-1.0))
    sph, sph_cl = _accelerate(sph, s_mn2, s_mx2, CLUSTER)

    # --- quads
    qn = np.asarray(scene["quad_normal"], np.float32)
    qc = np.asarray(scene["quad_center"], np.float32)
    qu = np.asarray(scene["quad_u"], np.float32)
    qv = np.asarray(scene["quad_v"], np.float32)
    qvd = np.asarray(scene["quad_valid"])
    q_mn, q_mx = geo.quad_aabb(qc.astype(np.float64), qu.astype(np.float64),
                               qv.astype(np.float64))
    q_ord = _morton_order(q_mn, q_mx)
    qn, qc, qu, qv, qvd = qn[q_ord], qc[q_ord], qu[q_ord], qv[q_ord], qvd[q_ord]
    us = qu / np.maximum((qu * qu).sum(1, keepdims=True), 1e-30)
    vs = qv / np.maximum((qv * qv).sum(1, keepdims=True), 1e-30)
    cn = (qc * qn).sum(1)
    cu = (qc * us).sum(1)
    cv = (qc * vs).sum(1)
    # Invalid quads: zero normal fails |d.n| >= 1e-8 and cu = cv = 2 fail
    # the extent test.
    qm = qvd[:, None]
    qn = np.where(qm, qn, 0.0)
    us = np.where(qm, us, 0.0)
    vs = np.where(qm, vs, 0.0)
    cn = np.where(qvd, cn, 0.0)
    cu = np.where(qvd, cu, 2.0)
    cv = np.where(qvd, cv, 2.0)
    quad = np.concatenate([
        qn.T, cn[None], us.T, cu[None], vs.T, cv[None],
        mat_cols(np.asarray(scene["quad_mat"])[q_ord]),
        (q_ord + n_sph_full).astype(np.float32)[None]], axis=0)
    q_mn2 = np.where(qvd[:, None], q_mn[q_ord], np.float64(1.0))
    q_mx2 = np.where(qvd[:, None], q_mx[q_ord], np.float64(-1.0))
    quad, quad_cl = _accelerate(quad, q_mn2, q_mx2, CLUSTER)

    # --- triangles (dense columns)
    v0 = np.asarray(scene["tri_v0"], np.float32)
    v1 = np.asarray(scene["tri_v1"], np.float32)
    v2 = np.asarray(scene["tri_v2"], np.float32)
    tvd_raw = np.asarray(scene["tri_valid"])
    if len(tvd_raw) > STREAM_THRESHOLD:
        raise NotImplementedError(
            "meshes above STREAM_THRESHOLD triangles (the streamed layout): "
            "ROADMAP Queue 1 item 12")
    t_mn, t_mx = geo.triangle_aabb(v0.astype(np.float64),
                                   v1.astype(np.float64),
                                   v2.astype(np.float64))
    t_ord = _morton_order(t_mn, t_mx)
    v0, v1, v2 = v0[t_ord], v1[t_ord], v2[t_ord]
    e1 = v1 - v0
    e2 = v2 - v0
    ng = np.cross(e1, e2)
    p0ng = (v0 * ng).sum(1)
    e2xp0 = np.cross(e2, v0)
    p0xe1 = np.cross(v0, e1)
    tvd = tvd_raw[t_ord]
    # Invalid triangles: a zero geometric normal makes div == 0 -> miss.
    ng = np.where(tvd[:, None], ng, 0.0)
    p0ng = np.where(tvd, p0ng, 0.0)
    tri_rows = [
        ng.T, p0ng[None], e1.T, e2.T, e2xp0.T, p0xe1.T,
        mat_cols(np.asarray(scene["tri_mat"])[t_ord]),
        (t_ord + n_sph_full + n_quad_full).astype(np.float32)[None],
        np.asarray(scene["tri_n0"], np.float32)[t_ord].T,
        np.asarray(scene["tri_n1"], np.float32)[t_ord].T,
        np.asarray(scene["tri_n2"], np.float32)[t_ord].T]
    if scene.get("tri_uv0") is not None:
        tri_rows += [np.asarray(scene[f"tri_uv{k}"], np.float32)[t_ord].T
                     for k in range(3)]
    tri = np.concatenate(tri_rows, axis=0)
    t_mn2 = np.where(tvd[:, None], t_mn[t_ord], np.float64(1.0))
    t_mx2 = np.where(tvd[:, None], t_mx[t_ord], np.float64(-1.0))
    tri, tri_cl = _accelerate(tri, t_mn2, t_mx2, TRI_CLUSTER)

    return (np.ascontiguousarray(sph), np.ascontiguousarray(quad),
            np.ascontiguousarray(tri), sph_cl, quad_cl, tri_cl,
            np.ascontiguousarray(mats))


#: rows of the triangle table, without and with texture coordinates
TRI_ROWS, TRI_UV_ROWS = 27, 33
#: rows of the instance tables: local triangles, BLAS nodes, world boxes,
#: instance records; and of the local triangles with texture coordinates
ITRI_ROWS, IACC_ROWS, IBOX_ROWS, INST_ROWS = 25, 8, 6, 24
ITRI_UV_ROWS = 31


def pack_instance_tables(inst_meshes, instances, ord_base: float,
                         ordered: bool = False, with_uv: bool = False):
    """Host tables for the kernels' instance block, the JAX package's
    ``pack_instance_tables`` on its default (threaded) layout, equal to
    it bit for bit.

    inst_meshes: the unique meshes; instances: (mesh index, material id,
    4x4 world transform) records (``Scene.instances``); ord_base: the
    first free global ordinal (the column count of the flat sphere, quad
    and triangle kinds, pads included).

    Returns float32 (itri (25 or 31, Nt), iacc (8, Mb), ibox (6, Ni),
    inst (24, Ni)):
    - itri: the unique meshes' triangles in mesh-local space, each mesh
      Morton-sorted, then permuted into its tree's leaf order:
      [ng(3) p0ng e1(3) e2(3) e2xp0(3) p0xe1(3) n0(3) n1(3) n2(3)];
      ``with_uv`` (a scene with image textures) adds rows 25-30
      [u0 v0 u1 v1 u2 v2], the mesh's texture coordinates (zeros for a
      mesh without them);
    - iacc: each mesh's binned-SAH threaded tree (the layout of
      ``_sah_threaded_tree``), concatenated: escape links shifted to
      global node indices (-1 ends the mesh's walk), leaf runs
      ``lo*64 + span`` shifted by the mesh's first itri column;
    - ibox: each instance's world box (its mesh's local root box, the 8
      corners transformed);
    - inst: per instance [tree root, world->local affine (12, row-major
      3x4), local normal -> world (9, the inverse transpose), material
      id, ordinal base].  An instanced triangle's ordinal is its
      instance's base plus its itri column.

    ``ordered`` (the near-first explicit-pointer tree) is not ported."""
    if ordered:
        raise NotImplementedError(
            "the ordered (near-first) instance trees: ROADMAP Queue 1 "
            "item 13 (left out, a TPU mechanism)")
    from parallelraytracing_tpu_torch.accel.tlas import _mesh_local_arrays

    itri_cols, iacc_cols, mesh_root, mesh_bbox = [], [], [], []
    node_off = 0
    tri_off = 0
    for mesh in inst_meshes:
        v0, v1, v2, n0, n1, n2 = (a.astype(np.float64)
                                  for a in _mesh_local_arrays(mesh))
        mn = np.minimum(np.minimum(v0, v1), v2)
        mx = np.maximum(np.maximum(v0, v1), v2)
        order = _morton_order(mn, mx)
        v0, v1, v2 = v0[order], v1[order], v2[order]
        n0, n1, n2 = n0[order], n1[order], n2[order]
        mn, mx = mn[order], mx[order]
        e1 = v1 - v0
        e2 = v2 - v0
        ng = np.cross(e1, e2)
        nt = len(v0)
        rows = [ng.T, (v0 * ng).sum(1)[None], e1.T, e2.T, np.cross(e2, v0).T,
                np.cross(v0, e1).T, n0.T, n1.T, n2.T]
        if with_uv:
            tc = mesh.texcoords
            if tc is not None and len(tc):
                tc = np.asarray(tc, np.float64)
                tri_idx = np.asarray(mesh.indices, np.int64).reshape(-1, 3)
                rows += [tc[tri_idx[:, k]][order].T for k in range(3)]
            else:
                rows += [np.zeros((2, nt))] * 3
        tab = np.concatenate(rows, axis=0).astype(np.float32)
        perm, tree = _sah_threaded_tree(mn, mx, TRI_CLUSTER)
        tab = np.ascontiguousarray(tab[:, perm])
        tree = tree.copy()
        tree[6] = np.where(tree[6] >= 0, tree[6] + node_off, -1.0)
        leaf = tree[7] >= 0
        enc = tree[7, leaf].astype(np.int64) + np.int64(tri_off) * 64
        if enc.size and enc.max() >= (1 << 24):
            raise ValueError(
                f"instance BLAS leaf encoding overflows the f32 integer "
                f"range: cumulative unique-mesh triangles {tri_off + nt} "
                f"exceed the {1 << 18}-triangle packed cap (lo*64+span "
                f"must stay < 2^24); decimate or split the meshes")
        tree[7, leaf] = enc.astype(np.float32)
        itri_cols.append(tab)
        iacc_cols.append(tree)
        mesh_root.append(node_off)
        mesh_bbox.append((mn.min(0), mx.max(0)))
        node_off += tree.shape[1]
        tri_off += nt

    itri = np.ascontiguousarray(np.concatenate(itri_cols, axis=1))
    iacc = np.ascontiguousarray(np.concatenate(iacc_cols, axis=1))
    ibox = np.zeros((IBOX_ROWS, len(instances)), np.float32)
    inst = np.zeros((INST_ROWS, len(instances)), np.float32)
    for k, (mi, mid, m4) in enumerate(instances):
        m4 = np.asarray(m4, np.float64)
        inv = np.linalg.inv(m4)
        lo, hi = mesh_bbox[mi]
        corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                            for y in (lo[1], hi[1])
                            for z in (lo[2], hi[2])])
        wc = corners @ m4[:3, :3].T + m4[:3, 3]
        ibox[:3, k] = wc.min(0)
        ibox[3:, k] = wc.max(0)
        inst[0, k] = mesh_root[mi]
        inst[1:13, k] = inv[:3, :4].reshape(-1)
        inst[13:22, k] = inv[:3, :3].T.reshape(-1)
        inst[22, k] = mid
        inst[23, k] = ord_base + k * tri_off  # tri_off: all local triangles
    return itri, iacc, ibox, inst


def check_instance_layout(itri_rows: int, iacc_rows: int) -> None:
    """Refuse instance tables of a layout the kernels do not read: an itri
    of other than 25 rows (31 with texture coordinates) and the JAX
    package's ordered trees (10-row iacc)."""
    if itri_rows not in (ITRI_ROWS, ITRI_UV_ROWS):
        raise ValueError(f"itri has {itri_rows} rows: want {ITRI_ROWS}, or "
                         f"{ITRI_UV_ROWS} with texture coordinates")
    if iacc_rows != IACC_ROWS:
        raise NotImplementedError(
            f"the ordered (near-first) instance trees ({iacc_rows}-row "
            f"iacc): ROADMAP Queue 1 item 13 (left out, a TPU mechanism); "
            f"want {IACC_ROWS} rows")


def instance_ranges(iacc: np.ndarray, inst: np.ndarray) -> tuple:
    """Each instance's run of itri columns, ((lo, hi), ...), read from the
    tables themselves: a mesh's tree occupies the iacc columns from its
    root (inst row 0) to its last leaf in preorder, the first leaf at or
    after the root whose escape link is -1, and its triangles are the
    union of those leaves' runs.  The plain versions test each instance
    against its own mesh's triangles only."""
    iacc = np.asarray(iacc)
    ranges = []
    for root in np.asarray(inst)[0].astype(np.int64):
        node, lo, hi = int(root), None, None
        while True:
            enc = iacc[7, node]
            if enc >= 0:
                a = int(enc) >> 6
                b = a + (int(enc) & 63)
                lo = a if lo is None else min(lo, a)
                hi = b if hi is None else max(hi, b)
                if iacc[6, node] < 0:
                    break
            node += 1
        ranges.append((lo, hi))
    return tuple(ranges)


#: texels per row of the packed texture table
TEX_LANES = 128
#: the largest image side the kernels take (the JAX package's KTEX_MAX,
#: kept for parity: its kernels fetch a texel by a loop over the rows)
KTEX_MAX = 128


def pack_kernel_textures(scene: dict):
    """The image textures of a scene's arrays for the kernels, the JAX
    package's ``pack_kernel_textures`` bit for bit.

    Returns (itex, rows):
    - itex: ((material id, first row, height, width), ...) for every
      image-textured material, in material order;
    - rows: (Rt, 128) float32: each texture quantised to 8 bits a channel
      and packed r * 65536 + g * 256 + b (exact integers below 2**24),
      texels row-major, 128 to a row, each texture starting a new row
      (a texture used by several materials is packed once).

    Raises NotImplementedError for an image above KTEX_MAX texels on a
    side."""
    mat_tex = np.asarray(scene["mat_tex"])
    atlas = np.asarray(scene["tex_atlas"])
    size = np.asarray(scene["tex_size"])
    chunks, tex_off, itex = [], {}, []
    off = 0
    for mid, tex in enumerate(mat_tex):
        if tex < TEX_IMAGE_BASE:
            continue
        tid = int(tex - TEX_IMAGE_BASE)
        th, tw = int(size[tid, 0]), int(size[tid, 1])
        if th > KTEX_MAX or tw > KTEX_MAX:
            raise NotImplementedError(
                f"image texture {tid} is {th}x{tw}: the kernels take at most "
                f"{KTEX_MAX}x{KTEX_MAX} (the JAX package's KTEX_MAX); larger "
                f"images: ROADMAP Queue 1 item 14 (the jnp engines' atlas)")
        if tid not in tex_off:
            img = np.clip(np.round(atlas[tid, :th, :tw] * 255.0), 0.0, 255.0)
            packed = (img[..., 0] * 65536.0 + img[..., 1] * 256.0
                      + img[..., 2]).reshape(-1)
            packed = np.concatenate([packed,
                                     np.zeros((-len(packed)) % TEX_LANES)])
            rows = packed.reshape(-1, TEX_LANES).astype(np.float32)
            tex_off[tid] = off
            chunks.append(rows)
            off += rows.shape[0]
        itex.append((float(mid), int(tex_off[tid]), th, tw))
    return tuple(itex), np.concatenate(chunks, axis=0)


#: rows of the light table
LIGHT_ROWS = 28


def pack_lights_table(scene: dict) -> np.ndarray:
    """(28, Nl) float32 light table for NEE, the JAX package's
    ``pack_lights_table``: per light (ops/nee.extract_lights order)
    [kind, global ord, center(3), radius, u(3), v(3), normal(3), emit(3)],
    then rows 18-27 [cn, us(3), cu, vs(3), cv, r2]: the light's own
    quad-plane and sphere constants, computed with the same float32 numpy
    expressions as the quad and sphere rows of ``pack_scene_tables``, so
    the shadow ray's analytic hit on its light is bit-equal to the t the
    primitive's own test gives (the equal-t, lowest-ordinal tie rule then
    decides coplanar geometry, such as CORNELL's light in its ceiling, as
    the closest-hit fold would).  A (28, 1) zero table when the scene has
    no light."""
    from parallelraytracing_tpu_torch.ops.nee import KIND_SPHERE, extract_lights
    lights = extract_lights(scene)
    if lights is None:
        return np.zeros((LIGHT_ROWS, 1), np.float32)
    n_sph_full = int(np.asarray(scene["sph_valid"]).shape[0])
    ordv = np.where(lights.kind == KIND_SPHERE, lights.idx,
                    n_sph_full + lights.idx)
    lc, lu, lv, ln = lights.center, lights.u, lights.v, lights.normal
    us = lu / np.maximum((lu * lu).sum(1, keepdims=True), 1e-30)
    vs = lv / np.maximum((lv * lv).sum(1, keepdims=True), 1e-30)
    return np.concatenate([
        lights.kind[None].astype(np.float32), ordv[None].astype(np.float32),
        lc.T, lights.radius[None], lu.T, lv.T, ln.T, lights.emit.T,
        (lc * ln).sum(1)[None], us.T, (lc * us).sum(1)[None], vs.T,
        (lc * vs).sum(1)[None], (lights.radius * lights.radius)[None]],
        axis=0).astype(np.float32)
