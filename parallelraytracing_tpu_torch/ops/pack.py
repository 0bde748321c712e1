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
                   n0(3) n1(3) n2(3)
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
    tri = np.concatenate([
        ng.T, p0ng[None], e1.T, e2.T, e2xp0.T, p0xe1.T,
        mat_cols(np.asarray(scene["tri_mat"])[t_ord]),
        (t_ord + n_sph_full + n_quad_full).astype(np.float32)[None],
        np.asarray(scene["tri_n0"], np.float32)[t_ord].T,
        np.asarray(scene["tri_n1"], np.float32)[t_ord].T,
        np.asarray(scene["tri_n2"], np.float32)[t_ord].T], axis=0)
    t_mn2 = np.where(tvd[:, None], t_mn[t_ord], np.float64(1.0))
    t_mx2 = np.where(tvd[:, None], t_mx[t_ord], np.float64(-1.0))
    tri, tri_cl = _accelerate(tri, t_mn2, t_mx2, TRI_CLUSTER)

    return (np.ascontiguousarray(sph), np.ascontiguousarray(quad),
            np.ascontiguousarray(tri), sph_cl, quad_cl, tri_cl,
            np.ascontiguousarray(mats))
