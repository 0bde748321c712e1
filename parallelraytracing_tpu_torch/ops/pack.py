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

A mesh of more than STREAM_THRESHOLD triangles (24,576, the JAX
package's) takes the stream route, the JAX package's streamed big-mesh
layout held as plain columns: the top tree is a binned-SAH tree whose
leaves each start a chunk of STREAM_CHUNK triangle slots (``_sah_threaded_tree(..., align=chunk)``, row 7 packing a
leaf as chunk * mult + span, mult the next power of two above the chunk);
each chunk carries its own threaded mini-tree over its slots
(``_mini_threaded_tree``, slot ranges lo*64 + span).  The triangle table
then holds the slots, (27 or 33, n_chunks * chunk), slot s of chunk c in
column c * chunk + s, pad slots zero columns (never hit); the mini-trees
are one (8, n_chunks * node_rows) table, chunk c's nodes in columns
c * node_rows + k with chunk-local escape links (``StreamTables``).  The
dense leaf word lo*64 + span caps a dense table at 2^18 primitives; the
stream route has no such cap.  The chunk is a module constant here, as
the threshold is, both read at each call (the tests set them): the JAX
package's choice of the smallest chunk whose tree fits the TPU's SMEM is
a TPU budget.

Instanced meshes get four more tables (``pack_instance_tables``): the
unique meshes' local triangles, their concatenated threaded trees, the
instances' world boxes and the instance records.  Image textures are
packed as rows of 128 texels (``pack_kernel_textures``).

The JAX package's other layouts (Karras tree, ordered tree, straggler-tail
views, SBVH, tile-SAH, eye-ordered linear scans, the stream route's
128-lane rows) are left out: none is on its default path, and the eye
ordering changes no result, since the closest-hit fold does not depend on
order.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import Any, Optional

import numpy as np
import torch

from parallelraytracing_tpu_torch.core import geometry as geo
from parallelraytracing_tpu_torch.core.scene import MAT_DIELECTRIC, MAT_EMISSIVE, MAT_METAL
from parallelraytracing_tpu_torch.ops.textures import TEX_IMAGE_BASE
from parallelraytracing_tpu_torch.utils.profiling import annotate

#: primitives per leaf / linear cluster, sphere and quad kinds
CLUSTER = 24
#: primitives per leaf / linear cluster, triangle kind
TRI_CLUSTER = 4
#: more clusters than this switch a kind from the linear scan to the tree
TREE_THRESHOLD = 4
#: splice internal nodes whose surface area is >= this x their parent's
COLLAPSE_TAU = 0.6
#: triangle count above which a mesh takes the stream route (the JAX
#: package's default, so both packages' tables agree on every scene)
STREAM_THRESHOLD = 24576
#: triangle slots per chunk of the stream route: of 64, 128 and 256, 64
#: gave the fastest segment kernel and the fastest trace kernel or one
#: within 1% of it on an H100 (chip_smoke.py's chunk sweep at 327,680
#: triangles; PERF.md)
STREAM_CHUNK = 64
#: mini-tree leaf size in slots (the JAX package's STREAM_SUB)
STREAM_SUB = 8
#: slots of a chained fat leaf, when no mini-tree fits a chunk's node rows
FAT_LEAF = 48
#: SAH bins per axis
_NB = 16


@dataclasses.dataclass(frozen=True)
class StreamTables:
    """The stream route's mini-trees and integers: ``mini`` the (8,
    n_chunks * node_rows) table of the chunks' threaded mini-trees (numpy
    on the host, a tensor on a device), ``chunk`` the slots per chunk,
    ``node_rows`` the mini-tree columns per chunk."""
    mini: Any
    chunk: int
    node_rows: int

    @property
    def shift(self) -> int:
        """The top tree's leaf word is chunk index << shift | span."""
        return stream_shift(self.chunk)


def stream_shift(chunk: int) -> int:
    """ceil(log2(chunk + 1)): the bits of a top-tree leaf's span."""
    return int(math.ceil(math.log2(chunk + 1)))


def default_node_rows(chunk: int) -> int:
    """The JAX package's mini-tree columns per chunk: max(16, chunk / 4)
    for a chunk of 64 or fewer slots, else chunk / 2."""
    return max(16, chunk // 4) if chunk <= 64 else chunk // 2


class PackedTables(tuple):
    """``pack_scene_tables``' result: a 7-tuple (sph, quad, tri, sph_cl,
    quad_cl, tri_cl, mats), and ``stream``, the StreamTables of a mesh on
    the stream route (tri then holds its slots and tri_cl its top tree),
    None on the dense route."""

    def __new__(cls, tables, stream: Optional[StreamTables] = None):
        self = super().__new__(cls, tables)
        self.stream = stream
        return self


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


def _areas(lo, hi):
    """Surface area of each row of (K, 3) boxes (0 for an inverted one)."""
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0])


def _best_bin_split(n, rcen, rmn, rmx, cmin, ext):
    """The binned SAH's best split of n primitives: (cost, axis, bins,
    split bin) over 16 bins per axis, or None.  The candidates are taken
    in the order of the JAX package's loops (axis, then bin) and the
    first strict minimum wins; the bins' bounds are exact mins and maxes,
    so each cost is the loops' to the bit."""
    best = None
    for ax in range(3):
        if ext[ax] <= 1e-12:
            continue
        b = np.minimum(((rcen[:, ax] - cmin[ax]) / ext[ax]
                        * _NB).astype(np.int64), _NB - 1)
        counts = np.bincount(b, minlength=_NB)
        nz = np.nonzero(counts)[0]
        order = np.argsort(b, kind="stable")
        starts = (np.cumsum(counts) - counts)[nz]
        bin_mn = np.full((_NB, 3), np.inf)
        bin_mx = np.full((_NB, 3), -np.inf)
        bin_mn[nz] = np.minimum.reduceat(rmn[order], starts, axis=0)
        bin_mx[nz] = np.maximum.reduceat(rmx[order], starts, axis=0)
        pmn = np.minimum.accumulate(bin_mn, axis=0)
        pmx = np.maximum.accumulate(bin_mx, axis=0)
        smn = np.minimum.accumulate(bin_mn[::-1], axis=0)[::-1]
        smx = np.maximum.accumulate(bin_mx[::-1], axis=0)[::-1]
        with np.errstate(invalid="ignore"):
            pre_a = np.where(np.isfinite(pmn).all(1), _areas(pmn, pmx), 0.0)
            suf_a = np.where(np.isfinite(smn).all(1), _areas(smn, smx), 0.0)
        nl = np.cumsum(counts)[:_NB - 1]
        nr = n - nl
        cost = np.where((nl != 0) & (nr != 0),
                        pre_a[:_NB - 1] * nl + suf_a[1:] * nr, np.inf)
        k = int(np.argmin(cost))
        if np.isfinite(cost[k]) and (best is None or cost[k] < best[0]):
            best = (cost[k], ax, b, k)
    return best


def _sah_threaded_tree(mn: np.ndarray, mx: np.ndarray, csize: int,
                       collapse_tau: float = COLLAPSE_TAU, align: int = 0):
    """Binned-SAH BVH over primitive AABBs -> (perm, (8, M) threaded table).

    Top-down build with 16 bins per axis; leaves hold <= csize primitives
    and their boxes are the exact union of those primitives.  Invalid
    primitives (inverted boxes) go last in `perm`, outside every leaf run.
    Internal nodes whose area is >= collapse_tau x their parent's are
    spliced out of the emitted table (their children hang off the
    parent); the escape-link encoding takes any arity, and the leaf runs
    are unchanged.

    With align > 0 (the stream route, csize <= align): every leaf's run
    starts at a multiple of `align`, the gaps in `perm` padded with -1
    (the caller's never-hit slots), and row 7 packs a leaf as
    (lo / align) * mult + span, mult the next power of two above csize,
    so a leaf is one align-sized chunk."""
    n = len(mn)
    if align:
        assert csize <= align
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
            if align:  # the stream route: the run starts a chunk
                perm_out.extend([-1] * ((-len(perm_out)) % align))
            lo = len(perm_out)
            perm_out.extend(ids.tolist())
            recs.append([bmn, bmx, 1, lo, len(perm_out)])
            return len(recs) - 1
        cmin = rcen.min(0)
        ext = rcen.max(0) - cmin
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
        best = _best_bin_split(len(ids), rcen, rmn, rmx, cmin, ext)
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
    real = perm[perm >= 0] if align else perm
    assert len(real) == n and len(set(real.tolist())) == n

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

    rarea = _areas(np.array([r[0] for r in recs]),
                   np.array([r[1] for r in recs]))
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
    mult = 1 << stream_shift(csize)
    slot = 0
    stack = [(root, -1)]
    while stack:
        ri, esc = stack.pop()
        bmn, bmx, kind, a, b = recs[ri]
        out[:3, slot] = bmn
        out[3:6, slot] = bmx
        out[6, slot] = esc
        if is_leaf_rec(ri) and align:
            lo, span = rlo[ri], rhi[ri] - rlo[ri]
            assert lo % align == 0 and 0 <= span <= csize
            enc = (lo // align) * mult + span
            if enc >= (1 << 24):
                raise ValueError(
                    f"stream leaf encoding overflows the f32 integer range "
                    f"at chunk {lo // align}: use a larger chunk")
            out[7, slot] = enc
        elif is_leaf_rec(ri):
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


def _mini_threaded_tree(mn: np.ndarray, mx: np.ndarray, leaf: int,
                        group: int = 1):
    """Full-sweep SAH threaded mini-tree over one chunk's primitives ->
    (perm_local, (8, M) table), the JAX package's ``_mini_threaded_tree``:
    per node, sort on each axis, prefix and suffix box areas by
    min/max-accumulate, the exact SAH cost at every split position, the
    best axis and position; leaves of <= `leaf` primitives packed lo*64 +
    span, escape links local to the tree (-1 ends it).

    With group > 1 the build splits groups of `group` consecutive
    primitives as indivisible units, so every leaf's slot range is
    group-aligned; perm_local then has the group-padded length (pads -1)
    and lo, span are slot ranges."""
    n = len(mn)
    if group > 1:
        ng = -(-n // group)
        gm = np.full((ng * group,), -1, np.int64)
        gm[:n] = np.arange(n)
        gids = gm.reshape(ng, group)
        # the groups' boxes are the unions of their real members
        gmn = np.full((ng, group, 3), np.inf)
        gmx = np.full((ng, group, 3), -np.inf)
        real = gids >= 0
        gmn[real] = mn[gids[real]]
        gmx[real] = mx[gids[real]]
        sub_perm, tab = _mini_threaded_tree(gmn.min(1), gmx.max(1),
                                            max(1, leaf // group))
        perm = gids[sub_perm].reshape(-1)
        enc = tab[7]
        is_leaf = enc >= 0
        lo = (enc[is_leaf].astype(np.int64) >> 6) * group
        sp = (enc[is_leaf].astype(np.int64) & 63) * group
        tab = tab.copy()
        tab[7, is_leaf] = (lo * 64 + sp).astype(np.float32)
        return perm, tab
    cen = (mn + mx) * 0.5
    perm_out: list = []

    def area_lr(bmn_s, bmx_s):
        """Prefix and suffix surface areas of a sorted box list."""
        pmn = np.minimum.accumulate(bmn_s)
        pmx = np.maximum.accumulate(bmx_s)
        smn = np.minimum.accumulate(bmn_s[::-1])[::-1]
        smx = np.maximum.accumulate(bmx_s[::-1])[::-1]
        d1 = np.maximum(pmx - pmn, 0.0)
        d2 = np.maximum(smx - smn, 0.0)
        a1 = d1[:, 0] * d1[:, 1] + d1[:, 1] * d1[:, 2] + d1[:, 2] * d1[:, 0]
        a2 = d2[:, 0] * d2[:, 1] + d2[:, 1] * d2[:, 2] + d2[:, 2] * d2[:, 0]
        return a1, a2

    def build(ids):
        """This subtree's columns in preorder, [(bmn, bmx, enc[, left
        size])]; enc -1.0 marks an internal node."""
        sel = mn[ids] <= mx[ids]
        if sel.all():
            bmn = mn[ids].min(0)
            bmx = mx[ids].max(0)
        else:  # group pads carry inverted boxes: left out of the bounds
            ok = sel.all(1)
            bmn = mn[ids[ok]].min(0) if ok.any() else np.ones(3)
            bmx = mx[ids[ok]].max(0) if ok.any() else -np.ones(3)
        if len(ids) <= leaf:
            lo = len(perm_out)
            perm_out.extend(ids.tolist())
            return [(bmn, bmx, float(lo * 64 + len(ids)))]
        k = len(ids)
        best = None  # (cost, order, split)
        counts = np.arange(1, k, dtype=np.float64)
        for ax in range(3):
            order = np.argsort(cen[ids, ax], kind="stable")
            a1, a2 = area_lr(mn[ids[order]], mx[ids[order]])
            cost = a1[:-1] * counts + a2[1:] * (k - counts)
            j = int(np.argmin(cost))
            if best is None or cost[j] < best[0]:
                best = (cost[j], order, j + 1)
        _, order, half = best
        left = build(ids[order[:half]])
        right = build(ids[order[half:]])
        return [(bmn, bmx, -1.0, len(left))] + left + right

    tree = build(np.arange(n, dtype=np.int64))
    m = len(tree)
    out = np.zeros((8, m), np.float32)
    # preorder threading: a left child escapes to its right sibling, a
    # right child (and a leaf) escapes like its parent
    esc = np.full(m, -1, np.int64)

    def link(i, e):
        esc[i] = e
        node = tree[i]
        if node[2] < 0:  # internal: left at i + 1, right after left's size
            right_at = i + 1 + node[3]
            link(i + 1, right_at)
            link(right_at, e)

    link(0, -1)
    for i, node in enumerate(tree):
        out[:3, i] = node[0]
        out[3:6, i] = node[1]
        out[6, i] = esc[i]
        out[7, i] = node[2] if node[2] >= 0 else -1.0
    return np.asarray(perm_out, np.int64), out


def stream_group(n_attr: int, chunk: int) -> int:
    """The JAX package's lane packing of a streamed chunk (4 triangles to
    a 128-lane row at 27 rows, 2 at 33), the group its mini-trees keep
    leaves aligned to.  The port stores plain columns, but builds its
    mini-trees with the same groups so its tables equal the JAX
    package's."""
    group = 4 if n_attr <= 32 else (2 if n_attr <= 64 else 1)
    while chunk % group:
        group //= 2
    return group


def _assemble_stream(tri: np.ndarray, perm: np.ndarray, tree: np.ndarray,
                     mn: np.ndarray, mx: np.ndarray, chunk: int,
                     node_rows: int):
    """The stream route's tables, the JAX package's
    ``_assemble_stream_blocks`` held as plain columns: (slots (n_attr,
    n_chunks * chunk), mini (8, n_chunks * node_rows)).

    Each top-tree leaf is one chunk.  Its mini-tree is built over groups
    of ``stream_group`` triangles with leaves of STREAM_SUB, 2 or 4 times
    that many slots
    (under 64), the first that fits node_rows columns; if none fits, the
    chunk is cut into chained fat leaves of FAT_LEAF slots.  The chunk's
    triangles go into its slots in mini-tree order (the fold tie-breaks on
    the ordinal row, so the order changes no image); pad slots stay zero
    columns, which are never hit."""
    n_attr = tri.shape[0]
    group = stream_group(n_attr, chunk)
    mult = 1 << stream_shift(chunk)
    leaves = tree[7][tree[7] >= 0].astype(np.int64)
    n_chunks = -(-len(perm) // chunk)
    slots = np.zeros((n_attr, n_chunks * chunk), np.float32)
    mini = np.zeros((8, n_chunks * node_rows), np.float32)
    for c, span in zip(leaves // mult, leaves % mult):
        if span == 0:
            continue
        ids = perm[c * chunk: c * chunk + span]
        assert (ids >= 0).all(), "leaf runs hold only real primitives"
        mtab = None
        for s in (STREAM_SUB, 2 * STREAM_SUB, 4 * STREAM_SUB):
            if s >= 64:
                break
            mperm, cand = _mini_threaded_tree(mn[ids], mx[ids], s, group)
            if cand.shape[1] <= node_rows:
                mtab = cand
                ids = np.where(mperm >= 0, ids[mperm], -1)
                break
        if mtab is None:
            # chained fat leaves over the group-padded slot list
            ids = np.concatenate([ids, np.full((-len(ids)) % group, -1,
                                               np.int64)])
            segs = [(lo, min(FAT_LEAF, len(ids) - lo))
                    for lo in range(0, len(ids), FAT_LEAF)]
            mtab = np.zeros((8, len(segs)), np.float32)
            for k, (lo, sp) in enumerate(segs):
                real = ids[lo:lo + sp]
                real = real[real >= 0]
                mtab[:3, k] = mn[real].min(0)
                mtab[3:6, k] = mx[real].max(0)
                mtab[6, k] = k + 1 if k + 1 < len(segs) else -1.0
                mtab[7, k] = lo * 64 + sp
        assert len(ids) <= chunk and mtab.shape[1] <= node_rows
        real = ids >= 0
        slots[:, c * chunk + np.nonzero(real)[0]] = tri[:, ids[real]]
        mini[:, c * node_rows: c * node_rows + mtab.shape[1]] = mtab
    return slots, mini


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


def pack_scene_tables(scene: dict, *,
                      node_rows: Optional[int] = None) -> PackedTables:
    """Pack a scene's arrays (``SceneData.numpy()`` or the JAX package's
    SceneData fields as numpy, keyed by field name) into
    (sph, quad, tri, sph_cl, quad_cl, tri_cl, mats) float32 tables.

    A scene of more than STREAM_THRESHOLD triangle columns takes the
    stream route (the module docstring): chunks of STREAM_CHUNK slots,
    `node_rows` mini-tree columns per chunk (default
    ``default_node_rows``) and mini-tree leaves of STREAM_SUB slots; the
    result's ``stream`` holds the mini-trees; its top tree and mini-trees
    are built inside the span ``prt.pack_stream``.  With the JAX package's
    constants set alike (STREAM_THRESHOLD, STREAM_CHUNK, STREAM_NODE_ROWS,
    STREAM_SUB) its tables are the JAX package's, unpacked from its
    128-lane rows (``convert.stream_from_blocks``)."""
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
    stream = None
    if len(tvd) > STREAM_THRESHOLD:
        chunk = STREAM_CHUNK
        node_rows = node_rows or default_node_rows(chunk)
        with annotate("prt.pack_stream"):
            perm, tri_cl = _sah_threaded_tree(t_mn2, t_mx2, chunk,
                                              align=chunk)
            tri, mini = _assemble_stream(tri, perm, tri_cl, t_mn2, t_mx2,
                                         chunk, node_rows)
        stream = StreamTables(mini=mini, chunk=chunk, node_rows=node_rows)
    else:
        tri, tri_cl = _accelerate(tri, t_mn2, t_mx2, TRI_CLUSTER)

    return PackedTables((np.ascontiguousarray(sph), np.ascontiguousarray(quad),
                         np.ascontiguousarray(tri), sph_cl, quad_cl, tri_cl,
                         np.ascontiguousarray(mats)), stream)


#: rows of the triangle table, without and with texture coordinates
TRI_ROWS, TRI_UV_ROWS = 27, 33
#: rows of a threaded tree (box, escape link, leaf word): the trees of the
#: kinds, the stream route's top tree and mini-trees
TREE_ROWS = 8
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
                f"images render through the plain PyTorch engines' atlas: "
                f"megakernel, wavefront, wavefront_bvh, bvh and tlas_ref")
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


# ---------------------------------------------------------------------------
# The kernels' 16-byte records
# ---------------------------------------------------------------------------

def _words(rows) -> tuple:
    """`rows` zero-padded (-1) to a whole number of float4s."""
    rows = tuple(rows)
    return rows + (-1,) * (-len(rows) % 4)


def record_rows(kind: str, n_rows: int) -> tuple:
    """The table row each float of a `kind` record holds (-1: a zero pad
    word), for a (n_rows, N) table.  Kinds:

    - ``node``: a threaded tree's column (8 rows) as {lo.xyz, miss},
      {hi.xyz, leaf word}; a linear cluster table's or ``ibox``'s box (6
      rows) as {lo.xyz, 0}, {hi.xyz, 0};
    - ``sph``: {c.xyz, r2}, {mid, ord, 0, 0};
    - ``quad``: its 14 rows in order, in 16 floats;
    - ``tri``: the hit record of a triangle (``tri`` or ``itri``), rows
      0-15, what the hit test reads for every candidate;
    - ``tri_tail``: the rest of a ``tri`` column, read only by a candidate
      that hits: ord, mid, the three vertex normals, the texture
      coordinates of a 33-row table;
    - ``itri_tail``: the three vertex normals and the texture coordinates
      of a 31-row ``itri``;
    - ``inst``, ``lights``: their 24 and 28 rows in order;
    - ``mats``: {mtype, c.xyz}, {extra, 0, 0, 0}."""
    if kind == "node":
        if n_rows == TREE_ROWS:
            return (0, 1, 2, 6, 3, 4, 5, 7)
        if n_rows == IBOX_ROWS:
            return (0, 1, 2, -1, 3, 4, 5, -1)
    elif kind == "sph" and n_rows == 6:
        return (0, 1, 2, 3, 4, 5, -1, -1)
    elif kind == "quad" and n_rows == 14:
        return _words(range(14))
    elif kind == "tri" and n_rows in (TRI_ROWS, TRI_UV_ROWS, ITRI_ROWS,
                                      ITRI_UV_ROWS):
        return tuple(range(16))
    elif kind == "tri_tail" and n_rows in (TRI_ROWS, TRI_UV_ROWS):
        return _words((17, 16) + tuple(range(18, n_rows)))
    elif kind == "itri_tail" and n_rows in (ITRI_ROWS, ITRI_UV_ROWS):
        return _words(range(16, n_rows))
    elif kind == "inst" and n_rows == INST_ROWS:
        return tuple(range(INST_ROWS))
    elif kind == "lights" and n_rows == LIGHT_ROWS:
        return tuple(range(LIGHT_ROWS))
    elif kind == "mats" and n_rows == 5:
        return _words(range(5))
    raise ValueError(f"no {kind!r} record for a table of {n_rows} rows")


def pack_records(table, kind: str):
    """The kernels' copy of a (C, N) float32 column table: (N, W) float32
    on the table's device, record j holding column j's values in the
    words ``record_rows(kind, C)`` names, zero in the pad words, W a
    multiple of 4, so every record is whole float4s and 16-byte aligned
    (a PyTorch allocation is).  The values are exact copies: a kernel
    that reads a record sees the column's floats.  One stack of row views
    on the device, no host copy."""
    rows = record_rows(kind, int(table.shape[0]))
    zero = table.new_zeros(table.shape[1])
    return torch.stack([table[r] if r >= 0 else zero for r in rows], dim=1)


@dataclasses.dataclass(frozen=True)
class SceneRecords:
    """Every table the kernels read through ``PrtScene``, as the (N, W)
    records of ``pack_records`` (the texture tables stay columns).  None
    for a table the scene does not have."""
    sph: Any
    sph_cl: Any
    quad: Any
    quad_cl: Any
    tri: Any
    tri_tail: Any
    tri_cl: Any
    mats: Any
    lights: Any = None
    itri: Any = None
    itri_tail: Any = None
    iacc: Any = None
    ibox: Any = None
    inst: Any = None
    mini: Any = None


#: (SceneRecords field, record kind) of each table
RECORD_KINDS = (("sph", "sph"), ("sph_cl", "node"), ("quad", "quad"),
                ("quad_cl", "node"), ("tri", "tri"), ("tri_tail", "tri_tail"),
                ("tri_cl", "node"), ("mats", "mats"), ("lights", "lights"),
                ("itri", "tri"), ("itri_tail", "itri_tail"),
                ("iacc", "node"), ("ibox", "node"), ("inst", "inst"),
                ("mini", "node"))


def record_columns(sph, quad, tri, sph_cl, quad_cl, tri_cl, mats,
                   lights=None, inst=None, stream=None) -> dict:
    """{SceneRecords field: the column table its records are made of} for
    a scene's tables: the column tables, the light table or None, the
    instance tables (an ``engines/tables.InstanceTables``) or None, the
    stream route's ``StreamTables`` or None."""
    cols = dict(sph=sph, sph_cl=sph_cl, quad=quad, quad_cl=quad_cl, tri=tri,
                tri_tail=tri, tri_cl=tri_cl, mats=mats, lights=lights)
    if inst is not None:
        cols.update(itri=inst.itri, itri_tail=inst.itri, iacc=inst.iacc,
                    ibox=inst.ibox, inst=inst.inst)
    if stream is not None:
        cols["mini"] = stream.mini
    return cols


def scene_records(*tables, **kw) -> SceneRecords:
    """The records of a scene's tables (``pack_records`` of each table of
    ``record_columns``, same arguments).  Made once per scene by
    ``engines/tables.build_scene_tables``."""
    cols = record_columns(*tables, **kw)
    return SceneRecords(**{name: pack_records(cols[name], kind)
                           for name, kind in RECORD_KINDS
                           if cols.get(name) is not None})
