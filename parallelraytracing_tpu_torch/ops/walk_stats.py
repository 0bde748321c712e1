"""The plain version of the probe kernel's walk counters.

``per_ray`` replays the walks of csrc/bounce.cuh one node at a time, with
the counting rules of its ``WalkCount`` (the JAX package's
``collect_stats`` rules, pallas_trace.py l.2006-2141 and l.2351-2355):

- [0] nodes: every column a threaded walk visits (a kind's tree, the
  stream route's top tree and each chunk's mini-tree, an instance's mesh
  tree), a linear scan's root pretest box and each of its cluster boxes;
  not a tiny kind's plain loop, not the instances' world-box scan;
- [1] leaves: every entered leaf or linear cluster, the stream route's
  top-tree leaves and mini-leaves alike;
- [2] primitives: the span (``enc & 63``) of each entered leaf, the full
  cluster size of each entered linear cluster (the short last one too);
  a top-tree leaf of the stream route adds nothing, its mini-walk counts
  its slots.

A walk is one ray segment of ``trace_reference``: an alive ray's
closest-hit walk at each bounce, seeded (BIG, 2^24), or a NEE shadow ray's
any-hit walk, seeded with its light's own (t, ordinal), which stops at the
first primitive that beats the seed, as the kernel's does.  The kinds go
in the kernel's order (spheres, quads, triangles dense or streamed,
instances), and the running best (t, ordinal) that gates every box test
comes from the plain version's own per-primitive tests (ops/trace.py),
which equal the kernel's bit for bit.  The replay is vectorised over walks
(one cursor each, one node a step) and runs on the few hundred rays the
tests and chip_smoke.py hold the kernel to, never on the main path.
"""

from __future__ import annotations

import torch

from parallelraytracing_tpu_torch.ops.pack import CLUSTER, TRI_CLUSTER
from parallelraytracing_tpu_torch.ops.trace import (BIG, _quad_hits,
                                                    _safe_inv, _slab,
                                                    _sphere_hits, _tri_hits)


def per_ray(walks, n_rays: int, sph, quad, tri, sph_cl, quad_cl, tri_cl, *,
            t_min: float, t_cap: float, inst=None, stream=None):
    """(n_rays, 3) int32 counters [nodes, leaves, primitives] of `walks`,
    summed per ray.  Each walk is (ray ids, ox, oy, oz, dx, dy, dz, seed
    t, seed ordinal, any-hit), the first nine (W,) tensors; `tri` is None
    when no triangle can be hit."""
    dev = sph.device
    out = torch.zeros((n_rays, 3), dtype=torch.int64, device=dev)
    if walks:
        ids = torch.cat([w[0] for w in walks])
        fields = [torch.cat([w[k] for w in walks]) for k in range(1, 9)]
        anyhit = torch.cat([torch.full((w[0].numel(),), bool(w[9]),
                                       device=dev) for w in walks])
        rep = _Replay(*fields, anyhit, t_min, t_cap)
        rep.fold_scene(sph, quad, tri, sph_cl, quad_cl, tri_cl, inst, stream)
        out.index_add_(0, ids, rep.counts)
    return out.to(torch.int32)


class _Replay:
    """The walks' state: world rays, the running best (t, ordinal), the
    any-hit walks' occluded flags and the counters; ``loc`` holds each
    walk's ray in the space of the instance being walked."""

    def __init__(self, ox, oy, oz, dx, dy, dz, t0, ord0, anyhit, t_min,
                 t_cap):
        self.world = (ox, oy, oz, dx, dy, dz,
                      _safe_inv(dx), _safe_inv(dy), _safe_inv(dz))
        self.loc = tuple(torch.zeros_like(ox) for _ in range(9))
        self.t = t0.clone()
        self.ord = ord0.clone()
        self.anyhit = anyhit
        self.occ = torch.zeros_like(anyhit)
        self.counts = torch.zeros((ox.shape[0], 3), dtype=torch.int64,
                                  device=ox.device)
        self.t_min, self.t_cap = t_min, t_cap

    def live(self):
        return torch.nonzero(~self.occ)[:, 0]

    # -------------------------------------------------------- primitives
    def _fold(self, idx, t, ok, ordv):
        """Fold candidates (M, S) into walks idx: a closest-hit walk keeps
        the lexicographic minimum of its (t, ordinal) and the accepted
        candidates; an any-hit walk is occluded by any accepted candidate
        that beats its seed."""
        tc = torch.where(ok, t, torch.inf)
        tmin = tc.min(1).values
        omin = torch.where(ok & (tc == tmin[:, None]), ordv,
                           torch.inf).min(1).values
        cur_t, cur_o = self.t[idx], self.ord[idx]
        beat = (tmin < cur_t) | ((tmin == cur_t) & (omin < cur_o))
        anyhit = self.anyhit[idx]
        upd, occ = idx[beat & ~anyhit], idx[beat & anyhit]
        self.t[upd] = tmin[beat & ~anyhit]
        self.ord[upd] = omin[beat & ~anyhit]
        self.t[occ] = -BIG
        self.occ[occ] = True

    def _test(self, kind, idx, lo, span, table, n: int, base_ord=None):
        """Test columns lo .. lo + span of `table` (a kind's, or with
        `base_ord` an instance's itri in its local space) for walks idx."""
        width = int(span.max())
        if width <= 0:
            return
        k = torch.arange(width, device=idx.device)
        j = lo[:, None] + k
        valid = k < span[:, None]
        tab = table[:, j.clamp(0, n - 1)]
        ray = tuple(v[idx] for v in (self.world if base_ord is None
                                     else self.loc)[:6])
        if kind == "sph":
            t, ok, _ = _sphere_hits(*ray, tab, self.t_min, self.t_cap)
            ordv = tab[5]
        elif kind == "quad":
            t, ok, *_ = _quad_hits(*ray, tab, self.t_min, self.t_cap)
            ordv = tab[13]
        else:
            t, ok, _, _ = _tri_hits(*ray, tab, self.t_min, self.t_cap)
            ordv = tab[17] if base_ord is None \
                else base_ord + j.to(torch.float32)
        self._fold(idx, t, ok & valid, ordv)

    # ------------------------------------------------------------- walks
    def _tree(self, tab, idx, node, base, leaf_fn, local=False,
              count_prims=True):
        """Threaded walk of (8, M) `tab` for walks idx from columns `node`:
        hit -> node + 1, miss -> the escape link (row 6, taken relative to
        `base`, -1 ends), an entered leaf (row 7 >= 0) calls
        leaf_fn(walks, leaf word, base)."""
        while idx.numel():
            ox, oy, oz, _, _, _, ix, iy, iz = (
                v[idx] for v in (self.loc if local else self.world))
            enter = _slab(tab, node, ox, oy, oz, ix, iy, iz, self.t_min,
                          self.t[idx])
            miss = tab[6, node].long()
            enc_f = tab[7, node]
            leaf = enc_f >= 0.0
            enc = torch.where(leaf, enc_f, 0.0).long()
            ent = enter & leaf
            self.counts[idx, 0] += 1
            self.counts[idx, 1] += ent.long()
            if count_prims:
                self.counts[idx, 2] += torch.where(ent, enc & 63, 0)
            if bool(ent.any()):
                leaf_fn(idx[ent], enc[ent], base[ent])
            nxt = torch.where(enter & ~leaf, node + 1,
                              torch.where(miss < 0, -1, base + miss))
            keep = (nxt >= 0) & ~self.occ[idx]
            idx, node, base = idx[keep], nxt[keep], base[keep]

    def fold_kind(self, kind, n: int, cl, csize: int, table):
        """``fold_kind``: a tiny kind's plain loop, the threaded tree, or
        the linear scan behind its root pretest."""
        idx = self.live()
        if idx.numel() == 0:
            return
        if n <= csize:
            zero = torch.zeros_like(idx)
            self._test(kind, idx, zero, zero + n, table, n)
            return
        if cl.shape[0] == 8:
            zero = torch.zeros_like(idx)
            self._tree(cl, idx, zero, zero, lambda i, enc, _: self._test(
                kind, i, enc >> 6, enc & 63, table, n))
            return
        n_cl = -(-n // csize)
        ox, oy, oz, _, _, _, ix, iy, iz = (v[idx] for v in self.world)
        self.counts[idx, 0] += 1  # the root pretest
        root = _slab(cl, n_cl, ox, oy, oz, ix, iy, iz, self.t_min,
                     self.t[idx])
        idx = idx[root]
        for ci in range(n_cl):
            idx = idx[~self.occ[idx]]
            if idx.numel() == 0:
                return
            ox, oy, oz, _, _, _, ix, iy, iz = (v[idx] for v in self.world)
            e = _slab(cl, ci, ox, oy, oz, ix, iy, iz, self.t_min, self.t[idx])
            self.counts[idx, 0] += 1
            self.counts[idx, 1] += e.long()
            self.counts[idx, 2] += e.long() * csize
            if bool(e.any()):
                sel = idx[e]
                lo = torch.full_like(sel, ci * csize)
                self._test(kind, sel, lo,
                           torch.full_like(sel, min(csize, n - ci * csize)),
                           table, n)

    def fold_stream(self, tri, tri_cl, stream):
        """``fold_stream``: the top tree; an entered top leaf walks its
        chunk's mini-tree, whose entered leaves test their slots."""
        idx = self.live()
        if idx.numel() == 0:
            return
        rows, chunk = int(stream.node_rows), int(stream.chunk)
        n = tri.shape[1]

        def mini_leaf(i, enc, base):
            self._test("tri", i, (base // rows) * chunk + (enc >> 6),
                       enc & 63, tri, n)

        def top_leaf(i, enc, _):
            mbase = (enc >> stream.shift) * rows
            self._tree(stream.mini, i, mbase, mbase, mini_leaf)

        zero = torch.zeros_like(idx)
        self._tree(tri_cl, idx, zero, zero, top_leaf, count_prims=False)

    def fold_instances(self, inst):
        """``fold_instances``: each instance's world box at the running t
        (not counted); an entered instance's mesh tree walked by the
        walk's ray taken into the mesh's space."""
        n_itri = inst.itri.shape[1]
        for k in range(inst.n_inst):
            idx = self.live()
            if idx.numel() == 0:
                return
            ox, oy, oz, dx, dy, dz, ix, iy, iz = (v[idx] for v in self.world)
            box = _slab(inst.ibox, k, ox, oy, oz, ix, iy, iz, self.t_min,
                        self.t[idx])
            idx = idx[box]
            if idx.numel() == 0:
                continue
            ox, oy, oz, dx, dy, dz = (v[idx] for v in self.world[:6])
            g = inst.inst[:, k]
            lox = g[1] * ox + g[2] * oy + g[3] * oz + g[4]
            loy = g[5] * ox + g[6] * oy + g[7] * oz + g[8]
            loz = g[9] * ox + g[10] * oy + g[11] * oz + g[12]
            ldx = g[1] * dx + g[2] * dy + g[3] * dz
            ldy = g[5] * dx + g[6] * dy + g[7] * dz
            ldz = g[9] * dx + g[10] * dy + g[11] * dz
            for dst, v in zip(self.loc, (lox, loy, loz, ldx, ldy, ldz,
                                         _safe_inv(ldx), _safe_inv(ldy),
                                         _safe_inv(ldz))):
                dst[idx] = v
            root = torch.full_like(idx, int(g[0]))
            self._tree(inst.iacc, idx, root, torch.zeros_like(idx),
                       lambda i, enc, _: self._test(
                           "tri", i, enc >> 6, enc & 63, inst.itri, n_itri,
                           base_ord=g[23]),
                       local=True)

    def fold_scene(self, sph, quad, tri, sph_cl, quad_cl, tri_cl, inst,
                   stream):
        """``fold_scene``: the kinds in the kernel's order."""
        self.fold_kind("sph", sph.shape[1], sph_cl, CLUSTER, sph)
        self.fold_kind("quad", quad.shape[1], quad_cl, CLUSTER, quad)
        if tri is not None and stream is not None:
            self.fold_stream(tri, tri_cl, stream)
        elif tri is not None:
            self.fold_kind("tri", tri.shape[1], tri_cl, TRI_CLUSTER, tri)
        if inst is not None:
            self.fold_instances(inst)
