"""The roofline of the trace and segment kernels: the least time the card
could take for a launch, and how far the kernel is from it.

The counterpart of ``benchmarks/roofline.py``:

1. ceiling: the card's float32 instruction rates and its read rate,
   measured (benchmarks/micro.py), or the data sheet's (``DATASHEET``);
2. demand: a launch's operations, the trace kernel's counted visits
   (ops/trace.py's ``collect_stats``) times an operation model counted
   from csrc/bounce.cuh (``SLAB_OPS`` ... ``SKY_OPS``), and its bytes (each
   ray's inputs and outputs once, each table once);
3. achieved: demand / the launch's measured time.

A launch's bound is the larger of its bytes over the read rate and its
operations over the instruction rate of the matching mix: the slab tests
at the "slab" mix's rate, the rest (primitive tests, shading, the scene
extensions) at the "fma" mix's.  Each multiply and each add is one
operation: the kernels build with -fmad=false, so each is one
instruction, and the rates are instructions per second (a multiply-add
counted once).  The data sheet's 67 TFLOP/s counts a multiply-add as two
operations; as an instruction rate it is half that.

``kernel_bound`` is the walk-shape bound of chip_smoke.py's earlier
phases: each ray segment pays its tree's shallowest root-to-leaf path and
one mean leaf.  The segment kernel's bounds keep that operation count
(the JAX segment kernel has no counters to hold a count to), divided by
the same rates.  ``counted_bound`` is the trace kernel's bound from
counted visits.

    python -m parallelraytracing_tpu_torch.benchmarks.roofline    # the card
    python -m parallelraytracing_tpu_torch.benchmarks.roofline --device cpu

On the CPU it prints the headline's demand at a small size (the plain
version's counts); a ceiling or an achieved rate comes only from the card.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

#: the H100 SXM's published peaks: float32 operations outside the tensor
#: cores (a multiply-add counted as 2), and HBM3 bytes/s
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
#: the data sheet's rates in the units the bounds divide by: float32
#: instructions per second (a multiply-add counted once) and bytes/s
DATASHEET = {"fma": PEAK_FLOPS / 2, "slab": PEAK_FLOPS / 2,
             "bytes": PEAK_BYTES}
#: float32 operations of the least walk a ray segment needs, counted from
#: csrc/bounce.cuh: one slab test, one sphere / quad / triangle test, one
#: instance entry (the local ray), and the shading after the fold (hit
#: point, normal, three PCG draws, the direction sample, the BSDF, the
#: normalisation)
SLAB_OPS, SPH_OPS, QUAD_OPS, TRI_OPS, ENTRY_OPS, SHADE_OPS = \
    26, 24, 45, 45, 60, 150
#: float32 operations of the scene extensions, counted from
#: csrc/bounce.cuh: an image texture's fetch (UV wrap, four texel fetches
#: with their wrap, index and u24 decode, the bilinear blend and the
#: albedo product), a sphere's equirectangular UV on top (atan2 and asin,
#: each counted as 20), a checker's cell parity, the gradient and sun sky
#: of a miss (sun power 256: nine squarings)
TEX_OPS, SPH_UV_OPS, CHECKER_OPS, SKY_OPS = 115, 46, 16, 45
#: bytes per ray of a trace launch (o, d, pixel id in; radiance out)
TRACE_RAY_BYTES = 3 * 4 + 3 * 4 + 4 + 3 * 4
#: bytes of a segment launch per live input slot (13 planes and the pixel
#: id read), per survivor (13 planes, the pixel id and the sort key
#: written) and per ended path (its radiance written)
SEGMENT_IN_BYTES, SEGMENT_OUT_BYTES, SEGMENT_END_BYTES = \
    13 * 4 + 4, 13 * 4 + 4 + 4, 3 * 4


def tree_depths(cl, roots=(0,)) -> np.ndarray:
    """The depth of each column of a threaded (8, M) table, 0 for a column
    no walk reaches: a node's first child is the next column and a child's
    next sibling its escape link, so one pass in column order gives every
    node's depth.  `roots` are the trees' first columns (the instance
    table holds one tree per unique mesh)."""
    m = cl.shape[1]
    depth = np.zeros(m, np.int64)
    for root in roots:
        depth[int(root)] = 1
    is_leaf = (cl[7] >= 0).tolist()
    escs = cl[6].astype(np.int64).tolist()
    for n in range(m):
        if not depth[n]:  # a column no walk reaches (a chunk's pad)
            continue
        if not is_leaf[n] and n + 1 < m and not depth[n + 1]:
            depth[n + 1] = depth[n] + 1
        esc = escs[n]
        if esc >= 0 and not depth[esc]:
            depth[esc] = depth[n]
    return depth


def tree_walk_shape(cl, roots=(0,)):
    """(fewest nodes on a root-to-leaf path, mean leaf span) of a threaded
    (8, M) table whose trees start at the columns `roots`."""
    cl = cl.cpu().numpy() if hasattr(cl, "cpu") else np.asarray(cl)
    depth = tree_depths(cl, roots)
    leaves = (cl[7] >= 0) & (depth > 0)
    spans = cl[7, leaves].astype(np.int64) & 63
    return int(depth[leaves].min()), float(spans.mean())


def stream_minis(t):
    """(mini-trees, roots) of a stream route's tables: the (8, n_chunks x
    node_rows) mini-trees with their chunk-local escape links taken to
    global columns, and the first column of each chunk a top-tree leaf
    enters."""
    st = t.stream
    top = t.tri_cl.cpu().numpy()
    enc = top[7][top[7] >= 0].astype(np.int64)
    roots = np.unique(enc >> st.shift) * st.node_rows
    mini = st.mini.cpu().numpy().copy()
    base = (np.arange(mini.shape[1]) // st.node_rows) * st.node_rows
    mini[6] = np.where(mini[6] >= 0, mini[6] + base, -1.0)
    return mini, roots


def stream_walk_shape(t):
    """(fewest top-tree nodes to a leaf, fewest mini-tree nodes to a
    mini-leaf, mean mini-leaf span) of a stream route's tables."""
    d_mini, span = tree_walk_shape(*stream_minis(t))
    return tree_walk_shape(t.tri_cl)[0], d_mini, span


def kind_ops(n: int, cl, csize: int, prim_ops: int) -> tuple:
    """(slab operations, other operations) of the least walk of one kind
    for one segment (the walks of fold_kind): a tiny kind tests every
    primitive; a tree the slab tests on its shallowest root-to-leaf path
    and one mean leaf's primitives; a linear table its root pretest, every
    cluster box and one cluster's primitives."""
    if n <= csize:
        return 0, n * prim_ops
    if cl.shape[0] == 8:
        d_min, span = tree_walk_shape(cl)
        return d_min * SLAB_OPS, span * prim_ops
    return cl.shape[1] * SLAB_OPS, csize * prim_ops


def segment_ops(t) -> tuple:
    """(slab operations, other operations) of the least walk of one ray
    segment through tables t: the shading plus each kind's least walk (a
    mesh on the stream route: the shallowest top-tree path, the shallowest
    mini-tree path and one mean mini-leaf's triangles); with instances,
    every instance's box test, one entry, and the shallowest walk of the
    instanced trees."""
    from parallelraytracing_tpu_torch.ops.pack import CLUSTER, TRI_CLUSTER
    walks = [kind_ops(t.sph.shape[1], t.sph_cl, CLUSTER, SPH_OPS),
             kind_ops(t.quad.shape[1], t.quad_cl, CLUSTER, QUAD_OPS)]
    if t.tri_live and t.stream is not None:
        d_top, d_mini, span = stream_walk_shape(t)
        walks.append(((d_top + d_mini) * SLAB_OPS, span * TRI_OPS))
    elif t.tri_live:
        walks.append(kind_ops(t.tri.shape[1], t.tri_cl, TRI_CLUSTER, TRI_OPS))
    if t.inst is not None:
        roots = sorted(set(int(x) for x in t.inst.inst[0].tolist()))
        d_min, span = tree_walk_shape(t.inst.iacc, roots)
        walks.append(((t.inst.n_inst + d_min) * SLAB_OPS,
                      ENTRY_OPS + span * TRI_OPS))
    return (sum(w[0] for w in walks),
            SHADE_OPS + sum(w[1] for w in walks))


def table_bytes(t) -> int:
    """Bytes of the tables of t on the card."""
    tabs = [t.sph, t.quad, t.tri, t.sph_cl, t.quad_cl, t.tri_cl, t.mats,
            t.lights]
    if t.inst is not None:
        tabs += [t.inst.itri, t.inst.iacc, t.inst.ibox, t.inst.inst]
    if t.itex_tab is not None:
        tabs.append(t.itex_tab)
    if t.stream is not None:
        tabs.append(t.stream.mini)
    return sum(x.numel() * x.element_size() for x in tabs)


def unread_bytes(t) -> int:
    """Bytes of the tables of t that no walk reads: on the stream route,
    the slot columns outside every mini-leaf's range (a chunk's unused
    tail) and the mini-tree columns no chunk's walk reaches (past each
    chunk's tree); 0 on the dense route."""
    if t.stream is None:
        return 0
    mini, roots = stream_minis(t)
    reach = tree_depths(mini, roots) > 0
    leaf = reach & (mini[7] >= 0)
    read = int((mini[7, leaf].astype(np.int64) & 63).sum())
    return ((t.tri.shape[1] - read) * t.tri.shape[0] * t.tri.element_size()
            + int((~reach).sum()) * mini.shape[0] * t.stream.mini.element_size())


def segment_io_bytes(live: int, survivors: int, key: bool = True) -> int:
    """Bytes of a segment launch's queues: `live` input slots read, and of
    them `survivors` pushed (with a sort key when `key`) and the rest
    ended (their radiance written)."""
    out = SEGMENT_OUT_BYTES - (0 if key else 4)
    return (live * SEGMENT_IN_BYTES + survivors * out
            + (live - survivors) * SEGMENT_END_BYTES)


def launch_bytes(t, io_bytes: int) -> int:
    """Bytes a launch must move: its rays' or queues' `io_bytes` (each
    input read once and each output written once), each table read once
    (the texel rows included, the stream route's columns that no walk
    reads left out)."""
    return io_bytes + table_bytes(t) - unread_bytes(t)


def kernel_bound(t, segments: int, io_bytes: int,
                 extra_ops: float = 0.0) -> dict:
    """The walk-shape bound of one launch at the data sheet's rates: the
    larger of its bytes (``launch_bytes`` of its `io_bytes`) over the read
    rate and its operations (`segments` ray segments of segment_ops each,
    plus `extra_ops`, the scene extensions' work) over the instruction
    rate (``bound_from``); ``datasheet_bound_ms`` keeps it when the caller
    recomputes ``bound_ms`` at measured rates.  The walk term counts the
    shallowest path, not the nodes each ray visits."""
    nbytes = launch_bytes(t, io_bytes)
    slab, other = segment_ops(t)
    ops = dict(slab_ops=float(segments * slab),
               other_ops=float(segments * other + extra_ops))
    sheet = bound_from(ops["slab_ops"], ops["other_ops"], nbytes, DATASHEET)
    return dict(**sheet, **ops, datasheet_bound_ms=sheet["bound_ms"],
                datasheet_bound_by=sheet["bound_by"], bytes=nbytes,
                operations=ops["slab_ops"] + ops["other_ops"],
                segments=segments, ops_per_segment=slab + other,
                extension_ops=extra_ops)


def live_prim_ops(t) -> int:
    """The cheapest primitive test among the kinds that hold a hittable
    primitive (a sphere of positive radius, a quad or triangle of non-zero
    normal, an instanced triangle)."""
    ops = []
    if bool((t.sph[3] > 0).any()):
        ops.append(SPH_OPS)
    if bool((t.quad[0:3] != 0).any()):
        ops.append(QUAD_OPS)
    if t.tri_live or t.inst is not None:
        ops.append(TRI_OPS)
    return min(ops) if ops else 0


def counted_ops(t, counts: dict, ext_ops: float = 0.0) -> dict:
    """A trace launch's operations from its counted visits (the probe's
    counters summed over the launch's rays: nodes, prims, bounces): the
    slab mix's (every counted node, and every instance's world box per
    alive bounce: the box scan counts nothing) and the fma mix's (every
    counted primitive at the cheapest live primitive test, each alive
    bounce's shading and its tiny kinds' plain loops, which count nothing,
    and `ext_ops`, the scene extensions' work).  Still a lower bound: the
    NEE shadow walks' tiny kinds and instance boxes, and instance entries,
    are not counted."""
    from parallelraytracing_tpu_torch.ops.pack import CLUSTER, TRI_CLUSTER
    bounces = int(counts["bounces"])
    n_inst = 0 if t.inst is None else t.inst.n_inst
    kinds = [(t.sph.shape[1], CLUSTER, SPH_OPS),
             (t.quad.shape[1], CLUSTER, QUAD_OPS)]
    if t.tri_live and t.stream is None:
        kinds.append((t.tri.shape[1], TRI_CLUSTER, TRI_OPS))
    tiny = sum(n * ops for n, csize, ops in kinds if n <= csize)
    slab = (int(counts["nodes"]) + bounces * n_inst) * SLAB_OPS
    other = int(counts["prims"]) * live_prim_ops(t) \
        + bounces * (SHADE_OPS + tiny) + ext_ops
    return dict(slab_ops=float(slab), other_ops=float(other))


def bound_from(slab_ops: float, other_ops: float, nbytes: int,
               peaks: dict) -> dict:
    """The bound of a launch of `nbytes` and these operations at the
    rates `peaks` ({"fma", "slab": operations/s, "bytes": bytes/s})."""
    b_ms = nbytes / peaks["bytes"] * 1e3
    f_ms = (slab_ops / peaks["slab"] + other_ops / peaks["fma"]) * 1e3
    return dict(bound_ms=max(b_ms, f_ms),
                bound_by="bytes" if b_ms >= f_ms else "operations",
                bytes_ms=b_ms, ops_ms=f_ms)


def counted_bound(t, counts: dict, n_rays: int, ray_bytes: int,
                  ext_ops: float = 0.0, peaks=None) -> dict:
    """A trace launch's bound from its counted visits (``counted_ops``)
    at the measured rates `peaks` (``measured_peaks``), with the data
    sheet's bound beside it (``datasheet_bound_ms``, both operation
    terms at ``DATASHEET``'s instruction rate).  Without `peaks` the
    measured fields are left out."""
    ops = counted_ops(t, counts, ext_ops)
    nbytes = launch_bytes(t, n_rays * ray_bytes)
    sheet = bound_from(ops["slab_ops"], ops["other_ops"], nbytes, DATASHEET)
    rec = dict(counts={k: int(v) for k, v in counts.items()}, bytes=nbytes,
               operations=ops["slab_ops"] + ops["other_ops"], **ops,
               datasheet_bound_ms=sheet["bound_ms"],
               datasheet_bound_by=sheet["bound_by"])
    if peaks is not None:
        rec.update(bound_from(ops["slab_ops"], ops["other_ops"], nbytes,
                              peaks), peaks=dict(peaks))
    return rec


def measured_peaks() -> dict:
    """The card's rates (benchmarks/micro.py): the "fma" and "slab" mixes'
    operations per second and the read rate in bytes per second."""
    from parallelraytracing_tpu_torch.benchmarks import micro
    peaks = {}
    for mix in micro.MIXES:
        sec, ops = micro.fp32_peak(mix)
        peaks[mix] = ops / sec
    peaks["bytes"] = micro.read_rate()
    return peaks


def sum_counts(stats) -> dict:
    """The probe's (R, 4) counters summed over a launch's rays."""
    s = stats.to(torch.int64).sum(0).tolist()
    return dict(zip(("nodes", "leaves", "prims", "bounces"), s))


def main(argv=None) -> int:
    from parallelraytracing_tpu_torch.benchmarks import trace_stats
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    cpu = args.device == "cpu"
    if not cpu and not torch.cuda.is_available():
        print("roofline: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    wl = trace_stats.workload("spheres", small=cpu)
    r = trace_stats.renderer(*wl, device=args.device)
    o, d, seed = r._sample_rays(r._ids, 0, 0)
    from parallelraytracing_tpu_torch.ops.trace import trace
    _, stats = trace(o, d, r._ids, seed, r._tables, r.config,
                     collect_stats=True)
    counts = sum_counts(stats)
    n = int(o.shape[0])
    rec = dict(device=args.device if cpu else torch.cuda.get_device_name(0),
               size=f"{r.config.width}x{r.config.height} depth "
                    f"{r.config.max_depth}")
    if cpu:
        rec.update(counted_bound(r._tables, counts, n, TRACE_RAY_BYTES),
                   ceiling="not measured (no card)")
        print(json.dumps(rec))
        return 0
    peaks = measured_peaks()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    trace(o, d, r._ids, seed, r._tables, r.config)
    start.record()
    for _ in range(5):
        trace(o, d, r._ids, seed, r._tables, r.config)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / 5
    b = counted_bound(r._tables, counts, n, TRACE_RAY_BYTES, peaks=peaks)
    rec.update(b, kernel_ms=ms,
               achieved_ops_per_s=b["operations"] / (ms / 1e3),
               share_of_bound=b["bound_ms"] / ms)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
