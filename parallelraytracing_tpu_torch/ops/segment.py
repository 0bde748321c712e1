"""The segment: up to `n_bounces` bounces of every path of a ray queue.

The counterpart of ``pallas_segment`` (``parallelraytracing_tpu/ops/
pallas_trace.py``), the wavefront_fused engine's kernel, on the same
subset as ``ops/trace.py``, together with the compaction the JAX engine
does after it (``_segmented_body``'s argsort).  Three functions, and
the queue re-sort between segments:

- ``segment``: the wrapper.  On a CUDA tensor it launches the hand-written
  kernel ``csrc/segment.cu`` (built at first use, ops/_build.py) or
  raises; on a CPU tensor it runs ``segment_reference``.
  ``segment.launches`` counts kernel launches; ``segment_config`` says
  with which persistent grid and resources each instantiation runs.
- ``segment_reference``: the plain PyTorch version of the same signature
  and result, survivors in stable queue order.
- ``segment_slots``: its per-slot step, the plain version of
  ``pallas_segment`` slot for slot (the JAX parity tests hold it there).
  Its bounce is ``ops/trace._bounce``, the plain version of the trace
  kernel's bounce, as the kernels share ``csrc/bounce.cuh``.
- ``resort`` and ``resort_reference``: the survivors a segment pushed,
  moved to the next segment's queue in ascending order of their key's
  bucket (the top BUCKET_BITS of the key), each bucket's slots
  contiguous.  On a CUDA tensor ``resort`` launches the segment library's
  two re-sort kernels; on a CPU tensor it runs ``resort_reference``, a
  stable sort of the buckets.

Inputs of ``segment``: the input queue, ``pix`` (R,) int32 pixel ids
keying the PCG streams and ``state`` (13, R) float32 planes [ox oy oz dx
dy dz tr tg tb rr rg rb alive] (alive 1, or 2 when NEE sampled the light
at the previous, diffuse vertex: the next vertex adds no emission,
whichever segment traces it), of which the slots [0, count) are read;
``count`` a (1,) int32 tensor on the state's device (the kernel reads it
there, so a frame needs no host sync between segments); ``rad`` the
frame's (P, 3) float32 radiance in pixel order; ``tables`` the scene's
``ops/pack.SceneTables`` and ``cfg`` the ``RenderConfig``, as in
ops/trace.py (``cfg.max_depth`` is the frame's depth); ``seed`` the
frame's path seed, ``depth0`` the absolute depth of the segment's first
bounce; ``sort_rays`` the key written for each survivor ("octant",
"origin", or "" for none) in the scene box ``tables.bb``; ``out``
optionally the output queue's buffers (state (13, R), pix (R,), key (R,)
int32 or None), reused across segments.

Each live slot runs its bounces from absolute depth ``depth0`` (bounce i
draws the streams of depth depth0 + i; Russian roulette, with
``cfg.russian_roulette_depth`` > 0, starts at that absolute depth).  A
path that ends, because its alive value becomes 0 or its depth reaches
``cfg.max_depth``, writes its
radiance to ``rad[pix]`` and is gone: at the frame's last segment every
path ends.  A survivor, alive after ``n_bounces``, goes to the output
queue with its 13 planes, its pixel id and its key (``sort_key``).
Returns ``(state_out, pix_out, key_out, count_out)``: survivors in slots
[0, count_out) (the kernel's order is unspecified; the plain version's
is the input's), count_out a (1,) int32 tensor; past count_out the state
and pixel ids are undefined and key_out holds DEAD_KEY, past every live
key, so a sort puts them last; key_out is None for ``sort_rays`` "".
No permutation of the queue changes ``rad`` or the set of survivors.
"""

from __future__ import annotations

import ctypes

import torch

from parallelraytracing_tpu_torch.ops import rng
from parallelraytracing_tpu_torch.ops.pack import check_tensors
from parallelraytracing_tpu_torch.ops.trace import (_bounce, _t_cap,
                                                    scene_struct, stream_of)

#: planes of the segment state: origin, direction, throughput, radiance, alive
PLANES = 13
#: the sort key modes and their codes in csrc/segment.cu
KEY_MODES = {"": 0, "origin": 1, "octant": 2}
#: the key past the survivors: 0x7f in every byte (the kernel's memset),
#: above every live key (< 2^30)
DEAD_KEY = 0x7F7F7F7F
#: the re-sort's bucket is the top BUCKET_BITS of the 30-bit key: under
#: "octant" the direction octant and 3 Morton bits an axis, under
#: "origin" 4 bits an axis (the kernels take the shift; they hold at
#: most 12 bits)
BUCKET_BITS = 12
BUCKET_SHIFT = 30 - BUCKET_BITS


def _part1by2(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of int32 v over 30 (x -> x00 interleave)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _origin_morton(ox, oy, oz, bb_lo, inv_ext) -> torch.Tensor:
    """30-bit Morton code of ray origins quantised in the scene box."""
    def q(o, lo, ie):
        return torch.clamp((o - lo) * ie * 1024.0, 0.0, 1023.0).to(torch.int32)
    return (_part1by2(q(ox, bb_lo[0], inv_ext[0])) << 2) \
        | (_part1by2(q(oy, bb_lo[1], inv_ext[1])) << 1) \
        | _part1by2(q(oz, bb_lo[2], inv_ext[2]))


def sort_key(state, bb, mode: str) -> torch.Tensor:
    """Coherence key of each column of (13, N) `state` in the scene box
    `bb`: "origin" is the origin's 30-bit Morton code; "octant" puts the
    direction octant (3 bits) over the top 27 bits of it, grouping rays by
    where they are and which way they point (the JAX engine's
    ``_sort_key``)."""
    m = _origin_morton(state[0], state[1], state[2], *bb)
    if mode == "origin":
        return m
    oct_ = ((state[3] < 0).to(torch.int32) << 2) \
        | ((state[4] < 0).to(torch.int32) << 1) \
        | (state[5] < 0).to(torch.int32)
    return (oct_ << 27) | (m >> 3)


def _key_mode(sort_rays: str) -> int:
    if sort_rays not in KEY_MODES:
        raise ValueError(f"sort_rays {sort_rays!r}: want one of "
                         f"{tuple(KEY_MODES)}")
    return KEY_MODES[sort_rays]


def _out_queue(state, sort_rays: str, out):
    """The output queue's buffers: `out` checked, or new ones."""
    r = state.shape[1]
    if out is None:
        key = (torch.empty((r,), dtype=torch.int32, device=state.device)
               if sort_rays else None)
        return (torch.empty_like(state),
                torch.empty((r,), dtype=torch.int32, device=state.device), key)
    state_out, pix_out, key_out = out
    ints = {"pix_out": (pix_out, (r,))}
    if sort_rays:
        if key_out is None:
            raise ValueError(f"sort_rays {sort_rays!r} needs a key buffer")
        ints["key_out"] = (key_out, (r,))
    if tuple(state_out.shape) != (PLANES, r):
        raise ValueError(f"state_out {tuple(state_out.shape)}: want "
                         f"({PLANES}, {r})")
    check_tensors(state.device, {"state_out": state_out}, ints)
    return state_out, pix_out, key_out if sort_rays else None


def segment(pix, state, count, rad, tables, cfg, *, seed: int, depth0: int,
            n_bounces: int, sort_rays: str = "", out=None):
    """Run the queue's paths for up to `n_bounces` bounces; (state_out,
    pix_out, key_out, count_out), ended paths' radiance written to `rad`
    (the module's note)."""
    if state.device.type == "cpu":
        return segment_reference(pix, state, count, rad, tables, cfg,
                                 seed=seed, depth0=depth0,
                                 n_bounces=n_bounces, sort_rays=sort_rays,
                                 out=out)
    if state.device.type != "cuda":
        raise ValueError(f"segment runs on cpu or cuda tensors, not {state.device}")
    key_mode = _key_mode(sort_rays)
    r = int(state.shape[1])
    if state.shape != (PLANES, r):
        raise ValueError(f"state {tuple(state.shape)}: want ({PLANES}, R)")
    if rad.dim() != 2 or rad.shape[1] != 3:
        raise ValueError(f"rad {tuple(rad.shape)}: want (P, 3)")
    check_tensors(state.device, {"state": state, "rad": rad,
                                 "tables.sph": tables.sph},
                  {"pix": (pix, (r,)), "count": (count, (1,))})
    scene = scene_struct(tables, cfg)
    state_out, pix_out, key_out = _out_queue(state, sort_rays, out)
    # counters[0]: the next input slot, counters[1]: the survivors (the
    # next segment's count); the launch function sets both to 0
    counters = torch.empty((2,), dtype=torch.int32, device=state.device)
    box = (ctypes.c_float * 6)(*(tables.bb[0] + tables.bb[1]))

    from parallelraytracing_tpu_torch.ops import _build
    ptr = torch.Tensor.data_ptr
    err = _build.load("segment")(
        *stream_of(state.device), ctypes.byref(scene), ptr(pix), ptr(state),
        ptr(count), ptr(pix_out), ptr(state_out),
        ptr(key_out) if key_out is not None else None, ptr(rad),
        ptr(counters), r, int(seed) & rng.MASK32, int(depth0),
        int(n_bounces), int(cfg.max_depth), key_mode, box)
    if err != 0:
        raise RuntimeError(f"segment kernel launch failed: cudaError_t {err}")
    segment.launches += 1
    return state_out, pix_out, key_out, counters[1:]


segment.launches = 0


def segment_config(device, variant: int) -> dict:
    """What the segment kernel's instantiation `variant` runs with on CUDA
    `device` (ops/_build.launch_config: its persistent grid, threads a
    block, resident blocks per SM, registers, local and shared memory,
    the device's SMs)."""
    from parallelraytracing_tpu_torch.ops import _build
    return _build.launch_config("segment",
                                stream_of(torch.device(device))[0], variant)


def segment_reference(pix, state, count, rad, tables, cfg, *, seed: int,
                      depth0: int, n_bounces: int, sort_rays: str = "",
                      out=None):
    """Plain PyTorch version of ``segment`` (same signature and result;
    the records are not read): ``segment_slots``' step over the live
    prefix, then the ended paths' radiance scattered to `rad` and the
    survivors gathered in queue order."""
    _key_mode(sort_rays)
    r = state.shape[1]
    dev = state.device
    n = min(int(count.reshape(-1)[0]), r)
    end = min(depth0 + n_bounces, cfg.max_depth)
    new = _slots(pix, state, seed, depth0, n, max(0, end - depth0), tables,
                 cfg)
    live = torch.arange(r, device=dev) < n
    survives = live & (new[12] > 0.0) & (end < cfg.max_depth)
    ended = torch.nonzero(live & ~survives)[:, 0]
    rad[pix[ended].long()] = new[9:12, ended].t()
    keep = torch.nonzero(survives)[:, 0]
    c = keep.numel()
    state_out, pix_out, key_out = _out_queue(state, sort_rays, out)
    state_out[:, :c] = new[:, keep]
    pix_out[:c] = pix[keep]
    if key_out is not None:
        key_out.fill_(DEAD_KEY)
        key_out[:c] = sort_key(new[:, keep], tables.bb, sort_rays)
    return (state_out, pix_out, key_out,
            torch.tensor([c], dtype=torch.int32, device=dev))


def resort(state, pix, key, count, out, tally=None):
    """Move the survivors [0, `count`) of a pushed queue (`state` (13, R),
    `pix` and `key` (R,) int32, `count` a (1,) int32 tensor on their
    device) into `out` = (state_out, pix_out) in ascending order of
    ``key >> BUCKET_SHIFT``, each bucket's slots contiguous (in the
    atomics' order inside a bucket on the card); the slots past `count`
    are neither read nor written.  `tally`, a (1,) int64 tensor, gets
    `count` added.  Returns `out`.  No host sync.  ``resort.launches``
    counts the kernels launched, two a call."""
    if state.device.type == "cpu":
        return resort_reference(state, pix, key, count, out, tally)
    if state.device.type != "cuda":
        raise ValueError(f"resort runs on cpu or cuda tensors, not {state.device}")
    r = int(state.shape[1])
    state_out, pix_out = out
    for name, t in (("state", state), ("state_out", state_out)):
        if tuple(t.shape) != (PLANES, r):
            raise ValueError(f"{name} {tuple(t.shape)}: want ({PLANES}, {r})")
    check_tensors(state.device, {"state": state, "state_out": state_out},
                  {"pix": (pix, (r,)), "key": (key, (r,)),
                   "count": (count, (1,)), "pix_out": (pix_out, (r,))})
    if tally is not None and (tally.dtype != torch.int64
                              or tally.device != state.device
                              or tuple(tally.shape) != (1,)):
        raise ValueError(f"tally: want a (1,) int64 tensor on {state.device}")
    # the histogram and the slots claimed in each bucket; the launch
    # zeroes both
    work = torch.empty((2 << BUCKET_BITS,), dtype=torch.int32,
                       device=state.device)

    from parallelraytracing_tpu_torch.ops import _build
    ptr = torch.Tensor.data_ptr
    err = _build.load("resort")(
        *stream_of(state.device), ptr(state), ptr(pix), ptr(key), ptr(count),
        ptr(state_out), ptr(pix_out), ptr(work),
        ptr(tally) if tally is not None else None, r, BUCKET_SHIFT)
    if err != 0:
        raise RuntimeError(f"resort kernel launch failed: cudaError_t {err}")
    resort.launches += 2
    return out


resort.launches = 0


def resort_reference(state, pix, key, count, out, tally=None):
    """Plain PyTorch version of ``resort``: a stable sort of the buckets
    of [0, count), the survivors gathered in that order."""
    n = min(int(count.reshape(-1)[0]), state.shape[1])
    state_out, pix_out = out
    order = torch.argsort(key[:n] >> BUCKET_SHIFT, stable=True)
    state_out[:, :n] = state[:, order]
    pix_out[:n] = pix[order]
    if tally is not None:
        tally += n
    return out


def segment_slots(pix, state, scalars, tables, cfg, *,
                  n_bounces: int) -> torch.Tensor:
    """The per-slot step: ``pallas_segment``'s result slot for slot.
    `scalars` (3,) int32 [seed, depth0, count]; returns a new (13, R)
    state: the 12 planes after the segment and alive (0.0 ended, 1.0 or
    2.0 goes on).  A slot at or past `count`, or not alive, is dead: its
    planes pass through and its alive is 0.  Each bounce runs on the
    slots still alive; as in ``trace_reference``, the fold tests every
    slot column of a stream route's tables (the records are not read)."""
    seed, depth0, count = (int(v) for v in scalars.tolist())
    return _slots(pix, state, seed, depth0, count, n_bounces, tables, cfg)


def _slots(pix, state, seed: int, depth0: int, count: int, n_bounces: int,
           t, cfg) -> torch.Tensor:
    lights = t.lights if t.nee else None
    tri = t.tri if t.tri_live else None
    r = state.shape[1]
    dev = state.device
    t_cap = _t_cap(cfg.t_max)
    out = state.clone()
    planes = [out[k] for k in range(PLANES - 1)]
    alive = out[12]
    alive[(alive <= 0.0) | (torch.arange(r, device=dev) >= count)] = 0.0
    idx = torch.nonzero(alive > 0.0)[:, 0]
    rng_base = rng.pcg_hash((pix.to(torch.int64) & rng.MASK32)
                            ^ (seed & rng.MASK32))
    for i in range(n_bounces):
        if idx.numel() == 0:
            break
        depth = depth0 + i
        rng_d = (rng_base[idx] + depth * rng.DEPTH_STEP) & rng.MASK32
        new, alive_out = _bounce([p[idx] for p in planes], alive[idx], rng_d,
                                 depth, t.sph, t.quad, tri, t.mats,
                                 cfg.t_min, t_cap, t.sky, lights,
                                 cfg.russian_roulette_depth, t.inst,
                                 t.checker, t.itex, t.itex_tab)
        for p, v in zip(planes, new):
            p[idx] = v
        alive[idx] = alive_out
        idx = idx[alive_out > 0.0]
    return out
