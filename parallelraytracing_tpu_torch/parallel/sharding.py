"""Multi-device rendering over a ("px", "spp") mesh of torch.distributed ranks.

The counterpart of ``parallelraytracing_tpu.parallel.sharding``, where the
mesh is a ``jax.sharding.Mesh`` and the collectives ride ``shard_map``.
Here the mesh is laid over the ranks of a process group, one rank a
device, as the JAX package lays its devices out: rank = px_i * n_spp +
spp_i.  Two axes:

- "px": spatial data parallelism.  Rank px_i traces the contiguous block
  [px_i * blk, (px_i + 1) * blk) of the frame's pixel order; the scene is
  replicated and tracing needs no communication.
- "spp": sample parallelism.  The ranks of one px block trace the same
  pixels with different sample streams (stream spp_i), and their radiance
  is summed by one all-reduce over the spp group.

The frame stays split over "px"; a gather over the px group puts it
together, every frame or (``defer_gather``, the film's own block,
``gather_film``) only when the whole image is read.  Every collective is
called by every rank of its group in the same order.  Without a process
group the mesh is 1x1 and no collective runs.

The frame's path and jitter seeds derive from the frame key only and
every stream is keyed on the global pixel id, so for a fixed spp-axis size
the image is bit-invariant to the number of px blocks and to the pixel
permutation: at 1x1 the kernels' routes give the fused and wavefront_fused
engines' bits.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from parallelraytracing_tpu_torch.ops import rng
from parallelraytracing_tpu_torch.ops.rays import (frame_stream_seeds,
                                                   generate_camera_rays_flat,
                                                   generate_camera_rays_ids,
                                                   qmc_rotation_seed)
from parallelraytracing_tpu_torch.utils.profiling import annotate

#: the odd stride between the seeds of two sample streams (int32)
SPP_STEP = 0x632BE5AB


def _int32(x: int) -> int:
    """x wrapped to a signed 32-bit integer, as int32 arithmetic wraps."""
    return ((int(x) + (1 << 31)) & rng.MASK32) - (1 << 31)


@dataclasses.dataclass(frozen=True, eq=False)
class RenderMesh:
    """A ("px", "spp") mesh over the ranks of a process group: `shape` as
    the JAX mesh's, `ranks` the (n_px, n_spp) group ranks (rank = px_i *
    n_spp + spp_i), this rank's place (px_i, spp_i), and the groups of
    this rank's spp streams (the ranks sharing px_i) and of its px blocks
    (the ranks sharing spp_i); None where the mesh needs no collective
    over that axis."""

    shape: dict
    ranks: np.ndarray
    px_i: int = 0
    spp_i: int = 0
    spp_group: Optional[object] = None
    px_group: Optional[object] = None


def make_render_mesh(spp_axis: Optional[int] = None, group=None) -> RenderMesh:
    """The ("px", "spp") mesh over the ranks of `group` (the default group
    when None).  By default every rank goes to the pixel axis (spatial data
    parallelism); spp_axis > 1 splits off sample parallelism.  Without an
    initialized process group it is the 1x1 mesh of this process's
    device.  Every rank of the group calls it, in the same order (it
    makes the subgroups)."""
    spp = spp_axis or 1
    if dist.is_available() and dist.is_initialized():
        group = group if group is not None else dist.group.WORLD
        n, rank = dist.get_world_size(group), dist.get_rank(group)
    else:
        n, rank = 1, 0
    assert n % spp == 0, f"{n} devices not divisible by spp axis {spp}"
    ranks = np.arange(n).reshape(n // spp, spp)
    px_i, spp_i = divmod(rank, spp)
    spp_group = px_group = None
    if n > 1:
        glob = dist.get_process_group_ranks(group)

        def subgroup(rows, mine):
            # every rank makes every subgroup, in one order (new_group's rule)
            if rows.shape[0] == 1:
                return group
            made = [dist.new_group([glob[i] for i in row]) for row in rows]
            return made[mine]

        if spp > 1:
            spp_group = subgroup(ranks, px_i)
        if n // spp > 1:
            px_group = subgroup(ranks.T, spp_i)
    return RenderMesh({"px": n // spp, "spp": spp}, ranks, px_i, spp_i,
                      spp_group, px_group)


def shard_block_size(cfg, mesh: RenderMesh) -> int:
    """Pixels per px block (the frame's pixel count padded up to the mesh)."""
    return -(-cfg.pixel_count // mesh.shape["px"])


def gather_px(block: torch.Tensor, mesh: RenderMesh) -> torch.Tensor:
    """The px blocks of all ranks in px order, (n_px * rows, ...), from
    this rank's (rows, ...) block: one all_gather over the px group (a
    collective).  Gloo stages CUDA tensors through the host itself."""
    if mesh.shape["px"] == 1:
        return block
    out = block.new_empty((mesh.shape["px"] * block.shape[0],)
                          + tuple(block.shape[1:]))
    dist.all_gather(list(out.chunk(mesh.shape["px"])), block.contiguous(),
                    group=mesh.px_group)
    return out


def sum_spp(block: torch.Tensor, mesh: RenderMesh) -> torch.Tensor:
    """The sum of this px block over the mesh's sample streams, in place:
    one all-reduce over the spp group (a collective)."""
    if mesh.shape["spp"] > 1:
        dist.all_reduce(block, op=dist.ReduceOp.SUM, group=mesh.spp_group)
    return block


def gather_film(film, mesh: RenderMesh) -> None:
    """Make a film that accumulates only this rank's px block
    (``Film.block``) whole: its other blocks are filled from their ranks
    by one all_gather each of accum and weights over the px group.  A
    collective: every rank of the mesh calls it before a read of the whole
    image; the blocks stay the ranks' own, so accumulation goes on."""
    if mesh.shape["px"] == 1:
        return
    lo, hi = film.block
    with annotate("prt.gather_film"):
        for buf in (film.accum, film.weights):
            dist.all_gather(list(buf.chunk(mesh.shape["px"])),
                            buf[lo:hi].clone(), group=mesh.px_group)


def render_frame_sharded(scene, cam_params: torch.Tensor, key, cfg,
                         mesh: RenderMesh, qpt=None,
                         gather: bool = True) -> torch.Tensor:
    """One progressive frame of the plain PyTorch tracer over the mesh:
    the mean radiance over the mesh's spp axis x ``cfg.samples_per_frame``
    samples, (H*W, 3) after a gather over the px group, or with `gather`
    False this rank's (blk, 3) block (rows past H*W are dummy rays).

    Rank (px_i, spp_i) traces the scanline block starting at px_i * blk
    under the key fold_in(fold_in(key, px_i), spp_i), sample s under
    fold_in(., s) split into its jitter key and its path key
    (engines/tracer.trace_paths_tiled).  qpt (QMC, cfg.qmc): the frame's
    Halton points, one row per sample (ops/rays.halton_qpt); the rotation
    seed is the same on every px block and offset per spp stream."""
    blk = shard_block_size(cfg, mesh)
    n_spp = mesh.shape["spp"]
    if cfg.qmc and qpt is None:
        raise ValueError("cfg.qmc requires the frame's Halton points "
                         "(qpt, one row per sample) — see halton_qpt")
    from parallelraytracing_tpu_torch.engines.tracer import trace_paths_tiled
    start = mesh.px_i * blk
    dev_key = rng.fold_in(rng.fold_in(key, mesh.px_i), mesh.spp_i)
    acc = torch.zeros((blk, 3), dtype=torch.float32, device=cam_params.device)
    for s in range(cfg.samples_per_frame):
        k_jit, k_path = rng.split(rng.fold_in(dev_key, s))
        if cfg.qmc:
            pseed = (qmc_rotation_seed(cfg.seed)
                     + mesh.spp_i * SPP_STEP) & rng.MASK32
            o, d = generate_camera_rays_flat(
                cam_params, cfg.width, cfg.height, start, blk, None,
                cfg.jitter, cfg.lens, pix_seed=pseed, qpt=qpt[s])
        else:
            o, d = generate_camera_rays_flat(
                cam_params, cfg.width, cfg.height, start, blk, k_jit,
                cfg.jitter, cfg.lens)
        acc = acc + trace_paths_tiled(scene, o, d, k_path, cfg)
    out = sum_spp(acc, mesh) / (n_spp * cfg.samples_per_frame)
    if not gather:
        return out
    return gather_px(out, mesh)[:cfg.pixel_count]


def _sharded_pallas_frame(trace_block, cfg, mesh: RenderMesh, perm, inv,
                          defer_gather: bool, tables, cam_params, key, qpt,
                          seeds=None):
    """The frame both kernel routes share (the JAX package's name, kept;
    no Pallas here): the block math, the seeds derived once from the
    frame key (or given: `seeds`, the pair ``frame_stream_seeds(key)``
    gives), the 1x1 path (no collective), the spp all-reduce, and the
    output.  Parameterized only by trace_block(tables, cam, seed0, jseed0,
    ids, spp_i, qpt) -> (len(ids), 3), so the fused and segmented routes
    cannot drift apart.

    perm, (n_px * blk,) int32: the pixel id of each slot, rank px_i
    tracing slots [px_i * blk, (px_i + 1) * blk); ids past H*W are dummy
    rays.  None: scanline order, padded.  The result is this rank's
    (blk, 3) block in perm order with `defer_gather` (the whole frame at
    1x1), else the whole frame after a gather over the px group: in pixel
    order through `inv` (pixel -> slot, (H*W,)) when given, else the
    first H*W slots."""
    n_px, n_spp = mesh.shape["px"], mesh.shape["spp"]
    blk = shard_block_size(cfg, mesh)
    if perm is None:
        perm = torch.arange(n_px * blk, dtype=torch.int32,
                            device=cam_params.device)
    assert perm.shape == (n_px * blk,), (tuple(perm.shape), n_px * blk)
    # the seeds of the frame, the same on every rank: spp stream i offsets
    # them by i (_spp_stream_offset), px blocks share them
    with annotate("prt.seeds"):
        jseed0, seed0 = frame_stream_seeds(key) if seeds is None else seeds
        if cfg.qmc:
            # QMC: the frame-independent rotation seed of every engine (so
            # the 1x1 mesh keeps the fused engine's bits) and this sample's
            # Halton point; the path seed stays the frame's
            if qpt is None:
                raise ValueError("cfg.qmc requires this sample's Halton "
                                 "point (qpt) — see ops/rays.halton_qpt")
            jseed0 = qmc_rotation_seed(cfg.seed)
    if n_px == 1 and n_spp == 1:
        out = trace_block(tables, cam_params, seed0, jseed0, perm, 0, qpt)
    else:
        ids = perm[mesh.px_i * blk:(mesh.px_i + 1) * blk]
        out = sum_spp(trace_block(tables, cam_params, seed0, jseed0, ids,
                                  mesh.spp_i, qpt), mesh)
    if defer_gather:
        return out / n_spp
    out = gather_px(out, mesh)
    if inv is not None:
        return out[inv.long()] / n_spp
    return out[:cfg.pixel_count] / n_spp


def _spp_stream_offset(seed0: int, jseed0: int, spp_i: int):
    """(path seed int32, jitter seed uint32) of sample stream spp_i: both
    offset by spp_i odd strides, in the JAX package's int32 arithmetic."""
    step = spp_i * SPP_STEP
    return _int32(seed0 + step), (jseed0 + step) & rng.MASK32


def _stream_rays(cfg, cam, ids, jseed: int, qpt):
    with annotate("prt.raygen"):
        return generate_camera_rays_ids(cam, cfg.width, cfg.height, ids,
                                        cfg.jitter, pix_seed=jseed,
                                        lens=cfg.lens, qpt=qpt)


def fused_block(cfg, tables, cam, seed0: int, jseed0: int, ids, spp_i: int,
                qpt=None) -> torch.Tensor:
    """Sample stream spp_i of the pixel ids `ids` through the trace kernel
    (ops/trace.trace; K1 on a card): (len(ids), 3) radiance.  The global
    pixel ids key the streams, so a pixel's result does not depend on its
    block."""
    from parallelraytracing_tpu_torch.ops.trace import trace
    seed, jseed = _spp_stream_offset(seed0, jseed0, spp_i)
    o, d = _stream_rays(cfg, cam, ids, jseed, qpt)
    return trace(o, d, ids, seed, tables, cfg)


def segmented_block(cfg, n_slots: int, segment: int, schedule: tuple,
                    sort_rays: str, tables, cam, seed0: int, jseed0: int,
                    ids, spp_i: int, qpt=None) -> torch.Tensor:
    """Sample stream spp_i of the pixel ids `ids` through the segment
    kernel (engines/wavefront_fused.segmented_trace; K8 on a card), the
    queue compacted and re-sorted on this rank only: (len(ids), 3).  The
    kernel writes an ended path's radiance to its global id's row of an
    (n_slots, 3) buffer, one row for every id of the mesh's slots (pad
    ids included); the rank's rows are read out of it in the order of
    `ids`."""
    from parallelraytracing_tpu_torch.engines.wavefront_fused import \
        segmented_trace
    seed, jseed = _spp_stream_offset(seed0, jseed0, spp_i)
    o, d = _stream_rays(cfg, cam, ids, jseed, qpt)
    rad = torch.zeros((n_slots, 3), dtype=torch.float32, device=o.device)
    segmented_trace(tables, o, d, ids, seed, cfg, segment_len=segment,
                    sort_rays=sort_rays, schedule=tuple(schedule), rad=rad)
    return rad[ids.long()]


def render_frame_sharded_fused(tables, cam_params: torch.Tensor, key, cfg,
                               mesh: RenderMesh, perm=None, inv=None,
                               defer_gather: bool = False,
                               qpt=None, seeds=None) -> torch.Tensor:
    """One sample of a frame over the mesh through the trace kernel, with
    every feature of the fused engine (NEE, roulette, instances, the scene
    extensions, the stream route): each rank traces its block of `perm`
    (``_sharded_pallas_frame`` says what comes back).  `key` is the
    sample's key (ops/rays.sample_key), unread when `seeds` gives its
    (jitter seed, path seed) pair; `tables` the scene's
    (engines/tables.build_scene_tables), on every rank."""
    return _sharded_pallas_frame(functools.partial(fused_block, cfg), cfg,
                                 mesh, perm, inv, defer_gather, tables,
                                 cam_params, key, qpt, seeds)


def render_frame_sharded_segmented(tables, cam_params: torch.Tensor, key,
                                   cfg, mesh: RenderMesh, segment: int = 5,
                                   schedule: tuple = (),
                                   sort_rays: str = "octant", perm=None,
                                   inv=None, defer_gather: bool = False,
                                   qpt=None, seeds=None) -> torch.Tensor:
    """``render_frame_sharded_fused`` through the segment kernel: each rank
    runs the wavefront_fused engine's bounce segments on its block, the
    queue compacted and re-sorted between segments on the rank (no
    collective touches it).  Streams are keyed on (pixel, absolute
    depth), so any schedule and sort mode gives the same image, and a 1x1
    mesh gives the wavefront_fused engine's bits."""
    block = functools.partial(
        segmented_block, cfg, mesh.shape["px"] * shard_block_size(cfg, mesh),
        segment, schedule, sort_rays)
    return _sharded_pallas_frame(block, cfg, mesh, perm, inv, defer_gather,
                                 tables, cam_params, key, qpt, seeds)
