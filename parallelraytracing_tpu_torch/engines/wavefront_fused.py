"""Wavefront-fused engine: bounce segments over a compacted, re-sorted queue.

The counterpart of ``parallelraytracing_tpu.engines.wavefront_fused``.  Per
frame: derive the frame's seeds (ops/rays.frame_stream_seeds), generate
jittered camera rays straight from the Morton-permuted pixel ids, then
trace them in segments of bounces (ops/segment.segment, the CUDA kernel
on a card).  Each segment compacts the queue itself: a path that ends
writes its radiance to the frame's buffer in pixel order, a survivor is
pushed to the next queue with its coherence key (direction octant over
origin Morton code, by default).  Between segments one stable argsort of
the keys re-sorts the queue (the slots past the survivors key last) and
one gather moves the (13, R) state and one the pixel ids; with
``sort_rays=""`` the next segment reads the queue as it is.  The live
count stays a device tensor that the next segment reads, so a frame has
no host sync.

Streams are keyed on (pixel id, absolute depth) and both engines share
the bounce (csrc/bounce.cuh; ops/trace._bounce on the CPU), so the image
does not depend on the schedule, the sort key, the queue's order or the
engine: it is the fused engine's, bit for bit.

Left out of the port, on purpose: the TPU's pad of the queue to a
(rows, 128) tile multiple with its drop row for pad rays, and the ``rows``
attribute (CUDA has no tile rule); the PRT_* environment variables (the
knobs are plain attributes); the bounce-0 frustum pretest (scheduling
only on the TPU).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from parallelraytracing_tpu_torch.config import RenderConfig
from parallelraytracing_tpu_torch.engines.base import Renderer, register_engine
from parallelraytracing_tpu_torch.engines.fused import morton_pixel_perm, raygen_ids
from parallelraytracing_tpu_torch.ops.rays import frame_stream_seeds, sample_key
from parallelraytracing_tpu_torch.ops.segment import segment
from parallelraytracing_tpu_torch.ops.trace import scene_struct
from parallelraytracing_tpu_torch.utils.profiling import annotate

SORT_MODES = ("octant", "origin", "")
#: a scene of more triangles than this is triangle-heavy: the renderer's
#: default is the growing schedule, and the CLI's "auto" picks this engine
TRI_HEAVY = 512


def scene_triangles(scene) -> int:
    """The triangle count that routes a scene: its flat triangles plus
    one copy of each unique instanced mesh (the JAX engine's count)."""
    return len(scene._tri) + sum(len(m.indices) // 3
                                 for m in scene._inst_meshes)


def segment_lengths(max_depth: int, segment: int, first_segment: int = 0,
                    schedule: Tuple[int, ...] = ()) -> list:
    """Bounces per segment covering `max_depth`: `schedule` (its last entry
    repeated) when given, else an optional `first_segment` and then
    `segment`-long segments; the last one is cut to fit."""
    lens = []
    if schedule:
        for s in schedule:
            if sum(lens) >= max_depth:
                break
            lens.append(min(int(s), max_depth - sum(lens)))
        segment = max(1, int(schedule[-1]))
    elif 0 < first_segment < max_depth:
        lens.append(first_segment)
    while sum(lens) < max_depth:
        lens.append(min(segment, max_depth - sum(lens)))
    return lens


def _initial_state(o, d) -> torch.Tensor:
    r = o.shape[0]
    ones = torch.ones((3, r), dtype=torch.float32, device=o.device)
    return torch.cat([o.t(), d.t(), ones, torch.zeros_like(ones),
                      ones[:1]]).contiguous()


def segmented_trace(tables, o, d, pix, seed: int, cfg: RenderConfig,
                    segment_len: int = 3, sort_rays: str = "octant",
                    first_segment: int = 0, schedule: Tuple[int, ...] = (),
                    seg_fn=None, rad=None) -> torch.Tensor:
    """(R, 3) radiance in pixel order for camera rays (o, d) of pixel ids
    `pix` ((R,) int32, a permutation of range(R), rays in any order),
    written to `rad` when given (else to new zeros): each pixel once.

    `seed` is the frame's path seed; the segments follow
    ``segment_lengths(cfg.max_depth, segment_len, first_segment,
    schedule)``.  `seg_fn` is ops/segment.segment by default; passing
    ``segment_reference`` runs the plain version on any device.  Two
    queues take turns: a segment reads one and pushes to the other; a
    re-sort gathers the pushed queue back into the first (the caller's
    `pix` is read, never written)."""
    if sort_rays not in SORT_MODES:
        raise ValueError(f"sort_rays {sort_rays!r}: want one of {SORT_MODES}")
    seg_fn = seg_fn or segment
    r = o.shape[0]
    dev = o.device
    if rad is None:
        rad = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    a = (_initial_state(o, d), torch.empty_like(pix))
    b = (torch.empty_like(a[0]), torch.empty_like(pix),
         torch.empty((r,), dtype=torch.int32, device=dev)
         if sort_rays else None)
    queue = (a[0], pix)
    count = torch.full((1,), r, dtype=torch.int32, device=dev)
    lens = segment_lengths(cfg.max_depth, segment_len, first_segment, schedule)
    depth0 = 0
    for s, n_bounces in enumerate(lens):
        last = s + 1 == len(lens)  # every path ends: no key, no next queue
        with annotate("prt.segment"):
            state, ids, key, count = seg_fn(
                queue[1], queue[0], count, rad, tables, cfg, seed=seed,
                depth0=depth0, n_bounces=n_bounces,
                sort_rays="" if last else sort_rays, out=b)
        depth0 += n_bounces
        if last:
            break
        if key is None:  # the next segment reads the pushed queue as it is
            a, b = (state, ids), (*a, None)
        else:
            with annotate("prt.resort"):
                order = torch.argsort(key, stable=True)
                torch.index_select(state, 1, order, out=a[0])
                torch.index_select(ids, 0, order, out=a[1])
        queue = a
    return rad


def count_depth_rays(tables, o, d, pix, seed: int, cfg: RenderConfig,
                     seg_fn=None) -> list:
    """The rays entering each bounce of one frame (the camera rays first),
    from one-bounce segments over the same pixel-keyed streams the engines
    trace (compacted, never re-sorted: each segment's survivor count is
    the next bounce's), so paths that Russian roulette ends count as the
    engines trace them.  NEE's shadow rays are not counted."""
    seg_fn = seg_fn or segment
    r = o.shape[0]
    dev = o.device
    rad = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    queue = (_initial_state(o, d), pix)
    count = torch.full((1,), r, dtype=torch.int32, device=dev)
    counts = []
    for depth in range(cfg.max_depth):
        counts.append(count)
        state, ids, _, count = seg_fn(queue[1], queue[0], count, rad, tables,
                                      cfg, seed=seed, depth0=depth,
                                      n_bounces=1)
        queue = (state, ids)
    return [int(c) for c in torch.cat(counts).tolist()]


def count_frame_rays(tables, o, d, pix, seed: int, cfg: RenderConfig,
                     seg_fn=None) -> int:
    """Exact ray count of one frame: the camera rays plus the rays alive
    entering every later bounce (``count_depth_rays``).  The numerator of
    Mrays/s."""
    return sum(count_depth_rays(tables, o, d, pix, seed, cfg, seg_fn))


@register_engine
class WavefrontFusedRenderer(Renderer):
    name = "wavefront_fused"

    #: bounces per segment; None: the scene's default (3, or the growing
    #: schedule of a triangle-heavy scene when `schedule` is None too)
    segment: Optional[int] = None
    #: between-segment sort key: "octant", "origin", or "" (compact only)
    sort_rays: str = "octant"
    #: length of the first segment only (0: uniform `segment`)
    segment_first: int = 0
    #: per-segment bounce counts, the last repeated; overrides the two above
    schedule: Optional[Tuple[int, ...]] = None

    def _post_init(self) -> None:
        from parallelraytracing_tpu_torch.engines.tables import build_scene_tables
        cfg = self.config
        # The JAX package's growing schedule for triangle-heavy scenes
        # (the flat triangles and each unique instanced mesh's, counted
        # once): compact and re-sort after bounce 2 (the sky misses) and
        # 6, then run the tail in one segment.  The knobs stay as the user
        # set them; the schedule this scene runs is resolved here.
        d = cfg.max_depth
        segment, schedule = self.segment, self.schedule
        if (segment is None and schedule is None
                and scene_triangles(self._scene) > TRI_HEAVY):
            segment = 5
            schedule = (2, 4, d - 6) if d > 10 else (2, d - 2) if d > 4 else ()
        self._lens = segment_lengths(d, 3 if segment is None else segment,
                                     self.segment_first, tuple(schedule or ()))
        self._tables, self._scene_data = build_scene_tables(
            self._scene, self.device, nee=cfg.nee)
        scene_struct(self._tables, cfg)  # the kernels' struct, made once
        perm, _ = morton_pixel_perm(cfg.width, cfg.height)
        self._ids = torch.from_numpy(perm.copy()).to(self.device)

    def segment_lengths(self) -> list:
        """The bounces of each segment of a frame: the knobs set on the
        renderer, else the scene's default."""
        return list(self._lens)

    def render_sample_buffer(self, frame_index: int) -> torch.Tensor:
        cfg = self.config
        acc = None
        for s in range(cfg.samples_per_frame):
            with annotate("prt.seeds"):
                jseed, s0 = frame_stream_seeds(
                    sample_key(cfg.seed, frame_index, s))
            with annotate("prt.raygen"):
                o, d = raygen_ids(self._cam_params, self._ids,
                                  self._pixel_seed(jseed), cfg.width,
                                  cfg.height, cfg.jitter, cfg.lens,
                                  self._qpt(frame_index, s))
            rad = segmented_trace(self._tables, o, d, self._ids, s0, cfg,
                                  sort_rays=self.sort_rays,
                                  schedule=tuple(self._lens))
            acc = rad if acc is None else acc + rad
        return acc / cfg.samples_per_frame
