"""Sharded engine: the kernels over a ("px", "spp") mesh of torch.distributed ranks.

The counterpart of ``parallelraytracing_tpu.engines.sharded``: the
multi-device path as an engine a user selects (the CLI's ``--engine
sharded``, the viewer's radio list).  Under ``torchrun`` every rank makes
this renderer on its own card and the mesh spans the process group (or
``group``); without a process group the mesh is 1x1 and the engine is the
fused engine at the same cost.  Each rank traces its block of the
Morton-ordered pixel ids through the trace kernel (K1), or on a
triangle-heavy scene through the segment kernel's bounce segments (K8,
the queue compacted and re-sorted on the rank), and the sample streams of
the spp axis are summed by one all-reduce
(parallel/sharding.render_frame_sharded_fused / _segmented).

It subclasses the fused engine and packs the same tables
(engines/tables.build_scene_tables), once, whichever route it takes: the
port's segment kernel reads the trace kernel's tables.  Every fused
feature (NEE, roulette, instances, the scene extensions, the stream
route, the thin lens, QMC) works the same.

The film (``defer_gather``, the default) keeps each rank's px block only:
a frame costs no collective over px, and ``gather_film`` (a collective,
called on every rank) makes the image whole before it is displayed or
written.  With ``PRT_DEFER_GATHER=0`` every frame is gathered and every
rank's film holds the whole image.

The seeds derive from the frame key only (each rank reads them from its
own block of frames, Renderer._frame_seeds) and every stream is keyed on
the global pixel id, so for a fixed spp-axis size the image does not
depend on the number of ranks or the block layout: it is the fused
engine's (or on the segmented route wavefront_fused's), bit for bit.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from parallelraytracing_tpu_torch.engines.base import register_engine
from parallelraytracing_tpu_torch.engines.fused import (FusedRenderer,
                                                        morton_pixel_perm)
from parallelraytracing_tpu_torch.utils.profiling import annotate


@register_engine
class ShardedRenderer(FusedRenderer):
    name = "sharded"

    #: ranks on the sample axis (the rest go to the pixel axis); 1 = pure
    #: spatial data parallelism; a value that does not divide the ranks
    #: falls back to 1
    spp_axis: int = int(os.environ.get("PRT_SPP_AXIS", "1"))

    #: the process group of the mesh (None: the default group, or the 1x1
    #: mesh without one)
    group = None

    #: keep the film in shard order, each rank its own px block: no
    #: per-frame gather over px, one at display time (gather_film)
    defer_gather: bool = os.environ.get("PRT_DEFER_GATHER", "1") != "0"

    #: the segment kernel's route on each rank: "auto" takes it above 512
    #: triangles (instances included), "1" / "0" force it; its schedule is
    #: wavefront_fused's growing one
    segmented: str = os.environ.get("PRT_SHARDED_SEGMENTED", "auto")
    sort_rays: str = os.environ.get("PRT_SORT", "octant")

    #: the fused engine's depth-sorted ids are never read here (_sperm
    #: drives the raygen): keep it off
    depth_sort: int = 0

    def film_layout(self):
        if not self.defer_gather:
            return None
        slots = int(self._sperm.shape[0])
        mesh = self._mesh
        if mesh.shape["px"] == 1:
            return self._sinv, slots
        blk = slots // mesh.shape["px"]
        return self._sinv, slots, (mesh.px_i * blk, (mesh.px_i + 1) * blk)

    def gather_film(self) -> None:
        if self.defer_gather and self._film is not None:
            from parallelraytracing_tpu_torch.parallel.sharding import gather_film
            gather_film(self._film, self._mesh)

    def _pack_tables(self) -> None:
        """The scene's tables, packed once for either route."""
        from parallelraytracing_tpu_torch.engines.tables import build_scene_tables
        from parallelraytracing_tpu_torch.ops.trace import scene_struct
        self._tables, self._scene_data = build_scene_tables(
            self._scene, self.device, nee=self.config.nee)
        scene_struct(self._tables, self.config)  # the kernels' struct, once

    def _post_init(self) -> None:
        import torch.distributed as dist

        from parallelraytracing_tpu_torch.engines.wavefront_fused import (
            TRI_HEAVY, scene_triangles)
        from parallelraytracing_tpu_torch.parallel.sharding import (
            make_render_mesh, shard_block_size)
        cfg = self.config
        self._use_seg = (scene_triangles(self._scene) > TRI_HEAVY
                         if self.segmented == "auto"
                         else self.segmented not in ("0", "", "none"))
        self._pack_tables()
        d = cfg.max_depth
        self._schedule = ()
        if self._use_seg:
            self._schedule = ((2, 4, d - 6) if d > 10
                              else (2, d - 2) if d > 4 else ())

        n = (dist.get_world_size(self.group)
             if dist.is_available() and dist.is_initialized() else 1)
        spp = self.spp_axis if self.spp_axis >= 1 and n % self.spp_axis == 0 \
            else 1
        self._mesh = make_render_mesh(spp_axis=spp, group=self.group)

        # Morton-ordered pixel ids, so a rank's block is a compact screen
        # region; pad slots get ids past H*W (dummy rays the film never
        # reads)
        r = cfg.pixel_count
        n_slots = self._mesh.shape["px"] * shard_block_size(cfg, self._mesh)
        mperm, minv = morton_pixel_perm(cfg.width, cfg.height)
        self._sperm = torch.from_numpy(np.concatenate(
            [mperm, np.arange(r, n_slots)]).astype(np.int32)).to(self.device)
        self._sinv = torch.from_numpy(minv.copy()).to(self.device)

    def _frame(self, seeds, qpt) -> torch.Tensor:
        """One sample over the mesh under its (jitter seed, path seed)
        pair, through this scene's route."""
        from parallelraytracing_tpu_torch.parallel.sharding import (
            render_frame_sharded_fused, render_frame_sharded_segmented)
        kw = dict(perm=self._sperm, inv=self._sinv,
                  defer_gather=self.defer_gather, qpt=qpt, seeds=seeds)
        if self._use_seg:
            return render_frame_sharded_segmented(
                self._tables, self._cam_params, None, self.config, self._mesh,
                schedule=self._schedule, sort_rays=self.sort_rays, **kw)
        return render_frame_sharded_fused(self._tables, self._cam_params, None,
                                          self.config, self._mesh, **kw)

    def render_sample_buffer(self, frame_index: int) -> torch.Tensor:
        cfg = self.config
        acc = None
        for s in range(cfg.samples_per_frame):
            with annotate("prt.seeds"):
                seeds = self._frame_seeds(frame_index, s)
            rad = self._frame(seeds, self._qpt(frame_index, s))
            acc = rad if acc is None else acc + rad
        return acc / cfg.samples_per_frame
