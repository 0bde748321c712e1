"""Fused engine: every bounce of a frame in one trace-kernel launch.

The counterpart of ``parallelraytracing_tpu.engines.fused``.  Per frame:
derive the frame's seeds (threefry chain, ops/rays.frame_stream_seeds),
generate pixel-keyed jittered camera rays straight from the Morton-
permuted pixel ids, trace them (ops/trace.trace, the CUDA kernel on a
card), and accumulate into the film in that same Morton order
(film_layout), so no per-frame gather is needed.

``depth_sort`` (``PRT_DEPTH_SORT``, as the JAX class reads it) reorders
the rays by the depth a probe frame measured (ops/trace.py's
``depth_out``), so that rays which die together run together: pure
scheduling, since every RNG stream is keyed on the pixel id and the
closest-hit fold does not depend on visit order, so the film is
bit-identical for any value.  Left out of the port, on purpose: the TPU's
pad of the pixel ids to a tile multiple (CUDA has no (rows, 128) tile
rule, so the film layout is exactly (inv, H*W)), ``sub_rows`` and the
eye-ordered front-to-back repack, scheduling of the TPU's lockstep tiles
alike.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from parallelraytracing_tpu_torch.engines.base import Renderer, register_engine
from parallelraytracing_tpu_torch.ops.rays import (frame_stream_seeds,
                                                   generate_camera_rays_ids,
                                                   sample_key)
from parallelraytracing_tpu_torch.ops.trace import scene_struct, trace
from parallelraytracing_tpu_torch.utils.profiling import annotate


def raygen_ids(cam_params, ids, jseed: int, width: int, height: int,
               jitter: bool, lens=None, qpt=None):
    """Camera rays (o, d) for an explicit pixel-id vector: pixel-keyed
    jitter and lens draws under `jseed`, rotated by the Halton point
    `qpt` under QMC."""
    return generate_camera_rays_ids(cam_params, width, height, ids, jitter,
                                    pix_seed=jseed, lens=lens, qpt=qpt)


def _part1by1(v: np.ndarray) -> np.ndarray:
    """Spread the low 16 bits of v over 32 (x -> 0x0x0x... interleave)."""
    v = v.astype(np.uint64) & 0xFFFF
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


@functools.lru_cache(maxsize=8)
def morton_pixel_perm(width: int, height: int):
    """(perm, inv) int32 arrays mapping scanline pixel order <-> Morton
    (Z-order) pixel order: perm[i] = pixel id at sorted position i,
    inv[p] = sorted position of pixel p.  Cached per resolution; the
    arrays are read-only because every caller shares them."""
    xx = _part1by1(np.arange(width, dtype=np.uint64))
    yy = _part1by1(np.arange(height, dtype=np.uint64)) << np.uint64(1)
    code = (yy[:, None] | xx[None, :]).reshape(-1)
    perm = np.argsort(code, kind="stable").astype(np.int32)
    inv = np.argsort(perm, kind="stable").astype(np.int32)
    perm.flags.writeable = False
    inv.flags.writeable = False
    return perm, inv


@register_engine
class FusedRenderer(Renderer):
    name = "fused"

    #: depth-sorted rays: a probe frame (frame 0's streams) measures each
    #: ray's depth and the pixel ids are reordered by it, re-probed when
    #: the eye moves.  0 off; 1 global (depth major, Morton order minor);
    #: >= 8 log2 of the Morton block inside which the rays are sorted by
    #: depth (the blocks keep their order).  The film is the same bits for
    #: any value.
    depth_sort: int = int(os.environ.get("PRT_DEPTH_SORT", "0"))

    def set_camera(self, camera) -> None:
        super().set_camera(camera)
        if self.depth_sort and hasattr(self, "_ids"):
            # the depth field follows the camera: re-probe when the eye
            # moved, and give the film the new layout
            eye = np.asarray(self._camera.position, np.float64)
            if not np.array_equal(eye, getattr(self, "_probe_eye", None)):
                self._depth_reorder()
                if self._film is not None:
                    self._film.set_layout(self.film_layout())

    def _post_init(self) -> None:
        from parallelraytracing_tpu_torch.engines.tables import build_scene_tables
        cfg = self.config
        self._tables, self._scene_data = build_scene_tables(
            self._scene, self.device, nee=cfg.nee)
        scene_struct(self._tables, cfg)  # the kernels' struct, made once
        perm, inv = morton_pixel_perm(cfg.width, cfg.height)
        self._ids = torch.from_numpy(perm.copy()).to(self.device)
        self._minv = torch.from_numpy(inv.copy()).to(self.device)
        if self.depth_sort:
            self._depth_reorder()

    def _depth_reorder(self) -> None:
        """Probe frame 0 for each ray's depth (``trace``'s depth_out) and
        reorder the pixel ids by it, then rebuild the film's inverse
        layout.  The key is the JAX engine's: ((rank >> depth_sort) << 5)
        | depth for depth_sort >= 8, else depth * R + rank, depth clipped
        to [0, 31], rank the id's current position, sorted stably."""
        o, d, s0 = self._sample_rays(self._ids, 0, 0)
        _, depth = trace(o, d, self._ids, s0, self._tables, self.config,
                         depth_out=True)
        self._probe_eye = np.asarray(self._camera.position, np.float64).copy()
        r = int(self._ids.shape[0])
        rank = torch.arange(r, dtype=torch.int64, device=self.device)
        ddc = torch.clamp(depth.to(torch.int64), 0, 31)
        if self.depth_sort >= 8:
            key = ((rank >> self.depth_sort) << 5) | ddc
        else:
            key = ddc * r + rank
        self._ids = self._ids[torch.argsort(key, stable=True)]
        self._minv = torch.empty_like(self._minv)
        self._minv[self._ids.long()] = torch.arange(
            r, dtype=self._minv.dtype, device=self.device)

    def film_layout(self):
        return self._minv, int(self._ids.shape[0])

    def render_sample_buffer(self, frame_index: int) -> torch.Tensor:
        return self._trace_ids(self._ids, frame_index)

    def _sample_rays(self, ids, frame_index: int, s: int):
        """(o, d, path seed) of sample s of a frame for the pixel-id vector
        `ids`.  Under QMC the jitter and lens draws rotate the sample's
        Halton point under the shared rotation seed; the path seed stays
        the frame's."""
        cfg = self.config
        with annotate("prt.seeds"):
            jseed, s0 = frame_stream_seeds(sample_key(cfg.seed, frame_index, s))
        with annotate("prt.raygen"):
            o, d = raygen_ids(self._cam_params, ids, self._pixel_seed(jseed),
                              cfg.width, cfg.height, cfg.jitter, cfg.lens,
                              self._qpt(frame_index, s))
        return o, d, s0

    def _trace_ids(self, ids, frame_index: int) -> torch.Tensor:
        """One frame's mean radiance for an explicit pixel-id vector (in
        that order); a pixel's streams depend only on (pixel, frame)."""
        cfg = self.config
        acc = None
        for s in range(cfg.samples_per_frame):
            o, d, s0 = self._sample_rays(ids, frame_index, s)
            rad = trace(o, d, ids, s0, self._tables, cfg)
            acc = rad if acc is None else acc + rad
        return acc / cfg.samples_per_frame
