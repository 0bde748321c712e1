"""Fused engine: every bounce of a frame in one trace-kernel launch.

The counterpart of ``parallelraytracing_tpu.engines.fused``.  Per frame:
derive the frame's seeds (threefry chain, ops/rays.frame_stream_seeds),
generate pixel-keyed jittered camera rays straight from the Morton-
permuted pixel ids, trace them (engines/tables.trace_tables ->
ops/trace.trace, the CUDA kernel on a card), and accumulate into the film
in that same Morton order (film_layout), so no per-frame gather is needed.

Left out of the port, on purpose: the TPU's pad of the pixel ids to a tile
multiple (CUDA has no (rows, 128) tile rule, so the film layout is exactly
(inv, H*W)), and ``depth_sort``, ``sub_rows`` and the eye-ordered
front-to-back repack.  Those are pure scheduling on the TPU: every RNG
stream is keyed on the pixel id, and the closest-hit fold does not depend
on visit order, so they leave the image bit-identical.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from parallelraytracing_tpu_torch.engines.base import Renderer, register_engine
from parallelraytracing_tpu_torch.ops.rays import (frame_stream_seeds,
                                                   generate_camera_rays_ids,
                                                   sample_key)


def raygen_ids(cam_params, ids, jseed: int, width: int, height: int,
               jitter: bool, lens=None):
    """Camera rays (o, d) for an explicit pixel-id vector."""
    return generate_camera_rays_ids(cam_params, width, height, ids, jitter,
                                    pix_seed=jseed, lens=lens)


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

    def _post_init(self) -> None:
        from parallelraytracing_tpu_torch.engines.tables import build_scene_tables
        cfg = self.config
        if cfg.qmc:
            raise NotImplementedError(
                "QMC camera sampling: ROADMAP Queue 1 item 11 (not ported yet)")
        self._tables, self._scene_data = build_scene_tables(
            self._scene, self.device, nee=cfg.nee)
        perm, inv = morton_pixel_perm(cfg.width, cfg.height)
        self._ids = torch.from_numpy(perm.copy()).to(self.device)
        self._minv = torch.from_numpy(inv.copy()).to(self.device)

    def film_layout(self):
        return self._minv, int(self._ids.shape[0])

    def render_sample_buffer(self, frame_index: int) -> torch.Tensor:
        return self._trace_ids(self._ids, frame_index)

    def _trace_ids(self, ids, frame_index: int) -> torch.Tensor:
        """One frame's mean radiance for an explicit pixel-id vector (in
        that order); a pixel's streams depend only on (pixel, frame)."""
        from parallelraytracing_tpu_torch.engines.tables import trace_tables
        cfg = self.config
        acc = None
        for s in range(cfg.samples_per_frame):
            jseed, s0 = frame_stream_seeds(sample_key(cfg.seed, frame_index, s))
            o, d = raygen_ids(self._cam_params, ids, jseed, cfg.width,
                              cfg.height, cfg.jitter, cfg.lens)
            rad = trace_tables(self._tables, o, d, ids, s0, cfg)
            acc = rad if acc is None else acc + rad
        return acc / cfg.samples_per_frame
