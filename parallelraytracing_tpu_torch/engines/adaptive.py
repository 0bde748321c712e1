"""Adaptive sampling: variance-guided per-pixel sample budgets (the
counterpart of ``parallelraytracing_tpu.engines.adaptive``).

The fused engine traces an explicit pixel-id vector, so "sample these
pixels" is the same trace-kernel launch as "sample every pixel", only
shorter.  `warmup` full frames seed each storage slot's luminance sums
(Welford through raw sums, in the film's Morton slot order); then every
frame sorts the slots by the relative standard error of their mean,
sqrt(var / n) / (|mean| + 0.05), and traces the `budget` fraction with
the largest error: the trace kernel (csrc/trace.cu) launched on those
ids, one launch a frame, its radiance added to their slots.  The streams
are keyed on (pixel, frame) as in the fused engine, so a pixel's samples
do not depend on which frames selected it, and the warm-up frames are
the fused engine's bit for bit.
"""

from __future__ import annotations

import os

import torch

from parallelraytracing_tpu_torch.engines.base import register_engine
from parallelraytracing_tpu_torch.engines.fused import FusedRenderer
from parallelraytracing_tpu_torch.ops import ieee

#: the JAX engine's budget quantum: its fused engine's ray tile of rows x
#: lanes = 24 x 128 slots (engines/fused.py's `rows`, pallas_trace's
#: LANES).  The port has no tile, but rounding the budget the same way
#: makes both packages select the same slots from the same statistics.
JAX_TILE_SLOTS = 24 * 128


def budget_slots(pixels: int, budget: float) -> int:
    """The slots traced per adaptive frame: the `budget` fraction of the
    frame rounded down to whole JAX tiles, at least one tile, at most
    the frame.  (The JAX engine caps it at its padded slot count instead,
    so below one tile it also selects pad slots, which hold no pixel.)"""
    b = int(pixels * budget)
    b = max(JAX_TILE_SLOTS, (b // JAX_TILE_SLOTS) * JAX_TILE_SLOTS)
    return min(b, pixels)


def select_slots(m1: torch.Tensor, m2: torch.Tensor, n: torch.Tensor,
                 budget: int) -> torch.Tensor:
    """The `budget` slots of the largest relative standard error of the
    mean, in ascending order (so the subset keeps the Morton coherence of
    the slot order): a stable descending argsort, as the JAX engine's
    ``_select_slots``, so equal errors go to the lower slot."""
    nn = torch.clamp_min(n, 1.0)
    mean = m1 / nn
    var = torch.clamp_min(m2 / nn - mean * mean, 0.0)
    rel = ieee.sqrt(var / nn) / (torch.abs(mean) + 0.05)
    idx = torch.argsort(-rel, stable=True)[:budget]
    return torch.sort(idx).values


def luma(rgb: torch.Tensor) -> torch.Tensor:
    return 0.2126 * rgb[:, 0] + 0.7152 * rgb[:, 1] + 0.0722 * rgb[:, 2]


@register_engine
class AdaptiveRenderer(FusedRenderer):
    """The fused engine with variance-guided pixel budgets (module doc)."""

    name = "adaptive"

    #: the depth-probe reorder is untested with the slot statistics: off
    depth_sort: int = 0
    #: full-frame passes that seed the statistics
    warmup: int = int(os.environ.get("PRT_ADAPT_WARMUP", "4"))
    #: fraction of the frame traced per adaptive pass
    budget: float = float(os.environ.get("PRT_ADAPT_BUDGET", "0.5"))

    def _post_init(self) -> None:
        super()._post_init()
        slots = int(self._ids.shape[0])
        self._budget_slots = budget_slots(slots, self.budget)
        self._reset_stats()

    def _reset_stats(self) -> None:
        slots = int(self._ids.shape[0])
        self._m1 = torch.zeros(slots, device=self.device)
        self._m2 = torch.zeros(slots, device=self.device)
        self._n = torch.zeros(slots, device=self.device)

    def reset_progressive(self) -> None:
        """Frame 0 again, from empty statistics: after a camera move the
        old pixels' variance says nothing of the new ones."""
        super().reset_progressive()
        self._reset_stats()

    def _accumulate_stats(self, sel, rad: torch.Tensor) -> None:
        lum = luma(rad)
        if sel is None:
            self._m1 += lum
            self._m2 += lum * lum
            self._n += 1.0
        else:
            self._m1.index_add_(0, sel, lum)
            self._m2.index_add_(0, sel, lum * lum)
            self._n.index_add_(0, sel, torch.ones_like(lum))

    def progressive_render(self) -> None:
        if self._film is None:
            raise RuntimeError("init() first")
        cfg = self.config
        spp = float(cfg.samples_per_frame)
        if self._frame_index < self.warmup:
            sel = None
            rgb = self._trace_ids(self._ids, self._frame_index)
        else:
            sel = select_slots(self._m1, self._m2, self._n, self._budget_slots)
            rgb = self._trace_ids(self._ids[sel], self._frame_index)
        if cfg.firefly_clamp > 0.0:
            rgb = torch.clamp_max(rgb, cfg.firefly_clamp)
        self._accumulate_stats(sel, rgb)
        if sel is None:
            self._film.add_sample_buffer(rgb, spp)
        else:
            self._film.add_sample_slots(sel, rgb, spp)
        self._frame_index += 1
