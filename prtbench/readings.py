"""What a per-layer metric's reader (``metrics/<name>.py``) reads: one
run's ranks, their profiled slices, their host spans and the reference's
tally, with the arithmetic the readers share.

A reader is ``read(readings) -> float | None``; it returns None where the
run has nothing for it to read (no profiled slice, no kernel of its
layer, one rank where it needs several), and the harness leaves the
metric out of the line.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from prtbench import roofline

#: the layer name of the collectives' kernels (layers/collectives.json)
COLLECTIVES = "collectives"


class Readings:
    def __init__(self, raws: list):
        self.raws = raws
        self.world = len(raws)
        self.traces = [r["trace"] for r in raws]
        self.traced = all(t is not None and r["slice_frames"] > 0
                          for t, r in zip(self.traces, raws))

    # ------------------------------------------------------------- spans
    def host_ms(self) -> Optional[float]:
        """Mean host ms a frame inside ``progressive_render`` over the
        frames before the profiler started, all ranks."""
        spans = [s for r in self.raws for s in r["host_s"]]
        return float(np.mean(spans)) * 1e3 if spans else None

    # ----------------------------------------------------------- slices
    def per_frame_ms(self, layer: str) -> Optional[float]:
        """Device ms a frame of `layer`'s kernels in the slice, the mean
        over the ranks."""
        if not self.traced:
            return None
        ms = [t["layer_s"].get(layer, 0.0) * 1e3 / r["slice_frames"]
              for t, r in zip(self.traces, self.raws)]
        return float(np.mean(ms)) if any(ms) else None

    def launches_per_frame(self) -> Optional[float]:
        if not self.traced:
            return None
        return float(np.mean([t["launches"] / r["slice_frames"]
                              for t, r in zip(self.traces, self.raws)]))

    def idle_pct(self) -> Optional[float]:
        if not self.traced:
            return None
        busy = np.mean([t["busy_s"] for t in self.traces])
        window = np.mean([t["window_s"] for t in self.traces])
        return float(100.0 * (1.0 - busy / window)) if busy > 0 else None

    def gather_ms(self) -> Optional[float]:
        """Collective device ms a display on the rank that reached the
        gather last (its kernel waits least for the others)."""
        if not self.traced or self.world < 2:
            return None
        per = [t["layer_s"].get(COLLECTIVES, 0.0) * 1e3 / r["slice_displays"]
               for t, r in zip(self.traces, self.raws) if r["slice_displays"]]
        return float(min(per)) if per and min(per) > 0 else None

    def rank_skew_pct(self) -> Optional[float]:
        """The slowest rank's device busy time a frame, the collectives
        left out, over the mean of the ranks', less 1, in %."""
        if not self.traced or self.world < 2:
            return None
        busy = [t["busy_without"].get(COLLECTIVES, t["busy_s"])
                / r["slice_frames"] for t, r in zip(self.traces, self.raws)]
        return float(100.0 * (max(busy) / np.mean(busy) - 1.0))

    # ---------------------------------------------------------- roofline
    def floor(self) -> dict:
        """The floor of one frame's work over every card (roofline.py),
        from the reference's tally of its paths."""
        counts = {k: sum(r["counts"][k] for r in self.raws)
                  for k in self.raws[0]["counts"]}
        paths = sum(r["paths"] for r in self.raws)
        r0 = self.raws[0]
        return roofline.frame_floor(counts, paths, r0["width"] * r0["height"],
                                    r0["scene_bytes"], cards=self.world)

    def roofline_pct(self, layer: str) -> Optional[float]:
        """The floor's time at the published peaks over `layer`'s device
        time a frame summed over the cards, in %."""
        ms = self.per_frame_ms(layer)
        if ms is None:
            return None
        seconds, _ = roofline.floor_seconds(self.floor())
        return float(100.0 * seconds / (ms * 1e-3 * self.world))
