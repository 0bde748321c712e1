"""Per-stage frame timing (the counterpart of
``parallelraytracing_tpu.utils.timing``).

The headless analogue of the reference's live timing graphs
(main.cpp:265-462: render / film / upload ms and FPS over 100-frame
rolling histories), with the same 100-entry rings and the same API.
Beyond the JAX timer, a timer made for a CUDA device also records each
stage's device time: a pair of CUDA events recorded on the current stream
around the stage, read only when a device time is asked for, so a stage
never waits for the card.  On the CPU a stage has its host time only, and
``summary()`` says so.  Beside the rings it keeps each stage's running
host total and call count (``totals``, ``take``), which no ring drops.

Attached to the program's spans (``utils/profiling.record_into``), every
span is a stage: the CLI's ``--stats`` times each stage of a frame so.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Deque, Dict, List, Optional, Tuple

import torch

HISTORY = 100  # main.cpp:177 historySize


class FrameTimer:
    def __init__(self, device=None) -> None:
        #: the CUDA device whose current stream the events time, or None
        dev = None if device is None else torch.device(device)
        self.device = dev if dev is not None and dev.type == "cuda" else None
        self._hist: Dict[str, Deque[float]] = {}
        self._dev: Dict[str, Deque[float]] = {}
        #: (name, start, end) event pairs not read yet, in record order
        self._pending: List[Tuple[str, torch.cuda.Event, torch.cuda.Event]] = []
        #: name -> [host seconds, calls] since made or last taken
        self._totals: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        start = None
        if self.device is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(self.device))
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._hist.setdefault(name, collections.deque(maxlen=HISTORY)) \
                .append(dt)
            total = self._totals.setdefault(name, [0.0, 0])
            total[0] += dt
            total[1] += 1
            if start is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record(torch.cuda.current_stream(self.device))
                self._pending.append((name, start, end))
                if len(self._pending) > 4 * HISTORY:
                    self._read_events()

    # ------------------------------------------------------------- host
    def last(self, name: str) -> float:
        h = self._hist.get(name)
        return h[-1] if h else 0.0

    def mean(self, name: str) -> float:
        h = self._hist.get(name)
        return sum(h) / len(h) if h else 0.0

    def history(self, name: str):
        return list(self._hist.get(name, ()))

    def totals(self) -> Dict[str, Tuple[float, int]]:
        """{name: (host seconds, calls)} of every stage since the timer
        was made or last taken."""
        return {name: (t[0], t[1]) for name, t in self._totals.items()}

    def take(self) -> Dict[str, Tuple[float, int]]:
        """``totals()``, and start them again from zero."""
        out = self.totals()
        self._totals = {}
        return out

    # ----------------------------------------------------------- device
    def _read_events(self) -> None:
        """Wait for the recorded events and move their times to the device
        rings (seconds)."""
        for name, start, end in self._pending:
            end.synchronize()
            self._dev.setdefault(name, collections.deque(maxlen=HISTORY)) \
                .append(start.elapsed_time(end) / 1e3)
        self._pending = []

    def device_history(self, name: str) -> Optional[List[float]]:
        """The stage's device times in seconds, or None on the CPU."""
        if self.device is None:
            return None
        self._read_events()
        return list(self._dev.get(name, ()))

    def device_last(self, name: str) -> Optional[float]:
        h = self.device_history(name)
        return None if h is None else (h[-1] if h else 0.0)

    def device_mean(self, name: str) -> Optional[float]:
        h = self.device_history(name)
        return None if h is None else (sum(h) / len(h) if h else 0.0)

    def summary(self) -> str:
        if self.device is None:
            lines = ["stage             last ms    mean ms   (n)"]
            for name, h in self._hist.items():
                lines.append(f"{name:<16} {h[-1]*1e3:9.2f} {sum(h)/len(h)*1e3:10.2f}"
                             f"  ({len(h)})")
            lines.append("(host time only: no CUDA device)")
            return "\n".join(lines)
        self._read_events()
        lines = ["stage             last ms    mean ms   (n)   dev last   dev mean"]
        for name, h in self._hist.items():
            d = self._dev.get(name) or [0.0]
            lines.append(f"{name:<16} {h[-1]*1e3:9.2f} {sum(h)/len(h)*1e3:10.2f}"
                         f"  ({len(h)}) {d[-1]*1e3:9.3f} {sum(d)/len(d)*1e3:10.3f}")
        return "\n".join(lines)
