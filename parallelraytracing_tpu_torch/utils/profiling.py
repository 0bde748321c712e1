"""Profiling hooks (the counterpart of
``parallelraytracing_tpu.utils.profiling``).

- ``trace(log_dir)``: a ``torch.profiler`` capture of the host and, where
  there is one, the CUDA device, written as a Chrome trace (Perfetto,
  chrome://tracing): the Nsight Systems analogue.
- ``annotate(name)``: a named span in that trace.
- ``device_busy(path)``: from a trace's events, the union of the CUDA
  kernels' and copies' intervals over the traced window, so one minus its
  share is the device's idle share; also the launches and the idle gaps.
- ``rays_per_second`` and ``ThroughputMeter``: the viewer's and the CLI's
  counters, unchanged from the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Iterator, List, Optional

import torch

#: Chrome-trace categories of device work (kernels, copies, fills)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[str]:
    """Profile the block (CPU, and CUDA when available) and write its
    Chrome trace to ``log_dir/trace.json``; yields that path."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield path
    prof.export_chrome_trace(path)


def annotate(name: str):
    """Named span in the profiler's trace."""
    return torch.profiler.record_function(name)


def _events(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    evs = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in evs if e.get("ph") == "X" and "dur" in e]


def device_busy(path: str, annotations: Optional[List[str]] = None) -> dict:
    """The device's activity in a Chrome trace written by ``trace``.

    Returns, with times in microseconds: ``window`` (from the first to
    the last of the named ``annotations`` spans, or of any event when
    none is named), ``busy`` (the union of the kernel, copy and fill
    intervals inside it), ``busy_share`` and ``idle_share`` of the window,
    ``kernels`` (device kernels) and ``launches`` (the host's
    cudaLaunchKernel calls) that start in the window, and ``gaps``: the device's idle intervals
    inside the window, longest first, as dicts of start, length and the
    innermost of the named ``annotations`` spans that holds the gap's
    start (None when none does)."""
    evs = _events(path)
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in evs if e.get("cat") == "user_annotation"
             and (annotations is None or e["name"] in annotations)]
    timed = ([(s, e) for s, e, _ in spans] if annotations and spans else
             [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in evs if e.get("cat") != "Trace"])
    if not timed:
        raise ValueError(f"{path} holds no timed events")
    t0 = min(s for s, _ in timed)
    t1 = max(e for _, e in timed)
    dev = sorted((max(float(e["ts"]), t0),
                  min(float(e["ts"]) + float(e["dur"]), t1))
                 for e in evs if e.get("cat") in DEVICE_CATEGORIES
                 and float(e["ts"]) < t1 and float(e["ts"]) + float(e["dur"]) > t0)
    busy, gaps, cur_s, cur_e = 0.0, [], None, None
    prev_end = t0
    for s, e in dev:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            if s > prev_end:
                gaps.append((prev_end, s - prev_end))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        prev_end = max(prev_end, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    if t1 > prev_end:
        gaps.append((prev_end, t1 - prev_end))

    def stage_at(t):
        inside = [sp for sp in spans if sp[0] <= t < sp[1]]
        return min(inside, key=lambda sp: sp[1] - sp[0])[2] if inside else None

    gaps.sort(key=lambda g: -g[1])
    window = t1 - t0
    return {
        "window": window, "busy": busy,
        "busy_share": busy / window, "idle_share": 1.0 - busy / window,
        "kernels": sum(1 for e in evs if e.get("cat") == "kernel"
                       and t0 <= float(e["ts"]) < t1),
        "launches": sum(1 for e in evs if e.get("cat") == "cuda_runtime"
                        and "LaunchKernel" in e.get("name", "")
                        and t0 <= float(e["ts"]) < t1),
        "gaps": [{"start": s - t0, "length": g, "stage": stage_at(s)}
                 for s, g in gaps],
    }


def rays_per_second(rays_per_frame: float, seconds_per_frame: float) -> float:
    return rays_per_frame / max(seconds_per_frame, 1e-12)


class ThroughputMeter:
    """Rolling rays/sec + frames/sec counter for the viewer/CLI HUD."""

    def __init__(self, window: int = 100):
        self._times: list = []
        self._rays: list = []
        self.window = window

    def tick(self, rays: float) -> None:
        self._times.append(time.perf_counter())
        self._rays.append(rays)
        if len(self._times) > self.window:
            self._times.pop(0)
            self._rays.pop(0)

    @property
    def mrays_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        return sum(self._rays[1:]) / max(dt, 1e-12) / 1e6

    @property
    def fps(self) -> float:
        if len(self._times) < 2:
            return 0.0
        return (len(self._times) - 1) / max(
            self._times[-1] - self._times[0], 1e-12)
