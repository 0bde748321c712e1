"""Profiling hooks (the counterpart of
``parallelraytracing_tpu.utils.profiling``).

- ``annotate(name)``: the program's one span.  The engines (and
  ``ops/trace.trace``, its own) put one around each stage of a frame
  (``prt.frame``, ``prt.seeds``,
  ``prt.raygen``, ``prt.trace``, ``prt.segment``, ``prt.resort``,
  ``prt.film_add``, ``prt.set_camera``, ``prt.film_clear``,
  ``prt.gather_film``, ``prt.display``), and two around the set-up's
  table build (``prt.build_tables``, and ``prt.pack_stream`` inside it on
  the stream route: engines/tables.py, ops/pack.py).  With nothing
  listening it is one shared null context: no allocation, no CUDA call,
  no sync.  Under an active ``torch.profiler`` it is a
  ``record_function`` span in the Chrome trace, on the clock of the
  device's kernels; with a recorder attached (``record_into``) it is
  also a stage of that ``utils/timing.FrameTimer``.
- ``record_into(timer)``: attach a ``FrameTimer`` to every span (None
  detaches it).
- ``trace(log_dir)``: a ``torch.profiler`` capture of the host and, where
  there is one, the CUDA device, written as a Chrome trace (Perfetto,
  chrome://tracing): the Nsight Systems analogue.
- ``device_busy(path)``: from a trace's events, the union of the CUDA
  kernels' and copies' intervals over the traced window, so one minus its
  share is the device's idle share; also the launches, the idle gaps and,
  for each named span, the idle time it holds and the device time it
  launched.
"""

from __future__ import annotations

import contextlib
import json
import os
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


#: the FrameTimer every span is also a stage of, or None
_recorder = None
_NULL = contextlib.nullcontext()
_profiler_on = torch._C._autograd._profiler_enabled


def record_into(timer) -> None:
    """Make every ``annotate`` span also a stage of `timer` (a
    ``utils/timing.FrameTimer``); None detaches it."""
    global _recorder
    _recorder = timer


@contextlib.contextmanager
def _recorded(name: str, timer):
    if _profiler_on():
        with torch.profiler.record_function(name), timer.stage(name):
            yield
    else:
        with timer.stage(name):
            yield


def annotate(name: str):
    """A named span of the program: the shared null context when nothing
    listens, a ``record_function`` span under an active profiler, and a
    stage of the attached recorder (``record_into``)."""
    timer = _recorder
    if timer is not None:
        return _recorded(name, timer)
    if _profiler_on():
        return torch.profiler.record_function(name)
    return _NULL


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
    start (None when none does); ``spans``: for each name of those spans,
    ``span_times``."""
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

    named = span_times(evs, spans, gaps, t0, t1)
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
        "spans": named,
    }


def span_times(evs: List[dict], spans, gaps, t0: float, t1: float) -> dict:
    """{name: {"calls", "host", "idle", "device"}} of the (start, end,
    name) `spans` that meet the window [t0, t1], times in the trace's
    microseconds: how many there are and their summed length; the idle
    time of the window that they hold (`gaps`, the window's disjoint
    (start, length) idle intervals, against the union of the name's
    spans, whatever is nested in them); and the device time of the
    kernels, copies and fills in the window whose launching runtime call
    (matched by ``args.correlation``) lies inside a span of that name and
    inside no later-starting named span within it (the innermost)."""
    spans = sorted((s, e, n) for s, e, n in spans if s < t1 and e > t0)
    out = {n: {"calls": 0, "host": 0.0, "idle": 0.0, "device": 0.0}
           for _, _, n in spans}
    by_name = {}
    for s, e, n in spans:
        out[n]["calls"] += 1
        out[n]["host"] += e - s
        by_name.setdefault(n, []).append((max(s, t0), min(e, t1)))
    gaps = sorted(gaps)
    for n, ivs in by_name.items():
        union = []
        for s, e in ivs:  # sorted by start
            if union and s <= union[-1][1]:
                union[-1][1] = max(union[-1][1], e)
            else:
                union.append([s, e])
        i = 0
        for s, e in union:
            while i < len(gaps) and gaps[i][0] + gaps[i][1] <= s:
                i += 1
            j = i
            while j < len(gaps) and gaps[j][0] < e:
                g0, g1 = gaps[j][0], gaps[j][0] + gaps[j][1]
                out[n]["idle"] += max(0.0, min(e, g1) - max(s, g0))
                j += 1
    # the host's CUDA API calls (the launches, copies and fills)
    calls = sorted((float(e["ts"]), e["args"]["correlation"]) for e in evs
                   if e.get("cat", "").startswith("cuda_")
                   and "correlation" in e.get("args", {}))
    inner, stack, k = {}, [], 0
    order = sorted(spans, key=lambda sp: (sp[0], -sp[1]))
    for t, corr in calls:
        while k < len(order) and order[k][0] <= t:
            stack.append(order[k])
            k += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        if stack:
            inner[corr] = stack[-1][2]
    for e in evs:
        n = inner.get(e.get("args", {}).get("correlation"))
        if n is not None and e.get("cat") in DEVICE_CATEGORIES:
            s, d = float(e["ts"]), float(e["dur"])
            out[n]["device"] += max(0.0, min(s + d, t1) - max(s, t0))
    return out
