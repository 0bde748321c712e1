"""Reduce a ``torch.profiler`` Chrome trace of a profiled slice to the
device's busy time, idle gaps, launches and time by layer.

The window is the slice's own: from the start of the first harness span
(``prtbench.frame`` / ``prtbench.display``, recorded around the
harness's calls into the renderer) to the end of the last.  Device work
is every kernel, copy and fill; busy time is the union of their
intervals inside the window (the arithmetic of the renderer's
``utils/profiling.device_busy``, copied here so that the yardstick does
not move with the program), and an idle gap is an interval of the window
that none covers.  Each kernel or copy is counted under the layer of
every ``layers/*.json`` map with a pattern its name matches, whatever
the other maps match (a finer map added later moves no layer that was
there), and one that no map claims under ``unattributed``.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List

#: Chrome-trace categories of device work (kernels, copies, fills)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: categories of host events a gap is named by (the innermost that holds
#: the gap's start)
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime",
                   "cuda_driver")
SPANS = ("prtbench.frame", "prtbench.display")


def events(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    evs = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in evs if e.get("ph") == "X" and "dur" in e]


UNATTRIBUTED = "unattributed"


def classify(name: str, layer_maps: List[dict]) -> List[str]:
    """The layers whose maps claim kernel `name` ([UNATTRIBUTED] if
    none)."""
    layers = [m["layer"] for m in layer_maps
              if any(re.search(p, name) for p in m["patterns"])]
    return sorted(set(layers)) or [UNATTRIBUTED]


def union(intervals, t0: float, t1: float) -> tuple:
    """(busy, gaps) of sorted (start, end, ...) intervals inside [t0, t1]:
    the length of their union and the uncovered intervals as (start,
    length)."""
    busy, gaps, cur_s, cur_e, prev_end = 0.0, [], None, None, t0
    for s, e, *_ in intervals:
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
    return busy, gaps


def reduce(path: str, layer_maps: List[dict], top: int = 10) -> Dict:
    """The slice's reduction; times in seconds: ``window_s``, ``busy_s``,
    ``layer_s`` {layer: device seconds}, ``busy_without`` {layer: busy
    seconds of the work it does not claim}, ``launches``
    (cudaLaunchKernel calls in the window), ``ops`` (the `top` device
    operations by total time, [name, seconds]), ``unattributed`` (those
    that no map claims, [name, seconds]) and ``gaps`` (the `top` longest
    idle gaps, [host event at the gap's start, seconds])."""
    evs = events(path)
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in evs if e.get("cat") == "user_annotation"
             and e.get("name") in SPANS]
    if not spans:
        raise ValueError(f"{path}: no {SPANS} spans")
    t0 = min(s for s, _ in spans)
    t1 = max(e for _, e in spans)
    dev = []
    for e in evs:
        if e.get("cat") not in DEVICE_CATEGORIES:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if s < t1 and s + d > t0:
            dev.append((max(s, t0), min(s + d, t1), e["name"]))
    dev.sort()
    busy, gaps = union(dev, t0, t1)
    layer_of = [classify(name, layer_maps) for _, _, name in dev]
    # the busy time of all but each layer, for a share that leaves out
    # kernels waiting on other ranks (the collectives)
    busy_without = {
        layer: union([iv for iv, lays in zip(dev, layer_of)
                      if layer not in lays], t0, t1)[0] * 1e-6
        for layer in {lay for lays in layer_of for lay in lays}}

    layer_s: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    lost: Dict[str, float] = {}
    for (s, e, name), layers in zip(dev, layer_of):
        for layer in layers:
            layer_s[layer] = layer_s.get(layer, 0.0) + (e - s) * 1e-6
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
        if layers == [UNATTRIBUTED]:
            lost[name] = by_name[name]
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in evs if e.get("cat") in HOST_CATEGORIES
            and float(e["ts"]) < t1 and float(e["ts"]) + float(e["dur"]) > t0]

    def at(t):
        inside = [h for h in host if h[0] <= t < h[1]]
        return min(inside, key=lambda h: h[1] - h[0])[2] if inside else "none"

    gaps.sort(key=lambda g: -g[1])
    launches = sum(1 for e in evs if e.get("cat") == "cuda_runtime"
                   and "LaunchKernel" in e.get("name", "")
                   and t0 <= float(e["ts"]) < t1)
    return {
        "window_s": (t1 - t0) * 1e-6,
        "busy_s": busy * 1e-6,
        "layer_s": layer_s,
        "busy_without": busy_without,
        "launches": launches,
        "ops": sorted(([n, s] for n, s in by_name.items()),
                      key=lambda x: -x[1])[:top],
        "unattributed": sorted(([n, s] for n, s in lost.items()),
                               key=lambda x: -x[1])[:top],
        "gaps": [[at(s), g * 1e-6] for s, g in gaps[:top]],
    }
