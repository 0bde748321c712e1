"""Traversal statistics of the trace kernel: where do its walks go?

The counterpart of ``benchmarks/trace_stats.py``.  One frame of the fused
engine's own tables and rays goes through ``trace(collect_stats=True)``
(the probe kernel on the card, the plain replay on the CPU), and the
per-ray counters [nodes, leaves entered, primitives tested, alive
bounces] are summarised two ways:

- per ray: the mean, p50, p90 and max of each counter;
- per warp (32 consecutive rays in launch order, the SIMT unit that
  issues together): the sum of each counter and 32 x its max, the lane
  slots the warp spends while its longest walk runs.  Their ratio is the
  walk's SIMT efficiency, the counterpart of the JAX tool's lockstep-tile
  figures (a TPU tile of rows x 128 lanes walks as one).

Workloads, as the JAX tool's: RANDOM_BALLS_LARGE at 1920x1080, depth 20,
eye (5, 5, 8) toward the origin; the level-5 icosphere (20,480 triangles)
in the PLY showcase scene, eye (0, 14, 28) toward (0, 7, 0).

    python -m parallelraytracing_tpu_torch.benchmarks.trace_stats
    python -m parallelraytracing_tpu_torch.benchmarks.trace_stats --device cpu

On the CPU the frame is cut to 96x54 (the plain replay steps one node at
a time); the counts are the plain version's, no time is measured.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

COUNTERS = ("nodes", "leaves", "prims", "bounces")
WARP = 32
#: the CPU run's frame
SMALL_W, SMALL_H = 96, 54


def workload(name: str, small: bool = False):
    """(scene, camera, RenderConfig) of the named workload, cut to
    SMALL_W x SMALL_H when `small`."""
    from parallelraytracing_tpu_torch import (Camera, RenderConfig, Scene,
                                              ScenePreset)
    from parallelraytracing_tpu_torch.core.mesh import icosphere
    from parallelraytracing_tpu_torch.core.scene import showcase_scene
    w, h = (SMALL_W, SMALL_H) if small else (1920, 1080)
    cfg = RenderConfig(width=w, height=h, max_depth=20, seed=0)
    if name == "spheres":
        scene, eye, look = (Scene(ScenePreset.RANDOM_BALLS_LARGE),
                            (5.0, 5.0, 8.0), (0.0, 0.0, 0.0))
    elif name == "mesh":
        scene, eye, look = showcase_scene(icosphere(5))
    else:
        raise ValueError(f"workload {name!r}: want spheres or mesh")
    eye = np.asarray(eye, np.float64)
    return scene, Camera(eye, np.asarray(look, np.float64) - eye, float(w),
                         float(h), 100.0), cfg


def renderer(scene, camera, cfg, device="cuda"):
    """The fused engine on `scene` seen through `camera`."""
    from parallelraytracing_tpu_torch import Film, create_renderer
    r = create_renderer("fused", device)
    r.init(Film(cfg.width, cfg.height, device), scene, camera, cfg)
    return r


def stats_for(scene, camera, cfg, device="cuda", frame: int = 0):
    """(R, 4) int32 counters of one frame's rays in launch order (the
    engine's Morton order), through the engine's own tables."""
    from parallelraytracing_tpu_torch.ops.trace import trace
    r = renderer(scene, camera, cfg, device)
    o, d, seed = r._sample_rays(r._ids, frame, 0)
    _, stats = trace(o, d, r._ids, seed, r._tables, cfg, collect_stats=True)
    return stats


def summarize(stats) -> dict:
    """Per-ray and per-warp summaries of (R, 4) counters (the module's
    note)."""
    s = stats.to(torch.int64).cpu().numpy()
    r = s.shape[0]
    pad = (-r) % WARP
    warps = np.concatenate([s, np.zeros((pad, 4), np.int64)]).reshape(
        -1, WARP, 4)
    out = {"rays": int(r), "warps": int(warps.shape[0]), "per_ray": {},
           "per_warp": {}}
    for k, name in enumerate(COUNTERS):
        col = s[:, k]
        out["per_ray"][name] = dict(
            mean=float(col.mean()), p50=float(np.percentile(col, 50)),
            p90=float(np.percentile(col, 90)), max=int(col.max()))
        total = int(warps[:, :, k].sum())
        slots = int(WARP * warps[:, :, k].max(1).sum())
        out["per_warp"][name] = dict(
            sum=total, lane_slots=slots,
            simt_efficiency=total / slots if slots else 1.0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    cpu = args.device == "cpu"
    if not cpu and not torch.cuda.is_available():
        print("trace_stats: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    for name in ("spheres", "mesh"):
        scene, camera, cfg = workload(name, small=cpu)
        rec = summarize(stats_for(scene, camera, cfg, args.device))
        rec.update(tag=name, size=f"{cfg.width}x{cfg.height} depth "
                                  f"{cfg.max_depth}",
                   device=args.device if cpu
                   else torch.cuda.get_device_name(0))
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
