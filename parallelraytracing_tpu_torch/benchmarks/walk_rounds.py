"""The LBVH walk's box-test steps a round against the `bvh` engine's frame
time.

accel/traverse.py walks in rounds: up to ``SUBSTEPS`` box-test steps,
then one host read and the parked rays' leaf tests.  A ray tests at most
one leaf a round, so fewer steps a round mean more rounds (each ~200
launches and a host read) and more steps mean more idle steps of parked
rays.  This tool renders the headline (RANDOM_BALLS_LARGE at 1920x1080,
depth 20, 1 spp, jitter, seed 0) through `bvh`: one warm-up frame, then
frame 1 at each step count, timed with CUDA events, with the walk's
rounds and steps; with --profile also one frame at the module's
``SUBSTEPS`` under ``torch.profiler``: the kernel launches, the device
time and the host time.

    python -m parallelraytracing_tpu_torch.benchmarks.walk_rounds
    python -m parallelraytracing_tpu_torch.benchmarks.walk_rounds --profile
    python -m parallelraytracing_tpu_torch.benchmarks.walk_rounds --device cpu

On the CPU the frame is cut to 96x54 and only the counts are printed.
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def frame_seconds(r, device) -> float:
    """One progressive frame of renderer r, in seconds (CUDA events on a
    card, the host clock otherwise)."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        r.progressive_render()
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    r.progressive_render()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def profile_frame(r) -> dict:
    """One frame under torch.profiler: kernel launches, the device's and
    the host's time (the profiler's own cost included in the latter)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r.progressive_render()
        torch.cuda.synchronize()
    events = prof.key_averages()
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    # the kernels' own rows (the operators' rows repeat their device time)
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA)
    host_us = sum(e.self_cpu_time_total for e in events)
    return dict(kernel_launches=launches, device_s=device_us / 1e6,
                host_s=host_us / 1e6)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, nargs="+", default=[2, 4, 8, 16])
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("walk_rounds: CUDA is not available (try --device cpu)",
              file=sys.stderr)
        return 1
    from parallelraytracing_tpu_torch import (Film, RenderConfig, Scene,
                                              ScenePreset, create_renderer,
                                              default_camera)
    from parallelraytracing_tpu_torch.accel import traverse
    w, h = (1920, 1080) if device.type == "cuda" else (96, 54)
    film = Film(w, h, device)
    r = create_renderer("bvh", device)
    r.init(film, Scene(ScenePreset.RANDOM_BALLS_LARGE), default_camera(w, h),
           RenderConfig(width=w, height=h, max_depth=20, seed=0))
    r.progressive_render()  # warm-up
    kept = traverse.SUBSTEPS
    out = dict(device=(torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
               size=f"{w}x{h}", substeps=kept, sweep=[])
    try:
        for k in args.steps:
            traverse.SUBSTEPS = k
            traverse.walk_counts.update(walks=0, rounds=0, steps=0)
            r._frame_index = 1
            sec = frame_seconds(r, device)
            out["sweep"].append(dict(steps_a_round=k, **traverse.walk_counts,
                                     frame_s=sec if device.type == "cuda"
                                     else None))
    finally:
        traverse.SUBSTEPS = kept
    if args.profile and device.type == "cuda":
        out["profile"] = profile_frame(r)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
